"""Training: the Trainer and its Adam update."""
