"""Model families ported so far: llama (training and serving), the
serving engines, and the MNIST-scale MLP."""
