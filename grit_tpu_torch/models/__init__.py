"""Model families ported so far: llama (training subset)."""
