"""Attention ops: the CUDA flash kernels and the plain-tensor reference."""
