"""Tensor ops of the port (NCHW)."""
