"""The plain reference of the benchmark: a frozen copy of the PyTorch port's
model, loss, step and optimizer modules, kept here so that later changes to
the port are held against the arithmetic it had when the benchmark was made.

It imports nothing of the port and nothing of JAX. Where the port calls its
CUDA kernels (K1 the multi-grid warp, K2 and K3 the fused SSIM+L1 error and
its gradient), this copy calls the port's plain PyTorch versions of them on
every device (`ops/cuda/`); `parallel/dist.py` is the single-process case of
the port's collectives. Everything else is the port's code as it was, its
docstrings included, so a reader can diff it against the port.
"""
