"""Kernel families of the port: each has a hand-written CUDA kernel for the
card and its plain PyTorch version for the CPU (``runtime`` builds, loads
and counts the kernels)."""
