"""Kernels of the port: CUDA C++ for Hopper (``repro_torch/csrc``) behind
Python wrappers that also hold each kernel's plain PyTorch version."""
