"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch and hand-written CUDA C++ kernels (``csrc/``).  It
imports neither ``jax`` nor ``repro``.  Subpackages mirror ``repro``'s
names so each module's counterpart is easy to find.

Slice covered so far: single-device continuous-batching paged serving of
the dense decoder family (qwen2-1.5b) under the ``exact`` and ``predicted``
accumulation policies.
"""
