"""Kernels of the port: CUDA C++ for Hopper (``repro_torch/csrc``) behind
Python wrappers that also hold each kernel's plain PyTorch version.

The package exports the JAX package's entry points (``qmatmul_fused``,
``QDotConfig``, ``qdot``, ``qdot_packed``, ``quantize_op``), resolved on
first access: ``kernels.common`` is imported by the quantizers that these
modules import in turn."""

_EXPORTS = {"qmatmul_fused": "fused", "QDotConfig": "ops", "qdot": "ops",
            "qdot_packed": "ops", "quantize_op": "ops"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
