# Online swamping telemetry and the closed-loop accumulation-precision
# controller (counterpart of ``repro.telemetry``): measure the paper's
# variance retention live through the stats variants of the kernels
# (K8/K9/K12's ports), compare it with the closed-form prediction, and feed
# the verdict back into the plan.
#
# ``capture`` is imported eagerly (dependency-free, consulted by
# ``repro_torch.kernels.ops.qdot`` on every call); ``stats``,
# ``controller`` and ``probe`` load lazily, which keeps import cycles with
# the model stack away.
from repro_torch.telemetry import capture  # noqa: F401

_LAZY = {
    "EnsembleStats": "repro_torch.telemetry.stats",
    "gemm_stats": "repro_torch.telemetry.stats",
    "bwd_pair_stats": "repro_torch.telemetry.stats",
    "predicted_kernel_vrr": "repro_torch.telemetry.stats",
    "ControllerConfig": "repro_torch.telemetry.controller",
    "PrecisionController": "repro_torch.telemetry.controller",
    "apply_schedule": "repro_torch.telemetry.controller",
    "probe_model_stats": "repro_torch.telemetry.probe",
    "stats": "repro_torch.telemetry.stats",
    "controller": "repro_torch.telemetry.controller",
    "probe": "repro_torch.telemetry.probe",
}

__all__ = ["capture", *sorted(set(_LAZY))]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.telemetry' has no attribute {name!r}")
    import importlib

    module = importlib.import_module(mod)
    return module if name == mod.rsplit(".", 1)[1] else getattr(module, name)
