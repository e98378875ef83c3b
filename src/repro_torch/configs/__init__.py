"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

One module per architecture exposing ``CONFIG`` (the full-size config) and
``SMOKE`` (a reduced config of the same family for CPU tests), copied from
the JAX package's ``repro.configs``.  ``ARCHS`` and ``ALIASES`` are JAX's;
the architectures of the families the port does not run yet
(``UNPORTED``: mamba2-1.3b and zamba2-7b, SSM and hybrid; seamless-m4t-
large-v2, encoder-decoder) are listed and refused by ``get_config``,
which names the ROADMAP item that will port each.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ARCHS = [
    "internvl2_2b",
    "qwen2_0_5b",
    "qwen2_1_5b",
    "qwen3_8b",
    "llama3_2_3b",
    "granite_8b",
    "seamless_m4t_large_v2",
    "moonshot_v1_16b_a3b",
    "llama4_maverick_400b_a17b",
    "zamba2_7b",
    "mamba2_1_3b",
]

# canonical ids -> module names
ALIASES = {
    "internvl2-2b": "internvl2_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen3-8b": "qwen3_8b",
    "llama3.2-3b": "llama3_2_3b",
    "granite-8b": "granite_8b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
}

# module name -> the ROADMAP item that will port its family
UNPORTED = {"mamba2_1_3b": "families-ssm", "zamba2_7b": "families-ssm",
            "seamless_m4t_large_v2": "families-encdec"}


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name in UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP [{UNPORTED[name]}], "
            "the rest of [families])")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_cells(arch: str) -> list[str]:
    """The shape names that apply to ``arch`` (JAX's skip rules: the
    500k-token decode only for the sub-quadratic SSM and hybrid families,
    which the port does not run yet, so never here)."""
    get_config(arch)
    return ["train_4k", "prefill_32k", "decode_32k"]
