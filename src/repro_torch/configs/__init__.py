"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

One module per architecture exposing ``CONFIG`` (the full-size config) and
``SMOKE`` (a reduced config of the same family for CPU tests).  The port
has qwen2-1.5b and its speculative-decoding draft, qwen2-0.5b.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ALIASES = {"qwen2-1.5b": "qwen2_1_5b", "qwen2-0.5b": "qwen2_0_5b"}


def _module(arch: str):
    name = ALIASES.get(arch)
    if name is None:
        raise ValueError(f"unknown arch {arch!r}; ported: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
