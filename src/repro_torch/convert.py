"""Parameters carried across from the JAX package.

``params_from_jax`` takes the JAX parameter pytree of a dense LM as numpy
arrays (for example ``jax.tree.map(np.asarray, params)``) and returns the
port's parameters: the same nested dict of the same shapes and dtypes
(bf16 stays bf16, the layer axis stays stacked), as tensors on ``device``,
so both packages compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "expected_shapes"]


def expected_shapes(cfg) -> dict:
    """The parameter tree's shapes for ``cfg`` (dense family)."""
    d, h, kv, dh, f, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.n_layers)
    attn = {"wq": (n, d, h * dh), "wk": (n, d, kv * dh),
            "wv": (n, d, kv * dh), "wo": (n, h * dh, d)}
    if cfg.attn_bias:
        attn.update(bq=(n, h * dh), bk=(n, kv * dh), bv=(n, kv * dh))
    tree = {
        "embed": (cfg.vocab_size, d),
        "final_norm": (d,),
        "layers": {"ln1": (n, d), "ln2": (n, d), "attn": attn,
                   "mlp": {"w_gate": (n, d, f), "w_up": (n, d, f),
                           "w_down": (n, f, d)}},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, cfg.vocab_size)
    return tree


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # torch wants a writable buffer
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype not in (np.float32, np.int32):
        raise TypeError(f"unexpected parameter dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def params_from_jax(np_params: dict, cfg, device) -> dict:
    """The port's parameters from the JAX pytree (numpy leaves); raises on
    any missing, extra or misshapen entry."""

    def walk(tree, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(tree, dict) or set(tree) != set(shapes):
                got = sorted(tree) if isinstance(tree, dict) else type(tree)
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"{sorted(shapes)}")
            return {k: walk(tree[k], shapes[k], f"{path}/{k}") for k in shapes}
        if tuple(np.shape(tree)) != tuple(shapes):
            raise ValueError(f"{path}: shape {np.shape(tree)} != {shapes}")
        return _tensor(np.asarray(tree), device)

    return walk(np_params, expected_shapes(cfg), "")
