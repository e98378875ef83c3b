"""Which params split across the ranks of tensor-parallel serving, and
rank r's slices of them.

Counterpart of ``repro.sharding.specs.serve_param_specs``.  Serving splits
every GEMM on its OUTPUT dim only, wo and w_down included: an
output-column slice of a GEMM is the corresponding slice of the full
GEMM, bit for bit, because each output's sum over K is untouched by the
split (a split of the contraction would sum partial sums in another
order).  So the layers gather the slices back (``dist.gather_cols``) and
the sharded logits are bitwise the single-device ones.

A spec is a tuple of axis names per dim, as JAX's ``PartitionSpec``:
``(None, ..., "model")`` splits the last dim over the ranks, ``()``
replicates.
"""

from __future__ import annotations

from typing import Any

__all__ = ["SERVE_SPLIT", "serve_param_specs", "shard_params"]

# the params split on their last dim: the q/k/v/o projections, the MLP,
# an untied lm_head and the qkv biases
SERVE_SPLIT = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                         "lm_head", "bq", "bk", "bv"})


def serve_param_specs(params: Any, *, n_shards: int,
                      model_axis: str = "model",
                      logit_wire: str = "gather", _path: tuple = ()) -> Any:
    """The tree of specs for ``params`` (nested dicts of tensors, or of
    anything with a ``shape``): last-dim splits for ``SERVE_SPLIT``,
    everything else (embed, norms) replicated; leading layer-stack dims
    are never split.  Under the int8 logit wire the ``lm_head`` stays
    replicated (each rank computes partial logits over its d_model slice
    instead).  A dim the ranks cannot split evenly is an error, never a
    silent fallback."""
    if isinstance(params, dict):
        return {k: serve_param_specs(v, n_shards=n_shards,
                                     model_axis=model_axis,
                                     logit_wire=logit_wire, _path=_path + (k,))
                for k, v in params.items()}
    shape = tuple(params.shape)
    name = _path[-1] if _path else ""
    if name not in SERVE_SPLIT or not shape:
        return ()
    if name == "lm_head" and logit_wire == "int8":
        return ()
    if shape[-1] % n_shards != 0:
        raise ValueError(f"a serve group of {n_shards} ranks cannot split "
                         f"{'/'.join(_path)} last dim {shape[-1]}")
    return (None,) * (len(shape) - 1) + (model_axis,)


def shard_params(params: Any, specs: Any, rank: int, n_shards: int) -> Any:
    """Rank ``rank``'s params: each split leaf's ``rank``-th slice of its
    last dim (a contiguous copy), each replicated leaf as it is."""
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], rank, n_shards)
                for k, v in params.items()}
    if not specs:
        return params
    n = params.shape[-1] // n_shards
    return params[..., rank * n:(rank + 1) * n].contiguous()
