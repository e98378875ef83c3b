"""Which params split across the ranks, and rank r's slices of them: the
training rules (FSDP over ``data``, TP over ``model``) and tensor-parallel
serving's.

Counterpart of ``repro.sharding.specs``.  Training (``ShardingRules``,
``build_param_specs``, JAX's name rules): column-parallel GEMMs
(wq/wk/wv/w_gate/w_up/lm_head) put their last dim on ``model`` and the
one before on ``data``; row-parallel ones (wo/w_down) the other way round;
the embedding (V, D) its vocab on ``model`` and D on ``data``; the qkv
biases follow ``model``; norms are replicated.  Every assignment is
guarded by divisibility (a dim the axis cannot split stays whole) and
leading layer-stack dims are never split.  ``batch_spec`` picks the
largest prefix of the data axes that divides the batch.  ``shard``,
``local_shard`` and ``unshard`` are the counterpart of ``named_shardings``
and the device placement: the block of each leaf a rank holds, and the
whole leaf back from the blocks (pure movement).

Serving splits
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

__all__ = ["SERVE_SPLIT", "serve_param_specs", "shard_params",
           "ShardingRules", "build_param_specs", "batch_spec", "shard",
           "local_shard", "unshard", "tree_specs_map"]

COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "lm_head",
          "frontend_proj"}
ROW = {"wo", "w_down", "out_proj"}
COLUMN_BIAS = {"bq", "bk", "bv"}
EXPERT = {"w_gate", "w_up", "w_down"}  # under a "moe" path component


class ShardingRules:
    """JAX's rules over a mesh (anything with a ``shape`` dict): FSDP over
    ``data`` when ``fsdp``, TP over ``model``, the batch over the present
    ``data_axes``."""

    def __init__(self, mesh, *, fsdp: bool = True,
                 data_axes: tuple = ("pod", "data"),
                 model_axis: str = "model"):
        self.mesh = mesh
        self.fsdp = fsdp
        self.model_axis = model_axis if model_axis in mesh.shape else None
        self.fsdp_axis = "data" if (fsdp and "data" in mesh.shape) else None
        self.data_axes = tuple(a for a in data_axes if a in mesh.shape)

    def _fits(self, dim: int, axis: str | None) -> str | None:
        if axis is None:
            return None
        return axis if dim % self.mesh.shape[axis] == 0 else None


def _leaf_spec(rules: ShardingRules, path: tuple, shape: tuple) -> tuple:
    name = path[-1] if path else ""
    in_moe = "moe" in path and "shared" not in path
    ndim = len(shape)
    spec: list = [None] * ndim

    def put(i: int, axis: str | None):
        axis = rules._fits(shape[i], axis)
        if axis is not None and axis not in spec:
            spec[i] = axis

    if name == "embed":
        put(ndim - 2, rules.model_axis)
        put(ndim - 1, rules.fsdp_axis)
    elif in_moe and name in EXPERT and ndim >= 3:
        put(ndim - 3, rules.model_axis)
        put(ndim - 2 if name in ("w_gate", "w_up") else ndim - 1,
            rules.fsdp_axis)
    elif name in COLUMN and ndim >= 2:
        put(ndim - 1, rules.model_axis)
        put(ndim - 2, rules.fsdp_axis)
    elif name in ROW and ndim >= 2:
        put(ndim - 2, rules.model_axis)
        put(ndim - 1, rules.fsdp_axis)
    elif name in COLUMN_BIAS:
        put(ndim - 1, rules.model_axis)
    return tuple(spec)


def build_param_specs(params: Any, rules: ShardingRules, _path: tuple = ()
                      ) -> Any:
    """The tree of specs (a tuple of axis names or None per dim, JAX's
    ``PartitionSpec`` entries) of ``params``: nested dicts of anything
    with a ``shape``."""
    if isinstance(params, dict):
        return {k: build_param_specs(v, rules, _path + (k,))
                for k, v in params.items()}
    return _leaf_spec(rules, _path, tuple(params.shape))


def batch_spec(batch_size: int, mesh, data_axes: tuple = ("pod", "data")
               ) -> tuple:
    """Largest prefix of data axes that divides the batch."""
    axes, prod = [], 1
    for a in data_axes:
        if a not in mesh.shape:
            continue
        if batch_size % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    return tuple(axes)


def tree_specs_map(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: tree_specs_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _blocks(spec: tuple, shape: tuple, mesh, rank: int | None = None):
    """(dim, start, size) of every split dim of a leaf on ``rank``."""
    from repro_torch.launch.mesh import Mesh

    coords = Mesh(mesh.shape, mesh.rank if rank is None else rank).coords
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        size = shape[dim] // n
        out.append((dim, idx * size, size))
    return out


def shard(x, spec: tuple, mesh, rank: int | None = None):
    """The block of leaf ``x`` that ``rank`` (default the mesh's) holds
    under ``spec``: a view."""
    for dim, start, size in _blocks(spec, tuple(x.shape), mesh, rank):
        x = x.narrow(dim, start, size)
    return x


def local_shard(tree: Any, specs: Any, mesh) -> Any:
    """This rank's blocks of every leaf of ``tree``, as contiguous copies
    (the whole leaves can then be freed)."""
    return tree_specs_map(lambda x, sp: shard(x, sp, mesh).contiguous()
                          .clone(), tree, specs)


def unshard(x, spec: tuple, dist) -> Any:
    """The whole leaf from every rank's block ``x`` under ``spec`` (an
    all-gather over each split dim's axis, concatenated in rank order:
    pure movement)."""
    import torch

    from repro_torch.dist import all_gather

    for dim, axis in enumerate(spec):
        if axis is None or dist.mesh.axis_size(axis) == 1:
            continue
        x = torch.cat(all_gather(x, dist, axis), dim=dim)
    return x

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
