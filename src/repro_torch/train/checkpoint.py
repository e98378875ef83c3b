"""Atomic checkpoints in the JAX package's layout.

Counterpart of ``repro.train.checkpoint``.  Layout: ``<dir>/step_<N:08d>/``
holding ``arrays.npz`` and ``meta.json``, written to ``step_<N>.tmp`` and
then ``os.rename``d into place (atomic on POSIX), so a crash during a
write never damages the latest checkpoint.  The arrays are keyed by the
JAX path strings of the same state (nested dict keys and list indices
joined by ``/``; a ``QTensor`` node adds ``payload`` and, in linear mode,
``scale``), so a checkpoint of the JAX package restores here and the other
way round.  bfloat16 leaves are stored as two-byte raw values, as numpy
stores JAX's bfloat16 arrays.

Packed tensors: a ``QTensor`` is stored as its int8 payload, and
``meta.json`` records each packed leaf's (1, e, m) format under
``"qtensors"``; a restore under another format is refused.  The
``precision_schedule`` (the telemetry controller's realized per-GEMM
m_acc, ``"<gemm>:<role>" -> m_acc``) goes into the meta, so a resumed run
or a server trains or serves under the widths the run reached.

Under a mesh the arrays are the whole ones, as JAX writes them: the ranks
gather their blocks and rank 0 writes (the launcher's ``_save``), and a
restore onto any mesh (``restore_checkpoint(shardings=)``, JAX's elastic
restore) reads each whole array and keeps the rank's block of it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.quant.qtensor import QTensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _items(tree: Any, prefix: str = ""):
    """(path, node) for every leaf of nested dicts, lists and tuples; a
    ``QTensor`` is a node of its own."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _leaves(tree: Any):
    """(JAX path string, tensor) for every array leaf."""
    for path, node in _items(tree):
        if isinstance(node, QTensor):
            yield f"{path}/payload", node.payload
            if node.scale is not None:
                yield f"{path}/scale", node.scale
        elif node is not None:
            yield path, node


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _qtensor_meta(tree: Any) -> dict[str, dict]:
    """{path: {"e", "m"} | {"linear": true}} for every QTensor node."""
    return {path: ({"e": node.fmt.e, "m": node.fmt.m}
                   if node.fmt is not None else {"linear": True})
            for path, node in _items(tree) if isinstance(node, QTensor)}


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    meta: dict | None = None, *,
                    precision_schedule: dict | None = None) -> str:
    """Write one atomic checkpoint of ``state`` (nested dicts and lists of
    tensors and ``QTensor``s); returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: _to_numpy(v) for k, v in _leaves(state)})
    payload = {"step": step, **(meta or {})}
    if precision_schedule:
        payload["precision_schedule"] = precision_schedule
    qt = _qtensor_meta(state)
    if qt:
        payload["qtensors"] = qt
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(payload, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint's step (``.tmp`` ones ignored)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, like: torch.Tensor, key: str, device):
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(like.shape)}")
    if like.dtype == torch.bfloat16 and arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device if device is None else device)


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       device=None, *, shardings=None) -> tuple[Any, dict]:
    """Restore into the structure, shapes and dtypes of ``like``, each
    tensor on its ``like`` leaf's device (or on ``device``); returns
    (state, meta).  ``shardings(path, tensor)``, when given, maps each
    whole restored tensor to the block this rank keeps (``like`` then
    holds the whole shapes, meta tensors will do)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(d, "arrays.npz"))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    # packed payloads are int8 codes whose meaning is the format they were
    # written under: refuse to read them under a drifted format
    saved = meta.get("qtensors", {})
    for key, fmt in _qtensor_meta(like).items():
        want = saved.get(key)
        if want is not None and want != fmt:
            raise ValueError(
                f"checkpoint {d}: packed leaf {key!r} was saved as {want} "
                f"but would be restored as {fmt}; int8 codes are not "
                "portable across formats")

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        path = prefix[:-1]
        if isinstance(tree, QTensor):
            scale = (None if tree.scale is None else
                     _tensor(data[f"{path}/scale"], tree.scale, path, device))
            return QTensor(payload=_tensor(data[f"{path}/payload"],
                                           tree.payload, path, device),
                           fmt=tree.fmt, scale=scale)
        if tree is None:
            return None
        t = _tensor(data[path], tree, path, device)
        return t if shardings is None else shardings(path, t)

    return rebuild(like, ""), meta
