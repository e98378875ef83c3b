"""Meshes of ranks: named axes over the processes of a training or serving
group.

Counterpart of ``repro.launch.mesh``.  A JAX mesh lays devices out on
named axes inside one program; here each device is a process (a rank of
a ``torch.distributed`` group), and a ``Mesh`` says where rank r sits:
its coordinates on the axes (row-major, the order ``jax.make_mesh`` lays
devices out) and, once ``init_groups`` has run, one process subgroup per
line of every axis set a collective reduces over (``"data"``, ``("pod",
"data")``, ...).  Builders mirror JAX's: ``make_smoke_mesh``,
``make_serve_mesh`` and ``make_production_mesh``; the last is a
description (its dry run is ROADMAP [dry-runs]).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any

__all__ = ["AXES", "Mesh", "make_production_mesh", "make_serve_mesh",
           "make_smoke_mesh"]

AXES = ("pod", "data", "model")


@dataclass
class Mesh:
    """Named axes over ``size`` ranks.  ``shape`` maps axis name to size in
    mesh order (what the sharding rules read, as JAX's ``mesh.shape``);
    ``rank`` is this process's rank; ``groups`` maps an axis tuple to this
    rank's subgroup over it (filled by ``init_groups``)."""

    shape: dict[str, int]
    rank: int = 0
    groups: dict[tuple, Any] = field(default_factory=dict, repr=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index on every axis (row-major)."""
        out, r = {}, self.rank
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (an axis name or a tuple of them; axes the
        mesh lacks count 1)."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, the first axis slowest (JAX's
        ``axis_index`` of a tuple of axes)."""
        idx, c = 0, self.coords
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def line(self, axes, rank: int | None = None) -> list[int]:
        """The ranks sharing every coordinate of ``rank`` (default this
        one) off ``axes``, in ``axis_index`` order."""
        axes = self._axes(axes)
        r = self.rank if rank is None else rank
        base = Mesh(self.shape, r).coords
        out = []
        for pos in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base, **dict(zip(axes, pos)))
            flat = 0
            for name in self.axis_names:
                flat = flat * self.shape[name] + c[name]
            out.append(flat)
        return out

    def init_groups(self, axis_sets) -> None:
        """Make one subgroup per line of every axis set of more than one
        rank (every rank calls this with the same sets, in the same order:
        ``new_group`` is collective over the world) and keep this rank's."""
        import torch.distributed as tdist

        for axes in axis_sets:
            axes = self._axes(axes)
            if self.axis_size(axes) <= 1 or axes in self.groups:
                continue
            seen = set()
            for r in range(self.size):
                ranks = tuple(self.line(axes, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = tdist.new_group(list(ranks))
                if self.rank in ranks:
                    self.groups[axes] = g

    def group(self, axes):
        """This rank's subgroup over ``axes`` (None when they hold one
        rank)."""
        axes = self._axes(axes)
        if self.axis_size(axes) <= 1:
            return None
        if axes not in self.groups:
            raise RuntimeError(f"no subgroup over {axes}: init_groups was "
                               "not given it")
        return self.groups[axes]

    def describe(self) -> str:
        """``2x1 (data, model)``."""
        return (f"{'x'.join(map(str, self.shape.values()))} "
                f"({', '.join(self.shape)})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production topology as JAX's: 16 x 16 (data, model), or 2 x 16
    x 16 (pod, data, model) across two pods.  A description: no group is
    made."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_smoke_mesh(n_data: int = 2, n_model: int = 2, rank: int = 0
                    ) -> Mesh:
    return Mesh({"data": n_data, "model": n_model}, rank)


def make_serve_mesh(n_shards: int, rank: int = 0) -> Mesh:
    """The 1-D tensor-parallel serving mesh over ``model``."""
    return Mesh({"model": n_shards}, rank)
