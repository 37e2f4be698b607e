"""The host mesh over an initialised ``torch.distributed`` process group:
the port's counterpart of ``repro/launch/mesh.py``.

A ``Mesh`` names its axes as the reference's does ("data" = request
parallelism, "model" = tensor parallelism), with ``shape`` the mapping of
axis name to size (all that ``dist.sharding``'s rules read), this rank's
index on each axis, and the process group of the ranks that differ only
on that axis; besides, for each ``n`` that divides the model axis (``1 <
n < model``), the group of the ``n`` consecutive model ranks whose block
this rank shares (``copy_groups``): the ranks that hold one copied KV
head (``dist.sharding.Copies``), whose grads the train step sums.  Ranks
lie row-major over the axes, as ``jax.make_mesh`` lays devices: rank
``d * model + m`` sits at ``(data=d, model=m)``.

The reference's production meshes (16x16 = 256 chips, or 2x16x16 with a
"pod" axis, ``:12-22``) have no counterpart: they are TPU pod slices, and
the port runs on the cards of one host.  ``make_host_mesh`` is the
reference's ``:24-28``: every rank on the model axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]          # axis name -> size, outermost first
    coords: Dict[str, int]         # this rank's index on each axis
    groups: Dict[str, Any]         # axis -> its process group (size > 1)
    # n -> the group of this rank's n consecutive model ranks (1 < n < model)
    copy_groups: Dict[int, Any] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def rank_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """The row-major coordinates of ``rank`` on a mesh of ``shape``."""
    coords = {}
    for axis in reversed(list(shape)):
        coords[axis] = rank % shape[axis]
        rank //= shape[axis]
    return {a: coords[a] for a in shape}


def make_mesh(shape: Sequence[int]) -> Mesh:
    """A ("data", "model") mesh of ``shape`` over the default process
    group, whose size must be the mesh's product.  Every rank calls it (it
    makes each axis's subgroups, then the model axis's copy groups, in
    one order on every rank: ``new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    if len(shape) != len(AXES):
        raise ValueError(f"mesh shape {tuple(shape)} does not match the "
                         f"axes {AXES}")
    sizes = dict(zip(AXES, (int(s) for s in shape)))
    world = dist.get_world_size()
    if math.prod(sizes.values()) != world:
        raise ValueError(f"a mesh of {dict(sizes)} needs "
                         f"{math.prod(sizes.values())} ranks; the process "
                         f"group has {world}")
    rank = dist.get_rank()
    coords = rank_coords(sizes, rank)
    groups = {}
    for axis in AXES:
        if sizes[axis] == 1:
            continue
        others = [a for a in AXES if a != axis]
        lines: Dict[Tuple[int, ...], list] = {}
        for r in range(world):
            c = rank_coords(sizes, r)
            lines.setdefault(tuple(c[a] for a in others), []).append(r)
        for key in sorted(lines):
            group = dist.new_group(lines[key])
            if rank in lines[key]:
                groups[axis] = group
    copy_groups = {}
    m = sizes["model"]
    for n in range(2, m):
        if m % n:
            continue
        for d in range(sizes["data"]):
            for first in range(0, m, n):
                ranks = [d * m + first + i for i in range(n)]
                group = dist.new_group(ranks)
                if rank in ranks:
                    copy_groups[n] = group
    return Mesh(shape=sizes, coords=coords, groups=groups,
                copy_groups=copy_groups)


def make_host_mesh() -> Mesh:
    """Every rank of the process group on the model axis: (1, world)."""
    return make_mesh((1, dist.get_world_size()))
