"""The host mesh over an initialised ``torch.distributed`` process group:
the port's counterpart of ``repro/launch/mesh.py``.

A ``Mesh`` names its axes as the reference's does ("data" = request
parallelism, "model" = tensor parallelism, and outermost "pod", the
slow axis whose gradient reduction may be compressed), with ``shape``
the mapping of axis name to size (all that ``dist.sharding``'s rules
read), this rank's index on each axis, and the process group of the
ranks that differ only on that axis; besides, for each ``n`` that
divides the model axis (``1 < n < model``), the group of the ``n``
consecutive model ranks whose block this rank shares (``copy_groups``):
the ranks that hold one copied KV head (``dist.sharding.Copies``), whose
grads the train step sums.  Ranks lie row-major over the axes, as
``jax.make_mesh`` lays devices: rank ``(p * data + d) * model + m``
sits at ``(pod=p, data=d, model=m)``.

A mesh with a pod axis carries two views of the same ranks, each a
("data", "model") ``Mesh`` of its own: ``in_pod``, the rank's own pod
(its data and model groups, its copy groups, and ``group``, the pod's
ranks), which the compressed pod reduction trains on; and ``merged``,
``(pod * data, model)`` with data index ``p * data + d``, where "pod"
joins the batch and FSDP axes (the uncompressed train step, the serve
step).  ``group`` is the process group of every rank of a mesh (None:
the default group); every collective that spans a whole mesh runs over
it.

The reference's production meshes (16x16 = 256 chips, or 2x16x16 with a
"pod" axis, ``:12-22``) have no counterpart: they are TPU pod slices, and
the port runs on the cards of one host.  ``make_host_mesh`` is the
reference's ``:24-28``: every rank on the model axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod",) + AXES


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]          # axis name -> size, outermost first
    coords: Dict[str, int]         # this rank's index on each axis
    groups: Dict[str, Any]         # axis -> its process group (size > 1)
    # n -> the group of this rank's n consecutive model ranks (1 < n < model)
    copy_groups: Dict[int, Any] = dataclasses.field(default_factory=dict)
    group: Any = None              # every rank of the mesh (None: default)
    in_pod: Optional["Mesh"] = None    # with a pod axis: this rank's pod
    merged: Optional["Mesh"] = None    # with a pod axis: (pod*data, model)

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


def _line_groups(rank: int, lines: Dict[Any, List[int]]) -> Any:
    """One new group a line (in sorted order, on every rank: ``new_group``
    is collective); the one that holds ``rank``."""
    mine = None
    for key in sorted(lines):
        group = dist.new_group(lines[key])
        if rank in lines[key]:
            mine = group
    return mine


def _axes_of(shape: Sequence[int]) -> Dict[str, int]:
    """``shape``'s sizes by axis name; a shape that fits neither axis
    tuple, or a pod axis of 1, raises."""
    axes = {len(AXES): AXES, len(POD_AXES): POD_AXES}.get(len(shape))
    if axes is None:
        raise ValueError(f"mesh shape {tuple(shape)} matches neither the "
                         f"axes {AXES} nor {POD_AXES}")
    sizes = dict(zip(axes, (int(s) for s in shape)))
    if sizes.get("pod", 2) < 2:
        raise ValueError(f"a pod axis of {sizes['pod']}: that mesh is "
                         f"(data, model) = {tuple(shape)[1:]}")
    return sizes


def plain_mesh(shape: Sequence[int], rank: int) -> Mesh:
    """Rank ``rank``'s mesh of ``shape`` without process groups: its
    coords and, with a pod axis, its ``in_pod`` and ``merged`` views'
    shapes and coords.  ``make_mesh`` adds the groups; code that reads
    only shapes and coords (a shard's block) takes it as it is."""
    sizes = _axes_of(shape)
    coords = rank_coords(sizes, rank)
    mesh = Mesh(shape=sizes, coords=coords, groups={})
    if "pod" not in sizes:
        return mesh
    data, m = sizes["data"], sizes["model"]
    in_pod = Mesh(shape={"data": data, "model": m},
                  coords={"data": coords["data"], "model": coords["model"]},
                  groups={})
    merged = Mesh(shape={"data": sizes["pod"] * data, "model": m},
                  coords={"data": coords["pod"] * data + coords["data"],
                          "model": coords["model"]},
                  groups={})
    return dataclasses.replace(mesh, in_pod=in_pod, merged=merged)


def make_mesh(shape: Sequence[int]) -> Mesh:
    """A ("data", "model") mesh, or a ("pod", "data", "model") one, of
    ``shape`` over the default process group, whose size must be the
    mesh's product: ``plain_mesh`` with its groups.  Every rank calls it
    (it makes each axis's subgroups, the model axis's copy groups and,
    with a pod axis, each pod's group and the merged view's data groups,
    in one order on every rank: ``new_group`` is collective).  A pod
    axis of 1 raises: that mesh is ``(data, model)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    sizes = _axes_of(shape)
    world = dist.get_world_size()
    if math.prod(sizes.values()) != world:
        raise ValueError(f"a mesh of {dict(sizes)} needs "
                         f"{math.prod(sizes.values())} ranks; the process "
                         f"group has {world}")
    rank = dist.get_rank()
    plain = plain_mesh(shape, rank)
    every = [rank_coords(sizes, r) for r in range(world)]
    groups = {}
    for axis in sizes:
        if sizes[axis] == 1:
            continue
        lines: Dict[Any, List[int]] = {}
        for r, c in enumerate(every):
            lines.setdefault(tuple(c[a] for a in sizes if a != axis),
                             []).append(r)
        groups[axis] = _line_groups(rank, lines)
    copy_groups = {}
    m = sizes["model"]
    for n in range(2, m):
        if m % n == 0:       # each row of model ranks, in blocks of n
            copy_groups[n] = _line_groups(rank, {
                r: list(range(r, r + n)) for r in range(0, world, n)})
    mesh = dataclasses.replace(plain, groups=groups, copy_groups=copy_groups)
    if "pod" not in sizes:
        return mesh
    pod_group = _line_groups(rank, {
        p: [r for r, c in enumerate(every) if c["pod"] == p]
        for p in range(sizes["pod"])})
    merged_data = _line_groups(rank, {
        j: [r for r, c in enumerate(every) if c["model"] == j]
        for j in range(m)})
    local = {a: groups[a] for a in AXES if a in groups}
    return dataclasses.replace(
        mesh, in_pod=dataclasses.replace(
            plain.in_pod, groups=local, copy_groups=copy_groups,
            group=pod_group),
        merged=dataclasses.replace(
            plain.merged, groups={**local, "data": merged_data},
            copy_groups=copy_groups))


def make_host_mesh() -> Mesh:
    """Every rank of the process group on the model axis: (1, world)."""
    return make_mesh((1, dist.get_world_size()))

