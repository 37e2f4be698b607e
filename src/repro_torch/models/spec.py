"""Parameter specifications and their materialization on a device.

Models declare parameters as ``ParamSpec`` leaves (shape + logical axes +
init) in the same nested dicts as ``repro.models.spec``, so a tree of the
reference's parameters converts key for key (``repro_torch.convert``).
``init_params`` follows the reference's init rules
(``repro/models/spec.py:59-74``): zeros, ones, normal * fan_in^-1/2, and
the embedding's own scale — drawn from an explicit ``torch.Generator`` on
the target device.  The numbers differ from JAX's; tests that need the
same weights carry the reference's across instead.

``spec_for`` / ``partition_specs`` resolve each leaf's logical axes to
mesh axes under a rule table (``dist.sharding``), with the reference's
divisibility fallback (``repro/models/spec.py:92-125``): a mesh axis is
used once per leaf and a dim that does not divide stays replicated.  A
spec is a tuple with one entry per dim (None, an axis name or a tuple of
names), trailing Nones dropped: the port's stand-in for a
``PartitionSpec``, equal to ``tuple(P(...))`` of the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]       # logical axis name per dim
    dtype: Any = torch.float32
    init: str = "normal"                      # normal | zeros | ones | embed
    scale: Optional[float] = None             # stddev override

    def __post_init__(self) -> None:
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(f: Callable[[ParamSpec], Any], tree: Any) -> Any:
    """Map ``f`` over the ParamSpec leaves of nested dicts (sorted-key walk,
    the order JAX flattens dicts in)."""
    if is_spec(tree):
        return f(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(f, tree[k]) for k in sorted(tree)}
    raise TypeError(f"unexpected node in a ParamSpec tree: {type(tree)}")


# leaves the model reads in float32 (``models/ssm.py``: Mamba2's and the
# RG-LRU's), besides norms
FLOAT32_KEYS = frozenset({"A_log", "D_skip", "dt_bias", "a_param"})


def stays_float32(path: Tuple[str, ...]) -> bool:
    """Whether the leaf at key ``path`` keeps its stored float32 when the
    serving weights are cast: a norm subtree's leaves and ``FLOAT32_KEYS``
    (the rule of ``convert.cast_params``)."""
    return any("norm" in k or k in FLOAT32_KEYS for k in path)


def init_std(s: ParamSpec) -> float:
    """The standard deviation ``init_params`` draws a random leaf at:
    ``s.scale`` when set, else 1 for an embedding and 1/sqrt(fan-in) (the
    second-to-last dim) for the rest.  A block of a leaf drawn on its own
    (a rank's shard) keeps the whole leaf's by carrying it as ``scale``."""
    if s.scale is not None:
        return s.scale
    if s.init == "embed":
        return 1.0
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_params(tree: Any, generator: torch.Generator, *,
                device="cuda", dtype=None) -> Any:
    """Concrete tensors for a ParamSpec tree, drawn in sorted-key order
    from ``generator`` (which must live on ``device``).

    ``dtype`` (e.g. ``cfg.dtype``) casts each leaf as it is born, but the
    leaves ``stays_float32`` keeps: bitwise ``cast_params(init_params(
    tree, generator), cfg)``, without the whole float32 tree (each draw is
    scaled in place, so the transient is one float32 leaf)."""
    dev = resolve_device(device)

    def one(s: ParamSpec, path: Tuple[str, ...]) -> torch.Tensor:
        out = s.dtype if dtype is None or stays_float32(path) else dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=out, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=out, device=dev)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(init_std(s)).to(s.dtype).to(out)

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if is_spec(node):
            return one(node, path)
        if isinstance(node, dict):
            return {k: walk(node[k], path + (k,)) for k in sorted(node)}
        raise TypeError(f"unexpected node in a ParamSpec tree: {type(node)}")

    return walk(tree, ())


# ---------------------------------------------------------------------------
# logical -> mesh rules
# ---------------------------------------------------------------------------

Rules = Dict[str, Any]  # logical axis name -> mesh axis | tuple | None
Spec = Tuple[Any, ...]  # per-dim mesh axis | tuple of axes | None


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             rules: Rules, mesh: Any) -> Spec:
    """One parameter's spec under ``rules`` on ``mesh`` (anything with a
    ``shape`` mapping of axis name to size).  A mesh axis is consumed at
    most once per parameter; a dim that does not divide its axes' product
    stays replicated."""
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name is not None else None
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        take = []
        span = 1
        for a in axes:
            if a in used:
                continue
            sz = mesh.shape[a]
            if dim % (span * sz) == 0:
                take.append(a)
                span *= sz
        if not take:
            out.append(None)
        else:
            used.update(take)
            out.append(tuple(take) if len(take) > 1 else take[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def partition_specs(tree: Any, rules: Rules, mesh: Any) -> Any:
    return tree_map_specs(
        lambda s: spec_for(s.shape, s.logical, rules, mesh), tree)
