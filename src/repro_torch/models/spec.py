"""Parameter specifications and their materialization on a device.

Models declare parameters as ``ParamSpec`` leaves (shape + logical axes +
init) in the same nested dicts as ``repro.models.spec``, so a tree of the
reference's parameters converts key for key (``repro_torch.convert``).
``init_params`` follows the reference's init rules
(``repro/models/spec.py:59-74``): zeros, ones, normal * fan_in^-1/2, and
the embedding's own scale — drawn from an explicit ``torch.Generator`` on
the target device.  The numbers differ from JAX's; tests that need the
same weights carry the reference's across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

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
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        if s.init == "embed":
            std = s.scale if s.scale is not None else 1.0
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(std).to(s.dtype).to(out)

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if is_spec(node):
            return one(node, path)
        if isinstance(node, dict):
            return {k: walk(node[k], path + (k,)) for k in sorted(node)}
        raise TypeError(f"unexpected node in a ParamSpec tree: {type(node)}")

    return walk(tree, ())
