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


def init_params(tree: Any, generator: torch.Generator, *,
                device="cuda") -> Any:
    """Concrete tensors for a ParamSpec tree, drawn in sorted-key order
    from ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        if s.init == "embed":
            std = s.scale if s.scale is not None else 1.0
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (x * std).to(s.dtype)

    return tree_map_specs(one, tree)
