"""The port's one tree walker: tensor leaves of nested dicts (sorted
keys), lists and tuples, in JAX's flatten order.  Parameter, optimizer
and gradient trees, the bucket plan of ``dist.compression`` and its
residual layout all walk in this order."""

from __future__ import annotations

from typing import Any, List, Sequence

import torch


def leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of nested dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like: Any, flat: Sequence[torch.Tensor]) -> Any:
    """``flat`` (in ``leaves`` order) rebuilt into the structure of
    ``like``."""
    it = iter(flat)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)
