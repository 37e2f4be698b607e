"""The port's one tree walker: tensor leaves of nested dicts (sorted
keys), lists and tuples, in JAX's flatten order.  Parameter, optimizer
and gradient trees, the bucket plan of ``dist.compression`` and its
residual layout, and the mesh step's shards and specs
(``dist.sharding``) all walk in this order."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

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


def map_with_path(f: Callable[..., Any], tree: Any, *others: Any,
                  path: Tuple = ()) -> Any:
    """``f(path, leaf, *other_leaves)`` over the leaves of ``tree``,
    rebuilt in its structure; ``path`` is the tuple of keys and indices
    from the root, and each tree of ``others`` is walked along ``tree``'s
    structure (its node at a leaf of ``tree`` is passed whole, so a tree
    of per-dim spec tuples zips with the tensors it describes)."""
    if isinstance(tree, dict):
        return {k: map_with_path(f, tree[k], *(o[k] for o in others),
                                 path=path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_path(f, v, *(o[i] for o in others), path=path + (i,))
            for i, v in enumerate(tree))
    return f(path, tree, *others)
