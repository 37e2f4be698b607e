"""Trees of numpy arrays <-> trees of torch tensors, and the serving cast.

``params_from_numpy`` takes the JAX package's parameters as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
tensors, key for key; ``caches_from_numpy`` does the same for cache trees
(dicts and tuples).  bfloat16 leaves (numpy arrays of the ml_dtypes
``bfloat16`` type) travel as a ``uint16`` view, because
``torch.from_numpy`` rejects that type; non-writable arrays are copied.
``to_numpy`` goes back, upcasting bfloat16 leaves to float32 (exact).

``cast_params`` casts every matrix, embedding and bias to ``cfg.dtype``
once, leaving in their stored float32 the leaves the model reads in
float32: the norm weights, Mamba2's ``A_log``, ``D_skip`` and
``dt_bias``, and the RG-LRU's ``a_param``.  The model casts every other
parameter to ``cfg.dtype`` at use (``x @ w.to(dt)``) exactly as the
reference does, so a pre-cast parameter gives the same bits and the
per-step cast becomes a no-op.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .kernels.common import resolve_device
from .models.config import ModelConfig
from .models.spec import stays_float32


def _leaf_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        if not a.flags.writeable or not a.flags.c_contiguous:
            a = np.array(a)
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    dev = resolve_device(device)
    return _map(tree, lambda a: _leaf_from_numpy(a, dev))


# caches are the same kind of tree (dicts and tuples of arrays)
caches_from_numpy = params_from_numpy


def to_numpy(tree: Any) -> Any:
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _map(tree, one)


def cast_params(params: Any, cfg: ModelConfig) -> Any:
    """Every leaf in ``cfg.dtype`` but those ``stays_float32`` keeps (the
    norm subtrees and ``models.spec.FLOAT32_KEYS``), which are left
    untouched.
    ``init_params(..., dtype=cfg.dtype)`` draws a tree already so cast."""
    def walk(node: Any, path) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node if stays_float32(path) else node.to(cfg.dtype)
    return walk(params, ())
