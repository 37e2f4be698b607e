"""Public KV-append ops: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors (``kernels/common.py`` holds the policy).

``kv_append_chunk`` writes up to C tokens per sequence with per-token
(page, slot) addressing; ``kv_append`` is its C=1 slice.  Both update the
pool in place and return it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import common
from .ref import kv_append_chunk_ref


def _launch(pool: torch.Tensor, new: torch.Tensor, page_ids: torch.Tensor,
            slot_ids: torch.Tensor) -> torch.Tensor:
    name = "kv_append_chunk"
    if pool.dim() != 4 or new.dim() != 4:
        raise ValueError(f"{name}: pool [P,T,KV,D] and new [B,C,KV,D] expected"
                         f", got {tuple(pool.shape)} and {tuple(new.shape)}")
    B, C, KV, D = new.shape
    P, T, KVp, Dp = pool.shape
    if (KV, D) != (KVp, Dp) or tuple(page_ids.shape) != (B, C) \
            or tuple(slot_ids.shape) != (B, C):
        raise ValueError(f"{name}: shape mismatch pool {tuple(pool.shape)}, "
                         f"new {tuple(new.shape)}, page_ids "
                         f"{tuple(page_ids.shape)}, slot_ids "
                         f"{tuple(slot_ids.shape)}")
    common.check_kernel_args(
        name, {"pool": pool, "new": new, "page_ids": page_ids,
               "slot_ids": slot_ids}, ("pool", "new"), pool.device)
    lib = common.library()
    with common.on_device(pool):
        status = lib.repro_kv_append_chunk(
            common.ptr(pool), common.ptr(new), common.ptr(page_ids),
            common.ptr(slot_ids), B * C, P, T, KV * D * pool.element_size(),
            common.stream_of(pool))
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    return pool


def kv_append_chunk(pool: torch.Tensor,        # [P, T, KV, D]
                    new: torch.Tensor,         # [B, C, KV, D]
                    page_ids: torch.Tensor,    # [B, C] int32
                    slot_ids: torch.Tensor,    # [B, C] int32
                    *, impl: Optional[str] = None) -> torch.Tensor:
    if common.resolve_impl(pool, impl) == "ref":
        return kv_append_chunk_ref(pool, new, page_ids, slot_ids)
    return _launch(pool, new, page_ids, slot_ids)


def kv_append(pool: torch.Tensor,        # [P, T, KV, D]
              new: torch.Tensor,         # [B, KV, D]
              page_ids: torch.Tensor,    # [B] int32
              slot_ids: torch.Tensor,    # [B] int32
              *, impl: Optional[str] = None) -> torch.Tensor:
    """Single-token append: the C=1 slice of the chunk scatter."""
    return kv_append_chunk(pool, new[:, None], page_ids[:, None],
                           slot_ids[:, None], impl=impl)
