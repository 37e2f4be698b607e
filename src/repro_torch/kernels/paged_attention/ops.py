"""Public paged-attention ops: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors (``kernels/common.py`` holds the policy).

``paged_attention_chunk`` serves a chunk of C queries at positions
``lengths[b] .. lengths[b]+C-1`` with causality inside the chunk
(``lengths`` = PRE-chunk length); ``paged_attention`` is its C=1 decode
form (``lengths`` = total valid keys, so the chunk sees ``lengths - 1``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import common
from .ref import paged_attention_chunk_ref

MAX_HEAD_DIM = 256
# keys per context split: the kernel cuts each sequence's page walk into
# splits of this many keys (one block each) and merges them in a second
# pass, so short-batch decode still fills the card
SPLIT_KEYS = 64


def _launch(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
            page_table: torch.Tensor, lengths: torch.Tensor,
            window: Optional[int], softcap: Optional[float]) -> torch.Tensor:
    name = "paged_attention_chunk"
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(f"{name}: q [B,C,H,D] and pools [P,T,KV,D] expected")
    B, C, H, D = q.shape
    P, T, KV, Dp = pool_k.shape
    if Dp != D or tuple(pool_v.shape) != tuple(pool_k.shape) \
            or page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,) or H % KV:
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)}, pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}, "
                         f"page_table {tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} > {MAX_HEAD_DIM} is not "
                         "supported by the CUDA kernel")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap must be positive, got {softcap}")
    if window is not None and window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    common.check_kernel_args(
        name, {"q": q, "pool_k": pool_k, "pool_v": pool_v,
               "page_table": page_table, "lengths": lengths},
        ("q", "pool_k", "pool_v"), q.device)
    N = page_table.shape[1]
    splits = max(1, -(-N * T // SPLIT_KEYS))
    out = torch.empty_like(q)
    ws_acc = ws_ml = None                    # per-split softmax state
    if splits > 1:
        ws_acc = torch.empty(B * C * H * splits * D, dtype=torch.float32,
                             device=q.device)
        ws_ml = torch.empty(B * C * H * splits * 2, dtype=torch.float32,
                            device=q.device)
    lib = common.library()
    with common.on_device(q):
        status = lib.repro_paged_attention_chunk(
            common.ptr(q), common.ptr(pool_k), common.ptr(pool_v),
            common.ptr(page_table), common.ptr(lengths), common.ptr(out),
            None if ws_acc is None else common.ptr(ws_acc),
            None if ws_ml is None else common.ptr(ws_ml),
            B, C, H, KV, D, P, T, N, splits,
            -1 if window is None else int(window), float(D ** -0.5),
            0.0 if softcap is None else float(softcap),
            int(q.dtype == torch.bfloat16), common.stream_of(q))
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    return out


def paged_attention_chunk(q: torch.Tensor,            # [B, C, H, D]
                          pool_k: torch.Tensor,       # [P, T, KV, D]
                          pool_v: torch.Tensor,       # [P, T, KV, D]
                          page_table: torch.Tensor,   # [B, N] int32
                          lengths: torch.Tensor,      # [B] int32 (PRE-chunk)
                          *, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          impl: Optional[str] = None) -> torch.Tensor:
    if common.resolve_impl(q, impl) == "ref":
        return paged_attention_chunk_ref(q, pool_k, pool_v, page_table,
                                         lengths, window=window,
                                         softcap=softcap)
    return _launch(q, pool_k, pool_v, page_table, lengths, window, softcap)


def paged_attention(q: torch.Tensor,            # [B, H, D]
                    pool_k: torch.Tensor,       # [P, T, KV, D]
                    pool_v: torch.Tensor,       # [P, T, KV, D]
                    page_table: torch.Tensor,   # [B, N] int32
                    lengths: torch.Tensor,      # [B] int32 (TOTAL valid keys)
                    *, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Single-query decode: the C=1 slice of the chunk op (the last valid
    key IS the query position, so pre-length = lengths - 1)."""
    out = paged_attention_chunk(q[:, None], pool_k, pool_v, page_table,
                                lengths - 1, window=window, softcap=softcap,
                                impl=impl)
    return out[:, 0]
