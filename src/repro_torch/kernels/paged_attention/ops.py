"""Public paged-attention ops: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors (``kernels/common.py`` holds the policy).

``paged_attention_chunk`` serves a chunk of C queries at positions
``lengths[b] .. lengths[b]+C-1`` with causality inside the chunk
(``lengths`` = PRE-chunk length); ``paged_attention`` is its C=1 decode
form (``lengths`` = total valid keys, so the chunk sees ``lengths - 1``).
``paged_attention_append_chunk`` is the serve step's call: the chunk's
K/V append (``kv_append_chunk`` on each pool) and ``paged_attention_chunk``
in one launch, counted under its own name.

Head dims: up to 256 for both; ``paged_attention_chunk`` also takes up to
576, MLA's latent (one KV head whose rows are both K and V: pass the same
pool twice and each latent tile is read once), on a kernel of its own in
bf16 (D % 8 == 0) and on the scalar path in float32.  Anything else
raises on a CUDA tensor; ``impl="ref"`` takes any D.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import common
from ..kv_append.ref import kv_append_chunk_ref
from .ref import paged_attention_chunk_ref

MAX_HEAD_DIM = 576   # the latent kernel's (MLA: kv_lora_rank + qk_rope_dim)
MAX_FUSED_HEAD_DIM = 256
TILE_KEYS = 64       # keys per tile, the unit a context split owns (kBK)
BLOCK_ROWS = 128     # query rows one bf16 block owns (kRows): 8 row tiles
                     # of 16 over 16 warps (8 at D = 256; PaWarps)
LATENT_ROWS = 64     # above D = 256 (bf16): query rows of a latent block
LATENT_SLICES = 3    # and the blocks of 192 output columns a row group
MAX_SPLITS = 16      # context splits the kernel takes (kMaxSplits)


def plan_splits(B: int, C: int, H: int, KV: int, N: int, T: int,
                sms: int, D: int = 128) -> int:
    """Context splits of one call.

    The kernel runs one block per (split, KV head, row group of up to 128
    query rows, sequence) — above D = 256, per (split, KV head, row group
    of up to 64 rows, column slice of 192, sequence); split s takes an
    equal share of its sequence's LIVE key tiles, and a second kernel
    merges the splits that held tiles (split 0 writes the rows of a
    sequence with at most one such split).  Splits fill the card's ``sms``
    SMs with one block each, so they fall as the blocks of one split grow;
    they never exceed the table's tiles or pages, nor ``MAX_SPLITS``.  (On
    the H100, 8 splits of the serving shape's 16 blocks beat 2-6 and tied
    12-16 at both C=16 and C=1 in a sweep of the split count.)"""
    if D > MAX_FUSED_HEAD_DIM:
        groups = -(-C * (H // KV) // LATENT_ROWS) * LATENT_SLICES
    else:
        groups = -(-C * (H // KV) // BLOCK_ROWS)
    tiles = -(-N * T // TILE_KEYS)
    fill = sms // (B * KV * groups)
    return max(1, min(fill, tiles, N, MAX_SPLITS))


def workspace_floats(B: int, C: int, H: int, D: int, splits: int) -> int:
    """Each split's (acc [D], m, l) for every output row; none for one
    split."""
    return B * C * H * splits * (D + 2) if splits > 1 else 0


def _launch(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
            page_table: torch.Tensor, lengths: torch.Tensor,
            window: Optional[int], softcap: Optional[float],
            append=None) -> torch.Tensor:
    """The kernel; ``append`` = (k_new, v_new, page_ids, slot_ids) fuses the
    chunk's append into the launch."""
    name = ("paged_attention_chunk" if append is None
            else "paged_attention_append_chunk")
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
    max_d = MAX_HEAD_DIM if append is None else MAX_FUSED_HEAD_DIM
    if D > max_d:
        raise ValueError(f"{name}: head dim {D} > {max_d} is not "
                         "supported by the CUDA kernel")
    if D > MAX_FUSED_HEAD_DIM and q.dtype == torch.bfloat16 and (
            D % 8 or any(t.data_ptr() % 16 for t in (q, pool_k, pool_v))):
        raise ValueError(f"{name}: bf16 head dim {D} > "
                         f"{MAX_FUSED_HEAD_DIM} needs D % 8 == 0 and "
                         "16-byte aligned q and pools (the latent kernel)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap must be positive, got {softcap}")
    if window is not None and window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    operands = {"q": q, "pool_k": pool_k, "pool_v": pool_v,
                "page_table": page_table, "lengths": lengths}
    if append is not None:
        k_new, v_new, page_ids, slot_ids = append
        if tuple(k_new.shape) != (B, C, KV, D) \
                or tuple(v_new.shape) != (B, C, KV, D) \
                or tuple(page_ids.shape) != (B, C) \
                or tuple(slot_ids.shape) != (B, C):
            raise ValueError(f"{name}: k_new/v_new [B,C,KV,D] = "
                             f"{(B, C, KV, D)} and page_ids/slot_ids [B,C] "
                             f"expected, got {tuple(k_new.shape)}, "
                             f"{tuple(v_new.shape)}, "
                             f"{tuple(page_ids.shape)}, "
                             f"{tuple(slot_ids.shape)}")
        operands.update(k_new=k_new, v_new=v_new, page_ids=page_ids,
                        slot_ids=slot_ids)
    common.check_kernel_args(name, operands,
                             ("q", "pool_k", "pool_v", "k_new", "v_new"),
                             q.device)
    N = page_table.shape[1]
    splits = plan_splits(B, C, H, KV, N, T, common.sm_count(q.device), D)
    out = torch.empty_like(q)
    ws_acc = ws_ml = None                    # per-split softmax state
    if splits > 1:
        ws = torch.empty(workspace_floats(B, C, H, D, splits),
                         dtype=torch.float32, device=q.device)
        n_acc = B * C * H * splits * D
        ws_acc, ws_ml = ws[:n_acc], ws[n_acc:]
    lib = common.library()
    tail = (common.ptr(out), None if ws_acc is None else common.ptr(ws_acc),
            None if ws_ml is None else common.ptr(ws_ml),
            B, C, H, KV, D, P, T, N, splits,
            -1 if window is None else int(window), float(D ** -0.5),
            0.0 if softcap is None else float(softcap),
            int(q.dtype == torch.bfloat16), common.stream_of(q))
    with common.on_device(q):
        if append is None:
            status = lib.repro_paged_attention_chunk(
                common.ptr(q), common.ptr(pool_k), common.ptr(pool_v),
                common.ptr(page_table), common.ptr(lengths), *tail)
        else:
            status = lib.repro_paged_attention_append_chunk(
                common.ptr(q), common.ptr(k_new), common.ptr(v_new),
                common.ptr(pool_k), common.ptr(pool_v),
                common.ptr(page_table), common.ptr(lengths),
                common.ptr(page_ids), common.ptr(slot_ids), *tail)
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    common.LAST_SPLITS[name] = splits
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


def paged_attention_append_chunk(q: torch.Tensor,            # [B, C, H, D]
                                 k_new: torch.Tensor,        # [B, C, KV, D]
                                 v_new: torch.Tensor,        # [B, C, KV, D]
                                 pool_k: torch.Tensor,       # [P, T, KV, D]
                                 pool_v: torch.Tensor,       # [P, T, KV, D]
                                 page_table: torch.Tensor,   # [B, N] int32
                                 lengths: torch.Tensor,      # [B] int32 (pre)
                                 page_ids: torch.Tensor,     # [B, C] int32
                                 slot_ids: torch.Tensor,     # [B, C] int32
                                 *, window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 impl: Optional[str] = None) -> torch.Tensor:
    """The serve step's append and attention: ``k_new`` and ``v_new`` land
    in the pools IN PLACE at (``page_ids``, ``slot_ids``), as
    ``kv_append_chunk`` puts them, and the chunk's queries attend as
    ``paged_attention_chunk`` does over the pools so updated.  Returns the
    attention output.  The kernel does both in one launch, reading the
    chunk's own keys from ``k_new``/``v_new``; its output and every pool
    byte off the null page 0 equal the two appends and the attention
    kernel's."""
    if common.resolve_impl(q, impl) == "ref":
        kv_append_chunk_ref(pool_k, k_new, page_ids, slot_ids)
        kv_append_chunk_ref(pool_v, v_new, page_ids, slot_ids)
        return paged_attention_chunk_ref(q, pool_k, pool_v, page_table,
                                         lengths, window=window,
                                         softcap=softcap)
    return _launch(q, pool_k, pool_v, page_table, lengths, window, softcap,
                   (k_new, v_new, page_ids, slot_ids))
