"""GQA and MLA attention (port of ``repro/models/attention.py``).

``gqa_train`` is the full-sequence forward of training and bulk logits,
through ``kernels.attention`` (the flash kernel).  ``gqa_serve`` is the
chunked serve step over the paged KV pool: up to C tokens per sequence
appended and attended (``kernels.paged_attention_append_chunk``: the
append and the attention in one launch) in one fixed-shape call; decode is
the C=1 slice.  ``mla_serve`` is deepseek-v2's serve step over ONE latent
pool ``[P, T, 1, R + dr]`` that is both K and V: ``kernels.kv_append_chunk``
and then ``kernels.paged_attention_chunk`` at head dim R + dr (576 at full
width), unfused as in the reference.  Pools are updated IN PLACE (the JAX
version returns new pools).  ``mla_train`` and ``gqa_cross`` wait for
their slices (ROADMAP queue 1, items 3.2 and 2.6).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import attention as attention_op
from ..kernels import (kv_append_chunk, paged_attention_append_chunk,
                       paged_attention_chunk)
from .config import ModelConfig
from .spec import ParamSpec


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rot_dims: Optional[int] = None) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S].  Rotates the first rot_dims dims
    (default all) pairwise, half-split (GPT-NeoX / llama convention), in
    float32."""
    B, S, H, D = x.shape
    d = rot_dims or D
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:d].float()
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    out = torch.cat([rx1, rx2], dim=-1).to(x.dtype)
    if d < D:
        out = torch.cat([out, x[..., d:]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def _no_mla(cfg: ModelConfig) -> None:
    if cfg.mla:
        raise NotImplementedError(
            "MLA training (mla_train) is not ported yet (ROADMAP queue 1, "
            "item 3.2); MLA serves through mla_serve")


def gqa_init(cfg: ModelConfig) -> Dict:
    D, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": ParamSpec((D, H * hd), ("embed", "heads"), cfg.param_dtype),
        "wk": ParamSpec((D, KV * hd), ("embed", "kv"), cfg.param_dtype),
        "wv": ParamSpec((D, KV * hd), ("embed", "kv"), cfg.param_dtype),
        "wo": ParamSpec((H * hd, D), ("heads", "embed"), cfg.param_dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((H * hd,), ("heads",), cfg.param_dtype, init="zeros")
        p["bk"] = ParamSpec((KV * hd,), ("kv",), cfg.param_dtype, init="zeros")
        p["bv"] = ParamSpec((KV * hd,), ("kv",), cfg.param_dtype, init="zeros")
    return p


def _qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
         positions: Optional[torch.Tensor], use_rope: bool = True):
    B, S, D = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, KV, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt).reshape(H, hd)
        k = k + p["bk"].to(dt).reshape(KV, hd)
        v = v + p["bv"].to(dt).reshape(KV, hd)
    if use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_train(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, window: Optional[int] = None,
              causal: bool = True, use_rope: bool = True,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              return_kv: bool = False, impl: Optional[str] = None):
    """Full-sequence attention.  ``kv_override`` supplies external K/V
    (cross-attention).  Returns (out, (k, v) if return_kv)."""
    _no_mla(cfg)
    q, k, v = _qkv(p, cfg, x, positions if use_rope else None, use_rope)
    if kv_override is not None:
        k, v = kv_override
        causal = False
    out = attention_op(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=causal, window=window,
                       softcap=cfg.attn_logit_softcap, impl=impl)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    out = out @ p["wo"].to(cfg.dtype)
    if return_kv:
        return out, (k, v)
    return out


def paged_chunk_ids(page_table: torch.Tensor, lengths: torch.Tensor,
                    chunk: int, page_tokens: int):
    """Per-token staging addresses for a chunk starting at ``lengths``.

    Returns (positions [B, C], page_ids [B, C], slot_ids [B, C]), int32.
    Page indices are clamped to the table row (safe because the engine's
    ``_cap`` keeps every valid position inside the row); unallocated
    entries are 0 — the controller's reserved null page — so fixed-shape
    pad tokens land in unpublished staging slots or the null page, never
    in published data."""
    pos = lengths[:, None] + torch.arange(chunk, dtype=torch.int32,
                                          device=lengths.device)[None, :]
    pp = torch.clamp(pos // page_tokens, max=page_table.shape[1] - 1)
    page_ids = torch.gather(page_table, 1, pp.long())
    slot_ids = pos % page_tokens
    return pos, page_ids, slot_ids


def gqa_serve(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              pool_k: torch.Tensor, pool_v: torch.Tensor,
              page_table: torch.Tensor, lengths: torch.Tensor,
              *, window: Optional[int] = None, use_rope: bool = True,
              impl: Optional[str] = None):
    """Chunked serve step: append this chunk's K/V into the staging
    page(s) in place, then attend through the page table with
    chunk-causal masking.  x: [B, C, D] (C=1 for decode).  Returns
    (out [B, C, D], pool_k, pool_v) — the same pool tensors, updated."""
    B, C = x.shape[:2]
    T = pool_k.shape[1]
    positions, page_ids, slot_ids = paged_chunk_ids(page_table, lengths, C, T)
    q, k, v = _qkv(p, cfg, x, positions if use_rope else None, use_rope)
    out = paged_attention_append_chunk(
        q.contiguous(), k.contiguous(), v.contiguous(), pool_k, pool_v,
        page_table, lengths, page_ids, slot_ids, window=window,
        softcap=cfg.attn_logit_softcap, impl=impl)
    out = out.reshape(B, C, cfg.n_heads * cfg.head_dim) @ p["wo"].to(cfg.dtype)
    return out, pool_k, pool_v


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): latent-compressed KV cache
# ---------------------------------------------------------------------------


def mla_init(cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    H = cfg.n_heads
    R = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pd = cfg.param_dtype
    return {
        "wq": ParamSpec((D, H * (dn + dr)), ("embed", "heads"), pd),
        "w_dkv": ParamSpec((D, R + dr), ("embed", "mla_rank"), pd),
        "w_uk": ParamSpec((R, H * dn), ("mla_rank", "heads"), pd),
        "w_uv": ParamSpec((R, H * dv), ("mla_rank", "heads"), pd),
        "wo": ParamSpec((H * dv, D), ("heads", "embed"), pd),
    }


def _mla_qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """Returns q_nope, q_rope, c_kv (latent), k_rope (shared across
    heads)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    R = cfg.kv_lora_rank
    dt = cfg.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ p["w_dkv"].to(dt)                     # [B, S, R + dr]
    c_kv, k_rope = ckv_full[..., :R], ckv_full[..., R:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_serve(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              pool_ckv: torch.Tensor, page_table: torch.Tensor,
              lengths: torch.Tensor, *, impl: Optional[str] = None):
    """Latent-space chunked paged serve: the pool stores c_kv ++ k_rope
    ([P, T, 1, R + dr]), appended IN PLACE, and serves as both K and V of
    ``paged_attention_chunk`` (the same tensor passed twice).  Attention
    runs in latent space with w_uk absorbed into q: score = <q_nope
    W_uk^T, c_kv> + <q_rope, k_rope>.  x: [B, C, D] (C=1 decode).  Returns
    (out [B, C, D], pool_ckv)."""
    B, C = x.shape[:2]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    R = cfg.kv_lora_rank
    dt = cfg.dtype
    T = pool_ckv.shape[1]
    positions, page_ids, slot_ids = paged_chunk_ids(page_table, lengths, C, T)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    new_lat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]  # [B,C,1,R+dr]
    kv_append_chunk(pool_ckv, new_lat.contiguous(), page_ids, slot_ids,
                    impl=impl)

    # absorb: q_lat[h] = q_nope[h] @ w_uk[:, h]^T  -> [B, C, H, R]
    w_uk = p["w_uk"].to(dt).reshape(R, H, dn)
    q_lat = torch.einsum("bchd,rhd->bchr", q_nope, w_uk)
    q_full = torch.cat([q_lat, q_rope], dim=-1)          # [B, C, H, R+dr]
    # the kernel scales by (R+dr)^-0.5; MLA's scale is (dn+dr)^-0.5
    q_full = q_full * ((R + dr) ** 0.5 / (dn + dr) ** 0.5)
    # keys are the latents themselves (+ the shared rope part); values are
    # the latents
    lat = paged_attention_chunk(q_full.contiguous(), pool_ckv, pool_ckv,
                                page_table, lengths, impl=impl)
    lat = lat[..., :R]                                   # [B, C, H, R]
    w_uv = p["w_uv"].to(dt).reshape(R, H, dv)
    out = torch.einsum("bchr,rhd->bchd", lat, w_uv)
    out = out.reshape(B, C, H * dv) @ p["wo"].to(dt)
    return out, pool_ckv
