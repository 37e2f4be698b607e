"""Decoder blocks (port of ``repro/models/blocks.py``).

The port has the reference's three kinds, all pre-norm residual: the
``"attn"`` kind (GQA or MLA attention, then a dense MLP or the MoE), the
``"rec"`` kind (the RG-LRU, then a dense MLP) and the ``"ssm"`` kind
(Mamba2 SSD): ``block_train`` for the full-sequence forward and
``block_serve`` for the chunked serve step.  Cache protocol per kind:

  attn  (pool_k, pool_v)   paged pools, [P, T, KV, D] per layer
        (pool_ckv,)        MLA: one latent pool, [P, T, 1, R + dr]
  rec   {"conv", "h"}      RG-LRU state, [B, ...] per layer
  ssm   {"conv", "ssd"}    Mamba2 state, [B, ...] per layer

MLA training raises ``NotImplementedError`` until its slice lands
(ROADMAP queue 1, item 3.2).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .attention import (gqa_init, gqa_serve, gqa_train, mla_init,
                        mla_serve)
from .config import ModelConfig
from .layers import (mlp_apply, mlp_init, moe_apply, moe_init, norm_apply,
                     norm_init)
from .ssm import (mamba2_init, mamba2_init_state, mamba2_serve, mamba2_train,
                  rglru_init, rglru_init_state, rglru_serve, rglru_train)


def _check_kind(kind: str) -> None:
    if kind not in ("attn", "rec", "ssm"):
        raise ValueError(f"unknown block kind {kind!r}")


def _channel_mix(p: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return moe_apply(p["moe"], cfg, h) if cfg.n_experts \
        else mlp_apply(p["mlp"], cfg, h)


def block_init(cfg: ModelConfig, kind: str) -> Dict:
    _check_kind(kind)
    if kind == "ssm":
        return {"norm1": norm_init(cfg), "ssm": mamba2_init(cfg)}
    if kind == "rec":
        return {"norm1": norm_init(cfg), "rec": rglru_init(cfg),
                "norm2": norm_init(cfg), "mlp": mlp_init(cfg)}
    p = {"norm1": norm_init(cfg), "norm2": norm_init(cfg),
         "attn": mla_init(cfg) if cfg.mla else gqa_init(cfg)}
    if cfg.n_experts:
        p["moe"] = moe_init(cfg)
    else:
        p["mlp"] = mlp_init(cfg)
    return p


def block_train(p: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    _check_kind(kind)
    h = norm_apply(p["norm1"], cfg, x)
    if kind == "ssm":
        return x + mamba2_train(p["ssm"], cfg, h, impl=impl)
    if kind == "rec":
        x = x + rglru_train(p["rec"], cfg, h)
        return x + mlp_apply(p["mlp"], cfg, norm_apply(p["norm2"], cfg, x))
    h = gqa_train(p["attn"], cfg, h, positions, window=cfg.attn_window,
                  use_rope=cfg.rope_theta is not None, impl=impl)
    x = x + h
    h = norm_apply(p["norm2"], cfg, x)
    return x + _channel_mix(p, cfg, h)


def block_serve(p: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                cache, page_table: torch.Tensor, lengths: torch.Tensor,
                n_new: torch.Tensor, *, impl: Optional[str] = None):
    """Chunked serve step.  x: [B, C, D]; ``lengths`` is the pre-chunk
    sequence length and ``n_new`` the per-sequence valid-token count.
    Returns (x, cache): attention pools are updated in place and returned;
    the recurrent (RG-LRU) and SSM state comes back as new tensors,
    advanced only through the first n_new tokens.  Attention pools need
    no validity mask: pad tokens' K/V land in unpublished staging slots or
    the null page, which nothing reads.  (The MoE routes pad rows too, as
    the reference does: they take expert capacity as real tokens do.)"""
    _check_kind(kind)
    h = norm_apply(p["norm1"], cfg, x)
    if kind == "ssm":
        h, state = mamba2_serve(p["ssm"], cfg, h, cache, n_new)
        return x + h, state
    if kind == "rec":
        h, state = rglru_serve(p["rec"], cfg, h, cache, n_new)
        x = x + h
        return x + mlp_apply(p["mlp"], cfg, norm_apply(p["norm2"], cfg, x)), \
            state
    if cfg.mla:
        (pool_ckv,) = cache
        h, pool_ckv = mla_serve(p["attn"], cfg, h, pool_ckv, page_table,
                                lengths, impl=impl)
        cache = (pool_ckv,)
    else:
        pool_k, pool_v = cache
        h, pool_k, pool_v = gqa_serve(p["attn"], cfg, h, pool_k, pool_v,
                                      page_table, lengths,
                                      window=cfg.attn_window,
                                      use_rope=cfg.rope_theta is not None,
                                      impl=impl)
        cache = (pool_k, pool_v)
    x = x + h
    h = norm_apply(p["norm2"], cfg, x)
    return x + _channel_mix(p, cfg, h), cache


def block_cache_init(cfg: ModelConfig, kind: str, batch: int,
                     num_pages: int, page_tokens: int, *,
                     device: torch.device, layers: Optional[int]):
    """Zeroed decode cache for ``layers`` stacked blocks (None: one block,
    no layer dim, as the non-periodic tail's): paged pools
    ([L, P, T, KV, D] each; MLA's one latent pool [L, P, T, 1, R + dr])
    for attention, state for the RG-LRU and SSM."""
    _check_kind(kind)
    if kind == "ssm":
        return mamba2_init_state(cfg, batch, device=device, layers=layers)
    if kind == "rec":
        return rglru_init_state(cfg, batch, device=device, layers=layers)
    lead = () if layers is None else (layers,)
    if cfg.mla:
        lat = cfg.kv_lora_rank + cfg.qk_rope_dim
        return (torch.zeros(lead + (num_pages, page_tokens, 1, lat),
                            dtype=cfg.dtype, device=device),)
    shape = lead + (num_pages, page_tokens, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
