"""Decoder blocks (port of ``repro/models/blocks.py``).

The port has the ``"attn"`` kind with GQA and a dense MLP, and the
``"ssm"`` kind (Mamba2 SSD), both pre-norm residual: ``block_train`` for
the full-sequence forward and ``block_serve`` for the chunked serve step.
Cache protocol per kind:

  attn  (pool_k, pool_v)   paged pools, [P, T, KV, D] per layer
  ssm   {"conv", "ssd"}    Mamba2 state, [B, ...] per layer

MLA, MoE and the RG-LRU (``"rec"``) raise ``NotImplementedError`` until
their slices land (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .attention import gqa_init, gqa_serve, gqa_train
from .config import ModelConfig
from .layers import mlp_apply, mlp_init, norm_apply, norm_init
from .ssm import mamba2_init, mamba2_init_state, mamba2_serve, mamba2_train


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind == "ssm":
        return
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1, item 2.5)")
    if cfg.mla:
        raise NotImplementedError("MLA is not ported yet (ROADMAP queue 1, "
                                  "item 2.4)")
    if cfg.n_experts:
        raise NotImplementedError("MoE is not ported yet (ROADMAP queue 1, "
                                  "item 2.3)")


def block_init(cfg: ModelConfig, kind: str) -> Dict:
    _check_kind(cfg, kind)
    if kind == "ssm":
        return {"norm1": norm_init(cfg), "ssm": mamba2_init(cfg)}
    return {"norm1": norm_init(cfg), "norm2": norm_init(cfg),
            "attn": gqa_init(cfg), "mlp": mlp_init(cfg)}


def block_train(p: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    _check_kind(cfg, kind)
    h = norm_apply(p["norm1"], cfg, x)
    if kind == "ssm":
        return x + mamba2_train(p["ssm"], cfg, h, impl=impl)
    h = gqa_train(p["attn"], cfg, h, positions, window=cfg.attn_window,
                  use_rope=cfg.rope_theta is not None, impl=impl)
    x = x + h
    h = norm_apply(p["norm2"], cfg, x)
    return x + mlp_apply(p["mlp"], cfg, h)


def block_serve(p: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                cache, page_table: torch.Tensor, lengths: torch.Tensor,
                n_new: torch.Tensor, *, impl: Optional[str] = None):
    """Chunked serve step.  x: [B, C, D]; ``lengths`` is the pre-chunk
    sequence length and ``n_new`` the per-sequence valid-token count.
    Returns (x, cache): attention pools are updated in place and returned;
    the SSM state comes back as new tensors, advanced only through the
    first n_new tokens.  Attention pools need no validity mask: pad
    tokens' K/V land in unpublished staging slots or the null page, which
    nothing reads."""
    _check_kind(cfg, kind)
    h = norm_apply(p["norm1"], cfg, x)
    if kind == "ssm":
        h, state = mamba2_serve(p["ssm"], cfg, h, cache, n_new)
        return x + h, state
    pool_k, pool_v = cache
    h, pool_k, pool_v = gqa_serve(p["attn"], cfg, h, pool_k, pool_v,
                                  page_table, lengths,
                                  window=cfg.attn_window,
                                  use_rope=cfg.rope_theta is not None,
                                  impl=impl)
    x = x + h
    h = norm_apply(p["norm2"], cfg, x)
    return x + mlp_apply(p["mlp"], cfg, h), (pool_k, pool_v)


def block_cache_init(cfg: ModelConfig, kind: str, batch: int,
                     num_pages: int, page_tokens: int, *,
                     device: torch.device, layers: int):
    """Zeroed decode cache for ``layers`` stacked blocks: paged pools
    ([L, P, T, KV, D] each) for attention, state for SSM."""
    _check_kind(cfg, kind)
    if kind == "ssm":
        return mamba2_init_state(cfg, batch, device=device, layers=layers)
    shape = (layers, num_pages, page_tokens, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
