"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in the reference: callers give
precomputed frame embeddings [B, enc_frames, D].  Positions are the
parameter-free sinusoids, computed in float32 and cast to ``cfg.dtype``.

Decoder blocks: causal self attention (at serve time the fused paged op,
``attention.gqa_serve``), cross attention over the encoder output (its K/V
computed once per request by ``encdec_prefill_cross`` and cached
read-only as ``cross_k`` / ``cross_v`` [L, B, Senc, KV, hd]; the queries
go through the flash kernel non-causally, ``attention.gqa_cross``) and a
GELU MLP, with LayerNorm and biases.

Where JAX scans over the stacked layers, the port runs a Python loop, as
``lm.py`` does: the training forward takes every stacked leaf apart once
(``lm._unbind``) and checkpoints each layer by ``cfg.remat``
(``lm._remat``); the serve step hands each layer ``[l]`` views of the
pools (``lm._index``), which the fused op updates in place, and returns
the same cache tensors with a new ``lengths``.  On a rank of the mesh
serve step (``serve.step``) the decoder holds its block of whole heads,
of the FFN and of the vocabulary, its self-attention pools and its cross
K/V hold its KV heads (``encdec_prefill_cross`` computes a rank's own
from its ``wk`` / ``wv``), and the serve step looks its tokens up
vocab-parallel (``lm.embed_tokens``); the reference's ``constrain_batch``
is a sharding hint with no counterpart.  On a rank of the mesh train step
(``train.step``) the encoder and decoder gather each layer's FSDP shards
inside its remat'd layer, the decoder looks its tokens up vocab-parallel
(``lm.lookup_tokens``) and the encoder's output enters the decoder
through one column-parallel entry: each layer's cross K/V read only this
rank's KV heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.common import resolve_device
from . import lm
from .attention import cross_kv, gqa_cross, gqa_init, gqa_serve, gqa_train
from .blocks import block_cache_init
from .config import ModelConfig
from .layers import mlp_apply, mlp_init, norm_apply, norm_init
from .shardctx import bind, fsdp_params, model_entry, model_split
from .spec import ParamSpec


def _sinusoid(pos: torch.Tensor, D: int) -> torch.Tensor:
    """[..., D] sinusoids (sines, then cosines) of float32 positions
    ``pos`` [...]."""
    dim = torch.arange(D // 2, dtype=torch.float32, device=pos.device)
    ang = pos[..., None] / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_positions(S: int, D: int, offset=0, *,
                       device=None) -> torch.Tensor:
    """[S, D] float32 sinusoids of positions offset .. offset + S - 1."""
    return _sinusoid(torch.arange(S, dtype=torch.float32, device=device)
                     + offset, D)


# ---------------------------------------------------------------------------


def encdec_init(cfg: ModelConfig) -> Dict:
    enc_block = {"norm1": norm_init(cfg), "attn": gqa_init(cfg),
                 "norm2": norm_init(cfg), "mlp": mlp_init(cfg)}
    dec_block = {"norm1": norm_init(cfg), "self_attn": gqa_init(cfg),
                 "norm2": norm_init(cfg), "cross_attn": gqa_init(cfg),
                 "norm3": norm_init(cfg), "mlp": mlp_init(cfg)}
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_tbl"),
                           cfg.param_dtype, init="embed", scale=0.02),
        "encoder": lm._stack_specs(enc_block, cfg.n_enc_layers),
        "enc_norm": norm_init(cfg),
        "decoder": lm._stack_specs(dec_block, cfg.n_dec_layers),
        "final_norm": norm_init(cfg),
    }


def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor, *,
           impl: Optional[str] = None) -> torch.Tensor:
    """frames: [B, Senc, D] stub embeddings -> encoder hidden states.
    Under the mesh train step each layer's FSDP shards are gathered
    inside its remat'd layer, ``enc_norm``'s where it is used."""
    B, S, D = frames.shape
    x = frames.to(cfg.dtype) + sinusoid_positions(
        S, D, device=frames.device).to(cfg.dtype)

    def layer(h, p):
        p = fsdp_params(p, ("encoder",), stacked=True)
        a = norm_apply(p["norm1"], cfg, h)
        h = h + gqa_train(p["attn"], cfg, a, positions=None, causal=False,
                          use_rope=False, impl=impl)
        a = norm_apply(p["norm2"], cfg, h)
        return h + mlp_apply(p["mlp"], cfg, a)

    layer = lm._remat(bind(layer), cfg.remat)
    for p in lm._unbind(params["encoder"], cfg.n_enc_layers):
        x = layer(x, p)
    return norm_apply(fsdp_params(params["enc_norm"], ("enc_norm",)), cfg, x)


def _dec_embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
               offset) -> torch.Tensor:
    x = lm.lookup_tokens(params, cfg, tokens)
    return x + sinusoid_positions(tokens.shape[1], cfg.d_model, offset,
                                  device=x.device).to(cfg.dtype)


def decode_train(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Teacher-forced decoder -> logits [B, S, V] (tied unembedding).
    Under the mesh train step each layer's FSDP shards are gathered
    inside its remat'd layer, ``final_norm``'s where it is used, and
    ``enc_out`` takes one column-parallel entry before the layers (each
    layer's cross K/V reads only this rank's KV heads)."""
    x = _dec_embed(params, cfg, tokens, 0)
    wo = params["decoder"]["cross_attn"]["wo"]
    if model_split(wo.shape[-2], cfg.q_dim, "the cross attention's wo"):
        enc_out = model_entry(enc_out)

    def layer(h, enc, p):
        p = fsdp_params(p, ("decoder",), stacked=True)
        a = norm_apply(p["norm1"], cfg, h)
        h = h + gqa_train(p["self_attn"], cfg, a, positions=None,
                          causal=True, use_rope=False, impl=impl)
        a = norm_apply(p["norm2"], cfg, h)
        k, v = cross_kv(p["cross_attn"], cfg, enc)
        h = h + gqa_cross(p["cross_attn"], cfg, a, k, v, impl=impl)
        a = norm_apply(p["norm3"], cfg, h)
        return h + mlp_apply(p["mlp"], cfg, a)

    layer = lm._remat(bind(layer), cfg.remat)
    for p in lm._unbind(params["decoder"], cfg.n_dec_layers):
        x = layer(x, enc_out, p)
    return lm.unembed(params, cfg, norm_apply(
        fsdp_params(params["final_norm"], ("final_norm",)), cfg, x))


def encdec_loss(params: Dict, cfg: ModelConfig, frames: torch.Tensor,
                tokens: torch.Tensor, targets: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    enc = encode(params, cfg, frames, impl=impl)
    return lm.cross_entropy(decode_train(params, cfg, tokens, enc,
                                         impl=impl), targets)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def encdec_init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                       page_tokens: int = 128, *, device="cuda") -> Dict:
    """Zeroed decode caches on ``device``: the decoder's self-attention
    pools (``pools``: (pool_k, pool_v), each [L, P, T, KV, hd]) sized by
    ``cfg.kv_pages_per_seq`` as ``api.kv_geometry`` is, and the cross
    K/V [L, B, Senc, KV, hd], which the caller fills from
    ``encdec_prefill_cross``."""
    dev = resolve_device(device)
    pages_per_seq = cfg.kv_pages_per_seq(max_seq, page_tokens)
    num_pages = max(batch * pages_per_seq, 1)
    L = cfg.n_dec_layers
    cross = (L, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
    return {
        "page_table": (torch.arange(batch * pages_per_seq, dtype=torch.int32,
                                    device=dev)
                       .reshape(batch, pages_per_seq) % num_pages),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "pools": block_cache_init(cfg, "attn", batch, num_pages,
                                  page_tokens, device=dev, layers=L),
        "cross_k": torch.zeros(cross, dtype=cfg.dtype, device=dev),
        "cross_v": torch.zeros(cross, dtype=cfg.dtype, device=dev),
    }


def encdec_prefill_cross(params: Dict, cfg: ModelConfig,
                         enc_out: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V of ``enc_out``, once: stacked
    [L, B, Senc, KV, hd] each (the read-only relinked file)."""
    ks, vs = zip(*(cross_kv(p, cfg, enc_out) for p in lm._unbind(
        params["decoder"]["cross_attn"], cfg.n_dec_layers)))
    return torch.stack(ks), torch.stack(vs)


def encdec_serve_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                      caches: Dict, n_new: torch.Tensor, *,
                      impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Unified chunked serve step: tokens [B, C] (tokens[b, :n_new[b]]
    valid) -> (logits [B, C, V], caches with lengths + n_new).  Decode is
    the C=1 slice.  Each token's sinusoid sits at its own position,
    lengths[b] .. lengths[b] + C - 1.  The pools are written in place
    through per-layer views; the cross K/V are only read."""
    page_table = caches["page_table"]
    lengths = caches["lengths"]
    C = tokens.shape[1]
    pos = lengths[:, None] + torch.arange(C, dtype=torch.int32,
                                          device=lengths.device)[None, :]
    x = lm.embed_tokens(params, cfg, tokens) + \
        _sinusoid(pos.float(), cfg.d_model).to(cfg.dtype)
    for layer in range(cfg.n_dec_layers):
        p = lm._index(params["decoder"], layer)
        pool_k, pool_v = lm._index(caches["pools"], layer)
        a = norm_apply(p["norm1"], cfg, x)
        a, _, _ = gqa_serve(p["self_attn"], cfg, a, pool_k, pool_v,
                            page_table, lengths, use_rope=False, impl=impl)
        x = x + a
        a = norm_apply(p["norm2"], cfg, x)
        x = x + gqa_cross(p["cross_attn"], cfg, a, caches["cross_k"][layer],
                          caches["cross_v"][layer], impl=impl)
        a = norm_apply(p["norm3"], cfg, x)
        x = x + mlp_apply(p["mlp"], cfg, a)
    x = norm_apply(params["final_norm"], cfg, x)
    return lm.unembed(params, cfg, x), {**caches, "lengths": lengths + n_new}
