"""Decoder-only LM (port of ``repro/models/lm.py``): the full-sequence
forward and loss of training, and the chunked serve step.

Parameters and caches keep the reference's pytree layout: the period
group's parameters and caches are stacked over layers (``params["group"]
["b0_attn"]`` leaves carry a leading layer dim; pools are
``[L, P, T, KV, D]``, SSM state ``{"conv", "ssd"}`` is ``[L, B, ...]``),
page 0 of every pool is the null page.  Where JAX scans over the stacked
layer index, the port runs a Python loop: the serve step hands each layer
``cache[l]`` views, which it updates in place; the training forward takes
every stacked leaf apart once with ``unbind(0)``, whose backward stacks
the layers' grads in one allocation
(indexing per layer would make each index's backward a zero-filled grad
of the whole stacked leaf).

Remat follows ``cfg.remat``: ``"full"`` checkpoints each layer group
(non-reentrant ``torch.utils.checkpoint``: only its input is kept and the
forward, kernels included, runs again in the backward); ``"dots"``
keeps the outputs of the plain matrix products (``aten.mm``/``addmm``,
JAX's ``checkpoint_dots_with_no_batch_dims``) and recomputes the rest;
``"none"`` keeps everything.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.common import resolve_device
from .blocks import block_cache_init, block_init, block_serve, block_train
from .config import ModelConfig
from .layers import norm_apply, norm_init
from .spec import ParamSpec, tree_map_specs


def _pattern_groups(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int]:
    """(period_pattern, n_full_groups).  The reference runs a non-periodic
    tail of layers unrolled; only hybrid patterns have one, and they are
    not ported yet."""
    pattern = cfg.block_pattern or ("attn",)
    n_full = cfg.n_layers // len(pattern)
    if cfg.pattern_for_layers()[n_full * len(pattern):]:
        raise NotImplementedError("layer patterns with a tail are not ported "
                                  "yet (ROADMAP queue 1, item 2.5)")
    return tuple(pattern), n_full


def _stack_specs(tree: Any, n: int) -> Any:
    return tree_map_specs(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical, s.dtype,
                            s.init, s.scale), tree)


def lm_init(cfg: ModelConfig) -> Dict:
    pattern, n_full = _pattern_groups(cfg)
    group = {f"b{i}_{kind}": block_init(cfg, kind)
             for i, kind in enumerate(pattern)}
    params: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed_tbl"),
                           cfg.param_dtype, init="embed", scale=0.02),
        "group": _stack_specs(group, n_full),
        "final_norm": norm_init(cfg),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                      ("embed", "vocab"), cfg.param_dtype,
                                      scale=0.02)
    return params


def embed_tokens(params: Dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    if cfg.family == "hybrid":               # gemma-style embedding scale
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cfg.dtype).T
    return x @ params["lm_head"].to(cfg.dtype)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat must be none, full or dots, got {remat!r}")


def _unbind(tree: Any, n: int) -> List[Any]:
    """The ``n`` per-layer subtrees of a stacked parameter subtree."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def lm_hidden(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              prefix_embeds: Optional[torch.Tensor] = None, *,
              impl: Optional[str] = None) -> torch.Tensor:
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings (VLMs) are not ported "
                                  "yet (ROADMAP queue 1, item 2.7)")
    pattern, n_full = _pattern_groups(cfg)
    x = embed_tokens(params, cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)

    def group_fn(h, *gps):
        for i, kind in enumerate(pattern):
            h = block_train(gps[i], cfg, kind, h, positions, impl=impl)
        return h

    group_fn = _remat(group_fn, cfg.remat)
    per_layer = [_unbind(params["group"][f"b{i}_{kind}"], n_full)
                 for i, kind in enumerate(pattern)]
    for layer in range(n_full):
        x = group_fn(x, *(p[layer] for p in per_layer))
    return norm_apply(params["final_norm"], cfg, x)


def lm_logits(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              prefix_embeds: Optional[torch.Tensor] = None, *,
              impl: Optional[str] = None) -> torch.Tensor:
    return unembed(params, cfg, lm_hidden(params, cfg, tokens, prefix_embeds,
                                          impl=impl))


def lm_loss(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            targets: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None, *,
            impl: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross entropy (float32 logits for stability).  The
    gold logit is a gather, where the reference uses a masked reduce: the
    same value, without a second [B, S, V] tensor."""
    logits = lm_logits(params, cfg, tokens, prefix_embeds,
                       impl=impl).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


def lm_init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                   page_tokens: int = 128, *, device="cuda") -> Dict:
    """Zeroed decode caches on ``device``.  Pool sizing comes from
    ``cfg.kv_pages_per_seq`` — the same formula the engine's
    ``api.kv_geometry`` uses."""
    dev = resolve_device(device)
    pattern, n_full = _pattern_groups(cfg)
    pages_per_seq = cfg.kv_pages_per_seq(max_seq, page_tokens)
    num_pages = max(batch * pages_per_seq, 1)
    return {
        "page_table": (torch.arange(batch * pages_per_seq, dtype=torch.int32,
                                    device=dev)
                       .reshape(batch, pages_per_seq) % num_pages),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "group": {f"b{i}_{kind}": block_cache_init(
                      cfg, kind, batch, num_pages, page_tokens, device=dev,
                      layers=n_full)
                  for i, kind in enumerate(pattern)} if n_full else {},
        "tail": {},
    }


def lm_serve_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  caches: Dict, n_new: torch.Tensor, *,
                  impl: Optional[str] = None) -> Tuple[torch.Tensor, Dict]:
    """Unified chunked serve step (prefill chunks AND decode in one
    fixed-shape call).  tokens: [B, C] with tokens[b, :n_new[b]] valid;
    positions run lengths[b] .. lengths[b]+C-1.  Returns
    (logits [B, C, V], caches with lengths + n_new).

    Unlike the pure JAX step, which donates the caches and returns new
    ones, this step MUTATES the stacked caches in place, layer by layer:
    the kernels write the ``[L, P, T, KV, D]`` pools through ``pool[l]``
    views, and each SSM layer's new state is copied into its
    ``state[l]`` views; the returned dict holds the same cache tensors
    and a new ``lengths``.
    ``impl`` picks the kernels' implementation (``None``: by device;
    ``"ref"``: the plain PyTorch versions)."""
    pattern, n_full = _pattern_groups(cfg)
    page_table = caches["page_table"]
    lengths = caches["lengths"]
    x = embed_tokens(params, cfg, tokens)

    for layer in range(n_full):
        for i, kind in enumerate(pattern):
            key = f"b{i}_{kind}"
            gp = {k: _index(v, layer) for k, v in params["group"][key].items()}
            cache = _index(caches["group"][key], layer)
            x, out = block_serve(gp, cfg, kind, x, cache, page_table,
                                 lengths, n_new, impl=impl)
            if isinstance(cache, dict):         # recurrent state
                for k, t in out.items():
                    cache[k].copy_(t)
    x = norm_apply(params["final_norm"], cfg, x)
    new_caches = dict(caches)
    new_caches["lengths"] = lengths + n_new
    return unembed(params, cfg, x), new_caches


def _index(tree: Any, layer: int) -> Any:
    """Layer ``layer`` of a stacked parameter or cache subtree (views, no
    copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, layer) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, layer) for v in tree)
    return tree[layer]
