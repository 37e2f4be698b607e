"""The model API (port of ``repro/models/registry.py``) for the
decoder-only families — dense, MoE (``moe``: grok's GQA and deepseek's
MLA), Mamba2 (``ssm``) and the RG-LRU hybrid (``hybrid``:
recurrentgemma) — and the VLM (``vlm``: internvl2): the training surface

    loss(params, batch, impl=None)   -> scalar
    logits(params, batch, impl=None) -> [B, S, V]

over ``batch = {"tokens", "targets"}`` (a VLM's also holds
``"patch_embeds"`` [B, n_patch_tokens, D], which go before the tokens; its
loss is taken on the text positions only), and the serve surface

    serve_step(params, tokens [B, C], caches, n_new [B], impl=None)
        -> (logits [B, C, V], caches)

processes up to C new tokens per sequence per call; decode is the C=1
slice.  The API owns the KV pool geometry (``kv_geometry``), so the
engine's controller and the device pools derive from one formula (an SSM
model keeps the controller's page metadata, as the reference does, but
no pools).  A VLM serves through the decoder's step, with no prefix, as
the reference does.  The encoder-decoder family raises until its slice
lands (ROADMAP queue 1, item 2.6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from . import lm
from .config import ModelConfig
from ..core.kvcache import KVGeometry


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_specs: Callable[[], Any]
    loss: Callable[..., Any]              # (params, batch, impl) -> scalar
    logits: Callable[..., Any]            # (params, batch, impl) -> [B, S, V]
    init_caches: Callable[..., Dict]      # (batch, max_seq, page_tokens, *, device)
    serve_step: Callable[..., Any]        # (params, tokens[B,C], caches, n_new[B], impl)
    kv_geometry: Callable[..., KVGeometry]  # (max_batch, max_seq, page_tokens)


def _kv_geometry(cfg: ModelConfig, max_batch: int, max_seq: int,
                 page_tokens: int) -> KVGeometry:
    """Pool geometry matching ``init_caches``' sizing exactly; page 0 of
    the pool is the controller-reserved null page."""
    pages_per_seq = cfg.kv_pages_per_seq(max_seq, page_tokens)
    return KVGeometry(num_pages=max(max_batch * pages_per_seq, 1),
                      page_tokens=page_tokens, max_seqs=max_batch,
                      pages_per_seq=pages_per_seq)


# family -> the ROADMAP.md queue-1 item that ports it
_PENDING_FAMILIES = {"encdec": "2.6"}


def _vlm_loss(p: Dict, cfg: ModelConfig, b: Dict,
              impl=None) -> torch.Tensor:
    """The patch embeddings occupy the first n_patch_tokens positions; the
    loss is the mean cross entropy of the text positions after them."""
    logits = lm.lm_logits(p, cfg, b["tokens"],
                          prefix_embeds=b["patch_embeds"], impl=impl)
    return lm.cross_entropy(logits[:, cfg.n_patch_tokens:], b["targets"])


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"item {_PENDING_FAMILIES.get(cfg.family, '2')}); the "
            "decoder-only families (dense, moe, ssm, hybrid) and the VLM "
            "run in repro_torch")
    if cfg.family == "vlm":
        loss = lambda p, b, impl=None: _vlm_loss(p, cfg, b, impl)
        logits = lambda p, b, impl=None: lm.lm_logits(
            p, cfg, b["tokens"], prefix_embeds=b["patch_embeds"], impl=impl)
    else:
        loss = lambda p, b, impl=None: lm.lm_loss(
            p, cfg, b["tokens"], b["targets"], impl=impl)
        logits = lambda p, b, impl=None: lm.lm_logits(
            p, cfg, b["tokens"], impl=impl)
    return ModelAPI(
        cfg=cfg,
        init_specs=lambda: lm.lm_init(cfg),
        loss=loss,
        logits=logits,
        init_caches=lambda batch, max_seq, page_tokens=128, *, device="cuda":
            lm.lm_init_caches(cfg, batch, max_seq, page_tokens, device=device),
        serve_step=lambda p, t, c, n, impl=None:
            lm.lm_serve_step(p, cfg, t, c, n, impl=impl),
        kv_geometry=lambda b, s, pt=128: _kv_geometry(cfg, b, s, pt),
    )
