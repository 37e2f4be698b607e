"""The model API (port of ``repro/models/registry.py``) for the
decoder-only families — dense, MoE (``moe``: grok's GQA and deepseek's
MLA) and Mamba2 (``ssm``): the training surface

    loss(params, batch, impl=None)   -> scalar
    logits(params, batch, impl=None) -> [B, S, V]

over ``batch = {"tokens", "targets"}``, and the serve surface

    serve_step(params, tokens [B, C], caches, n_new [B], impl=None)
        -> (logits [B, C, V], caches)

processes up to C new tokens per sequence per call; decode is the C=1
slice.  The API owns the KV pool geometry (``kv_geometry``), so the
engine's controller and the device pools derive from one formula (an SSM
model keeps the controller's page metadata, as the reference does, but
no pools).  The encoder-decoder and VLM families raise until their
slices land (ROADMAP queue 1, items 2.6 and 2.7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

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
_PENDING_FAMILIES = {"hybrid": "2.5", "encdec": "2.6", "vlm": "2.7"}


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"item {_PENDING_FAMILIES.get(cfg.family, '2')}); the "
            "decoder-only families (dense, moe, ssm) run in repro_torch")
    return ModelAPI(
        cfg=cfg,
        init_specs=lambda: lm.lm_init(cfg),
        loss=lambda p, b, impl=None:
            lm.lm_loss(p, cfg, b["tokens"], b["targets"], impl=impl),
        logits=lambda p, b, impl=None:
            lm.lm_logits(p, cfg, b["tokens"], impl=impl),
        init_caches=lambda batch, max_seq, page_tokens=128, *, device="cuda":
            lm.lm_init_caches(cfg, batch, max_seq, page_tokens, device=device),
        serve_step=lambda p, t, c, n, impl=None:
            lm.lm_serve_step(p, cfg, t, c, n, impl=impl),
        kv_geometry=lambda b, s, pt=128: _kv_geometry(cfg, b, s, pt),
    )
