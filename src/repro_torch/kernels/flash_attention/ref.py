"""The dense attention oracle in plain PyTorch, written from
``repro/kernels/flash_attention/ref.py``: causal, sliding-window or full
GQA attention with an optional softcap, a query offset and per-sequence
key lengths, all in float32, with the reference's finite ``-1e30`` fill,
``probs * mask`` (a row that sees no key gives 0, not NaN) and the
``1e-20`` clamp on the denominator.  It builds the whole [B, H, Sq, Sk]
score matrix, so it is for small shapes and for the calls the flash
schedule does not take (``q_offset``, ``lengths``)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor,                 # [B, Sq, H, D]
                  k: torch.Tensor,                 # [B, Sk, KV, D]
                  v: torch.Tensor,                 # [B, Sk, KV, D]
                  *, causal: bool = True,
                  window: Optional[int] = None,
                  q_offset: int = 0,
                  softcap: Optional[float] = None,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    assert H % KV == 0, (H, KV)
    G = H // KV
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * (D ** -0.5), kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    dev = q.device
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    mask = mask[None, None].expand(B, H, Sq, Sk)
    if lengths is not None:
        valid = kpos[None] < lengths.to(dev).long()[:, None, None]   # [B,1,Sk]
        mask = mask & valid[:, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs * mask
    denom = probs.sum(dim=-1, keepdim=True)
    probs = probs / torch.clamp(denom, min=1e-20)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
