"""Plain PyTorch versions of paged attention over the KV page pool,
written from ``repro/kernels/paged_attention/ref.py``: the same gather of
pages, f32 einsums and masks, without the sharding constraints.

  * ``paged_attention_ref``        one query token per sequence; ``lengths``
                                   counts the TOTAL valid keys.
  * ``paged_attention_chunk_ref``  a chunk of C query tokens per sequence at
                                   positions lengths[b] .. lengths[b]+C-1;
                                   ``lengths`` is the PRE-chunk length and
                                   query c sees keys at positions
                                   <= lengths[b] + c.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor,            # [B, H, D]
                        pool_k: torch.Tensor,       # [P, T, KV, D]
                        pool_v: torch.Tensor,       # [P, T, KV, D]
                        page_table: torch.Tensor,   # [B, N] int32
                        lengths: torch.Tensor,      # [B] int32 (total keys)
                        *, softcap: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    B, H, D = q.shape
    P, T, KV, _ = pool_k.shape
    N = page_table.shape[1]
    G = H // KV
    pt = page_table.long()
    k = pool_k[pt].reshape(B, N * T, KV, D).float()
    v = pool_v[pt].reshape(B, N * T, KV, D).float()

    qg = (q.float() * (D ** -0.5)).reshape(B, KV, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k)        # [B, KV, G, S]
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)

    kpos = torch.arange(N * T, device=q.device)[None, :]   # [1, S]
    lens = lengths.long()[:, None]
    mask = kpos < lens
    if window is not None:
        mask &= kpos > (lens - 1 - window)
    mask = mask[:, None, None, :]                          # [B, 1, 1, S]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True)) * mask
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bkgs,bskd->bkgd", probs / denom, v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_chunk_ref(q: torch.Tensor,            # [B, C, H, D]
                              pool_k: torch.Tensor,       # [P, T, KV, D]
                              pool_v: torch.Tensor,       # [P, T, KV, D]
                              page_table: torch.Tensor,   # [B, N] int32
                              lengths: torch.Tensor,      # [B] int32 (pre)
                              *, softcap: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    B, C, H, D = q.shape
    P, T, KV, _ = pool_k.shape
    N = page_table.shape[1]
    G = H // KV
    pt = page_table.long()
    k = pool_k[pt].reshape(B, N * T, KV, D).float()
    v = pool_v[pt].reshape(B, N * T, KV, D).float()

    qg = (q.float() * (D ** -0.5)).reshape(B, C, KV, G, D)
    logits = torch.einsum("bckgd,bskd->bkgcs", qg, k)      # [B, KV, G, C, S]
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)

    kpos = torch.arange(N * T, device=q.device)[None, None, :]        # [1,1,S]
    qpos = lengths.long()[:, None, None] \
        + torch.arange(C, device=q.device)[None, :, None]             # [B,C,1]
    mask = kpos <= qpos                                    # chunk-causal
    if window is not None:
        mask &= kpos > qpos - window
    mask = mask[:, None, None, :, :]                       # [B, 1, 1, C, S]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True)) * mask
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bkgcs,bskd->bkgcd", probs / denom, v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, D).to(q.dtype)
