"""The flash schedule in plain PyTorch, written from
``repro/kernels/flash_attention/blockwise.py``: memory-efficient attention
that never builds the [Sq, Sk] score matrix, forward and backward.

  * ``blockwise_fwd`` walks q in blocks of ``blk_q`` rows; each block runs
    the online softmax over exactly the key blocks its causal / window
    band can see (``_band``) and returns the output and the row
    log-sum-exp ``lse = m + log(max(l, 1e-20))`` (float32, [B, H, Sq]).
  * ``blockwise_bwd`` is the reference's ``_bw_bwd``: ``delta =
    rowsum(dO * O)``, ``p = exp(s - lse)`` recomputed per block, the
    softcap chain factor ``1 - (s/c)^2``, and the grouped query heads'
    dK/dV summed back onto their KV head.

Unlike the reference, any ``Sq`` and ``Sk`` are taken: the last block of
each may be short (the reference pads to block multiples and masks with a
static ``kv_len``).  Everything is float32; outputs and grads come back in
the inputs' dtypes.  This module is the plain version of the CUDA kernel
(forward) and the backward on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
DEFAULT_BLOCK = 1024


def _band(i: int, n_kv_blocks: int, blk_q: int, blk_k: int, Sq: int,
          causal: bool, window: Optional[int]) -> Tuple[int, int]:
    """Key block range [lo, hi) visible to q block i."""
    q_lo = i * blk_q
    q_hi = min((i + 1) * blk_q, Sq) - 1
    hi = n_kv_blocks if not causal else min(n_kv_blocks, q_hi // blk_k + 1)
    lo = 0 if window is None else max(0, (q_lo - window + 1) // blk_k)
    return lo, hi


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    return m


def _expand_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    KV = k.shape[2]
    return k if KV == H else k.repeat_interleave(H // KV, dim=2)


def _blocks(n: int, blk: int):
    return min(blk, n), -(-n // min(blk, n))


def blockwise_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  blk_q: int = DEFAULT_BLOCK, blk_k: int = DEFAULT_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Sq, H, D], k/v [B, Sk, KV, D] -> (out [B, Sq, H, D] in q's
    dtype, lse [B, H, Sq] float32)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    blk_q, nq = _blocks(Sq, blk_q)
    blk_k, nk = _blocks(Sk, blk_k)
    ke = _expand_kv(k, H).float()
    ve = _expand_kv(v, H).float()
    scale = D ** -0.5
    dev = q.device
    outs, lses = [], []
    for i in range(nq):
        q0, q1 = i * blk_q, min((i + 1) * blk_q, Sq)
        qf = q[:, q0:q1].float() * scale
        bq = q1 - q0
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=dev)
        lo, hi = _band(i, nk, blk_q, blk_k, Sq, causal, window)
        for j in range(lo, hi):
            k0, k1 = j * blk_k, min((j + 1) * blk_k, Sk)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, ke[:, k0:k1])
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            msk = _mask(q_pos, torch.arange(k0, k1, device=dev)[None, :],
                        causal, window)
            s = torch.where(msk, s, NEG_INF)
            m_cur = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_cur)
            p = torch.where(msk, torch.exp(s - m_cur[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, ve[:, k0:k1])
            m = m_cur
        lc = torch.clamp(l, min=1e-20)
        outs.append((acc / lc[..., None]).transpose(1, 2))
        lses.append(m + torch.log(lc))
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out, torch.cat(lses, dim=2)


def blockwise_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  blk_q: int = DEFAULT_BLOCK, blk_k: int = DEFAULT_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of ``sum(out * g)`` from the forward's residuals."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    blk_q, nq = _blocks(Sq, blk_q)
    blk_k, nk = _blocks(Sk, blk_k)
    ke = _expand_kv(k, H).float()
    ve = _expand_kv(v, H).float()
    scale = D ** -0.5
    dev = q.device
    gf = g.float()
    delta = torch.einsum("bqhd,bqhd->bhq", gf, out.float())
    dq = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Sk, H, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, H, D), dtype=torch.float32, device=dev)
    for i in range(nq):
        q0, q1 = i * blk_q, min((i + 1) * blk_q, Sq)
        qc = q[:, q0:q1].float()
        gc = gf[:, q0:q1]
        lse_c = lse[:, :, q0:q1, None]
        delta_c = delta[:, :, q0:q1, None]
        q_pos = torch.arange(q0, q1, device=dev)[:, None]
        dqc = torch.zeros_like(qc)
        lo, hi = _band(i, nk, blk_q, blk_k, Sq, causal, window)
        for j in range(lo, hi):
            k0, k1 = j * blk_k, min((j + 1) * blk_k, Sk)
            kj, vj = ke[:, k0:k1], ve[:, k0:k1]
            s = torch.einsum("bqhd,bkhd->bhqk", qc * scale, kj)
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            msk = _mask(q_pos, torch.arange(k0, k1, device=dev)[None, :],
                        causal, window)
            p = torch.where(msk, torch.exp(s - lse_c), 0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", gc, vj)
            ds = p * (dp - delta_c)
            if softcap is not None:
                ds = ds * (1.0 - (s / softcap) ** 2)
            dqc += torch.einsum("bhqk,bkhd->bqhd", ds, kj) * scale
            dk[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
            dv[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", p, gc)
        dq[:, q0:q1] = dqc
    if KV != H:                      # fold the grouped query heads back
        dk = dk.reshape(B, Sk, KV, G, D).sum(3)
        dv = dv.reshape(B, Sk, KV, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
