"""The schedules of the flash attention kernels' float32 forward
(``flash_fwd_f32_tiled``, ``csrc/flash_attention.cu``'s
``flash_f32_tc_kernel``) and of the backward kernels
(``csrc/flash_attention_bwd.cu``) in plain PyTorch, step for step: the
counterpart of ``blockwise.py`` for the CPU tests.  Nothing on the main
path calls them.

The float32 forward: one block per (``q_tile`` query rows, head h) walks
the key tiles of its band, ``k_tile`` keys a tile from a multiple of
``k_tile``, with the online softmax in log2 units (the bf16 kernels'
expressions: finite NEG_INF, masked probabilities exactly 0, the
denominator clamped at 1e-20, the softcap as ``c (1 - 2 / (1 + 2^(2 y
log2 e)))``).  Both products are 3xTF32, as ``csrc/mma_tf32.cuh`` takes
them: each operand split into TF32 big and small parts (the mantissa
rounded to 10 bits, to nearest with ties away from zero, as
``cvt.rna.tf32.f32``), and ``a_small b_big + a_big b_small + a_big b_big``
summed in float32.

The pre-pass writes ``delta = rowsum(dO * out)`` and the forward's ``lse``
into rows padded to whole ``pad``-row tiles; a padded row has delta 0 and
lse +1e30, so its P is 0 without a mask (Q and dO rows past Sq read as
zeros, as TMA fills them).  Then two passes, each owning its outputs:

  * key frame (dK, dV): one block per (key tile of ``kv_tile`` keys, query
    head h) walks the query tiles of its band in steps of ``q_step`` rows:

        S^T = K.Q^T,  dP^T = V.dO^T,  P^T = exp(scale S^T - lse) masked,
        dS^T = P^T (dP^T - delta) [(1 - t^2) under the softcap]
        dV += P^T.dO,  dK += dS^T.Q          (dK scaled once at the end)

    and writes head h's float32 partial; the group's G = H / KV partials
    are then added in head order (with H == KV the block writes the grads);
  * query frame (dQ): one block per (``q_tile`` query rows, head h) walks
    the key tiles of its band in steps of ``k_step`` keys, recomputing S
    and dP, and adds dQ += dS.K (scaled once at the end).

The bf16 kernels take 128 keys a tile in both frames, 64 at a head dim
over 128 (where dK and dV of 128 keys, or dQ beside S and dP of 128 keys,
would not fit a consumer's registers); these are the defaults.  The
float32 kernels own 64 rows a block (32 at a head dim over 128) in either
frame and stream the other frame 32 rows a step: ``kv_tile = q_tile = 64``
(32) and ``q_step = k_step = 32``.

Keys past Sk are masked (their K and V rows read as zeros).  With
``round_bf16`` P and dS are rounded to bf16 before the products, as the
bf16 kernels feed them to the tensor cores.  Sums are float32; the grads
come back in the inputs' dtypes, as ``blockwise_bwd`` returns them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

PAD_LSE = 1e30
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, S, ...] with zero rows appended up to n."""
    pad = torch.zeros((x.shape[0], n - x.shape[1], *x.shape[2:]),
                      dtype=x.dtype)
    return torch.cat([x, pad], dim=1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of float32 operands in 3xTF32: each split
    into big = tf32(x) and small = tf32(x - big), the small products
    first, all three summed in float32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def flash_fwd_f32_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_tile: int = 64,
                        k_tile: int = 32
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D], lse [B, H, Sq]) of float32 q, k, v through the
    float32 forward kernel's decomposition (``q_tile`` query rows a block,
    ``k_tile`` keys a step)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    if softcap is not None:
        mul, cap2 = 2.0 * LOG2E * scale / softcap, softcap * LOG2E
    else:
        mul = scale * LOG2E
    n_kt = _cdiv(Sk, k_tile)
    kf = _rows(k.float(), n_kt * k_tile).repeat_interleave(G, dim=2)
    vf = _rows(v.float(), n_kt * k_tile).repeat_interleave(G, dim=2)
    qf = _rows(q.float(), _cdiv(Sq, q_tile) * q_tile)
    out = torch.zeros(B, Sq, H, D)
    lse = torch.zeros(B, H, Sq)
    for qt in range(_cdiv(Sq, q_tile)):
        q0 = qt * q_tile
        q_last = min(q0 + q_tile, Sq) - 1
        lo = max(0, q0 - window + 1) // k_tile * k_tile \
            if window is not None else 0
        hi = min(Sk, q_last + 1) if causal else Sk
        qpos = torch.arange(q0, q0 + q_tile)[:, None]
        qs = qf[:, q0:q0 + q_tile].transpose(1, 2)            # [B, H, R, D]
        m = torch.full((B, H, q_tile, 1), NEG_INF)
        l = torch.zeros(B, H, q_tile, 1)
        o = torch.zeros(B, H, q_tile, D)
        for k0 in range(lo, hi, k_tile):
            ks = kf[:, k0:k0 + k_tile].transpose(1, 2)        # [B, H, K, D]
            vs = vf[:, k0:k0 + k_tile].transpose(1, 2)
            s = mm_3xtf32("bhqd,bhkd->bhqk", qs, ks)
            if softcap is not None:
                x = cap2 * (1.0 - 2.0 / (1.0 + torch.exp2(s * mul)))
            else:
                x = s * mul
            kpos = torch.arange(k0, k0 + k_tile)[None, :]
            vis = kpos < Sk
            if causal:
                vis = vis & (kpos <= qpos)
            if window is not None:
                vis = vis & (kpos > qpos - window)
            x = torch.where(vis, x, NEG_INF)
            m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(vis, torch.exp2(x - m_new), 0.0)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + mm_3xtf32("bhqk,bhkd->bhqd", p, vs)
            m = m_new
        d = l.clamp_min(1e-20)
        rows = slice(0, q_last + 1 - q0)
        out[:, q0:q_last + 1] = (o / d)[:, :, rows].transpose(1, 2)
        m2 = torch.where(m == NEG_INF, NEG_INF, m * LN2)
        lse[:, :, q0:q_last + 1] = (m2 + torch.log(d))[:, :, rows, 0]
    return out.to(q.dtype), lse


def flash_bwd_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_tile: Optional[int] = None, q_step: int = 64,
                    q_tile: int = 128, k_step: Optional[int] = None,
                    pad: int = 128, round_bf16: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), as ``blockwise_bwd``, through the kernels'
    decomposition (``kv_tile`` keys and ``q_step`` query rows a step in the
    key frame, ``q_tile`` rows and ``k_step`` keys a step in the query
    frame, workspace rows padded to ``pad``).  ``kv_tile`` and ``k_step``
    default to the kernels' 128 keys, 64 at a head dim over 128."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kv_tile = kv_tile or (128 if D <= 128 else 64)
    k_step = k_step or (128 if D <= 128 else 64)
    G = H // KV
    scale = D ** -0.5
    rnd = (lambda x: x.bfloat16().float()) if round_bf16 else (lambda x: x)
    Sq_pad = _cdiv(Sq, pad) * pad
    n_kt = _cdiv(Sk, kv_tile)
    Sk_pad = n_kt * kv_tile
    qf, gf = _rows(q.float(), Sq_pad), _rows(g.float(), Sq_pad)
    kf, vf = _rows(k.float(), Sk_pad), _rows(v.float(), Sk_pad)

    # pre-pass
    delta = torch.zeros(B, H, Sq_pad)
    delta[:, :, :Sq] = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float())
    lse_p = torch.full((B, H, Sq_pad), PAD_LSE)
    lse_p[:, :, :Sq] = lse.float()

    def p_ds(s, dp, lse_r, delta_r, kpos, qpos):
        """P and dS of scores s [B, rows, cols] with their rows' lse and
        delta broadcast alike; masked pairs (kpos, qpos broadcast to s's
        last two dims) give 0."""
        x = s * scale
        fac = 1.0
        if softcap is not None:
            t = torch.tanh(x / softcap)
            x = softcap * t
            fac = 1.0 - t * t
        msk = kpos < Sk
        if causal:
            msk = msk & (kpos <= qpos)
        if window is not None:
            msk = msk & (kpos > qpos - window)
        p = torch.where(msk, torch.exp(x - lse_r), 0.0)
        return p, torch.where(msk, p * (dp - delta_r) * fac, 0.0)

    # key frame: dK, dV per (key tile, head), partials folded in head order
    dk_part = torch.zeros(B, Sk_pad, H, D)
    dv_part = torch.zeros(B, Sk_pad, H, D)
    for kt in range(n_kt):
        k0 = kt * kv_tile
        ks = slice(k0, k0 + kv_tile)
        k_last = min(k0 + kv_tile, Sk) - 1
        t_lo = k0 // q_step if causal else 0
        t_hi = _cdiv(Sq, q_step)
        if window is not None:
            t_hi = min(t_hi, max(k_last + window - 1, 0) // q_step + 1)
        kpos = torch.arange(k0, k0 + kv_tile)[:, None]
        for h in range(H):
            kvh = h // G
            dk_t = torch.zeros(B, kv_tile, D)
            dv_t = torch.zeros(B, kv_tile, D)
            for i in range(t_lo, t_hi):
                qs = slice(i * q_step, (i + 1) * q_step)
                qpos = torch.arange(i * q_step, (i + 1) * q_step)[None, :]
                s_t = torch.einsum("bkd,bqd->bkq", kf[:, ks, kvh],
                                   qf[:, qs, h])
                dp_t = torch.einsum("bkd,bqd->bkq", vf[:, ks, kvh],
                                    gf[:, qs, h])
                p_t, ds_t = p_ds(s_t, dp_t, lse_p[:, h, None, qs],
                                 delta[:, h, None, qs], kpos, qpos)
                dv_t += torch.einsum("bkq,bqd->bkd", rnd(p_t), gf[:, qs, h])
                dk_t += torch.einsum("bkq,bqd->bkd", rnd(ds_t), qf[:, qs, h])
            dk_part[:, ks, h] = dk_t * scale
            dv_part[:, ks, h] = dv_t
    dk = dk_part[:, :Sk].reshape(B, Sk, KV, G, D)
    dv = dv_part[:, :Sk].reshape(B, Sk, KV, G, D)
    dk_sum, dv_sum = dk[:, :, :, 0].clone(), dv[:, :, :, 0].clone()
    for j in range(1, G):                 # the fold, in head order
        dk_sum += dk[:, :, :, j]
        dv_sum += dv[:, :, :, j]

    # query frame: dQ per (query tile, head)
    dq = torch.zeros(B, Sq_pad, H, D)
    n_ks = _cdiv(Sk, k_step)
    kf, vf = _rows(k.float(), n_ks * k_step), _rows(v.float(), n_ks * k_step)
    for qt in range(_cdiv(Sq, q_tile)):
        q0 = qt * q_tile
        qs = slice(q0, q0 + q_tile)
        q_last = min(q0 + q_tile, Sq) - 1
        t_hi = n_ks if not causal else min(n_ks, q_last // k_step + 1)
        t_lo = 0
        if window is not None and q0 - window + 1 > 0:
            t_lo = (q0 - window + 1) // k_step
        qpos = torch.arange(q0, q0 + q_tile)[:, None]
        for h in range(H):
            kvh = h // G
            dq_t = torch.zeros(B, q_tile, D)
            for j in range(t_lo, t_hi):
                ks = slice(j * k_step, (j + 1) * k_step)
                kpos = torch.arange(j * k_step, (j + 1) * k_step)[None, :]
                s = torch.einsum("bqd,bkd->bqk", qf[:, qs, h], kf[:, ks, kvh])
                dp = torch.einsum("bqd,bkd->bqk", gf[:, qs, h], vf[:, ks, kvh])
                _, ds = p_ds(s, dp, lse_p[:, h, qs, None],
                             delta[:, h, qs, None], kpos, qpos)
                dq_t += torch.einsum("bqk,bkd->bqd", rnd(ds), kf[:, ks, kvh])
            dq[:, qs, h] = dq_t * scale
    return (dq[:, :Sq].to(q.dtype), dk_sum.to(k.dtype), dv_sum.to(v.dtype))
