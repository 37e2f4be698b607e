"""The Mamba2 SSD intra-chunk block in plain PyTorch, written from
``repro/kernels/ssd_chunk/ref.py``: within one chunk of length L,

    y[b, i, h] = sum_{j <= i} (C[b, i] . B[b, j]) * exp(cs[b, i, h] - cs[b, j, h])
                 * dt[b, j, h] * x[b, j, h]

in float32, returned in ``x.dtype``.  The decay is ``exp`` of the
difference with the non-causal entries set to ``-inf`` first, so it is 0
there exactly as the reference's ``where(causal, exp(diff), 0)`` and
autograd through it never meets an overflowed ``exp``.

``ssd_chunk_bwd_plain`` is the gradient of that function with respect to
all five inputs, written out (the reference differentiates the same
einsums with JAX).  ``dt`` and ``dA_cs`` carry the gradients of the
model's ``dt_bias`` and ``A_log``.  Both build [B, L, L, H] tensors: they
are for chunk-sized L.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _decay(csf: torch.Tensor) -> torch.Tensor:
    """[B, i, j, H]: exp(cs_i - cs_j) where j <= i, else 0."""
    L = csf.shape[1]
    diff = csf[:, :, None, :] - csf[:, None, :, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=csf.device).tril()
    return torch.exp(diff.masked_fill(~causal[None, :, :, None],
                                      float("-inf")))


def ssd_chunk_ref(x: torch.Tensor,        # [B, L, H, P]
                  dt: torch.Tensor,       # [B, L, H]  softplus'd step sizes
                  dA_cs: torch.Tensor,    # [B, L, H]  within-chunk cumsum of dt*A
                  Bm: torch.Tensor,       # [B, L, N]  input projection
                  Cm: torch.Tensor,       # [B, L, N]  output projection
                  ) -> torch.Tensor:
    """The intra-chunk output y [B, L, H, P] in ``x.dtype``."""
    xf, dtf = x.float(), dt.float()
    scores = torch.einsum("bin,bjn->bij", Cm.float(), Bm.float())
    w = scores[..., None] * _decay(dA_cs.float()) * dtf[:, None, :, :]
    return torch.einsum("bijh,bjhp->bihp", w, xf).to(x.dtype)


def ssd_chunk_bwd_plain(x: torch.Tensor, dt: torch.Tensor,
                        dA_cs: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, ddA_cs, dBm, dCm) for the upstream gradient ``dy``
    [B, L, H, P], recomputed from the inputs in float32 and returned in
    each input's dtype.  With W = S * E * dt_j (S = C_i . B_j, E the
    decay) and G = dy_i . x_j per head:

        dx_j  = sum_i W[i, j] dy_i            ddt_j = sum_i G S E
        dS    = sum_h G E dt_j                dC = dS B,  dB = dS^T C
        Q     = G W,  dcs_k = sum_j Q[k, j] - sum_i Q[i, k]
    """
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    dyf = dy.float()
    S = torch.einsum("bin,bjn->bij", Cf, Bf)
    E = _decay(dA_cs.float())
    dx = torch.einsum("bijh,bihp->bjhp", S[..., None] * E * dtf[:, None],
                      dyf)
    GE = torch.einsum("bihp,bjhp->bijh", dyf, xf) * E
    del E
    ddt = torch.einsum("bijh,bij->bjh", GE, S)
    dS = torch.einsum("bijh,bjh->bij", GE, dtf)
    dC = torch.einsum("bij,bjn->bin", dS, Bf)
    dB = torch.einsum("bij,bin->bjn", dS, Cf)
    Q = GE * S[..., None] * dtf[:, None]
    dcs = Q.sum(2) - Q.sum(1)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dcs.to(dA_cs.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype))
