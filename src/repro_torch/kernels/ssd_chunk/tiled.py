"""The schedule of the ``ssd_chunk`` backward kernel (``csrc/ssd_chunk_bwd.cu``)
in plain PyTorch, step for step: the counterpart of
``flash_attention/blockwise.py`` for the CPU tests.  Nothing on the main
path calls it.

Kernel 1 has one block per (column tile of P, group of ``head_group``
heads, key tile j) and one launch per window of at most ``window`` of
the query tiles i >= j.  Per window it forms S = C_i . B_j for the
window's query tiles once, then walks the group's heads and, per head,
the window's query tiles:

    G  = dy_i x_j^T            (over the block's P columns only)
    E  = exp(cs_i - cs_j) where j <= i, else 0
    W  = S E dt_j,   Q = G W
    dx_j += W^T dy_i                        (complete: W needs no G)
    ddt_j, sum_i Q[i, j]  += column sums    (complete in the block)
    sum_j Q[i, j]         -> row_part[pt, :, i, h, jt]
    dS[i, j]              += G E dt_j       (the group's share)

and writes the window's tiles of the group's dS to ``dS_part[pt *
n_groups + group]``.  What a head sums over query tiles (dx_j, ddt_j and
Q's column sums) is carried from window to window, added in window order.
Everything linear in G (ddt, dS and both sums of Q) is a partial per
column tile of P, so no block needs another's columns.  Kernel 2 adds the
partials in a fixed order (dS over column tiles and groups; the row sums
over column tiles and key tiles j <= i) and forms dC_i = sum_j dS_ij B_j,
dB_j = sum_i dS_ij^T C_i and dcs = row sums - column sums.

All in float32; the grads come back in each input's dtype, as
``ssd_chunk_bwd_plain`` returns them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ssd_chunk_bwd_tiled(x: torch.Tensor, dt: torch.Tensor,
                        dA_cs: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, dy: torch.Tensor, *,
                        tile: int = 64, head_group: int = 8,
                        p_tile: int = 64, window: int = 4
                        ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, ddA_cs, dBm, dCm), as ``ssd_chunk_bwd_plain``, through the
    kernel's decomposition (``tile``, ``head_group``, ``p_tile`` and
    ``window`` are its query / key tile, heads per block, P columns per
    block and query tiles whose scores a block keeps at once)."""
    xf, dtf, csf = x.float(), dt.float(), dA_cs.float()
    Bf, Cf, dyf = Bm.float(), Cm.float(), dy.float()
    Bp, L, H, P = x.shape
    n_it, n_pt = _cdiv(L, tile), _cdiv(P, p_tile)
    n_grp = _cdiv(H, head_group)
    rows = [slice(t * tile, min(L, (t + 1) * tile)) for t in range(n_it)]
    pos = torch.arange(L, device=x.device)

    dx = torch.zeros_like(xf)
    ddt_part = torch.zeros(n_pt, Bp, L, H, device=x.device)
    col_part = torch.zeros_like(ddt_part)
    row_part = torch.zeros(n_pt, Bp, L, H, n_it, device=x.device)
    dS_part = torch.zeros(n_pt * n_grp, Bp, L, L, device=x.device)

    # kernel 1
    for pt in range(n_pt):
        p = slice(pt * p_tile, min(P, (pt + 1) * p_tile))
        for grp in range(n_grp):
            for jt in range(n_it):
                j = rows[jt]
                dtj = {h: dtf[:, j, h][:, None, :] for h in range(H)}
                for w0 in range(jt, n_it, window):
                    win = range(w0, min(n_it, w0 + window))
                    S = {it: torch.einsum("bin,bjn->bij", Cf[:, rows[it]],
                                          Bf[:, j]) for it in win}
                    dSc = {it: torch.zeros_like(S[it]) for it in S}
                    for h in range(grp * head_group,
                                   min(H, (grp + 1) * head_group)):
                        dxa = torch.zeros_like(xf[:, j, h, p])
                        cdd = torch.zeros_like(dtf[:, j, h])
                        cq = torch.zeros_like(cdd)
                        for it in win:
                            i = rows[it]
                            G = torch.einsum("bip,bjp->bij", dyf[:, i, h, p],
                                             xf[:, j, h, p])
                            causal = pos[j][None, :] <= pos[i][:, None]
                            diff = csf[:, i, h][:, :, None] - \
                                csf[:, j, h][:, None, :]
                            e = torch.exp(diff.masked_fill(~causal,
                                                           float("-inf")))
                            ge = G * e
                            w = S[it] * e * dtj[h]
                            cdd += (ge * S[it]).sum(1)
                            dSc[it] += ge * dtj[h]
                            q = G * w
                            row_part[pt, :, i, h, jt] = q.sum(2)
                            cq += q.sum(1)
                            dxa += torch.einsum("bij,bip->bjp", w,
                                                dyf[:, i, h, p])
                        # added to the earlier windows' (zero at the first)
                        dx[:, j, h, p] += dxa
                        ddt_part[pt, :, j, h] += cdd
                        col_part[pt, :, j, h] += cq
                    for it in S:
                        dS_part[pt * n_grp + grp][:, rows[it], j] = dSc[it]

    # kernel 2: the partials in a fixed order, then dC, dB, ddt, dcs
    dS = torch.zeros(Bp, L, L, device=x.device)
    for part in dS_part:
        dS += part
    dC, dB = torch.zeros_like(Cf), torch.zeros_like(Bf)
    for t in range(n_it):
        for kt in range(t + 1):
            dC[:, rows[t]] += dS[:, rows[t], rows[kt]] @ Bf[:, rows[kt]]
        for kt in range(t, n_it):
            dB[:, rows[t]] += dS[:, rows[kt], rows[t]].transpose(1, 2) @ \
                Cf[:, rows[kt]]
    ddt = torch.zeros_like(dtf)
    dcs_rows, dcs_cols = torch.zeros_like(dtf), torch.zeros_like(dtf)
    for pt in range(n_pt):
        ddt += ddt_part[pt]
        dcs_cols += col_part[pt]
        for t in range(n_it):
            for jt in range(t + 1):
                dcs_rows[:, rows[t]] += row_part[pt, :, rows[t], :, jt]
    dcs = dcs_rows - dcs_cols
    return (dx.to(x.dtype), ddt.to(dt.dtype), dcs.to(dA_cs.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype))
