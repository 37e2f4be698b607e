"""State-space layers (port of ``repro/models/ssm.py``): Mamba2 SSD and
the RG-LRU (griffin / recurrentgemma recurrent block).

Training (``mamba2_train``) uses the chunked block decomposition of the
reference: the intra-chunk term is the ``ssd_chunk`` op (the hand-written
kernel on a CUDA tensor, its plain version on the CPU), where the
reference builds the same contraction inline; the O(S/chunk) inter-chunk
recurrence is a Python loop over the chunks, where the reference scans.
Serving (``mamba2_serve``) runs the single-token recurrence over the C
tokens of a chunk, committing the state only for tokens ``c < n_new``:
only the recurrence itself runs token by token; the projections, the
causal conv (``conv_chunk``) and the gated norm run on the whole chunk,
so that on a rank of the mesh serve step, which holds its block of
whole SSD heads (``dist.sharding.state_specs``), the products that need
every head are summed once a layer a step, whatever the chunk.  On a
rank of the mesh train step ``mamba2_train`` and ``rglru_train`` run the
same blocks (the SSD op on the rank's heads), differentiated through
``shardctx``'s entries and sums.

The depthwise causal convolution stays a shifted sum, as in the
reference: ``F.conv1d`` would go through cuDNN, which runs float32
convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off.

The RG-LRU keeps the reference's cast points: its products run in
``cfg.dtype``, its sigmoid, softplus and exp in float32, and it reads
``a_param`` in float32 (``spec.FLOAT32_KEYS``).  Training
(``rglru_train``) runs the linear recurrence ``h_t = a_t h_{t-1} + b_t``
as a doubling scan over S where the reference runs
``jax.lax.associative_scan``; serving (``rglru_serve``) is the masked
per-token recurrence, as Mamba2's, its gates computed on the whole chunk
(on a rank that holds its block of the LRU channels, one sum of both
gates' partial pre-activations a layer a step).  Neither has a kernel:
the reference has no Pallas kernel for them either.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_chunk import ssd_chunk
from .config import ModelConfig
from .layers import rmsnorm_gated
from .shardctx import (model_all_reduce, model_entry, model_psum,
                       model_rank, model_split)
from .spec import ParamSpec


# ---------------------------------------------------------------------------
# depthwise causal conv1d
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x: [B, S, C]; w: [C, W]; left-padded depthwise conv + silu."""
    W = w.shape[1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[None, None, :, i] for i in range(W))
    return F.silu(out + b)


def conv_chunk(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor, n_new: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal conv of a serve chunk as the single-token steps give it
    when only tokens ``c < n_new[b]`` commit: token c's window is the
    last W-1 committed inputs before it (``conv_state``, then the chunk's
    first ``min(c, n_new)`` tokens) and its own input.  x: [B, C, ch];
    conv_state: [B, W-1, ch].  Returns (silu(out) [B, C, ch], the state
    after the first n_new tokens)."""
    B_, C, _ = x.shape
    W1 = conv_state.shape[1]
    xs = torch.cat([conv_state, x], dim=1)                    # [B, W-1+C, ch]
    rows = torch.arange(B_, device=x.device)
    taps = torch.arange(W1, device=x.device)
    n = n_new.long()
    done = torch.minimum(torch.arange(C, device=x.device)[None, :],
                         n[:, None])                          # [B, C]
    prev = xs[rows[:, None, None], done[..., None] + taps]    # [B,C,W-1,ch]
    window = torch.cat([prev, x[:, :, None, :]], dim=2)       # [B, C, W, ch]
    out = torch.einsum("bcwk,kw->bck", window, w) + b
    return F.silu(out), xs[rows[:, None], n[:, None] + taps]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    ngroups = 1
    conv_dim = d_inner + 2 * ngroups * cfg.ssm_state
    return dict(d_inner=d_inner, nheads=nheads, ngroups=ngroups,
                conv_dim=conv_dim, hd=cfg.ssm_head_dim, state=cfg.ssm_state)


def mamba2_init(cfg: ModelConfig) -> Dict:
    d = mamba2_dims(cfg)
    D = cfg.d_model
    pd = cfg.param_dtype
    in_dim = 2 * d["d_inner"] + 2 * d["ngroups"] * d["state"] + d["nheads"]
    return {
        "in_proj": ParamSpec((D, in_dim), ("embed", "ffn"), pd),
        "conv_w": ParamSpec((d["conv_dim"], cfg.ssm_conv), ("ffn", None), pd,
                            scale=0.5),
        "conv_b": ParamSpec((d["conv_dim"],), ("ffn",), pd, init="zeros"),
        "A_log": ParamSpec((d["nheads"],), (None,), pd, init="zeros"),
        "D_skip": ParamSpec((d["nheads"],), (None,), pd, init="ones"),
        "dt_bias": ParamSpec((d["nheads"],), (None,), pd, init="zeros"),
        "norm_w": ParamSpec((d["d_inner"],), ("ffn",), pd, init="ones"),
        "out_proj": ParamSpec((d["d_inner"], D), ("ffn", "embed"), pd),
    }


def _mamba2_split(p: Dict, zxbcdt: torch.Tensor):
    """z | xBC | dt at the widths of ``p`` (a rank of the mesh serve step
    holds its heads' z, x and dt and the whole B and C)."""
    di, nh = p["norm_w"].shape[-1], p["A_log"].shape[-1]
    return zxbcdt[..., :di], zxbcdt[..., di:-nh], zxbcdt[..., -nh:]


def _mamba2_xbc_split(p: Dict, xbc: torch.Tensor):
    """x | B | C of the conv's output (one group: B and C of ``state``
    each)."""
    di = p["norm_w"].shape[-1]
    st = (xbc.shape[-1] - di) // 2
    return xbc[..., :di], xbc[..., di:di + st], xbc[..., di + st:]


def mamba2_train(p: Dict, cfg: ModelConfig, u: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Chunked SSD forward. u: [B, S, D] -> [B, S, D].  The heads are
    those of ``p`` (all, or a rank's block of whole heads under the mesh
    train step), read from ``A_log``'s and ``norm_w``'s widths.  On a
    rank, z, x and dt come from ``u`` through the column-parallel entry;
    B and C, which feed every head while the rank's SSD reads its own
    heads only, come from ``u`` itself and take one entry after the
    conv, so their columns of ``in_proj`` and the conv get the same,
    whole grad on every rank and ``u``'s grad counts their path once.
    The gated norm's sum of squares and ``out_proj``'s partial products
    are summed over the model group."""
    B_, S, _ = u.shape
    nh, hd = p["A_log"].shape[-1], cfg.ssm_head_dim
    di = p["norm_w"].shape[-1]
    d_inner = mamba2_dims(cfg)["d_inner"]
    split = model_split(di, d_inner, "Mamba2's heads")
    dt_ = cfg.dtype
    cl = min(cfg.ssm_chunk, S)
    if S % cl:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {cl}")
    nc = S // cl

    w = p["in_proj"].to(dt_)
    if split:                          # z | x | B | C | dt
        ue = model_entry(u)
        zx = ue @ w[..., :2 * di]
        z, dtr = zx[..., :di], ue @ w[..., -nh:]
        xbc = torch.cat([zx[..., di:], u @ w[..., 2 * di:-nh]], dim=-1)
    else:
        z, xbc, dtr = _mamba2_split(p, u @ w)
    xbc = causal_conv1d(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    x, bc = xbc[..., :di], xbc[..., di:]
    if split:
        bc = model_entry(bc)
    st = bc.shape[-1] // 2

    x = x.reshape(B_, S, nh, hd).float()
    Bm = bc[..., :st].float()                           # [B, S, st], ngroups=1
    Cm = bc[..., st:].float()
    dt = F.softplus(dtr.float() + p["dt_bias"].float())          # [B, S, nh]
    A = -torch.exp(p["A_log"].float())                           # [nh]

    # chunk views
    xc = x.reshape(B_, nc, cl, nh, hd)
    Bc = Bm.reshape(B_, nc, cl, st)
    Cc = Cm.reshape(B_, nc, cl, st)
    dtc = dt.reshape(B_, nc, cl, nh)
    dA_cs = torch.cumsum(dtc * A, dim=2)                         # within-chunk

    # intra-chunk: the ssd_chunk op over the B * nc chunks
    y_intra = ssd_chunk(
        xc.reshape(B_ * nc, cl, nh, hd).contiguous(),
        dtc.reshape(B_ * nc, cl, nh).contiguous(),
        dA_cs.reshape(B_ * nc, cl, nh).contiguous(),
        Bc.reshape(B_ * nc, cl, st).contiguous(),
        Cc.reshape(B_ * nc, cl, st).contiguous(),
        impl=impl).reshape(B_, nc, cl, nh, hd)

    # chunk states + inter-chunk recurrence over the nc chunks
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)       # [B,nc,cl,nh]
    states = torch.einsum("bcjs,bcjhd->bchsd", Bc,
                          xc * (dtc * decay_to_end)[..., None])
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                  # [B, nc, nh]
    h = torch.zeros((B_, nh, st, hd), dtype=torch.float32, device=u.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                         # PREVIOUS
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # [B,nc,nh,st,hd]

    decay_from_start = torch.exp(dA_cs)                          # [B,nc,cl,nh]
    y_inter = torch.einsum("bcis,bchsd->bcihd", Cc, h_prev) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(B_, S, nh, hd)
    y = y + x * p["D_skip"].float()[None, None, :, None]
    y = y.reshape(B_, S, di)
    y = rmsnorm_gated(y, z, p["norm_w"], dt_, full=d_inner)
    out = y @ p["out_proj"].to(dt_)
    if split:
        out = model_all_reduce(out)      # this rank's heads: a partial sum
    return out


def _stacked(layers: Optional[int], *shape: int) -> Tuple[int, ...]:
    return shape if layers is None else (layers,) + shape


def mamba2_init_state(cfg: ModelConfig, batch: int, *, device: torch.device,
                      layers: Optional[int]) -> Dict[str, torch.Tensor]:
    """Zeroed state of ``layers`` stacked blocks (None: one block, no layer
    dim): conv [L, B, W-1, conv_dim] in ``cfg.dtype`` and ssd
    [L, B, nh, state, hd] in float32."""
    d = mamba2_dims(cfg)
    return {
        "conv": torch.zeros(_stacked(layers, batch, cfg.ssm_conv - 1,
                                     d["conv_dim"]),
                            dtype=cfg.dtype, device=device),
        "ssd": torch.zeros(_stacked(layers, batch, d["nheads"], d["state"],
                                    d["hd"]),
                           dtype=torch.float32, device=device),
    }


def _masked_recurrence(step: Callable, h: torch.Tensor, n_new: torch.Tensor,
                       C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``new = step(c, h)`` for the C tokens of a serve chunk, committing
    ``new`` only for tokens ``c < n_new[b]``: pad tokens (and idle slots
    with n_new == 0) produce garbage outputs but never advance the
    recurrence.  Returns (every token's new state, stacked on dim 1; the
    committed state)."""
    keep = n_new.reshape((-1,) + (1,) * (h.dim() - 1))
    outs = []
    for c in range(C):
        new = step(c, h)
        outs.append(new)
        h = torch.where(c < keep, new, h)
    return torch.stack(outs, dim=1), h


def mamba2_serve(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                 state: Dict[str, torch.Tensor], n_new: torch.Tensor):
    """Chunked serve step: C masked single-token updates of the SSD state.
    u: [B, C, D].  The heads are those of ``p`` (all, or a rank's block);
    the gated norm's mean of squares and ``out_proj``'s partial products
    are each summed over the model group once (``model_all_reduce``)."""
    B_, C, _ = u.shape
    nh, hd = p["A_log"].shape[-1], cfg.ssm_head_dim
    d_inner = mamba2_dims(cfg)["d_inner"]
    dt_ = cfg.dtype
    z, xbc, dtr = _mamba2_split(p, u @ p["in_proj"].to(dt_))
    xbc, conv_state = conv_chunk(xbc, state["conv"], p["conv_w"].to(dt_),
                                 p["conv_b"].to(dt_), n_new)
    x, Bm, Cm = _mamba2_xbc_split(p, xbc)
    x = x.reshape(B_, C, nh, hd).float()
    Bm, Cm = Bm.float(), Cm.float()                              # [B, C, st]
    dt = F.softplus(dtr.float() + p["dt_bias"].float())          # [B, C, nh]
    dec = torch.exp(dt * -torch.exp(p["A_log"].float()))         # [B, C, nh]
    inp = Bm[:, :, None, :, None] * (x * dt[..., None])[:, :, :, None, :]
    hs, h = _masked_recurrence(                         # h: [B, nh, st, hd]
        lambda c, h: h * dec[:, c, :, None, None] + inp[:, c],
        state["ssd"], n_new, C)
    y = torch.einsum("bcs,bchsd->bchd", Cm, hs)
    y = y + x * p["D_skip"].float()[None, None, :, None]
    y = rmsnorm_gated(y.reshape(B_, C, nh * hd), z, p["norm_w"], dt_,
                      full=d_inner)
    out = y @ p["out_proj"].to(dt_)
    if model_split(p["out_proj"].shape[0], d_inner, "Mamba2's out_proj"):
        out = model_all_reduce(out)      # this rank's heads: a partial sum
    return out, {"conv": conv_state, "ssd": h}


# ---------------------------------------------------------------------------
# RG-LRU (griffin / recurrentgemma recurrent block)
# ---------------------------------------------------------------------------

_RG_C = 8.0


def rglru_init(cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    L = cfg.lru_width or cfg.d_model
    pd = cfg.param_dtype
    return {
        "proj_x": ParamSpec((D, L), ("embed", "ffn"), pd),
        "proj_gate": ParamSpec((D, L), ("embed", "ffn"), pd),
        "conv_w": ParamSpec((L, 4), ("ffn", None), pd, scale=0.5),
        "conv_b": ParamSpec((L,), ("ffn",), pd, init="zeros"),
        "w_i": ParamSpec((L, L), ("ffn", "ffn2"), pd),
        "b_i": ParamSpec((L,), ("ffn",), pd, init="zeros"),
        "w_r": ParamSpec((L, L), ("ffn", "ffn2"), pd),
        "b_r": ParamSpec((L,), ("ffn",), pd, init="zeros"),
        "a_param": ParamSpec((L,), ("ffn",), pd, init="ones", scale=1.0),
        "out_proj": ParamSpec((L, D), ("ffn", "embed"), pd),
    }


def _rglru_coeffs(p: Dict, cfg: ModelConfig, xc: torch.Tensor):
    """xc: [..., L] post-conv activations -> (a, gated_x) float32.  On a
    rank that holds its block of the channels (``w_r`` / ``w_i`` rows,
    their columns whole), both gates' partial pre-activations are summed
    over the model group in one ``model_psum`` (each rank's grad of the
    sum covers its own channels only) and the rank takes its own
    channels' columns."""
    dt = cfg.dtype
    local, full = xc.shape[-1], cfg.lru_width or cfg.d_model
    pre_r, pre_i = xc @ p["w_r"].to(dt), xc @ p["w_i"].to(dt)
    if model_split(local, full, "the RG-LRU's channels"):
        pre = model_psum(torch.cat([pre_r, pre_i], dim=-1))
        lo = model_rank() * local
        pre_r = pre[..., lo:lo + local]
        pre_i = pre[..., full + lo:full + lo + local]
    r = torch.sigmoid((pre_r + p["b_r"].to(dt)).float())
    i = torch.sigmoid((pre_i + p["b_i"].to(dt)).float())
    log_a = -_RG_C * F.softplus(p["a_param"].float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = xc.float() * i * mult
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over dim 1 from h_{-1} = 0, as a doubling
    (Hillis-Steele) scan: log2 S rounds, each composing every position
    with the one ``offset`` before it by the reference's ``combine``,
    (a1, b1) then (a2, b2) -> (a2 a1, a2 b1 + b2).  Products only, no
    division: ``a_t`` can be ~1e-3, so its running product underflows
    within a few dozen steps, and a form that divides by it (h = A
    cumsum(b / A)) overflows.  Out of place, so autograd differentiates
    it.  In float32 it agrees with ``jax.lax.associative_scan`` (another
    tree over the same products) to 1e-5."""
    S = a.shape[1]
    offset = 1
    while offset < S:
        a_prev = F.pad(a[:, :-offset], (0, 0, offset, 0), value=1.0)
        b_prev = F.pad(b[:, :-offset], (0, 0, offset, 0))
        b = a * b_prev + b
        a = a * a_prev
        offset *= 2
    return b


def rglru_train(p: Dict, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """u: [B, S, D] -> [B, S, D] via h_t = a_t * h_{t-1} + m_t * x_t
    (``linear_scan`` over S).  The channels are those of ``p`` (all, or
    a rank's block under the mesh train step): ``u`` enters ``proj_x``
    and ``proj_gate`` through one column-parallel entry, and
    ``out_proj``'s partial products are summed over the model group."""
    dt = cfg.dtype
    split = model_split(p["out_proj"].shape[0], cfg.lru_width or cfg.d_model,
                        "the RG-LRU's out_proj")
    if split:
        u = model_entry(u)
    gate = F.gelu((u @ p["proj_gate"].to(dt)).float(), approximate="tanh")
    x = u @ p["proj_x"].to(dt)
    xc = causal_conv1d(x, p["conv_w"].to(dt), p["conv_b"].to(dt))
    a, gated = _rglru_coeffs(p, cfg, xc)
    h = linear_scan(a, gated)
    y = (gate * h).to(dt)
    out = y @ p["out_proj"].to(dt)
    if split:
        out = model_all_reduce(out)      # this rank's channels: a partial sum
    return out


def rglru_init_state(cfg: ModelConfig, batch: int, *, device: torch.device,
                     layers: Optional[int]) -> Dict[str, torch.Tensor]:
    """Zeroed state of ``layers`` stacked blocks (None: one block, no layer
    dim): conv [L, B, 3, lru] in ``cfg.dtype`` and h [L, B, lru] in
    float32."""
    L = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros(_stacked(layers, batch, 3, L), dtype=cfg.dtype,
                            device=device),
        "h": torch.zeros(_stacked(layers, batch, L), dtype=torch.float32,
                         device=device),
    }


def rglru_serve(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                state: Dict[str, torch.Tensor], n_new: torch.Tensor):
    """Chunked serve step: C masked single-token updates of ``h``.
    u: [B, C, D].  The channels are those of ``p`` (all, or a rank's
    block): the gates' pre-activations and ``out_proj``'s partial
    products are each summed over the model group once."""
    dt = cfg.dtype
    C = u.shape[1]
    gate = F.gelu((u @ p["proj_gate"].to(dt)).float(), approximate="tanh")
    xc, conv_state = conv_chunk(u @ p["proj_x"].to(dt), state["conv"],
                                p["conv_w"].to(dt), p["conv_b"].to(dt), n_new)
    a, gated = _rglru_coeffs(p, cfg, xc)                         # [B, C, L]
    hs, h = _masked_recurrence(lambda c, h: a[:, c] * h + gated[:, c],
                               state["h"], n_new, C)
    out = (gate * hs).to(dt) @ p["out_proj"].to(dt)
    if model_split(p["out_proj"].shape[0], cfg.lru_width or cfg.d_model,
                   "the RG-LRU's out_proj"):
        out = model_all_reduce(out)      # this rank's channels: a partial sum
    return out, {"conv": conv_state, "h": h}


def rglru_decode(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                 state: Dict[str, torch.Tensor]):
    """Single-token recurrent step (u: [B, 1, D]): the C=1 serve step."""
    return rglru_serve(p, cfg, u, state, torch.ones(
        u.shape[0], dtype=torch.int32, device=u.device))
