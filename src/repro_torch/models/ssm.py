"""Mamba2 SSD layers (port of the Mamba2 half of ``repro/models/ssm.py``).

Training (``mamba2_train``) uses the chunked block decomposition of the
reference: the intra-chunk term is the ``ssd_chunk`` op (the hand-written
kernel on a CUDA tensor, its plain version on the CPU), where the
reference builds the same contraction inline; the O(S/chunk) inter-chunk
recurrence is a Python loop over the chunks, where the reference scans.
Serving (``mamba2_serve``) runs the single-token recurrence over the C
tokens of a chunk, committing the state only for tokens ``c < n_new``.

The depthwise causal convolution stays a shifted sum, as in the
reference: ``F.conv1d`` would go through cuDNN, which runs float32
convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off.
The RG-LRU (recurrentgemma) is not ported yet (ROADMAP queue 1, item 2.5).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_chunk import ssd_chunk
from .config import ModelConfig
from .layers import rmsnorm_gated
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


def conv_step(x_new: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv: x_new [B, C]; conv_state [B, W-1, C].
    Returns (out [B, C], new_state)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # [B, W, C]
    out = torch.einsum("bwc,cw->bc", window, w) + b
    return F.silu(out), window[:, 1:]


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


def _mamba2_split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d = mamba2_dims(cfg)
    di = d["d_inner"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + d["conv_dim"]]
    dt = zxbcdt[..., di + d["conv_dim"]:]
    return z, xbc, dt


def _mamba2_xbc_split(cfg: ModelConfig, xbc: torch.Tensor):
    d = mamba2_dims(cfg)
    di, ng, st = d["d_inner"], d["ngroups"], d["state"]
    return xbc[..., :di], xbc[..., di:di + ng * st], xbc[..., di + ng * st:]


def mamba2_train(p: Dict, cfg: ModelConfig, u: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Chunked SSD forward. u: [B, S, D] -> [B, S, D]."""
    d = mamba2_dims(cfg)
    B_, S, _ = u.shape
    nh, hd, st = d["nheads"], d["hd"], d["state"]
    dt_ = cfg.dtype
    cl = min(cfg.ssm_chunk, S)
    if S % cl:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {cl}")
    nc = S // cl

    zxbcdt = u @ p["in_proj"].to(dt_)
    z, xbc, dtr = _mamba2_split(cfg, zxbcdt)
    xbc = causal_conv1d(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    x, Bm, Cm = _mamba2_xbc_split(cfg, xbc)

    x = x.reshape(B_, S, nh, hd).float()
    Bm = Bm.float()                                     # [B, S, st], ngroups=1
    Cm = Cm.float()
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
    y = y.reshape(B_, S, d["d_inner"])
    y = rmsnorm_gated(y, z, p["norm_w"], dt_)
    return y @ p["out_proj"].to(dt_)


def mamba2_init_state(cfg: ModelConfig, batch: int, *, device: torch.device,
                      layers: int) -> Dict[str, torch.Tensor]:
    """Zeroed state of ``layers`` stacked blocks: conv [L, B, W-1, conv_dim]
    in ``cfg.dtype`` and ssd [L, B, nh, state, hd] in float32."""
    d = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv - 1, d["conv_dim"]),
                            dtype=cfg.dtype, device=device),
        "ssd": torch.zeros((layers, batch, d["nheads"], d["state"], d["hd"]),
                           dtype=torch.float32, device=device),
    }


def _masked_state_scan(decode_fn: Callable, u: torch.Tensor,
                       state: Dict[str, torch.Tensor], n_new: torch.Tensor):
    """Run a single-token recurrent ``decode_fn`` over the C tokens of a
    serve chunk, committing the state only for tokens ``c < n_new[b]``:
    pad tokens (and idle slots with n_new == 0) produce garbage outputs
    but never advance the recurrence.  Returns (outputs [B, C, D], final
    state)."""
    outs = []
    for c in range(u.shape[1]):
        out, new = decode_fn(u[:, c:c + 1], state)
        keep = c < n_new                                          # [B]
        state = {k: torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)),
                                v, state[k])
                 for k, v in new.items()}
        outs.append(out[:, 0])
    return torch.stack(outs, dim=1), state


def mamba2_serve(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                 state: Dict[str, torch.Tensor], n_new: torch.Tensor):
    """Chunked serve step: C masked single-token updates.  u: [B, C, D]."""
    return _masked_state_scan(
        lambda u_c, st: mamba2_decode(p, cfg, u_c, st), u, state, n_new)


def mamba2_decode(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                  state: Dict[str, torch.Tensor]):
    """Single-token recurrent step. u: [B, 1, D]."""
    d = mamba2_dims(cfg)
    B_ = u.shape[0]
    nh, hd, st = d["nheads"], d["hd"], d["state"]
    dt_ = cfg.dtype

    zxbcdt = u[:, 0] @ p["in_proj"].to(dt_)
    z, xbc, dtr = _mamba2_split(cfg, zxbcdt)
    xbc, conv_state = conv_step(xbc, state["conv"], p["conv_w"].to(dt_),
                                p["conv_b"].to(dt_))
    x, Bm, Cm = _mamba2_xbc_split(cfg, xbc)
    x = x.reshape(B_, nh, hd).float()
    Bm = Bm.reshape(B_, st).float()
    Cm = Cm.reshape(B_, st).float()
    dt = F.softplus(dtr.float() + p["dt_bias"].float())          # [B, nh]
    A = -torch.exp(p["A_log"].float())
    dec = torch.exp(dt * A)                                      # [B, nh]
    # h: [B, nh, st, hd]
    h = state["ssd"] * dec[..., None, None] \
        + Bm[:, None, :, None] * (x * dt[..., None])[:, :, None, :]
    y = torch.einsum("bs,bhsd->bhd", Cm, h)
    y = y + x * p["D_skip"].float()[None, :, None]
    y = y.reshape(B_, d["d_inner"])
    y = rmsnorm_gated(y, z, p["norm_w"], dt_)
    out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, {"conv": conv_state, "ssd": h}
