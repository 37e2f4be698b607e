"""State-space layers (port of ``repro/models/ssm.py``): Mamba2 SSD and
the RG-LRU (griffin / recurrentgemma recurrent block).

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

The RG-LRU keeps the reference's cast points: its products run in
``cfg.dtype``, its sigmoid, softplus and exp in float32, and it reads
``a_param`` in float32 (``spec.FLOAT32_KEYS``).  Training
(``rglru_train``) runs the linear recurrence ``h_t = a_t h_{t-1} + b_t``
as a doubling scan over S where the reference runs
``jax.lax.associative_scan``; serving (``rglru_serve``) is the masked
per-token recurrence, as Mamba2's.  Neither has a kernel: the reference
has no Pallas kernel for them either.
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
    """xc: [..., L] post-conv activations -> (a, gated_x) float32."""
    dt = cfg.dtype
    r = torch.sigmoid((xc @ p["w_r"].to(dt) + p["b_r"].to(dt)).float())
    i = torch.sigmoid((xc @ p["w_i"].to(dt) + p["b_i"].to(dt)).float())
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
    (``linear_scan`` over S)."""
    dt = cfg.dtype
    gate = F.gelu((u @ p["proj_gate"].to(dt)).float(), approximate="tanh")
    x = u @ p["proj_x"].to(dt)
    xc = causal_conv1d(x, p["conv_w"].to(dt), p["conv_b"].to(dt))
    a, gated = _rglru_coeffs(p, cfg, xc)
    h = linear_scan(a, gated)
    y = (gate * h).to(dt)
    return y @ p["out_proj"].to(dt)


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
    """Chunked serve step: C masked single-token updates.  u: [B, C, D]."""
    return _masked_state_scan(
        lambda u_c, st: rglru_decode(p, cfg, u_c, st), u, state, n_new)


def rglru_decode(p: Dict, cfg: ModelConfig, u: torch.Tensor,
                 state: Dict[str, torch.Tensor]):
    """Single-token recurrent step. u: [B, 1, D]."""
    dt = cfg.dtype
    gate = F.gelu((u[:, 0] @ p["proj_gate"].to(dt)).float(),
                  approximate="tanh")
    x = u[:, 0] @ p["proj_x"].to(dt)
    xc, conv_state = conv_step(x, state["conv"], p["conv_w"].to(dt),
                               p["conv_b"].to(dt))
    a, gated = _rglru_coeffs(p, cfg, xc)
    h = a * state["h"] + gated
    y = (gate * h).to(dt)
    out = (y @ p["out_proj"].to(dt))[:, None, :]
    return out, {"conv": conv_state, "h": h}
