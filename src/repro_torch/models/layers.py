"""Norms, Mamba2's gated RMSNorm, dense MLP variants and the MoE channel
mixer (port of ``repro/models/layers.py``).

Norms compute in float32 and cast back to ``cfg.dtype``; parameters are
cast to ``cfg.dtype`` at each use (``x @ w.to(dt)``), as the reference
does — a no-op when the serving engine already cast them once at load.
The MoE's load-balance loss (``moe_aux_loss``) belongs to training
(ROADMAP queue 1, item 3.2).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .spec import ParamSpec


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, d: Optional[int] = None) -> Dict:
    d = d or cfg.d_model
    p = {"w": ParamSpec((d,), ("embed",), cfg.param_dtype, init="ones")}
    if cfg.norm == "layernorm":
        p["b"] = ParamSpec((d,), ("embed",), cfg.param_dtype, init="zeros")
    return p


def norm_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
        out = out * p["w"].float() + p["b"].float()
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["w"].float()
    return out.to(cfg.dtype)


def rmsnorm_gated(x: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(gate)) * w, in float32."""
    xf = (x * F.silu(gate.float())).float()
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * w.float()).to(dtype)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------


def mlp_init(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    pd = cfg.param_dtype
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamSpec((D, Fd), ("embed", "ffn"), pd),
            "wi_up": ParamSpec((D, Fd), ("embed", "ffn"), pd),
            "wo": ParamSpec((Fd, D), ("ffn", "embed"), pd),
        }
    p = {
        "wi": ParamSpec((D, Fd), ("embed", "ffn"), pd),
        "wo": ParamSpec((Fd, D), ("ffn", "embed"), pd),
    }
    if cfg.norm == "layernorm":  # bias-ful families (whisper, starcoder2)
        p["bi"] = ParamSpec((Fd,), ("ffn",), pd, init="zeros")
        p["bo"] = ParamSpec((D,), ("embed",), pd, init="zeros")
    return p


def mlp_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.dtype
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wi_gate"].to(dt)) * (x @ p["wi_up"].to(dt))
    elif cfg.mlp == "geglu":
        h = F.gelu(x @ p["wi_gate"].to(dt), approximate="tanh") \
            * (x @ p["wi_up"].to(dt))
    elif cfg.mlp == "gelu":
        h = x @ p["wi"].to(dt)
        if "bi" in p:
            h = h + p["bi"].to(dt)
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp == "relu2":
        h = F.relu(x @ p["wi"].to(dt)) ** 2
    else:
        raise ValueError(cfg.mlp)
    out = h @ p["wo"].to(dt)
    if "bo" in p:
        out = out + p["bo"].to(dt)
    return out


# ---------------------------------------------------------------------------
# MoE: token-choice top-k, fixed capacity, index dispatch
# ---------------------------------------------------------------------------


def moe_init(cfg: ModelConfig) -> Dict:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    pd = cfg.param_dtype
    p = {
        "router": ParamSpec((D, E), ("embed", None), pd, scale=0.02),
        "wi_gate": ParamSpec((E, D, Fd), ("expert", "embed", "ffn"), pd),
        "wi_up": ParamSpec((E, D, Fd), ("expert", "embed", "ffn"), pd),
        "wo": ParamSpec((E, Fd, D), ("expert", "ffn", "embed"), pd),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * cfg.moe_d_ff
        p["shared"] = {
            "wi_gate": ParamSpec((D, Fs), ("embed", "ffn"), pd),
            "wi_up": ParamSpec((D, Fs), ("embed", "ffn"), pd),
            "wo": ParamSpec((Fs, D), ("ffn", "embed"), pd),
        }
    return p


def top_k_experts(logits: torch.Tensor, K: int):
    """(values, indices) of each row's K largest logits, as jax.lax.top_k
    takes them: descending, ties to the lower expert index (a stable sort:
    torch.topk leaves the order of ties open, and bf16 router logits tie
    often enough to matter)."""
    values, experts = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)
    return values[:, :K], experts[:, :K]


def moe_route(p: Dict, cfg: ModelConfig, xt: torch.Tensor):
    """The router of T tokens xt [T, D]: (weights [T, K] float32, softmax
    over the K picks; experts [T, K]; keep [T*K], whether each (token, k)
    pick, in token-major order, fits its expert's capacity; slot [T*K],
    its row of the dispatch buffer, ``E * capacity`` (the overflow row)
    where it does not; capacity)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = (xt @ p["router"].to(cfg.dtype)).float()            # [T, E]
    weights, experts = top_k_experts(logits, K)
    weights = torch.softmax(weights, dim=-1)
    # each expert's buffer rows: exact (no pick can drop) while T*K <= 4E,
    # as at decode; else capacity factor 2
    capacity = T * K if T * K <= 4 * E else max(1, int(2 * T * K // E))
    flat_expert = experts.reshape(-1)                             # [T*K]
    # each pick's place in its expert's buffer: the exclusive running count
    # of earlier picks of that expert
    onehot = F.one_hot(flat_expert, E)                            # [T*K, E]
    pos = (onehot.cumsum(0) - onehot).gather(1, flat_expert[:, None])[:, 0]
    keep = pos < capacity
    slot = torch.where(keep, flat_expert * capacity + pos,
                       torch.full_like(pos, E * capacity))
    return weights, experts, keep, slot, capacity


def moe_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Fixed-capacity token-choice routing over every row of x [B, S, D]
    (pad rows of a serve step included: they take capacity as real tokens
    do, as in the reference).  Dispatch and combine are index copies and
    gathers; picks past an expert's capacity land in the overflow row,
    whose output is zero, and their combine weight is zero.  The expert
    products are batched matmuls over [E, capacity, D]."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = cfg.dtype
    T = B * S
    xt = x.reshape(T, D)
    weights, _, keep, slot, capacity = moe_route(p, cfg, xt)

    buf = torch.zeros((E * capacity + 1, D), dtype=dt, device=x.device)
    buf[slot] = xt.repeat_interleave(K, dim=0)   # overflow writes discarded
    hidden = buf[:E * capacity].reshape(E, capacity, D)
    h = F.silu(torch.bmm(hidden, p["wi_gate"].to(dt))) \
        * torch.bmm(hidden, p["wi_up"].to(dt))
    out_e = torch.bmm(h, p["wo"].to(dt))
    out_flat = torch.cat([out_e.reshape(E * capacity, D),
                          torch.zeros((1, D), dtype=dt, device=x.device)])

    gathered = out_flat[slot].reshape(T, K, D)
    w = (weights * keep.reshape(T, K)).to(dt)
    out = torch.einsum("tkd,tk->td", gathered, w)

    if cfg.n_shared_experts:
        sp = p["shared"]
        h = F.silu(xt @ sp["wi_gate"].to(dt)) * (xt @ sp["wi_up"].to(dt))
        out = out + h @ sp["wo"].to(dt)
    return out.reshape(B, S, D)
