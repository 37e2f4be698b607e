"""Norms, Mamba2's gated RMSNorm and dense MLP variants (port of
``repro/models/layers.py``).

Norms compute in float32 and cast back to ``cfg.dtype``; parameters are
cast to ``cfg.dtype`` at each use (``x @ w.to(dt)``), as the reference
does — a no-op when the serving engine already cast them once at load.
MoE waits for its slice (ROADMAP queue 1, item 2.3).
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
