"""Norms, Mamba2's gated RMSNorm, dense MLP variants and the MoE channel
mixer (port of ``repro/models/layers.py``).

Norms compute in float32 and cast back to ``cfg.dtype``; parameters are
cast to ``cfg.dtype`` at each use (``x @ w.to(dt)``), as the reference
does — a no-op when the serving engine already cast them once at load.
The MoE's load-balance loss (``moe_aux_loss``) is ported with the
reference's; as there, no loss calls it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .shardctx import (data_prefix, data_size, model_all_reduce,
                       model_entry, model_psum, model_rank, model_split)
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
                  dtype, full: Optional[int] = None) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(gate)) * w, in float32.
    ``full``: the whole width, where ``x`` may hold a rank's block of it
    (the mesh serve and train steps' heads): each rank's sum of squares
    is then summed over the model group before the mean
    (``model_psum``: each rank's grad of the sum covers its own heads
    only)."""
    xf = (x * F.silu(gate.float())).float()
    if full is not None and model_split(xf.shape[-1], full,
                                        "Mamba2's gated norm"):
        var = model_psum((xf ** 2).sum(-1, keepdim=True)) / full
    else:
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
    """The dense MLP; a rank's block of FFN columns enters ``x`` through
    the column-parallel entry and sums ``wo``'s partial products over the
    model group, then adds ``bo`` once."""
    dt = cfg.dtype
    split = model_split(p["wo"].shape[0], cfg.d_ff, "the MLP's wo")
    if split:
        x = model_entry(x)
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
    if split:
        out = model_all_reduce(out)      # partial sums, before the bias
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
    its row of the dispatch buffer, ``E * rows`` (the overflow row) where
    it does not; rows, each expert's buffer rows).

    Under the mesh serve step's ``gspmd`` variant, and in the mesh train
    step, with the batch split over data shards (``shardctx.data_size()
    > 1``), the capacity and the running count are the whole batch's (a
    training microbatch's), as the reference's one program counts them:
    T is every shard's rows, and each pick's place adds the picks of its
    expert on the data shards before this one (``shardctx.data_prefix``,
    int counts that carry no grad).  ``rows`` is then the capacity or
    this shard's T*K picks, whichever is fewer; elsewhere it is the
    capacity.
    """
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = (xt @ p["router"].to(cfg.dtype)).float()            # [T, E]
    weights, experts = top_k_experts(logits, K)
    weights = torch.softmax(weights, dim=-1)
    # each expert's buffer rows: exact (no pick can drop) while T*K <= 4E,
    # as at decode; else capacity factor 2
    shards = data_size()
    Tc = T * shards
    capacity = Tc * K if Tc * K <= 4 * E else max(1, int(2 * Tc * K // E))
    flat_expert = experts.reshape(-1)                             # [T*K]
    # each pick's place in its expert's buffer: the exclusive running count
    # of earlier picks of that expert
    onehot = F.one_hot(flat_expert, E)                            # [T*K, E]
    counts = onehot.cumsum(0)
    pos = (counts - onehot).gather(1, flat_expert[:, None])[:, 0]
    keep = pos < capacity
    if shards > 1:                  # earlier data shards' picks go first
        keep = pos + data_prefix(counts[-1])[flat_expert] < capacity
    rows = min(capacity, T * K)
    slot = torch.where(keep, flat_expert * rows + pos,
                       torch.full_like(pos, E * rows))
    return weights, experts, keep, slot, rows


def moe_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Fixed-capacity token-choice routing over every row of x [B, S, D]
    (pad rows of a serve step included: they take capacity as real tokens
    do, as in the reference).  Dispatch and combine are index copies and
    gathers; picks past an expert's capacity land in the overflow row,
    whose output is zero, and their combine weight is zero.  The expert
    products are batched matmuls over [E, rows, D].

    On a rank of the mesh serve step (expert parallelism): the router is
    replicated, so every rank of the model group routes its data shard's
    rows alike; a rank that holds ``E / model`` whole experts dispatches
    only the picks of its own experts (the others' go to the overflow
    row) and combines their weights; a rank whose experts are whole but
    whose ``"ffn"`` is split (``E`` not divisible) runs every expert on
    its FFN columns (SwiGLU separates over F).  The shared experts' FFN
    is split over ``"ffn"``.  One ``model_all_reduce`` sums the routed
    and shared partials; the activations are replicated over the model
    group, so no all-to-all is needed.

    Differentiated (the mesh train step), a rank's routed partial feeds
    the grads of the routing ``weights`` and of the dispatched rows only
    through its own experts (or FFN columns), and the split shared
    experts' input only through their columns: each takes a
    ``model_entry``, whose backward sums its grad over the model group.
    The router's path then carries the whole grad on every model rank,
    so the router, replicated over "model", needs no model reduction of
    its grad (and no entry on ``x`` in front of it, which would count
    that path once a rank)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = cfg.dtype
    T = B * S
    xt = x.reshape(T, D)
    weights, _, keep, slot, rows = moe_route(p, cfg, xt)
    E_local = p["wi_gate"].shape[0]
    xin = xt
    split = model_split(p["wi_gate"].shape[-1], cfg.moe_d_ff,
                        "the MoE's expert FFN")
    if model_split(E_local, E, "the MoE's experts"):
        first = model_rank() * E_local * rows        # this rank's experts
        mine = (slot >= first) & (slot < first + E_local * rows)
        slot = torch.where(mine, slot - first,
                           torch.full_like(slot, E_local * rows))
        keep = keep & mine
        split = True
    shared_split = bool(cfg.n_shared_experts) and model_split(
        p["shared"]["wo"].shape[0], cfg.n_shared_experts * cfg.moe_d_ff,
        "the MoE's shared experts")
    if split:       # this rank's experts or columns: partial grads
        weights = model_entry(weights)
        xin = model_entry(xt)

    buf = torch.zeros((E_local * rows + 1, D), dtype=dt, device=x.device)
    buf[slot] = xin.repeat_interleave(K, dim=0)  # overflow writes discarded
    hidden = buf[:E_local * rows].reshape(E_local, rows, D)
    h = F.silu(torch.bmm(hidden, p["wi_gate"].to(dt))) \
        * torch.bmm(hidden, p["wi_up"].to(dt))
    out_e = torch.bmm(h, p["wo"].to(dt))
    out_flat = torch.cat([out_e.reshape(E_local * rows, D),
                          torch.zeros((1, D), dtype=dt, device=x.device)])

    gathered = out_flat[slot].reshape(T, K, D)
    w = (weights * keep.reshape(T, K)).to(dt)
    out = torch.einsum("tkd,tk->td", gathered, w)

    if cfg.n_shared_experts:
        sp = p["shared"]
        xs = xt
        if shared_split:   # one entry for both sides where both are split
            xs = xin if split else model_entry(xt)
        h = F.silu(xs @ sp["wi_gate"].to(dt)) * (xs @ sp["wi_up"].to(dt))
        shared = h @ sp["wo"].to(dt)
        if shared_split != split:
            # one side whole, the other a partial sum: sum the partial alone
            if split:
                out, split = model_all_reduce(out), False
            else:
                shared = model_all_reduce(shared)
        out = out + shared
    if split:
        out = model_all_reduce(out)      # every rank's experts' partials
    return out.reshape(B, S, D)


def moe_aux_loss(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style fraction * prob) of x [B,
    S, D]: E * sum_e (share of the top-k picks that chose e) * (mean router
    probability of e), the picks taken as ``moe_route`` takes them."""
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, x.shape[-1])
    logits = (xt @ p["router"].to(cfg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    _, experts = top_k_experts(logits, K)
    counts = torch.bincount(experts.reshape(-1), minlength=E).float()
    frac = counts / counts.sum()
    return E * torch.sum(frac * probs.mean(0))
