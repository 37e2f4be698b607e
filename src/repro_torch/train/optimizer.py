"""AdamW with decoupled weight decay, global-norm clipping and linear
warmup + cosine decay (port of ``repro/train/optimizer.py``), on the same
nested dicts of tensors, walked in sorted-key order as JAX flattens them
(``repro_torch.tree``).

Where the reference returns new parameters and moments (and its train
step donates the old ones), ``adamw_update`` updates params, mu and nu IN
PLACE under ``torch.no_grad()`` and returns the same tensors: at full
width the state is tens of GB, and a second copy would not fit beside it.
The schedule, the bias corrections and the clip scale are float32 tensors
on the state's device, as in the reference.  Over a mesh each rank holds
its shards of params, mu and nu, and the clip reads the whole model's
norm (``sharded_norm``), so every rank scales by the reference's
factor."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from ..tree import leaves, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def adamw_init(params: Any) -> Dict:
    zeros = lambda t: unflatten(t, [torch.zeros_like(x) for x in leaves(t)])
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return {"mu": zeros(params), "nu": zeros(params), "step": step}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def sharded_norm(tree: Any, owned: Sequence[Any], group=None
                 ) -> torch.Tensor:
    """The global norm of a tree sharded over the ranks of ``group`` (the
    mesh's ``group``, None for the default one; a pod's own ranks where
    every pod holds the whole tree): each rank sums the squares of what
    it owns of each leaf (``owned``, in ``leaves`` order, ``dist.sharding.
    norm_share``'s: True for the whole block, False for none of it, or
    ``(dim, pieces)``, the (start, width) pieces of ``dim`` it owns; a
    piece held by several ranks is owned by one), one all-reduce sums the
    ranks' sums, then the square root."""
    flat = leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for x, own in zip(flat, owned, strict=True):
        if isinstance(own, tuple):
            dim, pieces = own
            for start, width in pieces:
                sq = sq + torch.sum(torch.square(
                    x.narrow(dim, start, width).float()))
        elif own:
            sq = sq + torch.sum(torch.square(x.float()))
    sq = sq.reshape(1)
    dist.all_reduce(sq, group=group)
    return torch.sqrt(sq[0])


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: Dict, *, norm: Callable[[Any], torch.Tensor] =
                 global_norm) -> Tuple[Any, Dict, Dict]:
    """Returns (params, state, metrics); params, ``state["mu"]`` and
    ``state["nu"]`` are the given tensors, updated in place.  ``norm``
    gives the grads' global norm, which the clip reads (``sharded_norm``
    over a mesh)."""
    with torch.no_grad():
        step = state["step"]
        gnorm = norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = schedule(cfg, step)
        b1, b2 = cfg.beta1, cfg.beta2
        t = (step + 1).float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        for p, g, mu, nu in zip(leaves(params), leaves(grads),
                                leaves(state["mu"]), leaves(state["nu"])):
            g32 = g.float() * scale
            mu.copy_(b1 * mu + (1 - b1) * g32)
            nu.copy_(b2 * nu + (1 - b2) * g32 * g32)
            step_d = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            p32 = p.float()
            p.copy_(p32 - lr * (step_d + cfg.weight_decay * p32))
        state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}
