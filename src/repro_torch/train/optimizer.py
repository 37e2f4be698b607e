"""AdamW with decoupled weight decay, global-norm clipping and linear
warmup + cosine decay (port of ``repro/train/optimizer.py``), on the same
nested dicts of tensors, walked in sorted-key order as JAX flattens them.

Where the reference returns new parameters and moments (and its train
step donates the old ones), ``adamw_update`` updates params, mu and nu IN
PLACE under ``torch.no_grad()`` and returns the same tensors: at full
width the state is tens of GB, and a second copy would not fit beside it.
The schedule, the bias corrections and the clip scale are float32 tensors
on the state's device, as in the reference."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch


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


def leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves of nested dicts in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(like: Any, flat: List[torch.Tensor]) -> Any:
    """``flat`` (in ``leaves`` order) rebuilt into the structure of
    ``like``."""
    it = iter(flat)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


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


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: Dict) -> Tuple[Any, Dict, Dict]:
    """Returns (params, state, metrics); params, ``state["mu"]`` and
    ``state["nu"]`` are the given tensors, updated in place."""
    with torch.no_grad():
        step = state["step"]
        gnorm = global_norm(grads)
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
