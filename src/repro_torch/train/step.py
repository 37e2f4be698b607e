"""The train_step builder on one device (port of ``repro/train/step.py``):
microbatch gradient accumulation into float32 buffers and the AdamW
update.

    train_step, init_state = make_train_step(api, opt_cfg, microbatches=4)
    state = init_state(params, device="cuda")
    state, metrics = train_step(state, batch)      # metrics: loss, grad_norm, lr

``state = {"params", "opt"}``; the step updates it in place (the
reference's jitted step donates it).  Gradients come from
``torch.autograd.grad`` over the flattened parameter leaves, taken through
detached aliases so the caller's parameters never require grad.  The
mesh, the shardings and the compressed pod reduction have no one-device
counterpart (ROADMAP queue 1, item 5).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..kernels.common import resolve_device
from ..models.registry import ModelAPI
from .optimizer import AdamWConfig, adamw_init, adamw_update, leaves, unflatten


def _split_microbatch(batch: Dict, n: int, i: int) -> Dict:
    return {k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
            for k, x in batch.items()}


def make_loss_and_grad(api: ModelAPI, microbatches: int, *,
                       impl: Optional[str] = None) -> Callable:
    """(params, batch) -> (loss, grads): the mean of the microbatches'
    losses and grads, each grad divided by ``microbatches`` and added into
    a float32 buffer, as the reference's scan does."""

    def value_and_grad(params: Any, batch: Dict):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss = api.loss(unflatten(params, flat), batch, impl=impl)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), list(grads)

    def loss_and_grad(params: Any, batch: Dict):
        if microbatches <= 1:
            loss, grads = value_and_grad(params, batch)
            return loss, unflatten(params, grads)
        loss_acc = 0.0
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        for i in range(microbatches):
            loss, grads = value_and_grad(
                params, _split_microbatch(batch, microbatches, i))
            for a, g in zip(acc, grads):
                a.add_(g / microbatches)
            del grads
            loss_acc = loss_acc + loss / microbatches
        return loss_acc, unflatten(params, acc)

    return loss_and_grad


def make_train_step(api: ModelAPI, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, impl: Optional[str] = None):
    """Returns (train_step, init_state).

    train_step(state, batch) -> (state, metrics), state = {params, opt};
    init_state(params, device=...) -> the state, every leaf on ``device``.
    """
    loss_and_grad = make_loss_and_grad(api, microbatches, impl=impl)

    def train_step(state: Dict, batch: Dict):
        loss, grads = loss_and_grad(state["params"], batch)
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                            state["opt"])
        del grads
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    def init_state(params: Any, device="cuda") -> Dict:
        dev = resolve_device(device)
        params = unflatten(params, [p.to(dev) for p in leaves(params)])
        return {"params": params, "opt": adamw_init(params)}

    return train_step, init_state
