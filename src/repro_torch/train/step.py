"""The train_step builder (port of ``repro/train/step.py``): microbatch
gradient accumulation into float32 buffers, the optional compressed
reduction across ranks, and the AdamW update.

    train_step, init_state = make_train_step(api, opt_cfg, microbatches=4)
    state = init_state(params, device="cuda")
    state, metrics = train_step(state, batch)      # metrics: loss, grad_norm, lr

``state = {"params", "opt"}``; the step updates it in place (the
reference's jitted step donates it).  Gradients come from
``torch.autograd.grad`` over the flattened parameter leaves, taken through
detached aliases so the caller's parameters never require grad.

Given ``pod_group`` (a ``torch.distributed`` process group, one process
per rank: the reference's ``"pod"`` mesh axis), each rank computes the
grads of its own rows of the batch, and the group's mean runs through
``dist.compression.bucketed_compressed_psum`` with this rank's
error-feedback residuals, ``state["err"]`` (one float32 buffer per
bucket of ``grad_bucket_plan``); the loss is averaged over the group,
then every rank runs the same AdamW update on the same reduced grads, so
the replicated parameters stay bitwise equal.  ``codec="none"`` takes the
exact float32 mean instead (the reference's uncompressed pod reduction),
and so does an encoder-decoder, as in the reference.

Not ported: the mesh, the shardings (FSDP / TP over ``dist.sharding``
rules, ``models/shardctx.py``'s activation hints, the ``gspmd`` /
``shard_map`` variants of ``serve/step.py``) and ``pod_err_struct`` (the
residuals' shapes for the dry run's lowering): each rank holds whole
parameters.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..dist import compression
from ..kernels.common import resolve_device
from ..models.registry import ModelAPI
from ..tree import leaves, unflatten
from .optimizer import AdamWConfig, adamw_init, adamw_update


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


def grad_bucket_plan(api: ModelAPI, *, bucket_elems: int =
                     compression.DEFAULT_BUCKET_ELEMS
                     ) -> compression.BucketPlan:
    """The static bucket partition of this model's gradient tree (leaf
    order == param flatten order: sorted keys, as JAX flattens)."""
    sizes = [math.prod(s.shape) for s in leaves(api.init_specs())]
    return compression.plan_buckets(sizes, bucket_elems=bucket_elems)


def exact_mean(grads: Any, group) -> Any:
    """The float32 group mean of every leaf, in place (the uncompressed
    reduction)."""
    for g in leaves(grads):
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        g.div_(dist.get_world_size(group))
    return grads


def make_train_step(api: ModelAPI, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, impl: Optional[str] = None,
                    pod_group=None, codec: str = "int8",
                    bucket_elems: int = compression.DEFAULT_BUCKET_ELEMS,
                    topk_frac: float = 0.01):
    """Returns (train_step, init_state).

    train_step(state, batch) -> (state, metrics), state = {params, opt}
    and, when the group's reduction is compressed, ``err``;
    init_state(params, device=...) -> the state, every leaf on ``device``.
    ``batch`` holds this rank's rows.  ``codec`` is one of
    ``compression.CODECS`` or ``"none"``.
    """
    if codec not in compression.CODECS + ("none",):
        raise ValueError(f"unknown codec {codec!r}; expected one of "
                         f"{compression.CODECS + ('none',)}")
    loss_and_grad = make_loss_and_grad(api, microbatches, impl=impl)
    # an encoder-decoder's pod reduction is uncompressed, as in the
    # reference (there XLA's partitioner fails on its embedding inside a
    # manual pod region; here the rule is kept for parity)
    compress = (pod_group is not None and codec != "none"
                and api.cfg.family != "encdec")
    plan = grad_bucket_plan(api, bucket_elems=bucket_elems) \
        if compress else None

    def train_step(state: Dict, batch: Dict):
        loss, grads = loss_and_grad(state["params"], batch)
        new = {}
        if compress:
            grads, new["err"] = compression.bucketed_compressed_psum(
                grads, state["err"], pod_group, plan=plan, codec=codec,
                topk_frac=topk_frac)
        elif pod_group is not None:
            grads = exact_mean(grads, pod_group)
        if pod_group is not None:
            loss = loss.reshape(1).clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=pod_group)
            loss = loss[0] / dist.get_world_size(pod_group)
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                            state["opt"])
        del grads
        metrics["loss"] = loss
        return {"params": params, "opt": opt, **new}, metrics

    def init_state(params: Any, device="cuda") -> Dict:
        dev = resolve_device(device)
        params = unflatten(params, [p.to(dev) for p in leaves(params)])
        state = {"params": params, "opt": adamw_init(params)}
        if compress:
            state["err"] = compression.init_residuals(plan, device=dev)
        return state

    return train_step, init_state
