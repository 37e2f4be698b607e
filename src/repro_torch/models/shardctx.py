"""The serve step's collective points over the model (tensor-parallel)
group: the port's counterpart of ``repro/models/shardctx.py``.

``serving_model_group(group)`` installs the ``torch.distributed`` group
of the ranks that split one model's heads, FFN and vocabulary (the
reference's ``serving_model_axis``, ``:53-59``); the model code calls

  * ``model_all_reduce(x)``: the sum over the group of each rank's
    partial product (after ``wo`` of the attention and of the MLP, and the
    vocab-parallel embedding lookup);
  * ``gather_vocab(x)``: the logits' vocab slices of every rank,
    concatenated in rank order along the last dim;
  * ``model_rank()``: this rank's index in the group (its vocab block).

Outside a context (or in a group of one rank) each returns ``x``
unchanged and ``model_rank()`` is 0, as the reference's ``constrain_*``
are no-ops outside theirs.  The model code calls the collectives only
where ``model_split`` finds a weight's width split (``dist.sharding``
shards whole heads; a dim that does not divide stays replicated), and
``model_split`` raises where a split width has no group to account for
it: outside a context, partial sums or one rank's vocab block would pass
for the whole.

Both collectives run on the step's own tensors through the group's
backend: NCCL a card, gloo where ranks share a card (NCCL refuses two
ranks on one device).  A backend that cannot run one on those tensors
raises; nothing is handed to another backend or to the host.  (Torch's
backend table lists gloo's ``all_gather`` as CPU-only; on the H100 with
torch 2.11 it gathers CUDA tensors, and ``chip_smoke.py`` phase 17
probes it before each run.)

No counterpart, by design: ``activation_batch_axes``,
``constrain_batch``, ``constrain_dim_model`` and ``constrain_moe_buffer``
are layout hints to XLA's SPMD partitioner.  Eager PyTorch has no
partitioner: each rank holds its own shard and runs its own program, and
the collectives above are all the serve step exchanges.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional

import torch
import torch.distributed as dist

_MODEL_GROUP: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("serving_model_group", default=None)


@contextlib.contextmanager
def serving_model_group(group: Optional[Any]):
    """Installs ``group`` (a ``torch.distributed`` process group, or None
    for no model split) for the model code's collectives."""
    token = _MODEL_GROUP.set(group)
    try:
        yield
    finally:
        _MODEL_GROUP.reset(token)


def _group():
    """The installed group and its size; (None, 1) outside a context or
    in a group of one rank."""
    group = _MODEL_GROUP.get()
    if group is None:
        return None, 1
    size = dist.get_world_size(group)
    return (group, size) if size > 1 else (None, 1)


def model_split(local: int, full: int, what: str) -> bool:
    """Whether a weight that holds ``local`` of the model's ``full`` rows
    or columns (heads, FFN or vocabulary) was split over the installed
    group: False when it is whole; True when the group's size times
    ``local`` is ``full``.  A split weight outside a context (or in a
    group of one rank), or in a group of another size, raises
    ``ValueError``."""
    if local == full:
        return False
    _, size = _group()
    if local * size != full:
        where = (f"a model group of {size} ranks" if size > 1 else
                 "no model group (serve a sharded tree through "
                 "serve.step.make_serve_step's step)")
        raise ValueError(f"{what} holds {local} of {full}, split, under "
                         f"{where}")
    return True


def model_rank() -> int:
    group, _ = _group()
    if group is None:
        return 0
    return dist.get_rank(group)


def model_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group (in place on a contiguous
    ``x``, which is returned)."""
    group, _ = _group()
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def gather_vocab(x: torch.Tensor) -> torch.Tensor:
    """``[.., V / m]`` slices of every rank -> ``[.., V]``, rank-major."""
    group, size = _group()
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)
