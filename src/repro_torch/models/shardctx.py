"""The serve step's collective points over the mesh's groups: the
port's counterpart of ``repro/models/shardctx.py``.

``serving_mesh(model=..., data=..., variant=...)`` installs, for one
step, the ``torch.distributed`` group of the ranks that split one
model's heads, experts, FFN and vocabulary (the reference's
``serving_model_axis``, ``:53-59``), the group of the ranks that split
the batch's rows (None where the batch is not split), and the step's
variant; the model code calls

  * ``model_all_reduce(x)``: the sum over the model group of each rank's
    partial product (after ``wo`` of the attention and of the MLP, after
    the MoE's routed and shared experts, and the vocab-parallel
    embedding lookup);
  * ``gather_vocab(x)``: the logits' vocab slices of every rank,
    concatenated in rank order along the last dim;
  * ``model_rank()``: this rank's index in the model group (its vocab
    block, its experts);
  * ``data_prefix(counts)``: under the ``gspmd`` variant, the sum of
    ``counts`` over the data shards before this one (an ``all_gather``
    over the data group); the MoE's capacity count
    (``layers.moe_route``) reads it with ``data_size()``.

Outside a context (or in a group of one rank) the model collectives
return ``x`` unchanged and ``model_rank()`` is 0, as the reference's
``constrain_*`` are no-ops outside theirs; ``data_size()`` is 1 and
``data_prefix`` gives zeros.  The model code calls the collectives only
where ``model_split`` finds a weight's width split (``dist.sharding``
shards whole heads and whole experts; a dim that does not divide stays
replicated), and ``model_split`` raises where a split width has no group
to account for it: outside a context, partial sums or one rank's vocab
block would pass for the whole.

The collectives run on the step's own tensors through the group's
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
the collectives above are all the serve step exchanges.  The expert
dim's layout that ``constrain_moe_buffer`` pins is the arithmetic of
``layers.moe_apply`` here: each rank dispatches into its own experts'
buffers only.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional

import torch
import torch.distributed as dist

VARIANTS = ("gspmd", "shard_map")

_MODEL_GROUP: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("serving_model_group", default=None)
_DATA_GROUP: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("serving_data_group", default=None)
_VARIANT: contextvars.ContextVar[str] = \
    contextvars.ContextVar("serving_variant", default="gspmd")


@contextlib.contextmanager
def serving_mesh(model: Optional[Any] = None, data: Optional[Any] = None,
                 variant: str = "gspmd"):
    """Installs ``model`` (a ``torch.distributed`` process group, or None
    for no model split), ``data`` (the group of the ranks that hold the
    batch's other rows, or None where the batch is not split) and
    ``variant`` (``gspmd``: the MoE counts capacity over the whole batch;
    ``shard_map``: over this data shard's rows) for the model code."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    tokens = (_MODEL_GROUP.set(model), _DATA_GROUP.set(data),
              _VARIANT.set(variant))
    try:
        yield
    finally:
        for var, token in zip((_MODEL_GROUP, _DATA_GROUP, _VARIANT),
                              tokens):
            var.reset(token)


def _group():
    """The installed model group and its size; (None, 1) outside a
    context or in a group of one rank."""
    group = _MODEL_GROUP.get()
    if group is None:
        return None, 1
    size = dist.get_world_size(group)
    return (group, size) if size > 1 else (None, 1)


def _data_group():
    """The data group the MoE counts over and its size: (None, 1) outside
    a context, under ``shard_map`` (each shard counts its own rows) or
    where the batch is not split."""
    group = _DATA_GROUP.get()
    if group is None or _VARIANT.get() != "gspmd":
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


def data_size() -> int:
    """The number of data shards whose rows the MoE's capacity counts
    together: the data group's size under ``gspmd``, else 1."""
    return _data_group()[1]


def data_prefix(counts: torch.Tensor) -> torch.Tensor:
    """The sum of ``counts`` [E] over the data shards before this one, in
    data-rank order (an ``all_gather`` of every shard's counts): where
    this shard's picks start in each expert's running count.  Zeros where
    ``data_size()`` is 1."""
    group, size = _data_group()
    if group is None:
        return torch.zeros_like(counts)
    parts = [torch.empty_like(counts) for _ in range(size)]
    dist.all_gather(parts, counts.contiguous(), group=group)
    return sum(parts[:dist.get_rank(group)], torch.zeros_like(counts))
