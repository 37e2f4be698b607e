"""The serve and train steps' collective points over the mesh's groups:
the port's counterpart of ``repro/models/shardctx.py``.

``serving_mesh(model=..., data=..., variant=...)`` installs, for one
step, the ``torch.distributed`` group of the ranks that split one
model's heads, experts, FFN and vocabulary (the reference's
``serving_model_axis``, ``:53-59``), the group of the ranks that split
the batch's rows (None where the batch is not split), and the step's
variant; the model code calls

  * ``model_all_reduce(x)``: the sum over the model group of each rank's
    partial product (after ``wo`` of the attention and of the MLP, after
    the MoE's routed and shared experts, after Mamba2's and the RG-LRU's
    ``out_proj``, and the vocab-parallel embedding lookup);
  * ``model_psum(x)``: the same sum where each rank's consumer reads only
    its own channels of it (Mamba2's gated norm's sum of squares, the
    RG-LRU's gate pre-activations);
  * ``gather_vocab(x)``: the logits' vocab slices of every rank,
    concatenated in rank order along the last dim;
  * ``model_rank()``: this rank's index in the model group (its vocab
    block, its experts);
  * ``data_prefix(counts)``: under the ``gspmd`` variant, the sum of
    ``counts`` over the data shards before this one (an ``all_gather``
    over the data group); the MoE's capacity count
    (``layers.moe_route``) reads it with ``data_size()``.

``training_mesh(model=..., data=..., dims=...)`` installs the same
model group for the train step (``train.step``), the group of the ranks
that split the parameters' contraction dim and the batch's rows (FSDP
over "data", and the MoE's capacity count, as under ``gspmd``) and, in
the parameters' structure, the dim of each leaf that is split over it.
Under it the model code calls, besides the above (autograd
differentiates ``model_all_reduce`` and ``model_entry`` as Megatron's
pair does, ``model_psum`` as JAX's ``psum``),

  * ``model_entry(x)``: the column-parallel entry before a split
    ``wq`` / ``wk`` / ``wv``, MLP ``wi``, output head, Mamba2's z, x and
    dt columns or the RG-LRU's ``proj_x`` / ``proj_gate``, and on what
    feeds only this rank's heads or experts (MLA's latent, the MoE's
    routing weights and dispatched rows, Mamba2's B and C, the
    encoder's output before the cross attentions' ``wk`` / ``wv``):
    ``x`` itself forward, the sum over the model group of ``x``'s grad
    backward (each rank's heads, columns, experts or vocab rows give a
    partial grad);
  * ``fsdp_params(tree, path)``: each leaf of the parameter subtree at
    ``path`` all-gathered over the data group on its FSDP dim; backward,
    the grad reduce-scattered (summed over the data ranks) back onto the
    rank's shard.  ``lm_hidden``, ``encdec.encode`` and
    ``encdec.decode_train`` call it inside each remat'd layer, so remat
    "full" gathers again in the recompute and no layer's gathered
    weights outlive it; ``bind(fn)`` carries the installed groups into
    that recompute, which autograd runs on its device thread.

The backward of ``model_all_reduce`` is the identity and that of
``gather_vocab`` this rank's vocab block of the grad: every rank of the
model group runs the same replicated computation after either.  Never
``torch.distributed.nn``'s all_reduce, whose backward is an all-reduce
too: after a row-parallel sum it would multiply every replicated grad
by the model size.  That backward is right only where each rank reads
its own channels of the sum, so each rank's grad of it is partial:
``model_psum``, a function of its own, used there alone.

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
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

VARIANTS = ("gspmd", "shard_map")

_MODEL_GROUP: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("serving_model_group", default=None)
_DATA_GROUP: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("serving_data_group", default=None)
_VARIANT: contextvars.ContextVar[str] = \
    contextvars.ContextVar("serving_variant", default="gspmd")
# the train step's FSDP: (the data group, its size, the dims tree)
_FSDP: contextvars.ContextVar[Optional[Tuple[Any, int, Any]]] = \
    contextvars.ContextVar("training_fsdp", default=None)


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


@contextlib.contextmanager
def training_mesh(model: Optional[Any] = None, data: Optional[Any] = None,
                  dims: Any = None):
    """Installs, for the train step's forward and backward, ``model`` (the
    group of the ranks that split the heads, FFN and vocabulary, or None)
    and ``data`` (the group of the ranks that split the parameters'
    contraction dim and the batch's rows, or None) with ``dims``: a tree
    in the parameters' structure holding, at each leaf, the dim that
    ``data`` splits (None where the leaf is whole over it).  The MoE
    counts each microbatch's capacity over ``data`` as ``gspmd`` does
    (``data_size``, ``data_prefix``): data rank ``d`` holds the ``d``-th
    block of each microbatch's rows (``train.step.mesh_rows``), so the
    earlier shards' picks come first, in the reference's token-major
    order."""
    size = dist.get_world_size(data) if data is not None else 1
    tokens = (_MODEL_GROUP.set(model), _DATA_GROUP.set(data),
              _VARIANT.set("gspmd"),
              _FSDP.set((data, size, dims) if size > 1 else None))
    try:
        yield
    finally:
        for var, token in zip((_MODEL_GROUP, _DATA_GROUP, _VARIANT, _FSDP),
                              tokens):
            var.reset(token)


def bind(fn: Callable) -> Callable:
    """``fn`` run under the groups installed now, wherever it is called:
    a remat'd layer's recompute runs on autograd's device thread, which
    does not see this thread's context (the FSDP gathers, the model
    collectives and the MoE's ``data_prefix`` run again there).  ``fn``
    itself outside a context."""
    if _MODEL_GROUP.get() is None and _FSDP.get() is None \
            and _DATA_GROUP.get() is None:
        return fn
    ctx = contextvars.copy_context()
    return lambda *args: ctx.run(fn, *args)


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


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _ModelSum(torch.autograd.Function):
    """The row-parallel sum: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ModelPsum(torch.autograd.Function):
    """The sum read by channel: all-reduce forward, all-reduce of the
    grad backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ModelEntry(torch.autograd.Function):
    """The column-parallel entry: identity forward, all-reduce of the
    input's grad backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherVocab(torch.autograd.Function):
    """All-gather of the vocab blocks forward, the rank's own block of the
    grad backward."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width), None, None


class _FsdpGather(torch.autograd.Function):
    """A leaf's shards all-gathered on ``dim`` over the data group
    forward, the grad reduce-scattered (summed) back onto the shard
    backward."""

    @staticmethod
    def forward(ctx, shard, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        buf = shard.new_empty((size * shard.shape[0],) + shard.shape[1:])
        dist.all_gather_into_tensor(buf, shard.contiguous(), group=group)
        return _unstack(buf.view((size,) + shard.shape), dim)

    @staticmethod
    def backward(ctx, grad):
        size, dim = ctx.size, ctx.dim
        shape = list(grad.shape)
        shape[dim:dim + 1] = [size, shape[dim] // size]
        stacked = grad.reshape(shape).movedim(dim, 0).contiguous()
        out = grad.new_empty(stacked.shape[1:])
        dist.reduce_scatter_tensor(out, stacked.flatten(0, 1),
                                   group=ctx.group)
        return out, None, None, None


def _unstack(buf: torch.Tensor, dim: int) -> torch.Tensor:
    """[size, *shard] -> the shards concatenated on ``dim``."""
    shape = list(buf.shape[1:])
    shape[dim] *= buf.shape[0]
    return buf.movedim(0, dim).reshape(shape)


def model_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group (in place on a contiguous
    ``x``, which is returned, where autograd does not record it; the
    row-parallel sum, whose backward is the identity, where it does)."""
    group, _ = _group()
    if group is None:
        return x
    if _differentiated(x):
        return _ModelSum.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def model_psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group where each rank goes on with
    its own channels of it: forward as ``model_all_reduce`` (bitwise),
    backward the sum of the grad over the group (each rank's grad covers
    only the channels it reads)."""
    group, _ = _group()
    if group is None or not _differentiated(x):
        return model_all_reduce(x)
    return _ModelPsum.apply(x, group)


def model_entry(x: torch.Tensor) -> torch.Tensor:
    """The column-parallel entry before a weight split over the model
    group: ``x`` forward, the sum of its grad over the group backward.
    ``x`` itself where autograd does not record it."""
    group, _ = _group()
    if group is None or not _differentiated(x):
        return x
    return _ModelEntry.apply(x, group)


def gather_vocab(x: torch.Tensor) -> torch.Tensor:
    """``[.., V / m]`` slices of every rank -> ``[.., V]``, rank-major."""
    group, size = _group()
    if group is None:
        return x
    if _differentiated(x):
        return _GatherVocab.apply(x, group, size)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def fsdp_gather(shard: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``shard`` all-gathered on ``dim`` over the installed data group
    (differentiable: the grad is reduce-scattered back); ``shard`` itself
    where ``dim`` is None or no data group splits the parameters."""
    fsdp = _FSDP.get()
    if fsdp is None or dim is None:
        return shard
    group, size, _ = fsdp
    return _FsdpGather.apply(shard, dim, group, size)


def fsdp_params(tree: Any, path: Tuple[str, ...],
                stacked: bool = False) -> Any:
    """The parameter subtree ``tree``, found at ``path`` of the parameter
    tree, with each leaf FSDP-gathered (``fsdp_gather``) on its dim from
    the installed dims; ``stacked``: ``tree``'s leaves are one layer of
    leaves stacked over layers, whose dims count the layer dim.  ``tree``
    itself outside a training context."""
    fsdp = _FSDP.get()
    if fsdp is None:
        return tree
    dims = fsdp[2]
    for key in path:
        dims = dims[key]
    shift = 1 if stacked else 0

    def walk(node, d):
        if isinstance(node, dict):
            return {k: walk(node[k], d[k]) for k in node}
        return fsdp_gather(node, None if d is None else d - shift)

    return walk(tree, dims)


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
