"""The train_step builder (port of ``repro/train/step.py``): microbatch
gradient accumulation into float32 buffers, the optional compressed
reduction across ranks, the mesh's FSDP and tensor parallelism, and the
AdamW update.

    train_step, init_state, specs = make_train_step(api, opt_cfg,
                                                    microbatches=4)
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

Given ``mesh`` (``launch.mesh.make_mesh``'s ("data", "model") mesh),
every family trains as the reference's GSPMD step does, every collective
explicit (``models.shardctx``): each rank holds its shards of the params
and of both moments (``dist.sharding.train_specs``: the reference's
``train_rules``, FSDP over "data" on the contraction dim and tensor and
expert parallelism over "model", then whole query heads and whole or
copied KV heads, Mamba2 by whole SSD heads with B and C whole, the
RG-LRU by channels; MLA's latent and the MoE's router whole on every
model rank), all-gathers each layer's shards over "data" inside its
remat'd layer (a hybrid's tail layer where it runs) and reduce-scatters
their grads, sums the row-parallel products and enters the
column-parallel ones over "model", counts each microbatch's expert
capacity over "data" (``layers.moe_route``), and runs AdamW on its
shards with the whole model's clip norm (``dist.sharding.norm_share``:
each piece once, a split segment on every model rank).  It takes this
data rank's rows of the global batch (each leaf, the VLM's patch
embeddings and the encoder-decoder's frames too, indexed by
``mesh_rows``).  ``specs`` is then the parameters' (and each moment's)
specs; None without a mesh.

Given a ("pod", "data", "model") mesh, the step is the reference's
(``:112-188``).  Where the pod reduction is compressed (``codec`` int8
or topk, not an encoder-decoder) it is the reference's ``podwise``: the
params and both moments are whole over "pod" and sharded within each pod
as above (``include_pod_in_fsdp=False``: the specs of the pod's own
mesh, ``Mesh.in_pod``); pod ``p`` takes the rows ``[p*B/P, (p+1)*B/P)``
(the reference's ``P("pod")``) and each of its data ranks its
``mesh_rows`` of them; the grads and the loss are the pod's (the MoE's
capacity counted over the pod's own "data"); then each rank reduces its
shards with the same ranks of the other pods through
``bucketed_compressed_psum`` over ``groups["pod"]``, in buckets planned
on its own pieces (``shard_buckets``), with its own
error-feedback residuals, ``state["err"]``; the loss is averaged over
the pods, and AdamW's clip norm sums the pod's own ranks, so every pod
updates its params alike, bitwise.  Uncompressed (``codec="none"``, or
an encoder-decoder), "pod" joins FSDP and the batch axes (the
reference's ``train_rules(include_pod_in_fsdp=True)`` and batch axes
("pod", "data")): the mesh step above on the ``(pod * data, model)``
view, ``Mesh.merged``.  ``shard_mesh`` names the mesh a step's specs
and rows are on, ``batch_rows`` the rows.

Not ported: ``models/shardctx.py``'s activation hints (layout hints to
XLA's partitioner; eager PyTorch has none) and ``pod_err_struct`` (the
residuals' shapes for the dry run's lowering).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..dist import compression
from ..dist.sharding import (axis_dim, copies_of, holder_pieces, norm_share,
                             shard_block, shard_params, train_specs)
from ..kernels.common import resolve_device
from ..launch.mesh import Mesh
from ..models.registry import ModelAPI
from ..models.shardctx import training_mesh
from ..tree import leaves, map_with_path, unflatten
from .optimizer import AdamWConfig, adamw_init, adamw_update, sharded_norm


def _split_microbatch(batch: Dict, n: int, i: int) -> Dict:
    return {k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
            for k, x in batch.items()}


def mesh_rows(n: int, microbatches: int, data: int, index: int) -> list:
    """The indices of data rank ``index``'s rows of a global batch of
    ``n`` rows on a mesh of ``data`` data ranks: microbatch ``i`` is the
    global rows ``[i*mb, (i+1)*mb)`` (the reference's
    ``_split_microbatch``), and the rank holds the ``index``-th of its
    ``data`` blocks of ``mb / data`` rows, microbatch after microbatch,
    so the step's own split gives it its block of each.  A microbatch
    that does not split raises ``ValueError``."""
    if n % microbatches or (n // microbatches) % data:
        raise ValueError(f"a batch of {n} rows does not split into "
                         f"{microbatches} microbatches over {data} data "
                         "ranks")
    mb = n // microbatches
    rows = mb // data
    return [i * mb + index * rows + j for i in range(microbatches)
            for j in range(rows)]


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


def compresses(api: ModelAPI, codec: str) -> bool:
    """Whether a pod reduction with ``codec`` is compressed: not for
    ``"none"``, nor for an encoder-decoder, as in the reference (there
    XLA's partitioner fails on its embedding inside a manual pod region;
    here the rule is kept for parity)."""
    if codec not in compression.CODECS + ("none",):
        raise ValueError(f"unknown codec {codec!r}; expected one of "
                         f"{compression.CODECS + ('none',)}")
    return codec != "none" and api.cfg.family != "encdec"


def shard_mesh(api: ModelAPI, mesh: Mesh, codec: str) -> Mesh:
    """The mesh whose specs and rows a train step over ``mesh`` takes:
    ``mesh`` itself without a pod axis; with one, the pod's own mesh
    where the pod reduction is compressed, else the ``(pod * data,
    model)`` view."""
    if "pod" not in mesh.shape:
        return mesh
    return mesh.in_pod if compresses(api, codec) else mesh.merged


def batch_rows(n: int, microbatches: int, mesh: Mesh, view: Mesh) -> list:
    """This rank's rows of a global batch of ``n`` rows, for a step over
    ``mesh`` sharded on ``view`` (``shard_mesh``): on a pod's own mesh,
    the pod's contiguous rows and its data rank's ``mesh_rows`` of them;
    else the view's ``mesh_rows``."""
    data, index = view.shape["data"], view.coords["data"]
    if view is not mesh.in_pod:
        return mesh_rows(n, microbatches, data, index)
    pods = mesh.shape["pod"]
    if n % pods:
        raise ValueError(f"a batch of {n} rows does not split over {pods} "
                         "pods")
    lo = mesh.coords["pod"] * (n // pods)
    return [lo + r for r in mesh_rows(n // pods, microbatches, data, index)]


def make_train_step(api: ModelAPI, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, impl: Optional[str] = None,
                    pod_group=None, codec: str = "int8",
                    bucket_elems: int = compression.DEFAULT_BUCKET_ELEMS,
                    topk_frac: float = 0.01, mesh: Any = None):
    """Returns (train_step, init_state, param_specs).

    train_step(state, batch) -> (state, metrics), state = {params, opt}
    and, when the pod reduction is compressed, ``err``;
    init_state(params, device=...) -> the state, every leaf on ``device``
    (over a mesh: this rank's shards of the global ``params``, and
    moments made on them).  ``batch`` holds this rank's rows
    (``batch_rows`` over a mesh).  ``codec`` is one of
    ``compression.CODECS`` or ``"none"``.  ``param_specs``: the specs
    of the mesh's shards (``dist.sharding.train_specs`` on
    ``shard_mesh``), None without a mesh; a mesh of one rank trains as
    no mesh does.  A pod is asked for by ``pod_group`` (one rank a pod)
    or by the mesh's pod axis, not both.
    """
    compress = compresses(api, codec)
    if mesh is not None:
        if pod_group is not None:
            raise ValueError("a pod group beside a mesh: give the mesh a "
                             "pod axis, make_mesh((pod, data, model))")
        view = shard_mesh(api, mesh, codec)
        specs = train_specs(api.cfg, view, api.init_specs())
        if view is mesh.in_pod:
            return _pod_train_step(api, opt_cfg, mesh, specs, microbatches,
                                   impl, codec, bucket_elems,
                                   topk_frac) + (specs,)
        if view.size > 1:
            return _mesh_train_step(api, opt_cfg, view, specs,
                                    microbatches, impl) + (specs,)
        return make_train_step(api, opt_cfg, microbatches=microbatches,
                               impl=impl)[:2] + (specs,)
    loss_and_grad = make_loss_and_grad(api, microbatches, impl=impl)
    compress = compress and pod_group is not None
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
            loss = group_mean(loss, pod_group)
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

    return train_step, init_state, None


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of the scalar ``x`` over ``group``."""
    x = x.reshape(1).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x[0] / dist.get_world_size(group)


def make_mesh_loss_and_grad(api: ModelAPI, mesh: Any, specs: Any,
                            microbatches: int, *,
                            impl: Optional[str] = None) -> Callable:
    """(shards, batch) -> (loss, grads) on a rank of ``mesh``: the mean
    loss of the whole batch (each data rank holding its ``mesh_rows``)
    and this rank's shards of its grads.  Each grad leaves the backward
    summed over "data" where its leaf is split over it (the FSDP
    gather's reduce-scatter); ``reduce_mesh_grads`` then sums the others
    over "data" (``bq`` / ``bk`` / ``bv``, a dim that does not divide),
    sums a copied KV head's over its copy group (each copy saw its own
    query heads only: what GSPMD does for the reference's split inside a
    head) and divides every grad by the data size.  A leaf, or a whole
    segment, replicated over "model" (norms, MLA's ``w_dkv``, the MoE's
    router, Mamba2's B and C columns) needs no model reduction: the
    column-parallel entries (``shardctx.model_entry``, also on MLA's
    latent, the MoE's routing weights and dispatched rows, Mamba2's B
    and C and the encoder's output) give it the same, whole grad on
    every model rank."""
    like = api.init_specs()
    flat_specs = []
    map_with_path(lambda _, __, spec: flat_specs.append(spec), like, specs)
    dims = map_with_path(lambda _, __, spec: axis_dim(spec, "data"), like,
                         specs)
    model_group = mesh.groups.get("model")
    data_group = mesh.groups.get("data")
    data = mesh.shape["data"]
    # per leaf: (all-reduce over data, its copy group or None)
    plan = [(data > 1 and axis_dim(spec, "data") is None,
             mesh.copy_groups.get(copies_of(spec, mesh), model_group)
             if copies_of(spec, mesh) > 1 else None)
            for spec in flat_specs]
    loss_and_grad = make_loss_and_grad(api, microbatches, impl=impl)

    def mesh_loss_and_grad(params: Any, batch: Dict):
        with training_mesh(model_group, data_group, dims):
            loss, grads = loss_and_grad(params, batch)
        reduce_mesh_grads(grads, plan, data_group, data)
        if data > 1:
            loss = group_mean(loss, data_group)
        return loss, grads

    return mesh_loss_and_grad


def reduce_mesh_grads(grads: Any, plan: list, data_group, data: int) -> None:
    """In place, each leaf of ``grads`` by its ``plan`` entry (all-reduce
    over ``data_group``, all-reduce over a copy group), then divided by
    the data size ``data``."""
    with torch.no_grad():
        for g, (over_data, copies) in zip(leaves(grads), plan, strict=True):
            if over_data:
                dist.all_reduce(g, group=data_group)
            if copies is not None:
                dist.all_reduce(g, group=copies)
            if data > 1:
                g.div_(data)


def _mesh_train_step(api: ModelAPI, opt_cfg: AdamWConfig, mesh: Any,
                     specs: Any, microbatches: int, impl: Optional[str]):
    """(train_step, init_state) of the mesh (module docstring)."""
    owned = []
    map_with_path(lambda _, __, spec: owned.append(norm_share(spec, mesh)),
                  api.init_specs(), specs)
    norm = functools.partial(sharded_norm, owned=owned, group=mesh.group)
    loss_and_grad = make_mesh_loss_and_grad(api, mesh, specs, microbatches,
                                            impl=impl)

    def train_step(state: Dict, batch: Dict):
        loss, grads = loss_and_grad(state["params"], batch)
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                            state["opt"], norm=norm)
        del grads
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    def init_state(params: Any, device="cuda") -> Dict:
        return {"params": (shards := _shards_on(params, specs, mesh,
                                                device)),
                "opt": adamw_init(shards)}

    return train_step, init_state


def _shards_on(params: Any, specs: Any, mesh: Mesh, device) -> Any:
    """This rank's shards of the global ``params`` on ``device``."""
    dev = resolve_device(device)
    shards = shard_params(params, specs, mesh)
    return unflatten(shards, [p.to(dev) for p in leaves(shards)])


@dataclasses.dataclass(frozen=True)
class ShardBuckets:
    """The bucket plan of one rank's shards of a gradient tree
    (``shard_buckets``): each leaf's block cut into the pieces that one
    set of ranks holds (``pieces``: per leaf, each piece's ``(dim,
    start, width)`` in the block, None for the whole block), the pieces
    in bucket order (``order``: each one's (leaf, piece); ``shapes``:
    each one's shape), and ``plan`` over them, the pieces its leaves."""
    pieces: Tuple[Tuple[Optional[Tuple[int, int, int]], ...], ...]
    order: Tuple[Tuple[int, int], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    plan: compression.BucketPlan

    def units(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The pieces of ``leaves`` (one block a leaf) in bucket order."""
        cut = [[x if p is None else x.narrow(*p) for p in ps]
               for x, ps in zip(leaves, self.pieces, strict=True)]
        return [cut[i][k] for i, k in self.order]

    def join(self, units: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The inverse of ``units``: each leaf's block from its pieces."""
        slots: List[List[Any]] = [[None] * len(ps) for ps in self.pieces]
        for (i, k), u in zip(self.order, units, strict=True):
            slots[i][k] = u
        return [s[0] if ps[0] is None else torch.cat(s, dim=ps[0][0])
                for s, ps in zip(slots, self.pieces)]

    def bucket(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each bucket of ``leaves`` (one block a leaf) as one flat
        float32 vector, zero-padded to whole codec blocks."""
        units = self.units(leaves)
        return [compression.bucket_flat(units, self.plan, b)
                for b in range(self.plan.num_buckets)]

    def unbucket(self, flats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The inverse of ``bucket``: each leaf's block."""
        like = [torch.empty(s, device="meta") for s in self.shapes]
        units = [x for b, flat in enumerate(flats)
                 for _, x in compression.bucket_leaves(flat, like, self.plan, b)]
        return self.join(units)


def shard_buckets(shapes: Sequence[Sequence[int]], specs: Sequence[Any],
                  mesh: Any, *, bucket_elems: int = compression.DEFAULT_BUCKET_ELEMS
                  ) -> ShardBuckets:
    """The buckets of the calling rank's shards (``dist.sharding`` specs
    ``specs`` on ``mesh``, in ``leaves`` order beside the global
    ``shapes``).  A piece that several ranks hold (a leaf replicated over
    an axis, a copied KV head, Mamba2's whole B and C) must be quantized
    alike on each, or their params part: int8's blocks and top-k's
    threshold read the whole bucket.  So the pieces of one holders' key
    (``sharding.holder_pieces``) fill buckets of their own, keys in
    sorted order, pieces in leaf order, each key's packed as
    ``plan_buckets`` packs leaves; every holder of a piece then builds
    its buckets from the same pieces.  On a mesh of one rank every key
    is ``()``: the plan is ``plan_buckets`` of the whole leaves."""
    pieces, by_key = [], {}
    for i, (shape, spec) in enumerate(zip(shapes, specs, strict=True)):
        local = shard_block(shape, spec, mesh)[0]
        cut = holder_pieces(spec, shape, mesh)
        pieces.append(tuple(p for p, _ in cut))
        for k, (p, key) in enumerate(cut):
            unit = local if p is None else \
                local[:p[0]] + (p[2],) + local[p[0] + 1:]
            by_key.setdefault(key, []).append(((i, k), unit))
    order: List[Tuple[int, int]] = []
    units: List[Tuple[int, ...]] = []
    groups, sizes, padded = [], [], []
    for key in sorted(by_key):
        sub = compression.plan_buckets([math.prod(u) for _, u in by_key[key]],
                           bucket_elems=bucket_elems)
        groups += [tuple(len(order) + j for j in g) for g in sub.groups]
        sizes += sub.sizes
        padded += sub.padded_sizes
        order += [ik for ik, _ in by_key[key]]
        units += [u for _, u in by_key[key]]
    plan = compression.BucketPlan(groups=tuple(groups), sizes=tuple(sizes),
                                  padded_sizes=tuple(padded))
    return ShardBuckets(tuple(pieces), tuple(order), tuple(units), plan)


def pod_buckets(api: ModelAPI, view: Mesh, specs: Any, *, bucket_elems:
                int = compression.DEFAULT_BUCKET_ELEMS
                ) -> ShardBuckets:
    """The buckets of this rank's grad shards on a pod's own mesh
    ``view`` (``shard_buckets``)."""
    like = api.init_specs()
    flat = []
    map_with_path(lambda _, __, spec: flat.append(spec), like, specs)
    return shard_buckets([s.shape for s in leaves(like)], flat, view,
                         bucket_elems=bucket_elems)


def _pod_train_step(api: ModelAPI, opt_cfg: AdamWConfig, mesh: Mesh,
                    specs: Any, microbatches: int, impl: Optional[str],
                    codec: str, bucket_elems: int, topk_frac: float):
    """(train_step, init_state) of a mesh with a compressed pod reduction
    (module docstring)."""
    view = mesh.in_pod
    owned = []
    map_with_path(lambda _, __, spec: owned.append(norm_share(spec, view)),
                  api.init_specs(), specs)
    norm = functools.partial(sharded_norm, owned=owned, group=view.group)
    loss_and_grad = make_mesh_loss_and_grad(api, view, specs, microbatches,
                                            impl=impl)
    buckets = pod_buckets(api, view, specs, bucket_elems=bucket_elems)
    pod = mesh.groups["pod"]

    def train_step(state: Dict, batch: Dict):
        loss, grads = loss_and_grad(state["params"], batch)
        units, err = compression.bucketed_compressed_psum(
            buckets.units(leaves(grads)), state["err"], pod,
            plan=buckets.plan, codec=codec, topk_frac=topk_frac)
        grads = unflatten(grads, buckets.join(units))
        del units
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                            state["opt"], norm=norm)
        del grads
        metrics["loss"] = group_mean(loss, pod)
        return {"params": params, "opt": opt, "err": err}, metrics

    def init_state(params: Any, device="cuda") -> Dict:
        shards = _shards_on(params, specs, view, device)
        return {"params": shards, "opt": adamw_init(shards),
                "err": compression.init_residuals(
                    buckets.plan, device=leaves(shards)[0].device)}

    return train_step, init_state
