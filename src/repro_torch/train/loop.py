"""Training loop, one device a rank (port of ``repro/train/loop.py``):
data pipeline -> train_step -> checkpoint -> fault path.

The loop consumes heartbeats, saves through the SplitFS checkpoint
manager, and on (injected or real) failure the caller restarts it: it
restores the newest valid checkpoint and the pipeline's position, then
continues.  With a ``FaultPolicy`` attached it also runs the cheap half of
the escalation ladder in-band: each step it polls the policy; a
``StealPlan`` is executed inline (if *this* worker is the absorbing spare
it reshards its pipeline onto the stolen shard — no restore), while a
``RemeshPlan`` ends the loop so the caller can run the full
restore + reshard path.

Parameters are drawn from ``torch.Generator(device).manual_seed(seed)``
(other numbers than JAX's from the same seed); batches come from the
numpy pipeline and go to the device with ``torch.from_numpy(...).to``.
The step updates the state in place; a restore replaces the state with
the restored tensors (``opt["step"]`` included), which the next in-place
step then updates.

With ``pod_group`` (a ``torch.distributed`` process group, one process a
rank: the reference's ``"pod"`` mesh axis) the step reduces the grads
across the group through ``loop_cfg.codec`` (``train.step``).  Every
rank draws the same global batch from its pipeline and keeps its own
contiguous rows ``[r*B/W, (r+1)*B/W)``, the reference's ``P("pod")``
split on dim 0; every rank draws the same parameters from the seed.  Rank
0 alone holds the ``CheckpointManager``: a save gathers each bucket's
residual rows into the reference's global ``[W * n]`` layout, rank-major;
a restore on rank 0 broadcasts the params, the optimizer state and the
pipeline's position, and hands each rank its own residual row.  The
fault path (``monitor``, ``policy``) does not run over a group.

With ``mesh`` (``launch.mesh.make_mesh``'s ("data", "model") mesh; every
family, ``train.step``) every rank draws the same global batch and keeps
its data rank's rows (``train.step.mesh_rows``; the frames and patch
embeddings too), and draws the same global parameters from the seed and
keeps its shards of them.  Rank 0
alone holds the ``CheckpointManager`` and saves the gathered global state
(every leaf all-gathered, assembled by ``dist.sharding.gather_params``),
in the leaves and layout of an unsharded run; a restore on rank 0
broadcasts each global leaf and every rank keeps its shards.  So a
checkpoint written on one mesh shape resumes on another, or unsharded.
Over a ("pod", "data", "model") mesh the step is ``train.step``'s: each
rank keeps ``batch_rows``; with a compressed pod reduction the state is
gathered from pod 0's ranks, and the residuals are saved in the layout
a pod group writes (one ``[P * n]`` buffer a bucket of the global
``grad_bucket_plan``, pod-major): each rank's residual is cut back into
its param shards' shapes, gathered into global leaves over its pod
(``gather_params``), flattened in the plan's order and padded; a
restore runs the inverse.  So the residuals resume on another pod mesh
shape, or on a pod group with no mesh.  The fault path does not run
over a mesh either (ROADMAP item 7.6e).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import TokenPipeline
from ..dist import compression
from ..dist.fault import FaultPolicy, HeartbeatMonitor, RemeshPlan, StealPlan
from ..dist.sharding import gather_params, shard_params
from ..kernels.common import resolve_device
from ..models.registry import ModelAPI
from ..models.spec import init_params
from ..tree import leaves, map_with_path, unflatten
from .optimizer import AdamWConfig
from .step import (batch_rows, grad_bucket_plan, make_train_step,
                   pod_buckets, shard_mesh)


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0
    codec: str = "int8"              # pod-reduction codec (int8 | topk | none)
    bucket_elems: Optional[int] = None   # None = compression default


@dataclass
class LoopResult:
    losses: List[float] = field(default_factory=list)
    restored_from: Optional[int] = None
    steps_run: int = 0
    mitigations: List[Any] = field(default_factory=list)  # Steal/RemeshPlans
    remesh_pending: Optional[RemeshPlan] = None
    # host seconds per step, ending when the loss reached the host
    step_seconds: List[float] = field(default_factory=list)


def gather_residuals(errs: List[torch.Tensor], group
                     ) -> Optional[List[torch.Tensor]]:
    """Every rank's residual rows, bucket by bucket, as the reference's
    global ``[W * n]`` buffers (rank-major) on rank 0; None on the other
    ranks.  A collective: every rank of ``group`` calls it."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    out = []
    for e in errs:
        rows = []
        for r in range(world):
            buf = e if r == rank else torch.empty_like(e)
            dist.broadcast(buf, group=group, group_src=r)
            rows.append(buf)
        if rank == 0:
            out.append(torch.cat(rows))
    return out if rank == 0 else None


def _broadcast_state(state: Dict, restored: Optional[Dict], group) -> Dict:
    """Rank 0's restored params, optimizer state and residuals on every
    rank: params and moments bitwise, and each rank's own row of every
    global ``[W * n]`` residual buffer.  A collective."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    out = dict(state)
    for key in ("params", "opt"):
        mine = leaves(state[key]) if rank else leaves(restored[key])
        for t in mine:
            dist.broadcast(t, group=group, group_src=0)
        out[key] = unflatten(state[key], mine)
    if "err" in state:
        rows = []
        for e in state["err"]:
            full = restored["err"][len(rows)] if rank == 0 else \
                torch.empty(world * e.numel(), dtype=e.dtype,
                            device=e.device)
            dist.broadcast(full, group=group, group_src=0)
            rows.append(full[rank * e.numel():(rank + 1) * e.numel()].clone())
        out["err"] = rows
    return out


def _state_specs(param_specs: Any) -> Dict:
    """The specs of a mesh train state: the moments' are the params'."""
    return {"params": param_specs,
            "opt": {"mu": param_specs, "nu": param_specs, "step": ()}}


def gather_state(state: Dict, specs: Dict, mesh: Any) -> Optional[Dict]:
    """The global train state (or any tree of shards under ``specs``)
    from every rank's shards, on the mesh's first rank (None on the
    others): each leaf all-gathered over the mesh's group, then
    assembled (``gather_params``; copies of a replicated piece must be
    bitwise equal).  A collective: every rank of the mesh calls it."""
    rank = dist.get_rank(mesh.group)
    out = []

    def one(_, leaf, spec):
        parts = [torch.empty_like(leaf) for _ in range(mesh.size)]
        dist.all_gather(parts, leaf.contiguous(), group=mesh.group)
        out.append(gather_params(parts, spec, mesh) if rank == 0 else None)
        del parts

    map_with_path(one, state, specs)
    return unflatten(state, out) if rank == 0 else None


def gather_pod_residuals(errs: List[torch.Tensor], api: ModelAPI,
                         mesh: Any, specs: Any, buckets, plan
                         ) -> Optional[List[torch.Tensor]]:
    """Every rank's residuals on a pod mesh (``buckets``: its
    ``train.step.pod_buckets``) as the global ``[P * n]`` buffers of
    ``plan`` (the global ``grad_bucket_plan``), pod-major, on rank 0;
    None on the others.  A collective: every rank calls it."""
    view = mesh.in_pod
    mine = unflatten(api.init_specs(), buckets.unbucket(errs))
    whole = gather_state(mine, specs, view)        # on the pod's first rank
    if view.coords != {"data": 0, "model": 0}:
        return None
    flat = leaves(whole)
    rows = [compression.bucket_flat(flat, plan, b)
            for b in range(plan.num_buckets)]
    return gather_residuals(rows, mesh.groups["pod"])


def scatter_pod_residuals(restored: Optional[List[torch.Tensor]],
                           api: ModelAPI, mesh: Any, specs: Any, buckets,
                           plan, device) -> List[torch.Tensor]:
    """The inverse of ``gather_pod_residuals``: rank 0's global ``[P *
    n]`` buffers broadcast, this rank's pod's row of each cut into the
    global leaves, its shards of them bucketed as ``buckets``.  A
    collective."""
    pods, p = mesh.shape["pod"], mesh.coords["pod"]
    like = [torch.empty(s.shape, device="meta")
            for s in leaves(api.init_specs())]
    whole: List[Any] = [None] * len(like)
    for b, n in enumerate(plan.padded_sizes):
        full = restored[b] if restored is not None else torch.empty(
            pods * n, dtype=torch.float32, device=device)
        dist.broadcast(full, src=0)
        for i, x in compression.bucket_leaves(full[p * n:(p + 1) * n], like,
                                              plan, b):
            whole[i] = x
    shards = shard_params(unflatten(api.init_specs(), whole), specs,
                          mesh.in_pod)
    return [x.clone() for x in buckets.bucket(leaves(shards))]


def _scatter_state(state: Dict, restored: Optional[Dict], specs: Dict,
                   mesh: Any, global_like: Dict) -> Dict:
    """Rank 0's restored global state (``restored``), each leaf
    broadcast and kept as this rank's shard; ``global_like`` gives every
    leaf's global shape.  A collective."""
    out = []
    flat = leaves(restored) if restored is not None else None

    def one(_, leaf, spec, like):
        full = flat[len(out)] if flat is not None else torch.empty(
            tuple(like.shape), dtype=leaf.dtype, device=leaf.device)
        dist.broadcast(full, src=0)
        out.append(shard_params(full, spec, mesh))

    map_with_path(one, state, specs, global_like)
    return unflatten(state, out)


def run_training(api: ModelAPI, pipeline: TokenPipeline,
                 loop_cfg: LoopConfig, opt_cfg: AdamWConfig, *,
                 ckpt: Optional[CheckpointManager] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 worker: int = 0,
                 policy: Optional[FaultPolicy] = None,
                 device="cuda", crash_at: Optional[int] = None,
                 pod_group=None, mesh: Any = None) -> LoopResult:
    """Run (or resume) training.  ``crash_at`` raises after that step's
    checkpointable state exists — tests use it to exercise restart.
    ``pod_group``: reduce the grads across this group's ranks; ``mesh``:
    train over a ("data", "model") or ("pod", "data", "model") mesh
    (module docstring).  Over either, ``ckpt`` belongs to rank 0 alone,
    and ``monitor`` and ``policy`` are refused (each rank would plan on
    its own; ROADMAP item 7.6e)."""
    dev = resolve_device(device)
    rank = world = None
    if mesh is not None and pod_group is not None:
        raise ValueError("a pod group beside a mesh: give the mesh a pod "
                         "axis, make_mesh((pod, data, model))")
    sharded = mesh is not None and mesh.size > 1
    group = dist.group.WORLD if sharded else pod_group
    if (sharded or pod_group is not None) and (monitor is not None
                                               or policy is not None):
        # the fault path plans on each rank alone: a rank that steps out,
        # or stops for a remesh, would leave the others blocked in the
        # group's next collective
        raise ValueError("a HeartbeatMonitor or FaultPolicy does not run "
                         "over a pod_group or a mesh (ROADMAP item 7.6e)")
    if group is not None:
        rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        if ckpt is not None and rank != 0:
            raise ValueError(f"rank {rank} was given a CheckpointManager: "
                             "rank 0 alone saves and restores")
    if pod_group is not None:
        if pipeline.local_batch % world:
            raise ValueError(f"a batch of {pipeline.local_batch} rows does "
                             f"not split over {world} ranks")
        rows = pipeline.local_batch // world
        lo, hi = rank * rows, (rank + 1) * rows
    step_kwargs = {}
    if loop_cfg.bucket_elems is not None:
        step_kwargs["bucket_elems"] = loop_cfg.bucket_elems
    train_step, init_state, specs = make_train_step(
        api, opt_cfg, microbatches=loop_cfg.microbatches,
        pod_group=pod_group, codec=loop_cfg.codec, mesh=mesh, **step_kwargs)
    if sharded:
        view = shard_mesh(api, mesh, loop_cfg.codec)
        take = batch_rows(pipeline.local_batch, loop_cfg.microbatches, mesh,
                          view)
    gen = torch.Generator(device=dev).manual_seed(loop_cfg.seed)
    state = init_state(init_params(api.init_specs(), gen, device=dev),
                       device=dev)
    # a compressed pod reduction over a mesh: its residuals' buckets
    pods = sharded and "err" in state
    if pods:
        buckets = pod_buckets(api, view, specs, **step_kwargs)
        global_plan = grad_bucket_plan(api, **step_kwargs)
    if sharded:
        state_specs = _state_specs(specs)
        shapes = api.init_specs()       # each leaf's global shape
        global_like = {"params": shapes, "opt": {
            "mu": shapes, "nu": shapes, "step": state["opt"]["step"]}}
    result = LoopResult()
    start = 0
    like = state if not pods else {**state, "err": [
        torch.empty(0, device=dev) for _ in range(global_plan.num_buckets)]}
    restored = ckpt.restore(like) if ckpt is not None else None
    has_ckpt = ckpt is not None
    if group is not None:
        # rank 0 tells the group whether it checkpoints and what it restored
        head = torch.tensor(
            [has_ckpt, restored is not None,
             restored[0] if restored else 0,
             restored[2].get("pipeline_step", restored[0]) if restored
             else 0], dtype=torch.int64, device=dev)
        dist.broadcast(head, group=group, group_src=0)
        has_ckpt, found, start, pipe_step = (int(x) for x in head.tolist())
        if found and sharded:
            tree = dict(restored[1]) if restored else None
            err = tree.pop("err", None) if tree else None
            new = _scatter_state({k: state[k] for k in ("params", "opt")},
                                 tree, state_specs, view, global_like)
            if pods:
                new["err"] = scatter_pod_residuals(
                    err, api, mesh, specs, buckets, global_plan, dev)
            state = new
        elif found:
            state = _broadcast_state(
                state, restored[1] if restored else None, group)
        if found:
            pipeline.restore(pipe_step)
            result.restored_from = start
    elif restored is not None:
        start, state, extra = restored
        pipeline.restore(extra.get("pipeline_step", start))
        result.restored_from = start

    for step in range(start, loop_cfg.steps):
        t0 = time.monotonic()
        batch = next(pipeline)
        if pod_group is not None:          # this rank's rows of the batch
            batch = {k: v[lo:hi] for k, v in batch.items()}
        elif sharded:
            batch = {k: v[take] for k, v in batch.items()}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        result.step_seconds.append(dt)
        result.losses.append(loss)
        result.steps_run += 1
        if monitor is not None:
            monitor.beat(worker, step, dt)
        if policy is not None:
            plan = policy.poll(
                restore_step=ckpt.latest_step() if ckpt else None)
            if plan is not None:
                result.mitigations.append(plan)
            if isinstance(plan, StealPlan):
                # steal executes in-band: the absorbing spare adopts the
                # shard, the straggler leaves the training set (shard-less;
                # it may rejoin as a spare once healthy), everyone else
                # keeps running untouched
                if plan.spare == worker:
                    pipeline = pipeline.reshard(
                        shard=plan.shard, num_shards=pipeline.num_shards)
                elif plan.straggler == worker:
                    return result
            elif isinstance(plan, RemeshPlan):
                # full fallback needs the out-of-band restore + reshard
                # path; stop cleanly and hand the plan to the caller
                result.remesh_pending = plan
                return result
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}: {loss}")
        if has_ckpt and (step + 1) % loop_cfg.ckpt_every == 0:
            tree = state
            if "err" in state and pod_group is not None:
                tree = {**state,
                        "err": gather_residuals(state["err"], pod_group)}
            elif pods:
                err = gather_pod_residuals(state["err"], api, mesh, specs,
                                           buckets, global_plan)
                tree = gather_state(
                    {k: state[k] for k in ("params", "opt")}, state_specs,
                    view) if mesh.coords["pod"] == 0 else None
                if tree is not None:
                    tree["err"] = err
            elif sharded:
                tree = gather_state(state, state_specs, view)
            if ckpt is not None:
                ckpt.save(step + 1, tree,
                          extra={"pipeline_step": pipeline.snapshot()})
            del tree
        if crash_at is not None and step + 1 >= crash_at:
            raise RuntimeError(f"injected crash at step {step + 1}")
    return result
