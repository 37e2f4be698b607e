"""Training driver of the port (port of ``repro.launch.train``).

The loop is the same fault-aware code path the reference runs
(heartbeats, SplitFS checkpoints, restore-on-restart), including the §9b
escalation ladder: ``--spares N`` registers N idle spare workers with the
``FaultPolicy`` so a flagged straggler's data shard is STOLEN
(metadata-only reassignment, the spare replays the shard
deterministically) before any remesh is considered.  Every host of a
multi-host deployment would run this driver with its own ``--worker``.

  python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 50
  python -m repro_torch.launch.train --arch mamba2-1.3b --smoke --steps 100 \
      --ckpt-every 20 --mode strict --spares 2
  python -m repro_torch.launch.train --smoke --steps 8 --device cpu
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --mesh 2x1x2 --codec int8

The model trains on ``--device`` (default ``cuda``; raises without a
card).  Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank runs this
module: it joins the process group (NCCL on ``cuda``, one card a rank
by ``LOCAL_RANK``; gloo on ``cpu``) and trains over ``--mesh`` (``DxM``
or ``PxDxM``; by default ``make_host_mesh()``, every rank on "model",
as the reference's ``:66``), the pod reduction through ``--codec``;
rank 0 alone makes the PM volume and the store, and prints.  The fault
path (``--spares``, ``--heartbeat-timeout``) does not run over a mesh
yet (ROADMAP item 7.6e).  ``--smoke`` is on by default, as in the
reference.  The PM volume is sized from the train state
(``checkpoint_volume``, ``state_bytes``): it holds the kept checkpoints
and the one being staged beside the staging files, so the oldest step
lives until the new one commits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..checkpoint.manager import CHUNK_BYTES
from ..configs import ARCH_IDS, get_config
from ..core import (BLOCK_SIZE, Mode, PMDevice, USplit, Volume,
                    VolumeGeometry)
from ..data import TokenPipeline
from ..dist.compression import CODECS
from ..dist.fault import FaultPolicy, HeartbeatMonitor
from ..kernels.common import resolve_device
from ..models import build_model
from ..train import AdamWConfig, LoopConfig, run_training
from ..train.optimizer import leaves
from ..train.step import compresses, grad_bucket_plan
from .mesh import make_host_mesh, make_mesh

STATE_BYTES_PER_PARAM = 12          # float32 params, mu and nu
KEEP = 3                            # checkpoints kept, as the reference's


def state_bytes(api, pods: int = 0) -> int:
    """Bytes of the train state the checkpoints hold: float32 params, mu
    and nu, and the int32 step; with ``pods`` (a compressed pod
    reduction), each pod's float32 residuals of every padded bucket."""
    n = sum(math.prod(spec.shape) for spec in leaves(api.init_specs()))
    err = pods * 4 * sum(grad_bucket_plan(api).padded_sizes) if pods else 0
    return n * STATE_BYTES_PER_PARAM + 4 + err


def checkpoint_geometry(nbytes: int, *, keep: int, staging_file_bytes: int,
                        staging_prealloc: int) -> Tuple[VolumeGeometry, int]:
    """The geometry and device bytes of a PM volume for ``keep + 1``
    checkpoints of ``nbytes`` each (the ``keep`` committed ones and the one
    being staged) written by a ``CheckpointManager`` in pieces of at most
    ``CHUNK_BYTES``, its default.

    Data: the committed checkpoints; the staged one, in whole staging
    files (a piece that does not fit a file's tail moves to the next file
    and leaves that tail unused, so a file holds at least
    ``file - chunk``, or half a file, of it); as much again as one
    checkpoint for the relink's temporary blocks (it maps a block at
    every hole of the target before the swap); the tails the committed
    ones left; and three times the staging files' preallocation (a
    remount leaves the old store's files in place).  Metadata: the K-Split
    checkpoint writes 16 B per mapped block plus a small header per inode,
    so it is sized for every block of the data region (a remount's
    checkpoint maps the staging files' preallocated blocks beside the
    committed checkpoints, and at a state small beside the staging files
    those outnumber a few checkpoints' blocks); the journal takes one 25 B
    map record per staged block before it checkpoints, so it is sized for
    one checkpoint.
    """
    blocks = -(-nbytes // BLOCK_SIZE) + 64
    file_use = max(staging_file_bytes - CHUNK_BYTES, staging_file_bytes // 2)
    files = nbytes // file_use + 2
    staged = files * staging_file_bytes
    tails = keep * files * min(CHUNK_BYTES, staging_file_bytes)
    data_bytes = ((keep + 1) * blocks * BLOCK_SIZE + staged + tails
                  + 3 * staging_prealloc * staging_file_bytes)
    data_blocks = -(-data_bytes // BLOCK_SIZE) + 64
    meta_blocks = max(512, -(-data_blocks * 16 // BLOCK_SIZE) + 256)
    journal_blocks = max(1024, -(-blocks * 48 // BLOCK_SIZE) + 256)
    geometry = VolumeGeometry(meta_blocks=meta_blocks,
                              journal_blocks=journal_blocks,
                              oplog_slots=2, oplog_blocks=512)
    return geometry, geometry.data_base() * BLOCK_SIZE + data_bytes \
        + 64 * BLOCK_SIZE


def checkpoint_volume(nbytes: int, *, mode: Mode, keep: int,
                      staging_file_bytes: int = 16 * 1024 * 1024,
                      staging_prealloc: int = 4,
                      device: Optional[PMDevice] = None) -> USplit:
    """A formatted PM volume of ``checkpoint_geometry`` and its store.
    ``device``: a PM device to format (its buffer reused), at least the
    size the volume needs; by default a new one."""
    geometry, size = checkpoint_geometry(
        nbytes, keep=keep, staging_file_bytes=staging_file_bytes,
        staging_prealloc=staging_prealloc)
    if device is None:
        device = PMDevice(size=size)
    elif device.size < size:
        raise ValueError(f"PM device of {device.size} B; the volume needs "
                         f"{size} B")
    volume = Volume.format(device, geometry)
    return USplit(volume, mode=mode, staging_file_bytes=staging_file_bytes,
                  staging_prealloc=staging_prealloc,
                  staging_background=False)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mode", choices=["posix", "sync", "strict"],
                    default="sync")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", type=int, default=0,
                    help="this host's worker id (multi-host deployment)")
    ap.add_argument("--workers", type=int, default=1,
                    help="shard-owning workers in the deployment")
    ap.add_argument("--spares", type=int, default=0,
                    help="idle spare workers registered with the fault "
                         "policy (work-stealing pool, DESIGN.md §9b)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="seconds of silence before a worker is declared "
                         "dead; 0 (default) disables death detection — "
                         "REQUIRED single-host, where only this process's "
                         "own heartbeats exist and every other registered "
                         "worker would spuriously 'die' after 60s. "
                         "Multi-host deployments pass a real timeout.")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the kernels' "
                         "plain PyTorch versions)")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM over the torchrun ranks (default: "
                         "every rank on the model axis)")
    ap.add_argument("--codec", choices=CODECS + ("none",), default="int8",
                    help="the pod reduction's codec, over a mesh with a "
                         "pod axis")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    api = build_model(cfg)
    pipeline = TokenPipeline(cfg, global_batch=args.global_batch,
                             seq_len=args.seq_len, seed=args.seed)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if args.spares or args.heartbeat_timeout:
            raise ValueError("--spares and --heartbeat-timeout over a mesh "
                             "wait for ROADMAP item 7.6e")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        try:
            mesh = make_mesh(tuple(int(x) for x in args.mesh.split("x"))) \
                if args.mesh else make_host_mesh()
            train_over(args, api, pipeline, device, mesh)
        finally:
            dist.destroy_process_group()
        return
    if args.mesh is not None:
        raise ValueError("--mesh needs the ranks torchrun starts")
    train_over(args, api, pipeline, device, None)


def train_over(args, api, pipeline, device, mesh) -> None:
    """``main``'s run on ``device``, over ``mesh`` (None: one device)."""
    lead = mesh is None or dist.get_rank() == 0
    pods = mesh.shape["pod"] if mesh is not None and "pod" in mesh.shape \
        and compresses(api, args.codec) else 0
    store = ckpt = None
    if lead:
        store = checkpoint_volume(state_bytes(api, pods),
                                  mode=Mode[args.mode.upper()], keep=KEEP)
        ckpt = CheckpointManager(store, keep=KEEP)
    workers = list(range(args.workers))
    spares = list(range(args.workers, args.workers + args.spares))
    monitor = None if mesh is not None else HeartbeatMonitor(
        workers + spares,
        timeout_s=args.heartbeat_timeout or float("inf"))
    policy = None
    if spares:
        # the spare-worker pool: stragglers get stolen from before the
        # remesh fallback is ever planned (steal-vs-remesh, DESIGN.md §9b);
        # the port trains on one device: one chip a worker, no model or pod
        # axis
        policy = FaultPolicy(
            monitor, assignment={w: w for w in workers}, spares=spares,
            chips_per_worker=1, model_axis=1, pod_axis=1)

    result = run_training(
        api, pipeline,
        LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                   microbatches=args.microbatches, seed=args.seed,
                   codec=args.codec),
        AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                    total_steps=args.steps),
        ckpt=ckpt, monitor=monitor, worker=args.worker, policy=policy,
        device=device, mesh=mesh)
    if not lead:
        return
    if mesh is not None:
        print(f"[train] mesh {mesh.shape} over {mesh.size} ranks, codec "
              f"{args.codec}")
    print(f"[train] losses {json.dumps(result.losses)}")
    print(f"[train] {args.arch}: ran {result.steps_run} steps, "
          f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f}"
          + (f" (restored from step {result.restored_from})"
             if result.restored_from else ""))
    if result.mitigations:
        print(f"[train] mitigations: {result.mitigations}")
    if result.remesh_pending is not None:
        print(f"[train] remesh pending: {result.remesh_pending.mesh_shape}")
    print(f"[train] store: {store.stats}")


if __name__ == "__main__":
    main()
