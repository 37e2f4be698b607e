"""Training loop on one device (port of ``repro/train/loop.py``): data
pipeline -> train_step -> checkpoint -> fault path.

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
step then updates.  The reference's pod-reduction codec options are
ROADMAP queue 1, item 5.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import TokenPipeline
from ..dist.fault import FaultPolicy, HeartbeatMonitor, RemeshPlan, StealPlan
from ..kernels.common import resolve_device
from ..models.registry import ModelAPI
from ..models.spec import init_params
from .optimizer import AdamWConfig
from .step import make_train_step


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0


@dataclass
class LoopResult:
    losses: List[float] = field(default_factory=list)
    restored_from: Optional[int] = None
    steps_run: int = 0
    mitigations: List[Any] = field(default_factory=list)  # Steal/RemeshPlans
    remesh_pending: Optional[RemeshPlan] = None
    # host seconds per step, ending when the loss reached the host
    step_seconds: List[float] = field(default_factory=list)


def run_training(api: ModelAPI, pipeline: TokenPipeline,
                 loop_cfg: LoopConfig, opt_cfg: AdamWConfig, *,
                 ckpt: Optional[CheckpointManager] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 worker: int = 0,
                 policy: Optional[FaultPolicy] = None,
                 device="cuda", crash_at: Optional[int] = None) -> LoopResult:
    """Run (or resume) training.  ``crash_at`` raises after that step's
    checkpointable state exists — tests use it to exercise restart."""
    dev = resolve_device(device)
    train_step, init_state = make_train_step(
        api, opt_cfg, microbatches=loop_cfg.microbatches)
    gen = torch.Generator(device=dev).manual_seed(loop_cfg.seed)
    state = init_state(init_params(api.init_specs(), gen, device=dev),
                       device=dev)
    result = LoopResult()
    start = 0
    if ckpt is not None:
        restored = ckpt.restore(state)
        if restored is not None:
            start, state, extra = restored
            pipeline.restore(extra.get("pipeline_step", start))
            result.restored_from = start

    for step in range(start, loop_cfg.steps):
        t0 = time.monotonic()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipeline).items()}
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
        if ckpt is not None and (step + 1) % loop_cfg.ckpt_every == 0:
            ckpt.save(step + 1, state,
                      extra={"pipeline_step": pipeline.snapshot()})
        if crash_at is not None and step + 1 >= crash_at:
            raise RuntimeError(f"injected crash at step {step + 1}")
    return result
