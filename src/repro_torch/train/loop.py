"""The training loop on one device (port of ``repro/train/loop.py``):
data pipeline -> train_step, with the reference's divergence check.

Parameters are drawn from ``torch.Generator(device).manual_seed(seed)``
(other numbers than JAX's from the same seed); batches come from the
numpy pipeline and go to the device with ``torch.from_numpy(...).to``.
The SplitFS checkpoint manager, heartbeats and the fault policy are the
next slice's (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..data.pipeline import TokenPipeline
from ..kernels.common import resolve_device
from ..models.registry import ModelAPI
from ..models.spec import init_params
from .optimizer import AdamWConfig
from .step import make_train_step


@dataclass
class LoopConfig:
    steps: int = 100
    microbatches: int = 1
    seed: int = 0


@dataclass
class LoopResult:
    losses: List[float] = field(default_factory=list)
    steps_run: int = 0
    # host seconds per step, ending when the loss reached the host
    step_seconds: List[float] = field(default_factory=list)


def run_training(api: ModelAPI, pipeline: TokenPipeline,
                 loop_cfg: LoopConfig, opt_cfg: AdamWConfig, *,
                 device="cuda", crash_at: Optional[int] = None) -> LoopResult:
    """Run ``loop_cfg.steps`` steps from freshly drawn parameters.
    ``crash_at`` raises after that step, as the reference's does."""
    dev = resolve_device(device)
    train_step, init_state = make_train_step(
        api, opt_cfg, microbatches=loop_cfg.microbatches)
    gen = torch.Generator(device=dev).manual_seed(loop_cfg.seed)
    state = init_state(init_params(api.init_specs(), gen, device=dev),
                       device=dev)
    result = LoopResult()
    for step in range(loop_cfg.steps):
        t0 = time.monotonic()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipeline).items()}
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        result.step_seconds.append(time.monotonic() - t0)
        result.losses.append(loss)
        result.steps_run += 1
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}: {loss}")
        if crash_at is not None and step + 1 >= crash_at:
            raise RuntimeError(f"injected crash at step {step + 1}")
    return result
