#!/usr/bin/env python3
"""chip_smoke.py's phase 17 (the mesh serve step) on its own, and what its
logit gate can tell apart.

    python3 tools/mesh_gate.py [--phase17] [--broken] [--cases] [--phase1]
                               [--windows]

``--phase17`` runs ``chip_smoke.phase17`` (qwen2-72b at full width on 4
layers: (a) unsharded in this process, (b) gloo ranks on the card at
meshes (1, 4) and (2, 2)), a failing gate logged with its error;
``--broken`` runs it through a copy whose MLP all_reduce drops rank 1's
partial sum (patched into the spawned ranks' ``repro_torch.models.layers``)
and logs, for every rank and lane, the largest logit difference to (a)
and the greedy tokens that differ where (a)'s top-2 gap exceeds the
noise; ``--cases`` holds the fused op at a rank's shape (phase 1's two
qwen2-72b cases); ``--phase1`` runs every phase-1 case and logs its
seconds; ``--windows`` times 20 CUPTI windows of one small kernel, the
cost of a window.  With no flag it does ``--phase17``, ``--broken`` and
``--cases``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.models import layers, shardctx  # noqa: E402


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def drop_rank_1(x: torch.Tensor) -> torch.Tensor:
    """The MLP's all_reduce without rank 1's partial sum."""
    if shardctx.model_rank() == 1:
        x = torch.zeros_like(x)
    return shardctx.model_all_reduce(x)


def broken_rank_entry(rank, world, tmp, base):
    """``chip_smoke._mesh_rank_entry`` with ``drop_rank_1`` patched into
    the MLP (in the spawned rank, where the step runs)."""
    layers.model_all_reduce = drop_rank_1
    cs._mesh_rank_entry(rank, world, tmp, base)


def readings(out: dict) -> list:
    rows = []
    for mesh in out["meshes"]:
        for r in mesh["ranks"]:
            for lane, _ in cs.MESH_LANES:
                if lane in r:
                    x = r[lane]
                    rows.append({k: x.get(k) for k in (
                        "max_abs_err", "logit_max_abs", "positions",
                        "tokens_checked", "prefill_ms", "decode_ms_median")}
                        | {"mesh": mesh["mesh"], "rank": r["rank"],
                           "lane": lane,
                           "tokens_wrong": len(x["tokens_wrong"])})
    return rows


def windows(reps: int = 20) -> dict:
    """The host seconds of ``reps`` CUPTI windows around one launch."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    out = {}
    for acts in (("cuda",), ("cpu", "cuda")):
        kinds = [getattr(ProfilerActivity, a.upper()) for a in acts]
        t0 = time.perf_counter()
        for _ in range(reps):
            with profile(activities=kinds) as prof:
                x.add_(1)
                torch.cuda.synchronize()
            cs.trace_events(prof)
        out["+".join(acts)] = (time.perf_counter() - t0) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    for flag in ("phase17", "broken", "cases", "phase1", "windows"):
        ap.add_argument(f"--{flag}", action="store_true")
    args = ap.parse_args()
    every = not (args.phase17 or args.broken or args.cases or args.phase1
                 or args.windows)
    if not torch.cuda.is_available():
        print("mesh_gate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    common.library()
    emit(build_s=time.perf_counter() - t0)
    failed = []

    def attempt(name: str, fn) -> None:
        """Run one part, its error logged; the later parts still run."""
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            failed.append(name)
            emit(part=name, error=traceback.format_exc())
        emit(part=name, seconds=time.perf_counter() - t0)

    def cases() -> None:
        rng = np.random.default_rng(0)
        for C in (16, 1):
            emit(case=cs.fused_case(
                rng, C, f"fused D=128 H=16 KV=2 C={C}", h=16, kv=2, d=128,
                library=True))

    def phase1() -> None:
        got = cs.phase1_cases()
        emit(cases=len(got), events_timed=[
            c["case"] for c in got if c.get("ms_timing") == "events"],
             case_s=sum(c["case_s"] for c in got),
             timing_s={k: sum(c["timing_s"][k] for c in got)
                       for k in ("events_s", "cupti_s")})

    def phase17() -> None:
        emit(lane="phase 17", readings=readings(cs.phase17(card)))

    def broken() -> None:
        emit(lane="MLP all_reduce drops rank 1", readings=readings(
            cs.phase17(card, entry=broken_rank_entry)))

    if args.windows:
        attempt("windows", lambda: emit(window_s=windows()))
    if args.cases or every:
        attempt("cases", cases)
    if args.phase1:
        attempt("phase1", phase1)
    if args.phase17 or every:
        attempt("phase17", phase17)
    if args.broken or every:
        attempt("broken", broken)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
