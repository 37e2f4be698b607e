#!/usr/bin/env python3
"""chip_smoke.py's phase 16 (the compressed gradient reduction) on its
own, and what its gates can tell apart.

    python3 tools/codec_gate.py [--phase16] [--gate] [--two-ranks]
                                [--seeds 0 1 2]

``--phase16`` runs ``chip_smoke.phase16`` ((a) one rank at full width and
depth through every codec, (b) two ranks on the card over gloo), a
failing gate logged with its error; ``--two-ranks`` runs phase 16 (b)
through a broken copy of the group's mean (a sum never divided by the
group's size) and logs what (b)'s gates read; ``--gate`` runs phase 16 (a)'s
``chip_smoke.pod_one_rank`` on qwen2-1.5b at full width and depth at each
seed through codec none, int8 and top-k, and through two broken copies of
the int8 codec (patched into ``repro_torch.dist.compression`` for the
run): one drops the residual (no error feedback: the new residual is
zero), one rounds by truncation (``torch.trunc`` for ``torch.round``).
Each lane logs its losses, its loss gap to codec none's at that seed, the
``CodecProbe``'s readings and failures and the codec's ms a step.  With
no flag it does all three.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import compression as c  # noqa: E402
from repro_torch.kernels import common  # noqa: E402


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def drop_residual(flat, err, group):
    """int8 with no error feedback: the residual is thrown away."""
    q, scale, pad, new_err = c.quantize_with_feedback(flat, err)
    deq = c.dequantize_int8(q, scale, pad, flat.shape)
    return c._mean(deq, group), torch.zeros_like(new_err)


def truncate_int8(x, *, block=c.BLOCK):
    """``quantize_int8`` rounding toward zero."""
    flat = x.reshape(-1).to(torch.float32)
    pad = c._pad_amount(flat.numel(), block)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True)
                            / c._QMAX, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.trunc(blocks / scale), -c._QMAX,
                    c._QMAX).to(torch.int8)
    return q, scale, pad


@contextlib.contextmanager
def patched(name: str, fn):
    real = getattr(c, name)
    setattr(c, name, fn)
    try:
        yield
    finally:
        setattr(c, name, real)


def undivided_mean(x, group):
    """The group's sum where the codec takes its mean."""
    torch.distributed.all_reduce(x, op=torch.distributed.ReduceOp.SUM,
                                 group=group)
    return x


def undivided_rank_entry(rank, world, tmp, layers, steps):
    """``chip_smoke._pod_rank_entry`` with ``undivided_mean`` patched in
    (in the spawned rank, where the codec runs)."""
    c._mean = undivided_mean
    cs._pod_rank_entry(rank, world, tmp, layers, steps)


LANES = {"int8 drops the residual": ("compressed_psum", drop_residual),
         "int8 truncates": ("quantize_int8", truncate_int8)}


def summary(run: dict) -> dict:
    return {k: run.get(k) for k in (
        "losses", "loss_gap_vs_none", "readings", "failures",
        "residual_nonzero", "codec_ms", "codec_share",
        "step_ms_without_checks", "launches_per_step", "peak_mem_gb")}


def gate(seeds, card: str) -> None:
    cfg = get_config("qwen2-1.5b")
    flash_step = {"flash_attention": 2 * cfg.n_layers * cs.TRAIN_MB,
                  "flash_attention_bwd": cfg.n_layers * cs.TRAIN_MB}
    for seed in seeds:
        t0 = time.perf_counter()
        res = cs.pod_one_rank(cfg, seed=seed, expected=flash_step)
        none = res["runs"]["none"]["losses"]
        emit(card=card, seed=seed, plan=res["plan"],
             seconds=time.perf_counter() - t0)
        for codec, run in res["runs"].items():
            emit(seed=seed, lane=codec, **summary(run))
        for lane, (name, fn) in LANES.items():
            with patched(name, fn):
                run = cs.pod_one_rank(cfg, seed=seed, codecs=("int8",),
                                      expected=flash_step)["runs"]["int8"]
            run["loss_gap_vs_none"] = max(
                abs(a - b) for a, b in zip(run["losses"], none))
            emit(seed=seed, lane=lane, **summary(run))


def two_ranks(card: str) -> None:
    res = cs.pod_two_ranks(entry=undivided_rank_entry)
    runs = res["ranks"][0]["runs"]
    emit(card=card, lane="two ranks, the sum undivided",
         seconds=res["seconds"],
         loss_gap_vs_none=max(abs(a - b) for a, b in zip(
             runs["int8"]["losses"], runs["none"]["losses"])),
         **{codec: {k: run.get(k) for k in (
             "losses", "readings", "failures", "params_equal",
             "residual_rows_differ")} for codec, run in runs.items()})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase16", action="store_true")
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--two-ranks", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    args = ap.parse_args()
    every = not (args.phase16 or args.gate or args.two_ranks)
    if not torch.cuda.is_available():
        print("codec_gate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    common.library()
    rc = 0
    if args.phase16 or every:
        t0 = time.perf_counter()
        try:
            cs.phase16(card)
        except Exception:
            rc = 1
            emit(phase16_error=traceback.format_exc())
        emit(phase16_seconds=time.perf_counter() - t0)
    if args.two_ranks or every:
        two_ranks(card)
    if args.gate or every:
        gate(args.seeds, card)
    return rc


if __name__ == "__main__":
    sys.exit(main())
