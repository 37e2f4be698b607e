#!/usr/bin/env python3
"""One save and one restore of qwen2-1.5b's train state at full width and
depth through the port's SplitFS checkpoint path, timed by part.

    python3 tools/ckpt_time.py [--layers N] [--phase11 L] [--entry]

Builds the train state on the card (random parameters, one AdamW step at
chip_smoke.py phase 4's shape, so ``mu``, ``nu`` and ``step`` are real),
saves it through a ``CheckpointManager`` over a SYNC ``USplit`` sized for
one checkpoint (``launch.train.checkpoint_volume``), restores it and holds
every leaf bitwise to the live state.  Prints one JSON line with the card,
the state's bytes and the save's and restore's ms, GB/s and parts (D2H /
H2D, the store's write / read, the relink fsync, the manifest, the crc),
and the host seconds a GB.  ``--layers`` cuts the depth; ``--phase11 L``
then runs chip_smoke.py's phase 11 (a) at depth L and ``--entry`` its (b)
entry-point runs, each as one more JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Mode  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch.train import state_bytes  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step  # noqa: E402


def save_restore(layers=None) -> dict:
    cfg = get_config("qwen2-1.5b")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = build_model(cfg)
    nbytes = state_bytes(api)
    step, init_state = make_train_step(
        api, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=4),
        microbatches=cs.TRAIN_MB)
    state = init_state(cs.fresh_params(api))
    state, m = step(state, cs.train_batch(cfg, cs.TRAIN_BATCH))
    float(m["loss"])
    cs.release()
    print(f"state: {nbytes} B", flush=True)
    t0 = time.perf_counter()
    store = cs.ckpt_store(nbytes, Mode.SYNC, cs.CKPT_STAGING_BYTES, keep=0)
    format_s = time.perf_counter() - t0
    print(f"formatted {store.device.size} B in {format_s:.1f} s", flush=True)
    mgr = CheckpointManager(store, keep=1)
    mgr.save(1, state)
    save = cs.ckpt_times(mgr.last_save)
    print("save", json.dumps(save), flush=True)
    got = mgr.restore(state)
    restore = cs.ckpt_times(mgr.last_restore)
    equal = cs.state_equal(got[1], state)
    del got
    out = {"layers": cfg.n_layers, "state_bytes": nbytes,
           "format_s": format_s, "save": save, "restore": restore,
           "bitwise": equal, "copied_bytes": store.stats.copied_bytes,
           "relinked_blocks": store.stats.relinked_blocks,
           "save_plus_restore_s": (save["ms"] + restore["ms"]) / 1e3,
           "host_s_per_gb": (save["ms"] + restore["ms"]) / 1e3
           / (nbytes / 1e9),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    assert equal and out["copied_bytes"] == 0, out
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--phase11", type=int, default=None)
    ap.add_argument("--entry", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    common.library()
    print(json.dumps({"card": card, "save_restore": save_restore(
        args.layers)}), flush=True)
    cs.release()
    if args.phase11 is not None:
        print(json.dumps({"card": card, "phase11": cs.checkpointed_trainer(
            get_config("qwen2-1.5b"), layers=args.phase11)}), flush=True)
        cs.release()
    if args.entry:
        for run, kernels in cs.ENTRY_RUNS:
            print(json.dumps({"card": card, "entry": cs.entry_point_run(
                run, kernels)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
