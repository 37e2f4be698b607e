#!/usr/bin/env python3
"""chip_smoke.py's phase-1 flash cases, forward (bf16 and float32) and
backward, timed for several checkouts of this repository on one card, in
turns.

    python3 tools/flash_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (the parent commit unpacked with ``git archive``
into a directory that .gitignore lists, say); give them in the order to run,
e.g. ``build/parent . . build/parent``.  Every ROOT runs in a process of its
own (each builds its own ``repro_torch`` kernels) through that ROOT's own
``chip_smoke.flash_case`` and ``flash_bwd_case``, so each tree's kernels
are held against their plain versions and timed by its own code, on the
same inputs (one seed per case).  A tree without ``flash_bwd_case`` (one
whose backward is the plain ``blockwise_bwd`` on the card) has that
backward, and forward + backward through its autograd, timed the same way
on the same inputs.  Prints, per ROOT and case, one JSON line with the
CUPTI device ms, SDPA's ms and the achieved TFLOP/s (the backward's: five
products of the forward's size); then the card's name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

# (name, S, keyword arguments of chip_smoke.flash_case): phase 1's bf16 cases
CASES = [
    ("flash S=4096 causal", 4096, {}),
    ("flash S=4096 causal D=64", 4096, {"D": 64}),
    ("flash S=4096 causal D=256", 4096, {"D": 256}),
    ("flash S=4096 window=1024", 4096, {"window": 1024}),
    ("flash S=4096 softcap=30", 4096, {"softcap": 30.0}),
    ("flash S=4096 non-causal", 4096, {"causal": False}),
    ("flash S=1000 ragged", 1000, {}),
]
# phase 1's bf16 backward cases, keyword arguments of flash_bwd_case
BWD_CASES = [("flash bwd" + name[5:], S, kw) for name, S, kw in CASES]
# phase 1's float32 forward cases (the dtype by name: torch loads later)
F32_CASES = [
    ("flash S=512 D=64 float32", 512, {"D": 64}),
    ("flash S=1000 ragged float32", 1000, {}),
    ("flash S=1000 window=256 float32", 1000, {"window": 256}),
    ("flash S=1000 softcap=30 float32", 1000, {"softcap": 30.0}),
]


def plain_bwd_case(cs, rng, name: str, S: int, causal=True, window=None,
                   softcap=None, D=128) -> dict:
    """A tree whose backward on the card is the plain ``blockwise_bwd``:
    that backward, and forward + backward through its autograd, on the
    inputs ``flash_bwd_case`` draws."""
    import torch
    from repro_torch.kernels import attention, attention_fwd, blockwise_bwd

    q, k, v = cs.flash_inputs(rng, S, torch.bfloat16, D)
    g = cs.randn(rng, *q.shape, dtype=torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = attention_fwd(q, k, v, **kw)
    req = [x.detach().requires_grad_() for x in (q, k, v)]
    t = cs.timings(ms=lambda: blockwise_bwd(q, k, v, out, lse, g, **kw),
                   fwd_bwd_ms=lambda: torch.autograd.grad(
                       attention(*req, **kw), req, g))
    flops = 10 * cs.H * D * cs.visible_keys(S, S, causal, window)
    return {**t, "flops": flops, "library_ms": None, "max_abs_err": 0.0}


def run_tree(root: Path, turn: int) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)          # puts root/src first on sys.path
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd = CASES + [(name, S, {**kw, "dtype": torch.float32})
                   for name, S, kw in F32_CASES]
    for i, (name, S, kw) in enumerate(fwd):
        c = cs.flash_case(np.random.default_rng(i), name, S, **kw)
        print(json.dumps({"tree": str(root), "turn": turn, "case": name,
                          "ms": c["ms"], "ms_timing": c["ms_timing"],
                          "library_ms": c["library_ms"],
                          "tflops": c["flops"] / c["ms"] / 1e9,
                          "max_abs_err": c["max_abs_err"],
                          "lse_max_abs_err": c["lse_max_abs_err"]}),
              flush=True)
    for i, (name, S, kw) in enumerate(BWD_CASES):
        rng = np.random.default_rng(100 + i)
        if hasattr(cs, "flash_bwd_case"):
            c = cs.flash_bwd_case(rng, name, S, **kw)
        else:
            c = plain_bwd_case(cs, rng, name, S, **kw)
        print(json.dumps({"tree": str(root), "turn": turn, "case": name,
                          "ms": c["ms"], "ms_timing": c["ms_timing"],
                          "fwd_bwd_ms": c["fwd_bwd_ms"],
                          "library_ms": c["library_ms"],
                          "tflops": c["flops"] / c["ms"] / 1e9,
                          "max_abs_err": c["max_abs_err"]}), flush=True)


def turns(script: str, args, doc: str) -> int:
    """Run ``script --one ROOT TURN`` for each ROOT of ``args`` in turn, one
    process per tree, then print the card's name and power limit."""
    roots = [Path(r).resolve() for r in args]
    if not roots:
        print(doc, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print(f"{Path(script).name}: needs a CUDA card", file=sys.stderr)
        return 2
    for turn, root in enumerate(roots):
        if not (root / "chip_smoke.py").exists():
            print(f"{Path(script).name}: no chip_smoke.py in {root}",
                  file=sys.stderr)
            return 2
        rc = subprocess.run([sys.executable, script, "--one", str(root),
                             str(turn)]).returncode
        if rc:
            return rc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        run_tree(Path(sys.argv[2]).resolve(), int(sys.argv[3]))
        return 0
    return turns(__file__, sys.argv[1:], __doc__)


if __name__ == "__main__":
    sys.exit(main())
