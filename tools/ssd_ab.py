#!/usr/bin/env python3
"""chip_smoke.py's phase-1 ssd_chunk cases, timed for several checkouts of
this repository on one card, in turns.

    python3 tools/ssd_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (the parent commit unpacked with ``git archive``
into a directory that .gitignore lists, say); give them in the order to run,
e.g. ``build/parent . . build/parent``.  Every ROOT runs in a process of its
own (each builds its own ``repro_torch`` kernels) through that ROOT's own
``chip_smoke.ssd_case`` / ``ssd_bwd_case`` / ``ssd_grad_case``, so each
tree's kernels are held against their plain versions and timed by its own
code, on the same inputs (one seed per case).  A tree without a backward
kernel (no ``ssd_bwd_case``) skips the backward-alone cases, and a case
whose shape a tree's wrapper refuses (ValueError) is reported as refused.
Prints, per
ROOT and case, one JSON line with the CUPTI device ms and the plain
version's; then the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

from flash_ab import turns     # tools/ is the script's own directory

PATH = dict(Bp=16, L=256, H=64, P=64, N=128)
RAGGED = dict(Bp=4, L=100, H=6, P=64, N=128)
CHUNK512 = dict(PATH, Bp=8, L=512)      # the path's tokens in chunks of 512
# (name, chip_smoke function, keyword arguments): phase 1's ssd cases
CASES = [
    ("ssd path float32", "ssd_case", PATH),
    ("ssd path bf16", "ssd_case", {**PATH, "dtype": "bfloat16"}),
    ("ssd ragged L=100 H=6", "ssd_case", RAGGED),
    ("ssd bwd path float32", "ssd_bwd_case", PATH),
    ("ssd bwd path bf16", "ssd_bwd_case", {**PATH, "dtype": "bfloat16"}),
    ("ssd bwd ragged L=100 H=6", "ssd_bwd_case", RAGGED),
    ("ssd grads path shape", "ssd_grad_case", PATH),
    ("ssd chunk 512 float32", "ssd_case", CHUNK512),
    ("ssd grads chunk 512", "ssd_grad_case", CHUNK512),
]


def run_tree(root: Path, turn: int) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)          # puts root/src first on sys.path
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, (name, fn, kw) in enumerate(CASES):
        if not hasattr(cs, fn):
            continue
        kw = dict(kw)
        if "dtype" in kw:
            kw["dtype"] = getattr(torch, kw["dtype"])
        try:
            c = getattr(cs, fn)(np.random.default_rng(i), name, **kw)
        except ValueError as e:
            print(json.dumps({"tree": str(root), "turn": turn, "case": name,
                              "refused": str(e)}), flush=True)
            continue
        print(json.dumps({"tree": str(root), "turn": turn, "case": name,
                          "ms": c["ms"], "ms_timing": c["ms_timing"],
                          "plain_ms": c["plain_ms"],
                          "bound_ms": c["bound_ms"],
                          "max_abs_err": c["max_abs_err"]}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        run_tree(Path(sys.argv[2]).resolve(), int(sys.argv[3]))
        return 0
    return turns(__file__, sys.argv[1:], __doc__)


if __name__ == "__main__":
    sys.exit(main())
