#!/usr/bin/env python3
"""chip_smoke.py's phase-1 paged-attention cases at MLA's latent width
(D=576, bf16 and float32) and in float32 (the standalone op and the fused
append), and the latent op over every step of phase 12's serve cell,
timed for several checkouts of this repository on one card, in turns.

    python3 tools/paged_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (the parent commit unpacked with ``git archive``
into a directory that .gitignore lists, say); give them in the order to run,
e.g. ``build/parent . . build/parent``.  Every ROOT runs in a process of its
own (each builds its own ``repro_torch`` kernels) through that ROOT's own
``chip_smoke.attention_case`` / ``fused_case``, so each tree's kernels are
held against their plain versions and timed by its own code, on the same
inputs (one seed per case).  A case that needs an argument a tree's
``attention_case`` does not take (``page_tokens``: pages of another size;
``short``: contexts of at most two pages) is reported as not run there.
Prints, per ROOT and case, one JSON line with the CUPTI device ms (every
kernel the op launches, the split merge included), the plain version's,
SDPA's where the case has it, the bound and the split count.

Then, per ROOT, the serve cell's schedule: the (C, lengths) that the
attention op is handed at each step of chip_smoke's serve cell (phase 2's
and phase 12's 8 requests, 32 new tokens each, max_batch 8, pages of 16),
read from the port's engine on the CPU with the SMOKE qwen2 (the schedule
depends on the prompts' lengths, not on the model), is replayed through
the tree's latent op (deepseek's shape: 16 heads over one KV head of 576,
bf16, one pool passed as K and V; random q and pool from one seed), each
step's output held against the plain version, and timed as CUPTI device
ms summed over the C=16 steps, over the first two of them (phase 12's
profiled prefill window) and over the C=1 steps: one layer's latent
attention; a deepseek step runs it on each of its 27 layers.  Last, the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import sys
from pathlib import Path

from flash_ab import turns     # tools/ is the script's own directory

LATENT = {"h": 16, "kv": 1, "d": 576, "alias": True}
# (name, chip_smoke function, C, keyword arguments; the dtype by name)
CASES = [
    ("attention D=576 C=16 bf16", "attention_case", 16, LATENT),
    ("attention D=576 C=1 bf16", "attention_case", 1, LATENT),
    ("attention D=576 C=16 T=8 bf16", "attention_case", 16,
     {**LATENT, "page_tokens": 8}),
    ("attention D=576 C=1 T=8 bf16", "attention_case", 1,
     {**LATENT, "page_tokens": 8}),
    ("attention D=576 C=16 full table bf16", "attention_case", 16,
     {**LATENT, "full": True}),
    ("attention D=576 C=1 full table bf16", "attention_case", 1,
     {**LATENT, "full": True}),
    ("attention D=576 C=16 short contexts bf16", "attention_case", 16,
     {**LATENT, "short": True}),
    ("attention D=576 C=16 float32", "attention_case", 16,
     {**LATENT, "dtype": "float32"}),
    ("attention D=576 C=1 float32", "attention_case", 1,
     {**LATENT, "dtype": "float32"}),
    ("attention D=576 C=16 window=256 float32", "attention_case", 16,
     {**LATENT, "dtype": "float32", "window": 256}),
    ("attention C=16 float32", "attention_case", 16, {"dtype": "float32"}),
    ("attention C=1 float32", "attention_case", 1, {"dtype": "float32"}),
    ("fused C=16 float32", "fused_case", 16, {"dtype": "float32"}),
    ("fused C=1 float32", "fused_case", 1, {"dtype": "float32"}),
]
KEYS = ("ms", "ms_timing", "plain_ms", "library_ms", "unfused_ms",
        "bound_ms", "bound_by", "splits", "max_abs_err")


def run_tree(root: Path, turn: int) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)          # puts root/src first on sys.path
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, (name, fn, C, kw) in enumerate(CASES):
        kw = dict(kw)
        if "dtype" in kw:
            kw["dtype"] = getattr(torch, kw["dtype"])
        takes = inspect.signature(getattr(cs, fn)).parameters
        if any(k not in takes for k in kw):
            print(json.dumps({"tree": str(root), "turn": turn, "case": name,
                              "not_run": "takes no "
                              + ", ".join(k for k in kw if k not in takes)}),
                  flush=True)
            continue
        c = getattr(cs, fn)(np.random.default_rng(i), C, name, **kw)
        print(json.dumps({"tree": str(root), "turn": turn, "case": name,
                          **{k: c.get(k) for k in KEYS}}), flush=True)
    run_schedule(cs, root, turn)


def serve_schedule(cs) -> list:
    """(C, lengths) of each step of chip_smoke's serve cell, as its first
    layer's attention op gets them (``cs``: a tree's chip_smoke, whose
    ``repro_torch`` is imported)."""
    import numpy as np
    import torch
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.core import Mode, OpLog, PMDevice
    from repro_torch.models import build_model, init_params
    from repro_torch.serve import ServeClient

    cfg = get_config("qwen2-1.5b", smoke=True)
    api = build_model(cfg)
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    oplog = OpLog(PMDevice(size=16 * 1024 * 1024), base_block=1,
                  num_blocks=64)
    client = ServeClient(api, params, max_batch=8, max_seq=cs.MAX_SEQ,
                         page_tokens=cs.T, oplog=oplog, device="cpu")
    sessions = (client.open_session(mode=Mode.POSIX),
                client.open_session(mode=Mode.STRICT))
    rng = np.random.default_rng(0)          # serve_main_path's prompts
    for i, n in enumerate(rng.integers(64, 481, 8)):
        sessions[i % 2].submit(rng.integers(1, cfg.vocab, int(n)).tolist(),
                               32)
    steps, first = [], [True]
    real = attention.paged_attention_append_chunk

    def record(q, k, v, pool_k, pool_v, page_table, lengths, *a, **kw):
        if first[0]:
            steps.append((q.shape[1], lengths.tolist()))
            first[0] = False
        return real(q, k, v, pool_k, pool_v, page_table, lengths, *a, **kw)

    attention.paged_attention_append_chunk = record
    try:
        eng = client.engine
        while eng.waiting or eng.active:
            first[0] = True
            eng.step()
    finally:
        attention.paged_attention_append_chunk = real
    return steps


def run_schedule(cs, root: Path, turn: int) -> None:
    """The latent op over the serve cell's schedule, on ``cs``'s tree."""
    import numpy as np
    import torch
    from repro_torch.kernels import common, paged_attention_chunk

    steps = serve_schedule(cs)
    rng = np.random.default_rng(0)
    pt = cs.page_table(rng)
    pool = cs.randn(rng, cs.B * cs.MAX_SEQ // cs.T, cs.T, 1, 576)
    calls, splits, err = [], [], 0.0
    for C, lengths in steps:
        q = cs.randn(rng, cs.B, C, 16, 576)
        L = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = paged_attention_chunk(q, pool, pool, pt, L)
        splits.append(common.LAST_SPLITS["paged_attention_chunk"])
        ref = paged_attention_chunk(q, pool, pool, pt, L, impl="ref")
        tol = cs.PAGED_TOL[torch.bfloat16]
        assert torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        err = max(err, float((out.float() - ref.float()).abs().max()))
        calls.append((C, q, L))

    def over(sel):
        def fn():
            for C, q, L in sel:
                paged_attention_chunk(q, pool, pool, pt, L)
        return cs.device_ms(fn, reps=5)

    wide = [c for c in calls if c[0] > 1]
    narrow = [c for c in calls if c[0] == 1]
    print(json.dumps({
        "tree": str(root), "turn": turn,
        "case": "latent D=576 bf16 over the serve cell's steps",
        "steps_c16": len(wide), "steps_c1": len(narrow),
        "splits_c16": sorted(set(s for (C, _), s in zip(steps, splits)
                                 if C > 1)),
        "splits_c1": sorted(set(s for (C, _), s in zip(steps, splits)
                                if C == 1)),
        "ms_c16_steps": over(wide), "ms_first_two_c16_steps": over(wide[:2]),
        "ms_c1_steps": over(narrow), "max_abs_err": err,
        "longest_context": max(max(L) for _, L in steps)}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        run_tree(Path(sys.argv[2]).resolve(), int(sys.argv[3]))
        return 0
    return turns(__file__, sys.argv[1:], __doc__)


if __name__ == "__main__":
    sys.exit(main())
