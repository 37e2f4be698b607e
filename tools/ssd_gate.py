#!/usr/bin/env python3
"""What chip_smoke.py's phase 7 (mamba2 kernel path against plain path) can
tell apart, and how far ssd_chunk's kernels sit from a float64 evaluation.

    python3 tools/ssd_gate.py [--f32]

Builds two throwaway copies of the ssd_chunk kernels under
``build/ssd_gate/`` (one whose forward drops key tile 1, one whose
backward does) and reads phase 7's numbers (``chip_smoke.train_path_vs_plain``
at seeds 0, 1, 2: loss gap, grad-norm gap, worst and median leaf error) for
four kernel-path lanes against the plain path: the kernels; the plain
version with its output times (1 + 1e-7 n), n standard normal; and the two
broken copies.  Activations are the config's bf16, or float32 with
``--f32``.  Without ``--f32`` it also holds the kernels' and the plain
versions' grads and output at the training shape (B'=16, L=256, H=64,
P=64, N=128) against the same formulas evaluated in float64, at seeds
0-2.  One JSON line per reading; needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import (common, ssd_chunk_bwd,  # noqa: E402
                                 ssd_chunk_bwd_plain, ssd_chunk_fwd,
                                 ssd_chunk_ref)
from repro_torch.kernels.ssd_chunk import ops  # noqa: E402
from repro_torch.kernels.ssd_chunk.ref import _decay  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SEEDS = (0, 1, 2)
# the causal test of both kernels' decay; `&& jt != 1` makes it drop key
# tile 1 (jt is the key tile in both)
DECAY = "const float e = (gj <= gi && gi < L)"
GATE_KEYS = ("loss_abs_diff", "grad_norm_rel_diff", "leaf_rel_err_max",
             "leaf_rel_err_median")


def broken_libraries() -> dict:
    """ctypes libraries of the two copies that drop key tile 1."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    fwd, bwd = ((csrc / f).read_text()
                for f in ("ssd_chunk.cu", "ssd_chunk_bwd.cu"))
    assert fwd.count(DECAY) == bwd.count(DECAY) == 1, "the decay line moved"
    drop = DECAY.replace("gi < L)", "gi < L && jt != 1)")
    copies = {"forward drops key tile 1": (fwd.replace(DECAY, drop), bwd),
              "backward drops key tile 1": (fwd, bwd.replace(DECAY, drop))}
    real = common.library()
    libs, procs = {}, []
    for i, (name, (f, b)) in enumerate(copies.items()):
        d = ROOT / "build" / "ssd_gate" / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "ssd_chunk.cu").write_text(f)
        (d / "ssd_chunk_bwd.cu").write_text(b)
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared", "-I", str(csrc),
               "-o", str(d / "lib.so"), str(d / "ssd_chunk.cu"),
               str(d / "ssd_chunk_bwd.cu")]
        procs.append((name, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, d, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ("repro_ssd_chunk", "repro_ssd_chunk_workspace",
                   "repro_ssd_chunk_bwd", "repro_ssd_chunk_bwd_workspace"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = lib
    return libs


def gate(f32: bool) -> None:
    cfg = get_config("mamba2-1.3b")
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    api = build_model(cfg)
    real, launch, launch_bwd = common.library(), ops._launch, ops._launch_bwd
    gen = torch.Generator(device="cuda").manual_seed(123)

    def noisy(*a):
        y = ssd_chunk_ref(*a)
        return y * (1 + 1e-7 * torch.randn(y.shape, device=y.device,
                                           generator=gen))

    lanes = {"kernels": (real, launch, launch_bwd),
             "plain, output x (1 + 1e-7 n)": (
                 real, noisy, lambda *a: ssd_chunk_bwd_plain(*a))}
    for name, lib in broken_libraries().items():
        lanes[name] = (lib, launch, launch_bwd)
    try:
        for lane, (lib, f, b) in lanes.items():
            common._LIB, ops._launch, ops._launch_bwd = lib, f, b
            for seed in SEEDS:
                r = cs.train_path_vs_plain(api, cfg, seed)
                print(json.dumps({"lane": lane, "activations": str(cfg.dtype),
                                  "seed": seed,
                                  **{k: r[k] for k in GATE_KEYS}}),
                      flush=True)
                cs.release()
    finally:
        common._LIB, ops._launch, ops._launch_bwd = real, launch, launch_bwd


def bwd64(x, dt, dA_cs, Bm, Cm, dy):
    """ssd_chunk_bwd_plain's formulas in float64."""
    xf, dtf, Bf, Cf, dyf = (t.double() for t in (x, dt, Bm, Cm, dy))
    S = torch.einsum("bin,bjn->bij", Cf, Bf)
    E = _decay(dA_cs.double())
    dx = torch.einsum("bijh,bihp->bjhp", S[..., None] * E * dtf[:, None], dyf)
    GE = torch.einsum("bihp,bjhp->bijh", dyf, xf) * E
    del E
    ddt = torch.einsum("bijh,bij->bjh", GE, S)
    dS = torch.einsum("bijh,bjh->bij", GE, dtf)
    Q = GE * S[..., None] * dtf[:, None]
    return (dx, ddt, Q.sum(2) - Q.sum(1), torch.einsum("bij,bin->bjn", dS, Cf),
            torch.einsum("bij,bjn->bin", dS, Bf))


def against_float64() -> None:
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        args = cs.ssd_inputs(rng, **cs.SSD_PATH, dtype=torch.float32)
        dy = cs.randn(rng, *args[0].shape, dtype=torch.float32)
        row = {"seed": seed}
        exact = bwd64(*args, dy)
        for lane, impl in (("kernel", None), ("plain", "ref")):
            for n, a, e in zip(("x", "dt", "dA_cs", "Bm", "Cm"),
                               ssd_chunk_bwd(*args, dy, impl=impl), exact):
                row[f"{lane} d{n}"] = float((a.double() - e).abs().max()
                                            / e.abs().max())
        del exact
        x, dt, cs_, Bm, Cm = (t.double() for t in args)
        w = torch.einsum("bin,bjn->bij", Cm, Bm)[..., None] * _decay(cs_) * \
            dt[:, None]
        y64 = torch.einsum("bijh,bjhp->bihp", w, x)
        del w
        for lane, impl in (("kernel", None), ("plain", "ref")):
            y = ssd_chunk_fwd(*args, impl=impl)
            row[f"{lane} y"] = float((y.double() - y64).abs().max()
                                     / y64.abs().max())
        print(json.dumps(row), flush=True)
        cs.release()


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_gate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = "--f32" in sys.argv[1:]
    gate(f32)
    if not f32:
        against_float64()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
