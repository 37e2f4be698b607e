#!/usr/bin/env python3
"""chip_smoke.py's phase 15 (the other families' training) and its new
phase-1 flash shapes on their own, and what phase 15's kernel-vs-plain
check can tell apart.

    python3 tools/train_gate.py [--cases] [--phase15] [--gate] [ARCH ...]

``--cases`` runs phase 1's training flash cases
(``chip_smoke.train_flash_cases``), one JSON line each, a failing case
logged with its error; ``--phase15`` runs ``chip_smoke.family_training``
for each family of ``chip_smoke.PHASE15`` (its kernel-vs-plain reading
logged, not gated); ``--gate`` reads ``chip_smoke.train_path_vs_plain``
(loss gap, grad-norm gap, worst and median leaf error) at seeds 0, 1, 2
for each family, in the activations phase 15 checks it in, through three
kernel lanes: the kernels, and two throwaway copies of the flash kernels
built under ``build/train_gate/`` whose forward or whose backward drops
the keys of the second 128-key tile (keys 128-255) from every row.  With
no flag it does all three; ARCH names limit the families.  Needs a CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SEEDS = (0, 1, 2)
GATE_KEYS = ("loss_abs_diff", "grad_norm_rel_diff", "leaf_rel_err_max",
             "leaf_rel_err_median")
DROP = "(kpos < 128 || kpos >= 256) && "
# (source, text, the same with keys 128-255 dropped): the mask tests and
# the whole-tile shortcuts that skip them
FWD_EDITS = (
    ("flash_attention.cu", "return kpos < Sk && (!causal || kpos <= qpos)",
     f"return {DROP}kpos < Sk && (!causal || kpos <= qpos)"),
    ("flash_attention.cu",
     "const bool full = (!rw.causal || k0 + BK - 1 <= row_lo) &&",
     "const bool full = (k0 + BK <= 128 || k0 >= 256) && "
     "(!rw.causal || k0 + BK - 1 <= row_lo) &&"))
BWD_EDITS = (
    ("flash_attention_bwd.cu",
     "return kpos < Sk && (!causal || kpos <= qpos)",
     f"return {DROP}kpos < Sk && (!causal || kpos <= qpos)"),
    ("flash_attention_bwd.cu", "const bool full = kr0 + 63 < Sk &&",
     "const bool full = (kr0 + 63 < 128 || kr0 >= 256) && kr0 + 63 < Sk &&"),
    ("flash_attention_bwd.cu", "const bool full = key0 + BK <= Sk &&",
     "const bool full = (key0 + BK <= 128 || key0 >= 256) && "
     "key0 + BK <= Sk &&"),
    ("flash_attention_bwd.cu", "const bool ok = kpos < Sk && qpos < Sq &&",
     f"const bool ok = {DROP}kpos < Sk && qpos < Sq &&"))
FLASH_FNS = ("repro_flash_attention", "repro_flash_attention_bwd_workspace",
             "repro_flash_attention_bwd")


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def broken_libraries() -> dict:
    """ctypes libraries of the flash kernels with keys 128-255 dropped from
    the forward or from the backward (both built in parallel)."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    real = common.library()
    procs = []
    for i, (name, edits) in enumerate((("forward drops keys 128-255",
                                        FWD_EDITS),
                                       ("backward drops keys 128-255",
                                        BWD_EDITS))):
        d = ROOT / "build" / "train_gate" / str(i)
        d.mkdir(parents=True, exist_ok=True)
        srcs = {f: (csrc / f).read_text() for f in
                ("flash_attention.cu", "flash_attention_bwd.cu")}
        for f, old, new in edits:
            assert srcs[f].count(old) == 1, (f, old)
            srcs[f] = srcs[f].replace(old, new)
        for f, text in srcs.items():
            (d / f).write_text(text)
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-shared",
               "-I", str(csrc), "-o", str(d / "lib.so"),
               *(str(d / f) for f in srcs)]
        procs.append((name, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, d, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in FLASH_FNS:
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = lib
    return libs


class FlashFrom:
    """The kernel library whose flash entry points the wrappers call: the
    built one with the flash functions of ``lib``."""

    def __init__(self, lib):
        self.lib, self.real = lib, common.library()

    def __getattr__(self, name):
        return getattr(self.lib if name in FLASH_FNS else self.real, name)


def cases(card: str) -> None:
    def run(case, rng, name, *a, **kw):
        try:
            c = case(rng, name, *a, **kw)
        except Exception as e:              # noqa: BLE001: logged, go on
            emit(case=name, error=repr(e)[:2000])
            return None
        emit(card=card, **c)
        return c
    cs.train_flash_cases(np.random.default_rng(0), run=run)


def families(arches):
    return [f for f in cs.PHASE15 if not arches or f[0] in arches]


def phase15(card: str, arches) -> None:
    for arch, layers, seq_len, seed, f32 in families(arches):
        try:
            res = cs.family_training(arch, layers, seq_len, seed,
                                     cs.FAMILY_BOUNDS[arch], f32)
        except Exception:                    # noqa: BLE001: logged, go on
            emit(arch=arch, error=traceback.format_exc()[-3000:])
            cs.release()
            continue
        emit(card=card, phase15=arch, **res)


def gate(arches) -> None:
    lanes = {"kernels": common.library(), **{
        name: FlashFrom(lib) for name, lib in broken_libraries().items()}}
    real = common.library()
    try:
        for arch, layers, seq_len, _, f32 in families(arches):
            cfg = get_config(arch)
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            if f32:
                cfg = dataclasses.replace(cfg, dtype=torch.float32)
            api = build_model(cfg)
            for lane, lib in lanes.items():
                common._LIB = lib
                for seed in SEEDS:
                    t0 = time.perf_counter()
                    r = cs.train_path_vs_plain(api, cfg, seed,
                                               cs.FAMILY_BOUNDS[arch],
                                               seq_len)
                    emit(arch=arch, lane=lane, activations=str(cfg.dtype),
                         seed=seed, seconds=time.perf_counter() - t0,
                         **{k: r[k] for k in GATE_KEYS})
                    cs.release()
    finally:
        common._LIB = real


def main() -> int:
    if not torch.cuda.is_available():
        print("train_gate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags = {a for a in sys.argv[1:] if a.startswith("--")}
    arches = [a for a in sys.argv[1:] if not a.startswith("--")]
    flags = flags or {"--cases", "--phase15", "--gate"}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    t0 = time.perf_counter()
    common.library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    if "--cases" in flags:
        cases(card)
    if "--phase15" in flags:
        phase15(card, arches)
    if "--gate" in flags:
        gate(arches)
    print(f"train_gate: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
