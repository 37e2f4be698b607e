#!/usr/bin/env python3
"""GPU smoke run of repro_torch: the port's serving and training paths on
one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a) and then, failing with a non-zero exit on any error:

  1. holds each kernel against its plain PyTorch version on the card at
     the shapes of qwen2-1.5b's paths: the serving kernels at bf16, T=16,
     B=8, C=16 and C=1, plus a window, a softcap, a page-straddling chunk,
     a full table (every sequence at 1008 keys, so every context split
     holds work), an idle slot (length 0, an all-zero table row) and
     float32 at C=16 (the scalar path); the serve step's fused append and
     attention at C=16 and C=1, with an idle slot, a straddling chunk, a
     window and in float32, each bitwise against the unfused kernel path
     (the two appends, then the attention kernel) and timed against its
     sum; the flash kernel at the training shape (B=1, S=4096, H=12, KV=2,
     D=128, causal, bf16), at D=64 and D=256, with a window, a softcap,
     non-causal, a ragged S=1000, and in float32 (its 3xTF32 tensor-core
     kernel) at S=512 D=64 and at S=1000 ragged, windowed and softcapped,
     each with its achieved TFLOP/s, its time over SDPA's and the name of
     the kernel its trace ran; the flash backward kernels at the same
     bf16 cases and at S=512 D=64 float32, each
     against the plain backward on the same forward residuals, with its
     time beside the plain backward's and SDPA's backward, the device
     time of each kernel its trace ran, and forward + backward through
     autograd beside SDPA's forward + backward; ``ssd_chunk``'s forward and its backward kernel, each
     on its own, at the mamba2 training path's shape (B'=16 chunks, L=256,
     H=64, P=64, N=128) in float32 and bf16, at a ragged L=100, H=6 and
     at chunk 512 (key and query tiles walked in windows of 256), and the
     op's forward + backward through autograd against autograd of the
     plain forward.  It times kernel, plain version and one PyTorch
     library call where there is one (a yardstick the port never calls);
  2. serves 8 requests (prompts of 64-480 tokens, 32 new tokens each,
     greedy) at full width through ``ServeClient`` with one POSIX and one
     STRICT session, and checks that every serve step launched the fused
     append and attention once on every layer and neither standalone
     serving kernel;
  3. runs one mixed prefill+decode ``serve_step`` of the full model twice
     from cloned caches, with the kernels and with the plain versions,
     and compares logits and pools;
  4. trains qwen2-1.5b at full width with ``run_training``: 4 AdamW steps
     of 4 microbatches of one 4096-token sequence, remat "full", and
     checks finite losses, 2 x 28 x 4 flash launches per step (each
     layer's forward runs again in the backward) and 28 x 4 flash
     backward launches; profiles one step, with both ops' kernels traced
     by name;
  5. takes the loss and every grad of one microbatch twice from the same
     parameters, through the kernel and through the plain version, at three
     draws of batch and parameters (seeds 0, 1, 2), each held to every
     bound;
  6. trains mamba2-1.3b at full width and depth (48 layers, d_model 2048,
     64 SSD heads of 64, state 128, chunk 256) the same way: 4 AdamW steps
     of 4 microbatches of one 4096-token sequence, remat "full", checking
     finite losses, 2 x 48 x 4 = 384 ``ssd_chunk`` launches and 48 x 4 =
     192 ``ssd_chunk_bwd`` launches per step; profiles one step, with both
     ops' kernels traced by name;
  7. takes one mamba2 microbatch's loss and grads through the kernels and
     through the plain versions at seeds 0, 1, 2, with the model's
     activations in float32 held to phase 5's bounds, and in bf16, as
     phase 6 trains, held to a grad-norm bound of its own: in bf16 the
     loss and per-leaf gaps cannot tell a correct kernel from a 1e-7
     perturbation (PERF.md §6, PR 17);
  8. serves the same 8 requests as phase 2 with mamba2-1.3b at full width
     (the recurrent serve path runs no kernel: it checks that none
     launched) and profiles a prefill and a decode window.

Every phase runs its model at full depth.

TF32 is switched off for matmuls and cuDNN, so float32 products are full
float32.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels with their launch counts, times and bounds.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
# float32-exact products on the tensor cores: 3xTF32 (each operand split
# into two TF32 parts, three products) at a third of the dense TF32 peak
TF32X3_FLOPS = 494.7e12 / 3
# a float32 operand against a bf16 one, exactly: the float32 one split into
# three bf16 parts, three bf16 products
BF16X3_FLOPS = BF16_FLOPS / 3

# qwen2-1.5b serving shapes of phase 2
B, T, KV, H, D = 8, 16, 2, 12, 128
MAX_SEQ = 1024
PAGES_PER_SEQ = MAX_SEQ // T
P = B * PAGES_PER_SEQ
LONGEST = 480 + 32               # the smoke run's longest context
TRACE_DIR = ROOT / "build" / "repro_torch_kernels" / "traces"
ATTN_TOL = 2e-2                  # bf16 out: about one ulp of values O(1)
# paged attention out, kernel vs plain: bf16 as ATTN_TOL; float32 sums the
# same float32 products in another order (tests/test_torch_cuda.py's TOL)
PAGED_TOL = {torch.bfloat16: ATTN_TOL, torch.float32: 1e-5}
PATH_REL_TOL = 5e-2              # phase 3: 28 bf16 layers, see PERF.md
# flash out (atol, rtol): bf16 kernel and plain version round float32
# values that agree to ~1e-6 and so differ by at most one bf16 ulp
# (2^-7 relative at the bottom of a binade; rtol covers two)
FLASH_TOL = {torch.bfloat16: (4e-3, 1.6e-2), torch.float32: (2e-5, 2e-5)}
LSE_ATOL = 1e-4                  # flash lse, float32 in both versions
# flash backward kernel vs plain backward on the same residuals, (atol as a
# share of the grad's largest magnitude, rtol): float32 takes its products
# in 3xTF32 (about 2^-21 relative each against float32's 2^-24) and sums
# in another order; bf16 rounds P and dS to bf16 before the products (2^-9
# relative each, as SDPA does) and the grads once more on the way out
FLASH_BWD_TOL = {torch.bfloat16: (1e-2, 3e-2), torch.float32: (2e-5, 1e-4)}
# phase 4-5: the training shape (configs/shapes.py TRAIN_4K's sequence)
TRAIN_S, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = 4096, 4, 4, 4
# phase 5 bounds, each well above the largest reading of a correct bf16
# kernel and below every reading of a kernel that drops a key tile
# (PERF.md §6, "the phase-5 gate"): the mma.sync and wgmma kernels read
# |dloss| <= 2.3e-4, grad-norm gaps <= 2.2e-4 (bf16 rounding through 28
# layers' backward, random in sign; 1e-5, set from one reading of 5.6e-8,
# refused the accepted kernel at seeds 1 and 2) and per-leaf errors <=
# 0.013 at seeds 0-2; dropping the second key tile of every band reads
# >= 3.4e-2, >= 0.48 and >= 2.6
LOSS_TOL = 1e-3                  # |loss_kernel - loss_plain|
GNORM_TOL = 1e-3                 # relative global grad-norm gap
LEAF_TOL = 2.5e-2                # per-leaf relative grad error
PHASE5_SEEDS = (0, 1, 2)         # batch and parameter draws of phase 5
# phase 7's bf16 lane (mamba2 as phase 6 trains it), gated on the relative
# grad-norm gap alone: at seeds 0-2 the kernels read <= 0.0155 and the
# plain path with its ssd_chunk output perturbed by 1e-7 relative noise
# <= 0.0141, a backward that drops key tile 1 >= 0.134 and a forward that
# does >= 2.6e17 (PERF.md §6, PR 17); the loss and per-leaf gaps of the
# noise lane reach the kernels' (1.6e-3, 0.31), so they gate nothing here
SSD_BF16_GNORM_TOL = 0.05
# ssd_chunk at the mamba2 training path's shape: one 4096-token sequence in
# chunks of 256 (B' = 16), 64 heads of 64, state 128
SSD_PATH = dict(Bp=16, L=256, H=64, P=64, N=128)
SSD_512 = dict(SSD_PATH, Bp=8, L=512)   # the same tokens in chunks of 512
# ssd_chunk out: (atol as a share of the output's largest magnitude, rtol).
# float32: kernel and plain version differ at most in summation order (on
# the H100 they agree bit for bit: the plain version's float32 cuBLAS
# products sum each output in k order with FMAs, as the kernel does);
# bf16: both round float32 sums that agree to ~1e-6, so they differ by at
# most one bf16 ulp (2^-7 relative at the bottom of a binade: rtol 1.6e-2)
SSD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 1.6e-2)}
# ssd_chunk's float32 grads: the kernels (3xTF32 products, float32 sums)
# and the plain backward agree to float32 rounding, summed in other orders;
# bf16 grads are held to SSD_TOL[bf16], one more rounding
SSD_GRAD_TOL = (1e-5, 1e-4)
# the flash kernel of each dtype, as CUPTI names it in a trace
FLASH_KERNELS = {torch.bfloat16: "flash_wgmma_kernel",
                 torch.float32: "flash_f32_tc_kernel"}
# the kernels of the serve step's fused append and attention
PAGED_KERNELS = ("paged_attention_kernel", "paged_attention_f32_kernel",
                 "paged_attention_merge_kernel")
# the flash backward's kernels of each dtype
FLASH_BWD_KERNELS = {
    torch.bfloat16: ("flash_bwd_prep_kernel", "flash_bwd_kv_kernel",
                     "flash_bwd_q_kernel"),
    torch.float32: ("flash_bwd_prep_kernel", "flash_bwd_f32_kernel")}
# ssd_chunk's forward and backward kernels, as CUPTI names them
SSD_FWD_KERNELS = ("ssd_chunk_tc_kernel",)
SSD_BWD_KERNELS = ("ssd_bwd_tile_kernel", "ssd_bwd_finish_kernel")


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed calls of ``fn``: the time one
    call holds the stream, host-side wrapper work included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_events(prof) -> list:
    """Kernel / memcpy / memset intervals of a torch.profiler run, read
    from its Chrome trace (ts and dur in microseconds)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "profile.tmp.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    path.unlink()
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def device_ms(fn, reps: int = 20):
    """Device time per call of ``fn``: the sum of its kernel / copy
    durations in a CUPTI trace of ``reps`` calls.  None when that trace
    does not hold ``reps`` times the events of a trace of one call, as
    when the profiler drops events or records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_call = len(device_events(prof))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    if per_call == 0 or len(ev) != reps * per_call:
        log(f"  cupti: {len(ev)} device events for {reps} calls of "
            f"{per_call}")
        return None
    return sum(e["dur"] for e in ev) / reps / 1e3


def kernel_names(fn, tries: int = 3) -> list:
    """The names of the device events of one traced call of ``fn``, from
    the first of ``tries`` traces that recorded any (a trace here can lose
    every event; see device_ms); empty if none did."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e["name"] for e in device_events(prof)]
        if names:
            return names
    return []


def kernel_split(fn, reps: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name (template
    arguments kept), from a CUPTI trace of ``reps`` calls; empty when the
    trace recorded no event (see device_ms)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in device_events(prof):
        key = e["name"].replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0]
        split[key] = split.get(key, 0.0) + e["dur"] / reps / 1e3
    return split


def ptxas_summary(build_log: str) -> list:
    """One line per compiled kernel instance of the build log: its
    (demangled) name, registers, shared memory and spills, as ``nvcc
    -Xptxas -v`` reported them; ptxas warnings as they are."""
    demangler = shutil.which("c++filt")
    lines, name, spill = [], None, ""
    for raw in build_log.splitlines():
        line = raw.strip()
        if line.startswith("=="):
            lines.append(line)
        elif "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            if demangler:
                name = subprocess.run([demangler, name], capture_output=True,
                                      text=True).stdout.strip() or name
            name = name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
        elif "spill" in line and name:
            spill = line
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
        elif "warning" in line.lower():
            lines.append(line)
    return lines


def timings(**fns) -> dict:
    """For each named callable: device ms per call (CUPTI) as ``<name>``
    and the event-timed call as ``<name>_call``.  A trace whose event count
    is off is taken once more; if it stays off, ``<name>`` falls back to
    the event-timed call and ``<name>_timing`` says so."""
    out = {}
    for name, fn in fns.items():
        call = time_ms(fn)
        dev = device_ms(fn)
        if dev is None:
            dev = device_ms(fn)
        out[name] = call if dev is None else dev
        out[name + "_call"] = call
        out[name + "_timing"] = "events" if dev is None else "cupti"
    return out


def bound(nbytes: int, flops: int, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak``."""
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_f = flops / peak * 1e3
    return {"bound_ms": max(bound_b, bound_f),
            "bound_by": "bytes" if bound_b >= bound_f else "operations",
            "bytes": nbytes, "flops": flops}


def page_table(rng: np.random.Generator, idle=()) -> torch.Tensor:
    """Distinct random pages per slot (never the null page 0); idle slots
    get an all-zero row, as the engine leaves them."""
    # P - 1 usable pages for B * PAGES_PER_SEQ entries: the last entry of
    # the last row (position >= 1008, past every context here) stays 0
    perm = np.concatenate([rng.permutation(np.arange(1, P)), [0]])
    pt = perm.reshape(B, PAGES_PER_SEQ).astype(np.int32)
    for b in idle:
        pt[b] = 0
    return torch.from_numpy(pt).cuda()


def randn(rng, *shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------


def kv_append_case(rng, C: int, name: str) -> dict:
    from repro_torch.kernels import kv_append_chunk
    from repro_torch.models.attention import paged_chunk_ids

    pt = page_table(rng, idle=(B - 1,))
    lengths = torch.from_numpy(
        rng.integers(0, LONGEST - C, B).astype(np.int32)).cuda()
    lengths[B - 1] = 0
    _, pids, sids = paged_chunk_ids(pt, lengths, C, T)
    pool = randn(rng, P, T, KV, D)
    new = randn(rng, B, C, KV, D)
    out_k = kv_append_chunk(pool.clone(), new, pids, sids)
    out_r = kv_append_chunk(pool.clone(), new, pids, sids, impl="ref")
    torch.cuda.synchronize()
    if not torch.equal(out_k[1:], out_r[1:]):
        raise AssertionError(f"{name}: kernel != plain version off page 0")
    err = float((out_k[1:].float() - out_r[1:].float()).abs().max())
    work = pool.clone()
    pl, sl = pids.long(), sids.long()
    t = timings(
        ms=lambda: kv_append_chunk(work, new, pids, sids),
        plain_ms=lambda: kv_append_chunk(work, new, pids, sids, impl="ref"),
        library_ms=lambda: work.index_put_((pl, sl), new))
    nbytes = 2 * new.numel() * new.element_size() + 2 * pids.numel() * 4
    return {"case": name, "C": C, "max_abs_err": err, **t,
            **bound(nbytes, 0, BF16_FLOPS)}


def attention_case(rng, C: int, name: str, *, window=None, softcap=None,
                   straddle=False, table_pages=PAGES_PER_SEQ, full=False,
                   idle=False, dtype=torch.bfloat16) -> dict:
    """``table_pages`` < PAGES_PER_SEQ narrows the page table (a table of
    at most 64 keys runs the kernel's single-split path); ``full`` puts
    every sequence at 1008 keys (the table's last entry stays the null
    page); ``idle`` gives the last slot length 0 and an all-zero row."""
    import torch.nn.functional as F
    from repro_torch.kernels import common, paged_attention_chunk

    pt = page_table(rng, idle=(B - 1,) if idle else ())
    pt = pt[:, :table_pages].contiguous()
    longest = min(LONGEST, table_pages * T)
    if straddle:   # every chunk starts mid-page and crosses a boundary
        starts = rng.integers(1, (longest - C) // T, B) * T - T // 2
    elif full:
        starts = np.full(B, 1008 - C)
    else:
        starts = rng.integers(0, longest - C + 1, B)
    if idle:
        starts[B - 1] = 0
    lengths = torch.from_numpy(starts.astype(np.int32)).cuda()
    q = randn(rng, B, C, H, D, dtype=dtype)
    pk = randn(rng, P, T, KV, D, dtype=dtype)
    pv = randn(rng, P, T, KV, D, dtype=dtype)
    kw = dict(window=window, softcap=softcap)
    out_k = paged_attention_chunk(q, pk, pv, pt, lengths, **kw)
    splits = common.LAST_SPLITS["paged_attention_chunk"]   # as launched
    out_r = paged_attention_chunk(q, pk, pv, pt, lengths, impl="ref", **kw)
    torch.cuda.synchronize()
    diff = (out_k.float() - out_r.float()).abs()
    err = float(diff.max())
    tol = PAGED_TOL[dtype]
    if not torch.allclose(out_k.float(), out_r.float(), atol=tol,
                          rtol=tol) or not torch.isfinite(out_k).all():
        raise AssertionError(f"{name}: kernel vs plain max |err| {err}")
    fns = dict(
        ms=lambda: paged_attention_chunk(q, pk, pv, pt, lengths, **kw),
        plain_ms=lambda: paged_attention_chunk(q, pk, pv, pt, lengths,
                                               impl="ref", **kw))
    if softcap is None:
        # yardstick: SDPA over the pages gathered beforehand (gather and
        # mask construction are outside the timed call)
        S = table_pages * T
        k = pk[pt.long()].reshape(B, S, KV, D).repeat_interleave(H // KV, 2)
        v = pv[pt.long()].reshape(B, S, KV, D).repeat_interleave(H // KV, 2)
        kpos = torch.arange(S, device="cuda")[None, None, :]
        qpos = lengths.long()[:, None, None] + \
            torch.arange(C, device="cuda")[None, :, None]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        m4 = mask[:, None]
        fns["library_ms"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4)
    t = {"library_ms": None, **timings(**fns)}
    return {"case": name, "C": C, "dtype": str(dtype), "splits": splits,
            "max_abs_err": err, "tolerance": {"atol": tol, "rtol": tol}, **t,
            **paged_bound(starts, C, window, table_pages, q.element_size())}


def paged_bound(starts, C: int, window, table_pages: int, esz: int,
                append: bool = False) -> dict:
    """The bound of one paged attention call on this run's data: the keys
    each sequence's chunk can see, [max(0, start - window + 1),
    min(start + C, N*T)), read once with the table entries that hold them,
    q read and out written; the products 4 H D a visible (query, key)
    pair.  ``append``: the fused call, which also reads the chunk's new K
    and V rows and its (page, slot) ids and writes the rows into the
    pools, and reads the chunk's own keys from the new rows, not the
    pools."""
    st = np.asarray(starts, np.int64)
    k_hi = np.minimum(st + C, table_pages * T)
    k_lo = np.zeros_like(k_hi) if window is None else \
        np.maximum(st - window + 1, 0)
    keys = int((k_hi - k_lo).sum())
    pages = int((-(-k_hi // T) - k_lo // T).sum())
    nbytes = (keys * KV * D * esz * 2 + 2 * B * C * H * D * esz
              + pages * 4 + B * 4)
    if append:
        own = int((k_hi - np.maximum(st, k_lo)).clip(min=0).sum())
        rows = B * C * KV * D * esz                  # k_new or v_new
        nbytes += 4 * rows - own * KV * D * esz * 2 + 2 * B * C * 4
    visible = st[:, None] + np.arange(C)[None, :] + 1   # keys per query
    if window is not None:
        visible = np.minimum(visible, window)
    flops = int(4 * H * D * visible.sum())
    peak = BF16_FLOPS if esz == 2 else TF32X3_FLOPS
    return bound(nbytes, flops, peak)


def fused_case(rng, C: int, name: str, *, window=None, straddle=False,
               idle=False, dtype=torch.bfloat16) -> dict:
    """The serve step's fused append and attention
    (``paged_attention_append_chunk``) against the unfused kernel path on
    the same inputs, ``kv_append_chunk`` on each pool and then
    ``paged_attention_chunk``: the outputs bitwise equal and the pools
    byte-equal off the null page 0; against the plain path (the two plain
    appends and the plain attention) to PAGED_TOL; timed beside the
    unfused path's sum and the plain path."""
    from repro_torch.kernels import (common, kv_append_chunk,
                                     paged_attention_append_chunk,
                                     paged_attention_chunk)
    from repro_torch.models.attention import paged_chunk_ids

    pt = page_table(rng, idle=(B - 1,) if idle else ())
    if straddle:   # every chunk starts mid-page and crosses a boundary
        starts = rng.integers(1, (LONGEST - C) // T, B) * T - T // 2
    else:
        starts = rng.integers(0, LONGEST - C + 1, B)
    if idle:
        starts[B - 1] = 0
    lengths = torch.from_numpy(starts.astype(np.int32)).cuda()
    _, pids, sids = paged_chunk_ids(pt, lengths, C, T)
    q = randn(rng, B, C, H, D, dtype=dtype)
    kn, vn = (randn(rng, B, C, KV, D, dtype=dtype) for _ in range(2))
    pk, pv = (randn(rng, P, T, KV, D, dtype=dtype) for _ in range(2))
    kw = dict(window=window)

    def unfused(pool_k, pool_v):
        kv_append_chunk(pool_k, kn, pids, sids)
        kv_append_chunk(pool_v, vn, pids, sids)
        return paged_attention_chunk(q, pool_k, pool_v, pt, lengths, **kw)

    def fused(pool_k, pool_v, impl=None):
        return paged_attention_append_chunk(q, kn, vn, pool_k, pool_v, pt,
                                            lengths, pids, sids, impl=impl,
                                            **kw)

    pools = {w: (pk.clone(), pv.clone()) for w in ("unfused", "fused",
                                                   "plain")}
    out_u = unfused(*pools["unfused"])
    out_f = fused(*pools["fused"])
    splits = common.LAST_SPLITS["paged_attention_append_chunk"]
    out_r = fused(*pools["plain"], impl="ref")
    torch.cuda.synchronize()
    bitwise = torch.equal(out_f, out_u)
    pools_equal = all(
        torch.equal(f[1:], o[1:]) for w in ("unfused", "plain")
        for f, o in zip(pools["fused"], pools[w]))
    err = float((out_f.float() - out_r.float()).abs().max())
    tol = PAGED_TOL[dtype]
    if not (bitwise and pools_equal and torch.isfinite(out_f).all()
            and torch.allclose(out_f.float(), out_r.float(), atol=tol,
                               rtol=tol)):
        raise AssertionError(f"{name}: fused vs unfused bitwise {bitwise}, "
                             f"pools off page 0 {pools_equal}, vs plain "
                             f"max |err| {err}")
    work = pools["fused"]
    t = timings(ms=lambda: fused(*work),
                unfused_ms=lambda: unfused(*work),
                plain_ms=lambda: fused(*work, impl="ref"))
    return {"case": name, "C": C, "dtype": str(dtype), "splits": splits,
            "bitwise_vs_unfused": bitwise, "pools_equal_off_page0":
            pools_equal, "max_abs_err": err,
            "tolerance": {"atol": tol, "rtol": tol},
            "kernel": check_ran(name, lambda: fused(*work), PAGED_KERNELS[:1]
                                if dtype == torch.bfloat16
                                else PAGED_KERNELS[1:2]),
            "library_ms": None, **t,
            "ms_over_unfused": t["ms"] / t["unfused_ms"],
            **paged_bound(starts, C, window, PAGES_PER_SEQ,
                          q.element_size(), append=True)}


def visible_keys(Sq: int, Sk: int, causal: bool, window) -> int:
    """Keys the mask lets each query row see, summed over the rows."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def flash_inputs(rng, S, dtype, D=128, Sk=None):
    Sk = S if Sk is None else Sk
    return (randn(rng, 1, S, H, D, dtype=dtype),
            randn(rng, 1, Sk, KV, D, dtype=dtype),
            randn(rng, 1, Sk, KV, D, dtype=dtype))


def sdpa_args(q, k, v, causal, window):
    """SDPA's [B, H, S, D] views of q, k, v and its mask arguments for the
    same attention (a window needs a mask, built here, outside any timed
    call)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        return (qt, kt, vt), {"is_causal": causal, "enable_gqa": True}
    Sq, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Sk, device="cuda")[None, :]
    m = kpos > qpos - window
    if causal:
        m &= kpos <= qpos
    return (qt, kt, vt), {"attn_mask": m, "enable_gqa": True}


def flash_case(rng, name: str, S: int, *, causal=True, window=None,
               softcap=None, dtype=torch.bfloat16, D=128) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import attention_fwd

    q, k, v = flash_inputs(rng, S, dtype, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = attention_fwd(q, k, v, **kw)
    ref, ref_lse = attention_fwd(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[dtype]
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    if not (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
            and lse_err <= LSE_ATOL and torch.isfinite(out).all()):
        raise AssertionError(f"{name}: kernel vs plain max |err| {err}, "
                             f"lse {lse_err}")
    fns = dict(ms=lambda: attention_fwd(q, k, v, **kw),
               plain_ms=lambda: attention_fwd(q, k, v, impl="ref", **kw))
    if softcap is None:
        # yardstick: SDPA on [B, H, S, D] views built outside the timed call
        (qt, kt, vt), skw = sdpa_args(q, k, v, causal, window)
        fns["library_ms"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **skw)
    t = {"library_ms": None, **timings(**fns)}
    ran = check_ran(name, fns["ms"], (FLASH_KERNELS[dtype],))
    flops = 4 * H * D * visible_keys(S, S, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + lse.numel() * 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
    lib = t["library_ms"]
    return {"case": name, "S": S, "D": D, "dtype": str(dtype),
            "kernel": ran,
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "tolerance": {"atol": atol, "rtol": rtol, "lse_atol": LSE_ATOL},
            **t, "tflops": flops / t["ms"] / 1e9,
            "ms_over_library": None if lib is None else t["ms"] / lib,
            **bound(nbytes, flops, peak)}


def flash_bwd_case(rng, name: str, S: int, *, causal=True, window=None,
                   softcap=None, dtype=torch.bfloat16, D=128) -> dict:
    """The backward kernel against the plain backward on the same forward
    residuals and upstream gradient; timed beside the plain backward and
    SDPA's backward, and forward + backward through autograd beside SDPA's
    forward + backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention, attention_bwd, attention_fwd

    q, k, v = flash_inputs(rng, S, dtype, D)
    g = randn(rng, *q.shape, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = attention_fwd(q, k, v, **kw)
    got = attention_bwd(q, k, v, out, lse, g, **kw)
    want = attention_bwd(q, k, v, out, lse, g, impl="ref", **kw)
    torch.cuda.synchronize()
    atol, rtol = FLASH_BWD_TOL[dtype]
    errs, rel = {}, {}
    for key, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = float(b.float().abs().max())
        errs[key] = float((a.float() - b.float()).abs().max())
        rel[key] = errs[key] / max(scale, 1e-30)
        if not (torch.allclose(a.float(), b.float(), atol=atol * scale,
                               rtol=rtol) and torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {key} max |err| {errs[key]} of "
                                 f"{scale}")
    del got, want
    req = [x.detach().requires_grad_() for x in (q, k, v)]
    fns = dict(ms=lambda: attention_bwd(q, k, v, out, lse, g, **kw),
               plain_ms=lambda: attention_bwd(q, k, v, out, lse, g,
                                              impl="ref", **kw),
               fwd_bwd_ms=lambda: torch.autograd.grad(
                   attention(*req, **kw), req, g))
    if softcap is None:
        # yardsticks: SDPA's backward alone and its forward + backward
        (qt, kt, vt), skw = sdpa_args(*req, causal, window)
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, **skw)
        gt = g.transpose(1, 2)
        fns["library_ms"] = lambda: torch.autograd.grad(
            o_sdpa, req, gt, retain_graph=True)
        fns["library_fwd_bwd_ms"] = lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, **skw), req, gt)
    t = {"library_ms": None, "library_fwd_bwd_ms": None, **timings(**fns)}
    ran = check_ran(name, fns["ms"], FLASH_BWD_KERNELS[dtype])
    # five products of the forward's size: S, dP, dQ, dK, dV; each input
    # (q, k, v, out, dO, lse) read once, each grad written once
    flops = 10 * H * D * visible_keys(S, S, causal, window)
    esz = q.element_size()
    nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * esz \
        + lse.numel() * 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
    lib = t["library_ms"]
    return {"case": name, "S": S, "D": D, "dtype": str(dtype),
            "kernel": ran, "ms_by_kernel": kernel_split(fns["ms"]),
            "max_abs_err": max(errs.values()), "grad_max_abs_err": errs,
            "grad_rel_err": rel,
            "tolerance": {"atol": f"{atol} x grad_max_abs", "rtol": rtol},
            **t, "tflops": flops / t["ms"] / 1e9,
            "ms_over_library": None if lib is None else t["ms"] / lib,
            **bound(nbytes, flops, peak)}


def ssd_inputs(rng, Bp, L, H, P, N, dtype):
    """tests/test_kernels.py's inputs: dt = 0.1 |n|, A = -0.5 |n|,
    cs = cumsum(dt * A) along the chunk (dt and cs float32)."""
    dt = torch.from_numpy((np.abs(rng.standard_normal((Bp, L, H))) * 0.1)
                          .astype(np.float32)).cuda()
    A = torch.from_numpy((-np.abs(rng.standard_normal(H)) * 0.5)
                         .astype(np.float32)).cuda()
    return (randn(rng, Bp, L, H, P, dtype=dtype), dt,
            torch.cumsum(dt * A, dim=1).contiguous(),
            randn(rng, Bp, L, N, dtype=dtype), randn(rng, Bp, L, N,
                                                    dtype=dtype))


def ssd_work(Bp, L, H, P, N, esz, part="fwd"):
    """(bytes, FLOP, peak) of this call's data: each input read once, each
    output written once; the causal pairs j <= i times the scores (2N)
    and the per-head contraction (2HP).  The backward ("bwd") recomputes
    the scores and adds the dy.x products and dx (4HP) and dB, dC (4N);
    it reads x, dt, cs, Bm, Cm and dy and writes the five grads.  "both"
    is a forward and a backward.  ``peak`` is the rate of the float32-
    exact mix: float32 operands at TF32X3_FLOPS; with bf16 x, B, C (esz
    2) the products of two bf16 operands (S, dy.x) at BF16_FLOPS and
    those with a float32 one (W.x, W.dy, dS.B, dS.C) at BF16X3_FLOPS."""
    pairs = Bp * L * (L + 1) // 2
    xs, hs, ns = Bp * L * H * P * esz, Bp * L * H * 4, Bp * L * N * esz
    # (bytes, FLOP of two x-dtype operands, FLOP with a float32 operand)
    fwd = (xs + 2 * hs + 2 * ns + xs, pairs * 2 * N, pairs * 2 * H * P)
    bwd = (3 * xs + 4 * hs + 4 * ns, pairs * (2 * N + 2 * H * P),
           pairs * (4 * N + 2 * H * P))
    nbytes, same, mixed = {"fwd": fwd, "bwd": bwd}.get(
        part, tuple(a + b for a, b in zip(fwd, bwd)))
    if esz == 4:
        return nbytes, same + mixed, TF32X3_FLOPS
    secs = same / BF16_FLOPS + mixed / BF16X3_FLOPS
    return nbytes, same + mixed, (same + mixed) / secs


def check_ran(name: str, fn, kernels) -> str:
    """The kernels a traced call of ``fn`` ran must include ``kernels``: a
    time filed under them is never another's (a trace that lost every
    event shows nothing)."""
    ran = kernel_names(fn)
    missing = [k for k in kernels if not any(k in n for n in ran)]
    if ran and missing:
        raise AssertionError(f"{name}: no {missing} in {ran}")
    return " + ".join(kernels) if ran else "no events traced"


def ssd_case(rng, name: str, *, Bp, L, H, P, N,
             dtype=torch.float32) -> dict:
    from repro_torch.kernels import ssd_chunk_fwd

    args = ssd_inputs(rng, Bp, L, H, P, N, dtype)
    out = ssd_chunk_fwd(*args)
    ref = ssd_chunk_fwd(*args, impl="ref")
    torch.cuda.synchronize()
    scale = float(ref.float().abs().max())
    atol, rtol = SSD_TOL[dtype]
    err = float((out.float() - ref.float()).abs().max())
    if not (torch.allclose(out.float(), ref.float(), atol=atol * scale,
                           rtol=rtol) and torch.isfinite(out).all()):
        raise AssertionError(f"{name}: kernel vs plain max |err| {err} of "
                             f"{scale}")
    # no single PyTorch call computes this function: library_ms is None
    fns = dict(ms=lambda: ssd_chunk_fwd(*args),
               plain_ms=lambda: ssd_chunk_fwd(*args, impl="ref"))
    t = {"library_ms": None, **timings(**fns)}
    esz = args[0].element_size()
    return {"case": name, "Bp": Bp, "L": L, "H": H, "P": P, "N": N,
            "dtype": str(dtype),
            "kernel": check_ran(name, fns["ms"], SSD_FWD_KERNELS),
            "max_abs_err": err, "out_max_abs": scale,
            "tolerance": {"atol": f"{atol} x out_max_abs", "rtol": rtol},
            **t, **bound(*ssd_work(Bp, L, H, P, N, esz))}


def check_grads(name: str, got, want) -> dict:
    """Each grad against its plain counterpart: float32 grads to
    SSD_GRAD_TOL, bf16 grads to SSD_TOL[bf16], atol a share of the grad's
    largest magnitude.  Returns each grad's max |err|."""
    errs = {}
    for key, a, b in zip(("x", "dt", "dA_cs", "Bm", "Cm"), got, want):
        atol, rtol = (SSD_GRAD_TOL if a.dtype == torch.float32
                      else SSD_TOL[a.dtype])
        scale = float(b.float().abs().max())
        errs[key] = float((a.float() - b.float()).abs().max())
        if not (torch.allclose(a.float(), b.float(), atol=atol * scale,
                               rtol=rtol) and torch.isfinite(a).all()):
            raise AssertionError(f"{name}: d{key} max |err| {errs[key]} of "
                                 f"{scale}")
    return errs


def ssd_bwd_case(rng, name: str, *, Bp, L, H, P, N,
                 dtype=torch.float32) -> dict:
    """The backward on its own: the kernel against the plain backward on
    the same inputs and upstream gradient."""
    from repro_torch.kernels import ssd_chunk_bwd

    args = ssd_inputs(rng, Bp, L, H, P, N, dtype)
    dy = randn(rng, Bp, L, H, P, dtype=dtype)
    got = ssd_chunk_bwd(*args, dy)
    want = ssd_chunk_bwd(*args, dy, impl="ref")
    torch.cuda.synchronize()
    errs = check_grads(name, got, want)
    fns = dict(ms=lambda: ssd_chunk_bwd(*args, dy),
               plain_ms=lambda: ssd_chunk_bwd(*args, dy, impl="ref"))
    t = {"library_ms": None, **timings(**fns)}
    esz = args[0].element_size()
    return {"case": name, "Bp": Bp, "L": L, "H": H, "P": P, "N": N,
            "dtype": str(dtype),
            "kernel": check_ran(name, fns["ms"], SSD_BWD_KERNELS),
            "max_abs_err": max(errs.values()), "grad_max_abs_err": errs,
            "tolerance": {"float32": f"{SSD_GRAD_TOL} (atol x grad_max_abs"
                          ", rtol)", "bf16": str(SSD_TOL[torch.bfloat16])},
            **t, **bound(*ssd_work(Bp, L, H, P, N, esz, "bwd"))}


def ssd_grad_case(rng, name: str, *, Bp, L, H, P, N) -> dict:
    """The op's five gradients (forward and backward kernels) against
    torch.autograd through the plain forward, and both timed forward +
    backward."""
    from repro_torch.kernels import ssd_chunk, ssd_chunk_ref

    args = ssd_inputs(rng, Bp, L, H, P, N, torch.float32)
    dy = randn(rng, Bp, L, H, P, dtype=torch.float32)

    def grads(fn):
        req = [a.detach().requires_grad_() for a in args]
        return torch.autograd.grad(fn(*req), req, dy)

    got, want = grads(ssd_chunk), grads(ssd_chunk_ref)
    torch.cuda.synchronize()
    errs = check_grads(name, got, want)
    fns = dict(ms=lambda: grads(ssd_chunk),
               plain_ms=lambda: grads(ssd_chunk_ref))
    t = {"library_ms": None, **timings(**fns)}
    atol, rtol = SSD_GRAD_TOL
    return {"case": name, "Bp": Bp, "L": L, "H": H, "P": P, "N": N,
            "kernel": check_ran(name, fns["ms"],
                                SSD_FWD_KERNELS + SSD_BWD_KERNELS),
            "max_abs_err": max(errs.values()),
            "grad_max_abs_err": errs,
            "tolerance": {"atol": f"{atol} x grad_max_abs", "rtol": rtol},
            **t, **bound(*ssd_work(Bp, L, H, P, N, 4, "both"))}


# ---------------------------------------------------------------------------
# phase 2: the main path at full width
# ---------------------------------------------------------------------------


def serve_main_path(api, params, cfg, per_layer_step: dict) -> dict:
    """``per_layer_step``: each kernel's launches per layer and serve step
    (every other kernel must not launch)."""
    from repro_torch.core import OP_KV_COMMIT, Mode, OpLog, PMDevice
    from repro_torch.kernels import common
    from repro_torch.serve import ServeClient

    oplog = OpLog(PMDevice(size=16 * 1024 * 1024), base_block=1,
                  num_blocks=64)
    client = ServeClient(api, params, max_batch=8, max_seq=MAX_SEQ,
                         page_tokens=T, oplog=oplog, device="cuda")
    posix = client.open_session(mode=Mode.POSIX)
    strict = client.open_session(mode=Mode.STRICT)
    rng = np.random.default_rng(0)
    reqs = []
    for i, n in enumerate(rng.integers(64, 481, 8)):
        prompt = rng.integers(1, cfg.vocab, int(n)).tolist()
        reqs.append(((strict if i % 2 else posix).submit(prompt, 32),
                     i % 2 == 1))
    eng = client.engine
    torch.cuda.synchronize()
    common.reset_launch_counts()
    prefill, decode = [], []
    t_start = time.perf_counter()
    while eng.waiting or eng.active:
        wide = bool(eng.waiting) or any(r.in_prefill
                                        for r in eng.active.values())
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        (prefill if wide else decode).append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    launches = dict(common.LAUNCHES)
    steps = eng.steps
    L = cfg.n_layers
    for r, _ in reqs:
        assert r.done and not r.truncated and len(r.output) == 32, r
        assert all(0 <= t < cfg.vocab for t in r.output)
    for name, n in launches.items():
        assert n == per_layer_step.get(name, 0) * L * steps, (launches, steps)
    strict_pages = sum((len(r.prompt) + 32 - 1) // T for r, s in reqs if s)
    commits = [e for e in oplog.scan() if e.op == OP_KV_COMMIT]
    assert len(commits) == strict_pages, (len(commits), strict_pages)
    assert all(e.mode == int(Mode.STRICT) for e in commits)
    out_tokens = sum(len(r.output) for r, _ in reqs)
    return {"steps": steps, "prefill_steps": len(prefill),
            "decode_steps": len(decode),
            "prefill_step_ms_median": statistics.median(prefill),
            "decode_step_ms_median": statistics.median(decode),
            "wall_s": wall, "output_tokens": out_tokens,
            "output_tokens_per_s": out_tokens / wall,
            "tokens_processed": eng.tokens_processed,
            "strict_commits": len(commits), "launches": launches,
            "prompt_lens": [len(r.prompt) for r, _ in reqs]}


def logits_d2h_ms(cfg) -> dict:
    """Host cost of the engine's per-step logits pull ([B, C, V] bf16 to
    the host and widened to float32 there), timed on the host clock."""
    from repro_torch.serve.engine import ServingEngine
    out = {}
    for C in (16, 1):
        x = torch.randn(B, C, cfg.vocab, device="cuda").to(torch.bfloat16)
        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ServingEngine._logits_to_host(x)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"C{C}_ms"] = statistics.median(times[2:])
        out[f"C{C}_bytes"] = x.numel() * x.element_size()
    return out


def profiled_window(step, n_steps: int, ops) -> dict:
    """A CUPTI trace over ``n_steps`` calls of ``step``.  Wall time is the
    host clock around the window (ending in a synchronize); device busy
    time is the union of kernel/copy intervals; idle share = 1 - busy/wall;
    ``ops`` maps each of the port's ops to the names of every kernel it
    launches: the op's device time per step is the sum over them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = sorted(device_events(prof), key=lambda e: e["ts"])
    busy, end = 0.0, -1e30
    for e in ev:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    by_name = {}
    for e in ev:
        key = e["name"][:70]
        by_name[key] = by_name.get(key, 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    mine = {op: [e for e in ev if any(k in e["name"] for k in names)]
            for op, names in ops.items()}
    return {"steps": n_steps, "wall_ms_per_step": wall_us / n_steps / 1e3,
            "device_busy_ms_per_step": busy / n_steps / 1e3,
            "idle_share": 1.0 - busy / wall_us if wall_us else None,
            "ops_ms_per_step": {op: sum(e["dur"] for e in x) / n_steps / 1e3
                                for op, x in mine.items()},
            "ops_kernels_per_step": {op: len(x) / n_steps
                                     for op, x in mine.items()},
            "top_ms_per_step": [(k, v / n_steps / 1e3) for k, v in top]}


def profile_windows(api, params, cfg, ops=None) -> dict:
    """Where a serve step's time goes: a CUPTI trace over two all-prefill
    steps and over four decode-only steps of 8 fresh requests."""
    from repro_torch.serve import ServeClient

    client = ServeClient(api, params, max_batch=8, max_seq=MAX_SEQ,
                         page_tokens=T, device="cuda")
    sess = client.open_session()
    rng = np.random.default_rng(2)
    for n in rng.integers(64, 481, 8):
        sess.submit(rng.integers(1, cfg.vocab, int(n)).tolist(), 40)
    eng = client.engine
    eng.step()

    def window(n_steps: int) -> dict:
        return profiled_window(eng.step, n_steps, ops or {})

    out = {"prefill": window(2)}
    while any(r.in_prefill for r in eng.active.values()):
        eng.step()
    out["decode"] = window(4)
    for r in list(eng.active.values()) + list(eng.waiting):
        eng.cancel(r)
    return out


# ---------------------------------------------------------------------------
# phase 3: the full step with kernels vs with the plain versions
# ---------------------------------------------------------------------------


def path_vs_plain(api, params, cfg) -> dict:
    rng = np.random.default_rng(1)
    caches = api.init_caches(B, MAX_SEQ, T, device="cuda")
    caches["page_table"].copy_(page_table(rng, idle=(B - 1,)))
    C = T
    for _ in range(3):      # fill some context with the kernels
        n = torch.tensor([16, 16, 16, 9, 16, 16, 16, 0], dtype=torch.int32,
                         device="cuda")
        tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B, C))
                               .astype(np.int32)).cuda()
        _, caches = api.serve_step(params, tok, caches, n)
    n_new = [16, 1, 16, 1, 5, 16, 1, 0]           # mixed prefill + decode
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B, C))
                           .astype(np.int32)).cuda()
    n = torch.tensor(n_new, dtype=torch.int32, device="cuda")

    def clone(c):
        return {"page_table": c["page_table"].clone(),
                "lengths": c["lengths"].clone(),
                "group": {k: tuple(t.clone() for t in v)
                          for k, v in c["group"].items()},
                "tail": {}}

    lk, ck = api.serve_step(params, tok, clone(caches), n)
    lr, cr = api.serve_step(params, tok, clone(caches), n, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(ck["lengths"], cr["lengths"])
    worst, scale, agree, rows = 0.0, 0.0, 0, 0
    for b, k in enumerate(n_new):
        a, r = lk[b, :k].float(), lr[b, :k].float()
        assert torch.isfinite(a).all()
        worst = max(worst, float((a - r).abs().max())) if k else worst
        scale = max(scale, float(r.abs().max())) if k else scale
        agree += int((a.argmax(-1) == r.argmax(-1)).sum())
        rows += k
    pool_err, pool_scale = 0.0, 0.0
    for pk, pr in zip(ck["group"]["b0_attn"], cr["group"]["b0_attn"]):
        d = (pk[:, 1:].float() - pr[:, 1:].float()).abs().max()
        pool_err = max(pool_err, float(d))
        pool_scale = max(pool_scale, float(pr[:, 1:].float().abs().max()))
    res = {"logits_max_abs_err": worst, "logits_max_abs": scale,
           "argmax_agree": f"{agree}/{rows}", "pool_max_abs_err": pool_err,
           "pool_max_abs": pool_scale}
    if worst > PATH_REL_TOL * scale or pool_err > PATH_REL_TOL * pool_scale:
        raise AssertionError(f"kernel path vs plain path: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 4: training at full width; phase 5: kernel path vs plain path
# ---------------------------------------------------------------------------


def train_main_path(api, cfg, expected: dict) -> dict:
    """``expected``: each kernel wrapper the step must launch, with its
    launches per step."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import common
    from repro_torch.train import AdamWConfig, LoopConfig, run_training

    pipe = TokenPipeline(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_S,
                         seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    res = run_training(api, pipe,
                       LoopConfig(steps=TRAIN_STEPS, microbatches=TRAIN_MB),
                       AdamWConfig(lr=3e-4, warmup_steps=2,
                                   total_steps=TRAIN_STEPS), device="cuda")
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    assert res.steps_run == TRAIN_STEPS and all(map(math.isfinite,
                                                    res.losses)), res
    # random init: unit-RMS final norm times the tied N(0, 0.02^2)
    # embedding gives logits of std sigma = 0.02 sqrt(d_model), so the first
    # loss is about ln(V) + sigma^2 / 2 (0.31 for qwen2, 0.41 for mamba2)
    offset = 0.02 ** 2 * cfg.d_model / 2
    expect0 = math.log(cfg.vocab) + offset
    assert abs(res.losses[0] - expect0) < 0.5, (res.losses, expect0)
    for kernel, per_step in expected.items():
        assert launches[kernel] == per_step * TRAIN_STEPS, (kernel, launches)
    step_s = statistics.median(res.step_seconds[1:])
    tokens = TRAIN_BATCH * TRAIN_S
    return {"losses": res.losses, "step_seconds": res.step_seconds,
            "step_s_median_2_4": step_s, "tokens_per_step": tokens,
            "tokens_per_s": tokens / step_s, "launches": launches,
            "launches_per_step": {k: launches[k] // TRAIN_STEPS
                                  for k in expected},
            "expected_per_step": expected,
            "first_loss_expected": expect0,
            "first_loss_offset_measured": res.losses[0] - math.log(cfg.vocab),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def train_batch(cfg, n: int, seed: int = 0) -> dict:
    from repro_torch.data import TokenPipeline
    b = TokenPipeline(cfg, global_batch=n, seq_len=TRAIN_S,
                      seed=seed).batch_at(0)
    return {k: torch.from_numpy(x).cuda() for k, x in b.items()}


def fresh_params(api, seed: int = 0):
    from repro_torch.models import init_params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return init_params(api.init_specs(), gen, device="cuda")


def train_profile(api, cfg, expected: dict, ops: dict) -> dict:
    """One warm train step, then a CUPTI window over the next, holding the
    step to ``expected`` launches (as train_main_path); ``ops`` maps each
    op to the names of its kernels in the trace, and each must show."""
    from repro_torch.kernels import common
    from repro_torch.train import AdamWConfig, make_train_step

    step, init_state = make_train_step(
        api, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS),
        microbatches=TRAIN_MB)
    box = {"state": init_state(fresh_params(api))}
    batch = train_batch(cfg, TRAIN_BATCH)

    def one():
        box["state"], m = step(box["state"], batch)
        float(m["loss"])

    one()
    common.reset_launch_counts()
    out = profiled_window(one, 1, ops)
    for kernel, per_step in expected.items():
        assert common.LAUNCHES[kernel] == per_step, (kernel, common.LAUNCHES)
    traced = sum(out["ops_kernels_per_step"].values())
    if traced and not all(out["ops_kernels_per_step"].values()):
        raise AssertionError(f"an op's kernels are missing from the trace: "
                             f"{out['ops_kernels_per_step']}")
    return out


# the bounds of train_path_vs_plain, by the reading each holds
TRAIN_BOUNDS = {"loss_abs_diff": LOSS_TOL, "grad_norm_rel_diff": GNORM_TOL,
                "leaf_rel_err_max": LEAF_TOL}


def train_path_vs_plain(api, cfg, seed: int = 0,
                        bounds: dict = TRAIN_BOUNDS) -> dict:
    """Loss and grads of one microbatch through the kernel and through the
    plain version, from the parameters and batch of ``seed``;
    ``within_tolerance`` says whether every bound in ``bounds`` (reading
    -> its largest value) held."""
    from repro_torch.train import make_loss_and_grad
    from repro_torch.train.optimizer import leaves

    params = fresh_params(api, seed)
    batch = train_batch(cfg, 1, seed)
    got = {}
    for impl in (None, "ref"):
        loss, grads = make_loss_and_grad(api, 1, impl=impl)(params, batch)
        got[impl] = (float(loss), leaves(grads))
        del grads
    torch.cuda.synchronize()
    (lk, gk), (lr, gr) = got[None], got["ref"]
    norm_k = math.sqrt(sum(float(g.float().square().sum()) for g in gk))
    norm_r = math.sqrt(sum(float(g.float().square().sum()) for g in gr))
    leaf_err = [float((a - b).float().norm() / b.float().norm().clamp_min(
        1e-30)) for a, b in zip(gk, gr)]
    assert all(torch.isfinite(g).all() for g in gk)
    res = {"seed": seed, "loss_kernel": lk, "loss_plain": lr,
           "loss_abs_diff": abs(lk - lr),
           "grad_norm_kernel": norm_k, "grad_norm_plain": norm_r,
           "grad_norm_rel_diff": abs(norm_k - norm_r) / norm_r,
           "leaf_rel_err_max": max(leaf_err),
           "leaf_rel_err_median": statistics.median(leaf_err),
           "leaves": len(leaf_err), "activations": str(cfg.dtype),
           "tolerances": bounds}
    res["within_tolerance"] = all(res[k] <= v for k, v in bounds.items())
    return res


def check_train_path(phase: str, res: dict) -> None:
    log(phase, json.dumps(res))
    if not res["within_tolerance"]:
        raise AssertionError(f"{phase}: training kernel path vs plain path "
                             "outside its bounds")


def release() -> None:
    """Return the memory of a finished phase to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.convert import cast_params
    from repro_torch.kernels import common
    from repro_torch.models import build_model, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"nvidia-smi: {smi.stdout.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log("tf32: matmul off, cudnn off")

    t0 = time.perf_counter()
    common.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {common.BUILD_INFO.get('seconds', 0.0):.2f} s, "
        f"cached={common.BUILD_INFO.get('cached')})")
    for line in ptxas_summary(str(common.BUILD_INFO.get("log", ""))):
        log("  ptxas", line)

    rng = np.random.default_rng(0)
    cases = [
        kv_append_case(rng, 16, "kv_append C=16"),
        kv_append_case(rng, 1, "kv_append C=1"),
        attention_case(rng, 16, "attention C=16"),
        attention_case(rng, 1, "attention C=1 (decode)"),
        attention_case(rng, 16, "attention C=16 window=256", window=256),
        attention_case(rng, 16, "attention C=16 softcap=30", softcap=30.0),
        attention_case(rng, 16, "attention C=16 straddling", straddle=True),
        attention_case(rng, 16, "attention C=16 one split", table_pages=4),
        attention_case(rng, 16, "attention C=16 full table", full=True),
        attention_case(rng, 1, "attention C=1 full table", full=True),
        attention_case(rng, 16, "attention C=16 idle slot", idle=True),
        attention_case(rng, 1, "attention C=1 idle slot", idle=True),
        flash_case(rng, "flash S=4096 causal", TRAIN_S),
        flash_case(rng, "flash S=4096 causal D=64", TRAIN_S, D=64),
        flash_case(rng, "flash S=4096 causal D=256", TRAIN_S, D=256),
        flash_case(rng, "flash S=4096 window=1024", TRAIN_S, window=1024),
        flash_case(rng, "flash S=4096 softcap=30", TRAIN_S, softcap=30.0),
        flash_case(rng, "flash S=4096 non-causal", TRAIN_S, causal=False),
        flash_case(rng, "flash S=1000 ragged", 1000),
        flash_case(rng, "flash S=512 D=64 float32", 512,
                   dtype=torch.float32, D=64),
        flash_bwd_case(rng, "flash bwd S=4096 causal", TRAIN_S),
        flash_bwd_case(rng, "flash bwd S=4096 causal D=64", TRAIN_S, D=64),
        flash_bwd_case(rng, "flash bwd S=4096 causal D=256", TRAIN_S, D=256),
        flash_bwd_case(rng, "flash bwd S=4096 window=1024", TRAIN_S,
                       window=1024),
        flash_bwd_case(rng, "flash bwd S=4096 softcap=30", TRAIN_S,
                       softcap=30.0),
        flash_bwd_case(rng, "flash bwd S=4096 non-causal", TRAIN_S,
                       causal=False),
        flash_bwd_case(rng, "flash bwd S=1000 ragged", 1000),
        flash_bwd_case(rng, "flash bwd S=512 D=64 float32", 512,
                       dtype=torch.float32, D=64),
        ssd_case(rng, "ssd path B'=16 L=256 H=64 float32", **SSD_PATH),
        ssd_case(rng, "ssd path B'=16 L=256 H=64 bf16", **SSD_PATH,
                 dtype=torch.bfloat16),
        ssd_case(rng, "ssd ragged L=100 H=6", Bp=4, L=100, H=6, P=64,
                 N=128),
        ssd_bwd_case(rng, "ssd bwd path B'=16 L=256 H=64 float32",
                     **SSD_PATH),
        ssd_bwd_case(rng, "ssd bwd path B'=16 L=256 H=64 bf16", **SSD_PATH,
                     dtype=torch.bfloat16),
        ssd_bwd_case(rng, "ssd bwd ragged L=100 H=6", Bp=4, L=100, H=6,
                     P=64, N=128),
        ssd_grad_case(rng, "ssd grads path shape", **SSD_PATH),
        # mamba2 at chunk 512 over the path's 4096 tokens: both kernels walk
        # their tiles in windows of 256 positions
        ssd_case(rng, "ssd chunk 512 B'=8 float32", **SSD_512),
        ssd_grad_case(rng, "ssd grads chunk 512", **SSD_512),
        # the serve step's fused append and attention (after the cases
        # above, so their inputs are the draws earlier runs had)
        fused_case(rng, 16, "fused C=16"),
        fused_case(rng, 1, "fused C=1 (decode)"),
        fused_case(rng, 16, "fused C=16 idle slot", idle=True),
        fused_case(rng, 1, "fused C=1 idle slot", idle=True),
        fused_case(rng, 16, "fused C=16 straddling", straddle=True),
        fused_case(rng, 16, "fused C=16 window=256", window=256),
        fused_case(rng, 16, "fused C=16 float32", dtype=torch.float32),
        # the float32 scalar path of paged_attention_chunk on its own
        attention_case(rng, 16, "attention C=16 float32",
                       dtype=torch.float32),
        # the float32 forward's tensor-core kernel at its mask edges
        flash_case(rng, "flash S=1000 ragged float32", 1000,
                   dtype=torch.float32),
        flash_case(rng, "flash S=1000 window=256 float32", 1000, window=256,
                   dtype=torch.float32),
        flash_case(rng, "flash S=1000 softcap=30 float32", 1000,
                   softcap=30.0, dtype=torch.float32),
    ]
    for c in cases:
        log("phase1", json.dumps(c))

    cfg = get_config("qwen2-1.5b")
    api = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(api.init_specs(), gen, device="cuda")
    params = cast_params(params, cfg)   # what the engine does at load
    torch.cuda.synchronize()
    # one fused append and attention per layer and step; the standalone
    # append and attention kernels never launch on the serving path
    main_path = serve_main_path(api, params, cfg, {
        "paged_attention_append_chunk": 1, "kv_append_chunk": 0,
        "paged_attention_chunk": 0})
    log("phase2", json.dumps(main_path))
    log("phase2 logits_d2h", json.dumps(logits_d2h_ms(cfg)))
    log("phase2 profile", json.dumps(profile_windows(api, params, cfg, {
        "paged_attention_append_chunk": PAGED_KERNELS,
        "kv_append_chunk": ("kv_append_kernel",)})))
    log("phase2 peak_mem_gb",
        round(torch.cuda.max_memory_allocated() / 2**30, 3))

    path = path_vs_plain(api, params, cfg)
    log("phase3", json.dumps(path))
    del params                       # the serving phases' weights
    release()

    # each layer's forward runs twice (remat "full" recomputes it), its
    # backward once
    flash_step = {"flash_attention": 2 * cfg.n_layers * TRAIN_MB,
                  "flash_attention_bwd": cfg.n_layers * TRAIN_MB}
    train = train_main_path(api, cfg, flash_step)
    log("phase4", json.dumps(train))
    release()
    log("phase4 profile", json.dumps(train_profile(
        api, cfg, flash_step,
        {"flash_attention": tuple(FLASH_KERNELS.values()),
         "flash_attention_bwd": FLASH_BWD_KERNELS[torch.bfloat16]})))
    release()
    for seed in PHASE5_SEEDS:
        check_train_path(f"phase5 seed={seed}",
                         train_path_vs_plain(api, cfg, seed))
        release()

    cfg = get_config("mamba2-1.3b")
    api = build_model(cfg)
    ssd_step = {"ssd_chunk": 2 * cfg.n_layers * TRAIN_MB,
                "ssd_chunk_bwd": cfg.n_layers * TRAIN_MB}
    ssm_train = train_main_path(api, cfg, ssd_step)
    log("phase6", json.dumps(ssm_train))
    release()
    log("phase6 profile", json.dumps(train_profile(
        api, cfg, ssd_step, {"ssd_chunk": SSD_FWD_KERNELS,
                             "ssd_chunk_bwd": SSD_BWD_KERNELS})))
    release()
    # mamba2-1.3b in bf16 amplifies a 1e-7 relative change of ssd_chunk's
    # output to ~30% in every grad leaf at init (PERF.md §6, PR 17), so the
    # kernel path is held to phase 5's bounds with float32 activations,
    # where the same change reads 1e-4 and a kernel that drops a key tile
    # reads >= 0.13 (grad norm) and >= 0.5 (leaf), and in bf16, the
    # activations phase 6 trains in, to the grad-norm bound alone
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    api32 = build_model(cfg32)
    for seed in PHASE5_SEEDS:
        check_train_path(f"phase7 float32 seed={seed}",
                         train_path_vs_plain(api32, cfg32, seed))
        release()
    del api32
    for seed in PHASE5_SEEDS:
        check_train_path(f"phase7 bf16 seed={seed}", train_path_vs_plain(
            api, cfg, seed, {"grad_norm_rel_diff": SSD_BF16_GNORM_TOL}))
        release()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_params(init_params(api.init_specs(), gen, device="cuda"),
                         cfg)
    torch.cuda.reset_peak_memory_stats()
    log("phase8", json.dumps(serve_main_path(api, params, cfg, {})))
    log("phase8 profile", json.dumps(profile_windows(api, params, cfg)))
    log("phase8 peak_mem_gb",
        round(torch.cuda.max_memory_allocated() / 2**30, 3))
    del params
    release()

    by = {c["case"]: c for c in cases}
    kernels = []
    for name, case, src, replaces, launches in (
            ("kv_append_chunk", "kv_append C=16",
             "src/repro_torch/kernels/csrc/kv_append.cu",
             "src/repro/kernels/kv_append/kernel.py:38",
             main_path["launches"]),
            ("paged_attention_chunk", "attention C=16",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/kernel.py:96",
             main_path["launches"]),
            ("paged_attention_append_chunk", "fused C=16",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/kv_append/kernel.py:38 + "
             "src/repro/kernels/paged_attention/kernel.py:96",
             main_path["launches"]),
            ("flash_attention", "flash S=4096 causal",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:92",
             train["launches"]),
            # the reference differentiates attention_ref (ops.py:140); the
            # backward kernel is the TPU kernel's gradient
            ("flash_attention_bwd", "flash bwd S=4096 causal",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:92",
             train["launches"]),
            ("ssd_chunk", "ssd path B'=16 L=256 H=64 float32",
             "src/repro_torch/kernels/csrc/ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk/kernel.py:50",
             ssm_train["launches"])):
        c = by[case]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"],
                        "call_ms": c["ms_call"],
                        "timing": c["ms_timing"]})
        if name in ("kv_append_chunk", "paged_attention_chunk"):
            # the serving path runs their work inside the fused launch
            kernels[-1]["launches"] = launches["paged_attention_append_chunk"]
            kernels[-1]["launched_inside"] = "paged_attention_append_chunk"
            kernels[-1]["standalone_launches"] = launches[name]
        if name == "paged_attention_chunk":   # prefill and decode shapes
            kernels[-1]["cases"] = [
                {k: by[n][k] for k in ("case", "splits", "ms", "bound_ms",
                                       "bound_by", "plain_ms", "library_ms",
                                       "max_abs_err")}
                for n in ("attention C=16", "attention C=1 (decode)",
                          "attention C=16 float32")]
        if name == "paged_attention_append_chunk":   # every fused case
            kernels[-1]["cases"] = [
                {k: c[k] for k in ("case", "dtype", "splits", "ms",
                                   "unfused_ms", "ms_over_unfused",
                                   "bound_ms", "bound_by", "plain_ms",
                                   "max_abs_err", "bitwise_vs_unfused")}
                for c in cases if c["case"].startswith("fused")]
        if name == "flash_attention":         # every phase-1 flash case
            kernels[-1]["cases"] = [
                {k: c[k] for k in ("case", "D", "dtype", "kernel", "ms",
                                   "bound_ms", "bound_by", "tflops",
                                   "plain_ms", "library_ms",
                                   "ms_over_library", "max_abs_err",
                                   "lse_max_abs_err")}
                for c in cases if c["case"].startswith("flash S")]
        if name == "flash_attention_bwd":     # every phase-1 backward case
            kernels[-1]["cases"] = [
                {k: c[k] for k in ("case", "D", "dtype", "kernel", "ms",
                                   "bound_ms", "bound_by", "tflops",
                                   "plain_ms", "library_ms",
                                   "ms_over_library", "fwd_bwd_ms",
                                   "library_fwd_bwd_ms", "max_abs_err",
                                   "grad_rel_err")}
                for c in cases if c["case"].startswith("flash bwd")]
        if name == "ssd_chunk":   # forward, backward, forward + backward
            bwd_src = "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu"
            ops = {"ssd ": ("ssd_chunk", src),
                   "ssd bwd": ("ssd_chunk_bwd", bwd_src),
                   "ssd grads": ("ssd_chunk+ssd_chunk_bwd",
                                 f"{src} + {bwd_src}")}
            kernels[-1]["cases"] = []
            for c in cases:
                op = max((k for k in ops if c["case"].startswith(k)),
                         key=len, default=None)
                if op is None:
                    continue
                op_name, op_src = ops[op]
                kernels[-1]["cases"].append({
                    "name": op_name, "route": "cuda", "source": op_src,
                    "replaces": replaces,
                    "launches": {k: launches[k]
                                 for k in op_name.split("+")},
                    **{k: c[k] for k in ("case", "kernel", "ms", "bound_ms",
                                         "bound_by", "plain_ms",
                                         "library_ms", "max_abs_err",
                                         "ms_call")}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
