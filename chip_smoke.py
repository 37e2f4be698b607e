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
     float32 at C=16 (3xTF32); the serve step's fused append and
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
     plain forward; and MLA's latent shape (16 heads over one KV head of
     576, one pool passed as K and V) at C=16 and C=1, with and without an
     idle slot, in bf16 (the latent kernel) and float32 (3xTF32), the
     latent kernel at pages of 8, on a full table and where every chunk
     sees at most two pages, and float32 there with a window, and
     ``kv_append_chunk`` at that row; the attention and the fused op at
     recurrentgemma-9b's row (16 heads over one KV head of 256, bf16) on a
     129-page table under its 2048 window, at C=16, C=8 (phase 13's
     prefill chunk) and C=1, with chunks past the window (the window
     floor drops key tiles) and below it, and
     at internvl2-1b's (14 heads over 2 of 64), each fused case bitwise
     against the unfused path and timed beside SDPA.  It times kernel,
     plain version and one PyTorch library call where there is one (a
     yardstick the port never calls);
  2. serves 8 requests (prompts of 64-480 tokens, 32 new tokens each,
     greedy) at full width through ``ServeClient`` (prefix cache on, as
     by default; the prompts share no page) with one POSIX and one STRICT
     session, and checks that every serve step launched the fused append
     and attention once on every layer and neither standalone serving
     kernel, and that the STRICT crash replay equals the committed pages
     after every step (phases 8, 12 and 13 serve through the same gates);
  3. runs one mixed prefill+decode ``serve_step`` of the full model twice
     from cloned caches, with the kernels and with the plain versions,
     and compares the logits, every pool and every recurrent state leaf;
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
     launched, and that the engine refused the prefix cache) and profiles
     a prefill and a decode window;
  9. drives the engine's mechanisms on qwen2-1.5b at full width and depth
     through ``ServeClient(max_batch=8, max_seq=1024, page_tokens=16)``:
     (a) 7 requests adopting a published 256-token prefix, (b) a fork whose
     tail page is CoW'd, (c) the host tier (a 16-page chain demoted by a
     flood of prompts and promoted back, bit for bit, the promotion's
     freed arena slots rewritten by a demotion in the same step), (d)
     speculative decoding in a POSIX and a STRICT session (crash replay
     equal to the committed pages after every step) and (e) (a) under
     ``Obs(trace=True)`` (a valid trace, ledgers summing to the phase
     totals).  In float32 activations each scenario's 32 greedy tokens a
     request equal those of the same requests without the mechanism; in
     bf16 (the timing lane) (a), (c) and (d) run with and without it,
     every request finishing with 32 tokens and the float32 lane's paging
     counts, and it prints their prefill steps and wall time, the
     adopters' time to first token, the decode step with and without
     speculation, the promote lag and the demotion time a page.  Every
     step launches the fused append and attention once a layer;
 10. drives the engine cluster at full width and depth through
     ``ServeClient(n_engines=2, n_spares=1)``, one PMDevice + OpLog per
     engine: 16 qwen2-1.5b requests (phase 2's 8 prompts and 8 of two
     shared-prefix families, 32 greedy tokens each) with and without the
     busiest engine killed mid-decode (each of its sessions 8 tokens in),
     in float32 activations (gates: tokens equal in the two runs, one
     steal, one death, a session migrated, no straggler flag) and in bf16
     (prints: the kill's detection in ticks and seconds, migration ms a
     session and a page, the migrated sessions' largest gap between two
     tokens, output tokens/s, and an open-loop Poisson run's time to first
     token and latency with and without a kill); then mamba2-1.3b in
     float32 with tests/test_cluster.py's kill (its recurrent state
     migrates, tokens equal).  In every run each request finishes with its
     tokens and a rid of its own, each live engine's STRICT log replays to
     its committed pages after every tick, its pool is whole at the end
     but for its trie's pins, every engine serves one copy of the weights,
     and every qwen2 step of every engine, restored pages included,
     launches the fused append and attention once a layer;
 11. drives SplitFS in the trainer: (a) qwen2-1.5b at full width on 14
     of its 28 layers, phase 4's shape, ``run_training`` with a
     ``CheckpointManager(keep=1)``: on a SYNC ``USplit``, 4 steps with a
     save every 2 and a crash after step 3; ``Volume.mount`` of the same
     device and a fresh manager over a STRICT ``USplit``, whose run
     restores step 2 bitwise equal to the state that save was given (all
     43 leaves) and gives steps 3-4 the losses of an uninterrupted run
     (rtol 1e-5, or the spread of two uninterrupted runs where they
     differ); its STRICT save of step 4 restored bitwise after a mount
     with oplog recovery; every relink commit copying nothing; a POSIX
     ``save(blocking=False)`` followed by one more in-place step, whose
     restore equals the state before that step.  It prints each save's
     and restore's ms and GB/s by part (D2H / H2D, the store's write /
     read, the relink fsync, the manifest, the crc), the bytes, the peak
     device memory with the non-blocking snapshot and the phase's
     seconds.  (b) runs ``repro_torch.launch.train`` as a subprocess twice
     (qwen2-1.5b SMOKE, 8 steps, a checkpoint every 4; mamba2-1.3b SMOKE,
     STRICT, 2 spares): exit 0, a falling loss, ``copied_bytes=0`` and the
     path's kernels launched;
 12. serves MoE and MLA (run before phase 11): deepseek-v2-lite-16b at
     full width and all 27 layers in bf16, weights cast as they are born,
     phase 2's 8 requests through ``ServeClient`` with every step launching
     ``kv_append_chunk`` and ``paged_attention_chunk`` (the latent kernel,
     D=576) once a layer and nothing else, a profiled prefill and decode
     window, init and serving peak memory, and one step's kernel path
     against its plain path on the same MoE routes (the router logits held
     to phase 3's bound too); grok-1-314b the same way at full width on 2
     of its 64 layers (the fused op with softcap 30, 8 experts top-2); then
     a float32 two-engine cluster of deepseek at full width and depth
     (max_batch 2, so every expert's capacity is exact) whose busiest
     engine dies mid-decode: its MLA pages migrate to the spare and every
     request's 12 tokens equal the unkilled run's.

 13. serves the RG-LRU hybrid and the VLM backbone (run before phase 11):
     (a) recurrentgemma-9b at full width and all 38 layers (12 groups of
     rec, rec, attn and a tail of two rec layers) in bf16, weights cast as
     they are born, through ``ServeClient(max_batch=8, max_seq=2304,
     page_tokens=16, chunk_tokens=8)``: phase 2's 8 requests in a POSIX
     and a STRICT session and one more whose 2032-token prompt and 24
     greedy tokens pass the 2048 window (the engine caps a slot at window
     + page - chunk tokens, so chunks of 8); after every step the STRICT
     crash replay equals the committed pages and the step launched the
     fused append and attention 12 times (once an attention layer) and no
     other serving kernel; the engine refuses the prefix cache; it prints
     tokens/s, the step medians, the steps at each chunk width, a prefill
     and a decode window profiled at the same table and chunks (phase 2's
     prompts, not the long request) and the init and serving peak memory;
     (b) phase 3's comparison at C=8, from random pools and state, slots
     past, across and below the window: logits, pools and every ``h`` and
     ``conv`` leaf to phase 3's bound; (c)
     internvl2-1b at full width and all 24 layers in bf16: phase 2's 8
     requests gated the same way (24 fused launches a step) and phase 3's
     comparison.

Every phase runs its model at full depth, but grok-1-314b (2 of 64
layers: its bf16 weights are ~632 GB) and phase 11 (a)'s qwen2-1.5b (14
of its 28 layers, at full width: three saves and three restores of the
full-depth state took 462-598 s of the script's 1200 s).

TF32 is switched off for matmuls and cuDNN, so float32 products are full
float32.  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels with their launch counts, times and bounds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
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
# recurrentgemma-9b's serving attention (16 heads over one KV head of 256,
# window 2048, a table of window + 16 tokens: 129 pages of 16) and
# internvl2-1b's (14 heads over 2 of 64)
# the serve step's only serving kernel at a GQA attention layer: the fused
# append and attention, once a layer
FUSED_STEP = {"paged_attention_append_chunk": 1}
LONG_NEW = 24                    # greedy tokens of the request past a window
RG_HEADS = dict(h=16, kv=1, d=256)
RG_WINDOW = 2048
RG_SEQ = RG_WINDOW + T
RG_MAX_SEQ = 2304                # its table: 129 pages of 16 (window + 16)
# the engine caps a slot at window + page_tokens - chunk tokens (the
# reference's ``_cap``), so with chunks of a page no request ever passes
# the window; chunks of 8 let one reach window + 8 = 2056 tokens, and
# phase 13's prefill steps run at C=8
RG_CHUNK = 8
VLM_HEADS = dict(h=14, kv=2, d=64)
# phase 11 (a): qwen2-1.5b at full width on half its 28 layers (three saves
# and three restores of the full 18.52 GB state took 462-598 s of the
# script's 1200 s)
PHASE11_LAYERS = 14
# the flash kernel of each dtype, as CUPTI names it in a trace
FLASH_KERNELS = {torch.bfloat16: "flash_wgmma_kernel",
                 torch.float32: "flash_f32_tc_kernel"}
# the kernels of the serve step's fused append and attention
PAGED_KERNELS = ("paged_attention_kernel", "paged_attention_f32_kernel",
                 "paged_attention_merge_kernel", "paged_latent_kernel")
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


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime / driver calls that put a kernel, copy or set on a stream
API_CATS = ("cuda_runtime", "cuda_driver")
API_CALLS = ("Launch", "Memcpy", "Memset")


def trace_events(prof) -> list:
    """Every complete event of a torch.profiler run, read from its Chrome
    trace (ts and dur in microseconds)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "profile.tmp.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    path.unlink()
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X"]


def device_events(prof) -> list:
    """Kernel / memcpy / memset intervals of a torch.profiler run."""
    return [e for e in trace_events(prof) if e.get("cat") in DEVICE_CATS]


def lost_events(events: list) -> dict:
    """Checks a trace for lost events: the correlation ids of its device
    kernels, copies and sets against those of the runtime and driver calls
    that enqueued them.  Empty when every call has its device event and
    every device event its call; else both counts and the names of the
    unmatched events of each side, counted."""
    def corr(e):
        return e.get("args", {}).get("correlation")
    dev = {corr(e): e for e in events if e.get("cat") in DEVICE_CATS}
    api = {corr(e): e for e in events if e.get("cat") in API_CATS
           and any(k in e.get("name", "") for k in API_CALLS)}
    if dev and dev.keys() == api.keys():
        return {}

    def names(side, ids):
        return dict(Counter(side[i].get("name", "")[:60] for i in ids))
    return {"device_events": len(dev), "api_calls": len(api),
            "calls_without_device_event": names(
                api, api.keys() - dev.keys()),
            "device_events_without_call": names(
                dev, dev.keys() - api.keys())}


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


def kernel_names(fn, want=(), tries: int = 3) -> list:
    """The names of the device events of one traced call of ``fn``, from
    the first of ``tries`` traces that recorded a name holding each of
    ``want`` (a trace here can lose every event, or some; see
    device_ms); else from the last trace that recorded any, or empty if
    none did."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e["name"] for e in device_events(prof)]
        if names:
            got = names
            if all(any(k in n for n in names) for k in want):
                break
    return got


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


def page_table(rng: np.random.Generator, idle=(), t: int = T,
               seq: int = MAX_SEQ) -> torch.Tensor:
    """Distinct random pages of ``t`` tokens per slot, ``seq // t`` a slot
    (never the null page 0); idle slots get an all-zero row, as the engine
    leaves them."""
    # B * seq // t - 1 usable pages for as many entries: the last entry
    # of the last row (past every context here) stays 0
    pages = seq // t
    perm = np.concatenate([rng.permutation(np.arange(1, B * pages)), [0]])
    pt = perm.reshape(B, pages).astype(np.int32)
    for b in idle:
        pt[b] = 0
    return torch.from_numpy(pt).cuda()


def randn(rng, *shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------


def kv_append_case(rng, C: int, name: str, *, kv=KV, d=D) -> dict:
    """``kv``, ``d``: the pool's row (MLA's latent: one head of 576)."""
    from repro_torch.kernels import kv_append_chunk
    from repro_torch.models.attention import paged_chunk_ids

    pt = page_table(rng, idle=(B - 1,))
    lengths = torch.from_numpy(
        rng.integers(0, LONGEST - C, B).astype(np.int32)).cuda()
    lengths[B - 1] = 0
    _, pids, sids = paged_chunk_ids(pt, lengths, C, T)
    pool = randn(rng, P, T, kv, d)
    new = randn(rng, B, C, kv, d)
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
    return {"case": name, "C": C, "KV": kv, "D": d, "max_abs_err": err, **t,
            **bound(nbytes, 0, BF16_FLOPS)}


def attention_case(rng, C: int, name: str, *, window=None, softcap=None,
                   straddle=False, table_pages=None, full=False,
                   short=False, idle=False, dtype=torch.bfloat16, h=H,
                   kv=KV, d=D, alias=False, page_tokens=T, seq=MAX_SEQ,
                   starts=None) -> dict:
    """``page_tokens``: tokens a page (the table spans ``seq``, MAX_SEQ
    unless given); ``starts``: the chunks' start positions, drawn by
    ``starts(rng)`` (else as the flags below say); ``table_pages``
    below the table's width narrows it (a table of at most 64 keys runs
    the kernel's single-split path); ``full`` puts every sequence at 1008
    keys (the table's last entry stays the null page); ``short`` keeps
    every chunk in the table's first two pages, as a prompt's first
    chunks (phase 2's and 12's profiled prefill window); ``idle`` gives the
    last slot length 0 and an all-zero row; ``h``, ``kv``, ``d`` the heads
    and head dim, and ``alias`` one pool passed as K and V (MLA's latent:
    16 heads over one KV head of 576)."""
    from repro_torch.kernels import common, paged_attention_chunk

    ptok = page_tokens              # tokens a page
    table_pages = seq // ptok if table_pages is None else table_pages
    pt = page_table(rng, idle=(B - 1,) if idle else (), t=ptok, seq=seq)
    pt = pt[:, :table_pages].contiguous()
    longest = min(LONGEST, table_pages * ptok)
    if starts is not None:
        starts = np.asarray(starts(rng))
    elif straddle:   # every chunk starts mid-page and crosses a boundary
        starts = rng.integers(1, (longest - C) // ptok, B) * ptok - ptok // 2
    elif full:
        starts = np.full(B, 1008 - C)
    elif short:
        starts = rng.integers(0, 2 * ptok, B)
    else:
        starts = rng.integers(0, longest - C + 1, B)
    if idle:
        starts[B - 1] = 0
    lengths = torch.from_numpy(starts.astype(np.int32)).cuda()
    q = randn(rng, B, C, h, d, dtype=dtype)
    pk = randn(rng, B * seq // ptok, ptok, kv, d, dtype=dtype)
    pv = pk if alias else randn(rng, B * seq // ptok, ptok, kv, d,
                                   dtype=dtype)
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
        fns["library_ms"] = sdpa_yardstick(q, pk, pv, pt, lengths, window)
    t = {"library_ms": None, **timings(**fns)}
    kernel = (PAGED_KERNELS[3] if d > 256 and dtype == torch.bfloat16
              else PAGED_KERNELS[0] if dtype == torch.bfloat16
              else PAGED_KERNELS[1])
    return {"case": name, "C": C, "dtype": str(dtype), "H": h, "KV": kv,
            "D": d, "T": ptok, "aliased_pools": alias, "splits": splits,
            "max_abs_err": err, "tolerance": {"atol": tol, "rtol": tol}, **t,
            "kernel": kernel if d <= 256 else check_ran(
                name, fns["ms"], (kernel,)),
            **paged_bound(starts, C, window, table_pages, q.element_size(),
                          h=h, kv=kv, d=d, pools=1 if alias else 2,
                          page_tokens=ptok)}


def sdpa_yardstick(q, pk, pv, pt, lengths, window):
    """One SDPA call computing the chunk's attention over the pages
    gathered beforehand (gather and mask construction are outside the
    timed call): the library yardstick of the paged ops."""
    import torch.nn.functional as F
    Bq, C, h, d = q.shape
    ptok, kv = pk.shape[1], pk.shape[2]
    S = pt.shape[1] * ptok
    k = pk[pt.long()].reshape(Bq, S, kv, d).repeat_interleave(h // kv, 2)
    v = pv[pt.long()].reshape(Bq, S, kv, d).repeat_interleave(h // kv, 2)
    kpos = torch.arange(S, device=q.device)[None, None, :]
    qpos = lengths.long()[:, None, None] + \
        torch.arange(C, device=q.device)[None, :, None]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    m4 = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)


def paged_bound(starts, C: int, window, table_pages: int, esz: int,
                append: bool = False, h=H, kv=KV, d=D, pools=2,
                page_tokens=T) -> dict:
    """The bound of one paged attention call on this run's data: the keys
    each sequence's chunk can see, [max(0, start - window + 1),
    min(start + C, N*T)), read once from each of ``pools`` pools (1: one
    pool passed as K and V, read once) with the table entries that hold
    them, q read and out written; the products 4 h d a visible (query,
    key) pair.  ``append``: the fused call, which also reads the chunk's
    new K and V rows and its (page, slot) ids and writes the rows into the
    pools, and reads the chunk's own keys from the new rows, not the
    pools."""
    st = np.asarray(starts, np.int64)
    k_hi = np.minimum(st + C, table_pages * page_tokens)
    k_lo = np.zeros_like(k_hi) if window is None else \
        np.maximum(st - window + 1, 0)
    keys = int((k_hi - k_lo).sum())
    pages = int((-(-k_hi // page_tokens) - k_lo // page_tokens).sum())
    row = kv * d * esz                             # one key's K (or V) row
    nbytes = (keys * row * pools + 2 * B * C * h * d * esz
              + pages * 4 + B * 4)
    if append:
        own = int((k_hi - np.maximum(st, k_lo)).clip(min=0).sum())
        rows = B * C * row                           # k_new or v_new
        nbytes += 4 * rows - own * row * 2 + 2 * B * C * 4
    visible = st[:, None] + np.arange(C)[None, :] + 1   # keys per query
    if window is not None:
        visible = np.minimum(visible, window)
    flops = int(4 * h * d * visible.sum())
    peak = BF16_FLOPS if esz == 2 else TF32X3_FLOPS
    return bound(nbytes, flops, peak)


def fused_case(rng, C: int, name: str, *, window=None, straddle=False,
               idle=False, dtype=torch.bfloat16, h=H, kv=KV, d=D,
               seq=MAX_SEQ, starts=None, library=False) -> dict:
    """The serve step's fused append and attention
    (``paged_attention_append_chunk``) against the unfused kernel path on
    the same inputs, ``kv_append_chunk`` on each pool and then
    ``paged_attention_chunk``: the outputs bitwise equal and the pools
    byte-equal off the null page 0; against the plain path (the two plain
    appends and the plain attention) to PAGED_TOL; timed beside the
    unfused path's sum and the plain path.  ``h``, ``kv``, ``d``: the
    heads and head dim; ``seq``: the table's tokens a slot; ``starts``:
    the chunks' start positions, drawn by ``starts(rng)``; ``library``:
    time SDPA's attention alone on the updated pools beside it."""
    from repro_torch.kernels import (common, kv_append_chunk,
                                     paged_attention_append_chunk,
                                     paged_attention_chunk)
    from repro_torch.models.attention import paged_chunk_ids

    pt = page_table(rng, idle=(B - 1,) if idle else (), seq=seq)
    if starts is not None:
        starts = np.asarray(starts(rng))
    elif straddle:   # every chunk starts mid-page and crosses a boundary
        starts = rng.integers(1, (LONGEST - C) // T, B) * T - T // 2
    else:
        starts = rng.integers(0, LONGEST - C + 1, B)
    if idle:
        starts[B - 1] = 0
    lengths = torch.from_numpy(starts.astype(np.int32)).cuda()
    _, pids, sids = paged_chunk_ids(pt, lengths, C, T)
    q = randn(rng, B, C, h, d, dtype=dtype)
    kn, vn = (randn(rng, B, C, kv, d, dtype=dtype) for _ in range(2))
    pk, pv = (randn(rng, B * seq // T, T, kv, d, dtype=dtype)
              for _ in range(2))
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
    fns = dict(ms=lambda: fused(*work), unfused_ms=lambda: unfused(*work),
               plain_ms=lambda: fused(*work, impl="ref"))
    if library:
        fns["library_ms"] = sdpa_yardstick(q, *work, pt, lengths, window)
    t = {"library_ms": None, **timings(**fns)}
    return {"case": name, "C": C, "dtype": str(dtype), "H": h, "KV": kv,
            "D": d, "table_pages": seq // T, "splits": splits,
            "bitwise_vs_unfused": bitwise, "pools_equal_off_page0":
            pools_equal, "max_abs_err": err,
            "tolerance": {"atol": tol, "rtol": tol},
            "kernel": check_ran(name, lambda: fused(*work), PAGED_KERNELS[:1]
                                if dtype == torch.bfloat16
                                else PAGED_KERNELS[1:2]),
            **t, "ms_over_unfused": t["ms"] / t["unfused_ms"],
            **paged_bound(starts, C, window, seq // T, q.element_size(),
                          append=True, h=h, kv=kv, d=d)}


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
    event shows nothing; one that lost some is taken again)."""
    ran = kernel_names(fn, kernels)
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


def attn_layers(cfg) -> int:
    return sum(k == "attn" for k in cfg.pattern_for_layers())


def serve_main_path(api, params, cfg, per_layer_step: dict, *,
                    max_seq=MAX_SEQ, chunk_tokens=None,
                    long_prompt=None) -> dict:
    """8 requests (prompts of 64-480 tokens, 32 greedy tokens each) in a
    POSIX and a STRICT session through ``ServeClient(max_batch=8,
    page_tokens=16)``, and with ``long_prompt`` one more POSIX request of
    that many tokens and LONG_NEW greedy ones, submitted first.  Gates,
    after every step: each live STRICT sequence's crash replay equals its
    committed pages, and the step launched each kernel of
    ``per_layer_step`` that many times an attention layer and no other
    kernel.  Every request finishes with its tokens, none truncated, and
    the STRICT log holds one commit a full page; a recurrent model's
    engine refused the prefix cache.  A step is a prefill step when its
    ``serve_step`` ran wider than one token."""
    from repro_torch.core import (OP_KV_COMMIT, Mode, OpLog, PMDevice,
                                  replay_kv_commits)
    from repro_torch.kernels import common
    from repro_torch.serve import ServeClient

    widths = []                 # each step's chunk width C

    def serve_step(params, tokens, *a, **kw):
        widths.append(tokens.shape[1])
        return api.serve_step(params, tokens, *a, **kw)

    oplog = OpLog(PMDevice(size=16 * 1024 * 1024), base_block=1,
                  num_blocks=64)
    client = ServeClient(dataclasses.replace(api, serve_step=serve_step),
                         params, max_batch=8, max_seq=max_seq,
                         page_tokens=T, chunk_tokens=chunk_tokens,
                         oplog=oplog, device="cuda")
    posix = client.open_session(mode=Mode.POSIX)
    strict = client.open_session(mode=Mode.STRICT)
    every = []
    if long_prompt is not None:
        every.append((posix.submit(np.random.default_rng(5).integers(
            1, cfg.vocab, long_prompt).tolist(), LONG_NEW), LONG_NEW))
    rng = np.random.default_rng(0)
    for i, n in enumerate(rng.integers(64, 481, 8)):
        prompt = rng.integers(1, cfg.vocab, int(n)).tolist()
        every.append(((strict if i % 2 else posix).submit(prompt, 32), 32))
    reqs = [r for r, _ in every]
    eng = client.engine
    want = {k: v * attn_layers(cfg) for k, v in per_layer_step.items() if v}
    torch.cuda.synchronize()
    common.reset_launch_counts()
    prefill, decode, replay_checks = [], [], 0
    t_start = time.perf_counter()
    while eng.waiting or eng.active:
        before = Counter(common.LAUNCHES)
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        (prefill if widths[-1] > 1 else decode).append(ms)
        step = dict(Counter(common.LAUNCHES) - before)
        assert step == want, (eng.steps, step, want)
        state = replay_kv_commits(oplog.scan())
        for r in reqs:
            if r.mode is Mode.STRICT and not r.done and r.seq_id is not None:
                assert state.get(r.seq_id, {}) == \
                    eng.controller.committed_extents(r.seq_id), r
                replay_checks += 1
    wall = time.perf_counter() - t_start
    for r, n_new in every:
        assert r.done and not r.truncated and len(r.output) == n_new, r
        assert all(0 <= t < cfg.vocab for t in r.output)
    strict_pages = sum((len(r.prompt) + len(r.output) - 1) // T
                       for r in reqs if r.mode is Mode.STRICT)
    commits = [e for e in oplog.scan() if e.op == OP_KV_COMMIT]
    assert len(commits) == strict_pages, (len(commits), strict_pages)
    assert all(e.mode == int(Mode.STRICT) for e in commits)
    assert replay_checks > 0
    if eng._recurrent:
        assert eng.prefix_cache is None
    out_tokens = sum(len(r.output) for r in reqs)
    assert len(widths) == eng.steps, (len(widths), eng.steps)
    res = {"steps": eng.steps, "chunk_tokens": eng.chunk,
           "steps_by_chunk": {f"C={c}": n
                              for c, n in sorted(Counter(widths).items())},
           "prefill_steps": len(prefill), "decode_steps": len(decode),
           "prefill_step_ms_median": statistics.median(prefill),
           "decode_step_ms_median": statistics.median(decode),
           "wall_s": wall, "output_tokens": out_tokens,
           "output_tokens_per_s": out_tokens / wall,
           "tokens_processed": eng.tokens_processed,
           "strict_commits": len(commits), "replay_checks": replay_checks,
           "launches": dict(common.LAUNCHES),
           "launches_per_step": want,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "prefix_cache": eng.prefix_cache is not None,
           "pages_adopted": eng.controller.pages_adopted}
    if long_prompt is not None:
        res["long_request"] = {"prompt": long_prompt,
                               "tokens": long_prompt + len(reqs[0].output),
                               "window": cfg.attn_window}
    return res


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
    launches: the op's device time per step is the sum over them.  A
    trace that lost events (``lost_events``) reports its counts as
    ``lost`` and busy time and idle share as None: the union of what it
    kept would read low."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = trace_events(prof)
    lost = lost_events(events)
    if lost:
        log(f"  cupti: window of {n_steps} steps lost events: {lost}")
    ev = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                key=lambda e: e["ts"])
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
            "device_busy_ms_per_step": None if lost
            else busy / n_steps / 1e3,
            "idle_share": None if lost or not wall_us
            else 1.0 - busy / wall_us,
            "lost": lost,
            "ops_ms_per_step": {op: sum(e["dur"] for e in x) / n_steps / 1e3
                                for op, x in mine.items()},
            "ops_kernels_per_step": {op: len(x) / n_steps
                                     for op, x in mine.items()},
            "top_ms_per_step": [(k, v / n_steps / 1e3) for k, v in top]}


def profile_windows(api, params, cfg, ops=None, *, max_seq=MAX_SEQ,
                    chunk_tokens=None) -> dict:
    """Where a serve step's time goes: a CUPTI trace over two all-prefill
    steps and over four decode-only steps of 8 fresh requests, served as
    ``serve_main_path`` serves them (``max_seq``, ``chunk_tokens``)."""
    from repro_torch.serve import ServeClient

    client = ServeClient(api, params, max_batch=8, max_seq=max_seq,
                         page_tokens=T, chunk_tokens=chunk_tokens,
                         device="cuda")
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


def path_vs_plain(api, params, cfg, *, max_seq=MAX_SEQ, C=T,
                  lengths=None) -> dict:
    """One mixed prefill + decode ``serve_step`` of the whole model at
    chunk width ``C`` (slots of C, 1 and 5 new tokens and an idle one),
    run twice from clones of the same caches: with the kernels and with
    ``impl="ref"`` (a MoE's routes pinned by ``RoutePin``).  The context
    before it: three kernel steps of 16 tokens or, given ``lengths``,
    random pools and recurrent state (N(0, 1) in each leaf's dtype) under
    those lengths; the table holds ``cfg.kv_pages_per_seq(max_seq)``
    pages a slot.  The logits, every pool off the null page and every
    recurrent state leaf are held to PATH_REL_TOL of their largest
    value."""
    rng = np.random.default_rng(1)
    caches = api.init_caches(B, max_seq, T, device="cuda")
    seq = cfg.kv_pages_per_seq(max_seq, T) * T
    caches["page_table"].copy_(page_table(rng, idle=(B - 1,), seq=seq))
    if lengths is None:
        for _ in range(3):      # fill some context with the kernels
            n = torch.tensor([16, 16, 16, 9, 16, 16, 16, 0],
                             dtype=torch.int32, device="cuda")
            tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B, T))
                                   .astype(np.int32)).cuda()
            _, caches = api.serve_step(params, tok, caches, n)
    else:
        gen = torch.Generator(device="cuda").manual_seed(13)
        for part in ("group", "tail"):
            for v in caches[part].values():
                for t in (v.values() if isinstance(v, dict) else v):
                    t.copy_(torch.randn(t.shape, generator=gen,
                                        device="cuda"))
        caches["lengths"].copy_(torch.tensor(lengths, dtype=torch.int32))
    n_new = [C, 1, C, 1, min(5, C), C, 1, 0]
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B, C))
                           .astype(np.int32)).cuda()
    n = torch.tensor(n_new, dtype=torch.int32, device="cuda")

    pin = RoutePin() if cfg.n_experts else contextlib.nullcontext()
    with pin:
        lk, ck = api.serve_step(params, tok, clone_tree(caches), n)
        if cfg.n_experts:
            pin.mode = "pin"
        lr, cr = api.serve_step(params, tok, clone_tree(caches), n,
                                impl="ref")
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
    res = {"C": C, "lengths": caches["lengths"].tolist(), "n_new": n_new,
           "logits_max_abs_err": worst, "logits_max_abs": scale,
           "argmax_agree": f"{agree}/{rows}", "leaves": {}}
    bad = [] if worst <= PATH_REL_TOL * scale else ["logits"]
    for part in ("group", "tail"):
        for key, v in ck[part].items():
            ref = cr[part][key]
            if isinstance(v, dict):             # recurrent state
                pairs = [(leaf, v[leaf], ref[leaf]) for leaf in v]
            else:                               # pools, off the null page
                off = (slice(None), slice(1, None)) if part == "group" \
                    else slice(1, None)
                pairs = [(f"pool{i}", x[off], y[off])
                         for i, (x, y) in enumerate(zip(v, ref))]
            for leaf, x, y in pairs:
                err = float((x.float() - y.float()).abs().max())
                top = float(y.float().abs().max())
                res["leaves"][f"{part}/{key}/{leaf}"] = {"max_abs_err": err,
                                                         "max_abs": top}
                if err > PATH_REL_TOL * top:
                    bad.append(f"{part}/{key}/{leaf}")
    if cfg.n_experts:
        res.update(moe_calls=len(pin.picks), route_flips=pin.flips,
                   router_logits_max_abs_err=pin.err,
                   router_logits_max_abs=pin.scale)
        if pin.err > PATH_REL_TOL * pin.scale:
            bad.append("router logits")
    if bad:
        raise AssertionError(f"kernel path vs plain path: {bad}: {res}")
    return res


class RoutePin:
    """The MoE's top-k during ``path_vs_plain``'s two steps: the kernel
    path's router logits and picks are recorded, call by call (one call a
    layer), and the plain path runs on those picks (``mode = "pin"``), so
    the two paths are held to each other on the same routes.  The router's
    input is held instead: ``err`` is the largest difference between the
    two paths' router logits, ``scale`` the largest kernel-path logit, and
    ``flips`` counts the rows whose own picks differ (the two paths' bf16
    hidden states differ by about 2%, and a row whose K-th and (K+1)-th
    logits lie closer than that flips: on the H100, 982 of deepseek's
    27 x 128 routed rows did in one step)."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers = layers
        self.inner = layers.top_k_experts
        self.mode = "record"
        self.picks = []
        self.calls = self.flips = 0
        self.err = self.scale = 0.0

    def __enter__(self):
        self.layers.top_k_experts = self.pick
        return self

    def __exit__(self, *exc):
        self.layers.top_k_experts = self.inner

    def pick(self, logits, K):
        vals, own = self.inner(logits, K)
        if self.mode == "record":
            self.picks.append((logits.clone(), own))
            return vals, own
        ref_logits, ref = self.picks[self.calls]
        self.calls += 1
        self.flips += int((own != ref).any(-1).sum())
        self.err = max(self.err, float((logits - ref_logits).abs().max()))
        self.scale = max(self.scale, float(ref_logits.abs().max()))
        return logits.gather(1, ref), ref


# ---------------------------------------------------------------------------
# phase 9: the engine's mechanisms (prefix cache, fork, host tier,
# speculative decoding, obs) on qwen2-1.5b at full width and depth
# ---------------------------------------------------------------------------

MECH_NEW = 32                    # greedy tokens of every phase-9 request
MECH_PREFIX = 256                # (a), (c): the shared prefix, 16 pages
# (c): 40 usable pages (trie capacity 20) over an arena of exactly the
# 16-page chain.  The flood publishes 20 pages, so the trie's capacity and
# the pool's pressure push the whole chain (and nothing else) to the
# host; the promotion then frees every arena slot, and the demotion that
# the next publish makes in the same step lands in one of them
TIER_POOL, TIER_HOST = 41, 16


def mech_client(api, params, device, **kw):
    from repro_torch.serve import ServeClient
    return ServeClient(api, params, max_batch=B, max_seq=MAX_SEQ,
                       page_tokens=T, device=device, **kw)


# the counts of every gated serving run (set to 0 just before the run, read
# just after it), summed: main sets it to 0 before a phase and reads the
# float32 kernel's launches in that phase's float32 lanes from it after
RUN_LAUNCHES: Counter = Counter()


def gated_launches(eng, kernels, n: int) -> dict:
    """Read the launch counts of a run of ``eng`` (or of its cluster) that
    set them to 0 first, add them to RUN_LAUNCHES and check them: ``n``
    launches of each of ``kernels`` (in float32 activations, every one of
    them the float32 instantiation's, where the wrapper counts it) and
    none of any other wrapper."""
    from repro_torch.kernels import common
    launches = dict(common.LAUNCHES)
    want = {k: n for k in kernels}
    if eng.api.cfg.dtype == torch.float32:
        want.update({f"{k}:float32": n for k in kernels
                     if f"{k}:float32" in launches})
    assert launches == {k: want.get(k, 0) for k in launches}, \
        (launches, want)
    RUN_LAUNCHES.update(launches)
    return launches


def drive(eng, reqs, layers=None, after_step=None) -> dict:
    """Step ``eng`` until it is idle, host clock around each step (ending
    in a synchronize on a CUDA engine).  Every request of ``reqs`` must
    finish with MECH_NEW tokens, none truncated; with ``layers`` every
    step must launch the fused append and attention once a layer and no
    other serving kernel (counts set to 0 first).  ``ttft_ms``: each
    request's first token, from the start of the drive."""
    from repro_torch.kernels import common
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    sync()
    common.reset_launch_counts()
    steps0 = eng.steps
    prefill, decode, first = [], [], {}
    t0 = time.perf_counter()
    while eng.waiting or eng.active:
        wide = bool(eng.waiting) or any(r.in_prefill
                                        for r in eng.active.values())
        ts = time.perf_counter()
        eng.step()
        sync()
        te = time.perf_counter()
        (prefill if wide else decode).append((te - ts) * 1e3)
        for r in reqs:
            if r.output and r.rid not in first:
                first[r.rid] = (te - t0) * 1e3
        if after_step is not None:
            after_step()
    wall = time.perf_counter() - t0
    steps = eng.steps - steps0
    if layers is not None:
        gated_launches(eng, ("paged_attention_append_chunk",),
                       layers * steps)
    for r in reqs:
        assert r.done and not r.truncated and len(r.output) == MECH_NEW, r
    return {"steps": steps, "prefill_steps": len(prefill),
            "prefill_ms": sum(prefill), "decode_steps": len(decode),
            "decode_step_ms_median": (statistics.median(decode)
                                      if decode else None),
            "wall_s": wall, "ttft_ms": [first[r.rid] for r in reqs]}


def mech_prefix(api, params, cfg, device, on, layers=None, obs=None):
    """(a): a 256-token prefix with 8 tails of 16-200 tokens; one request
    alone publishes the prefix, then 7 run together and (with the prefix
    cache) adopt its 16 pages.  With ``obs``, (e): the trace validates and
    the request ledgers sum to the phase totals."""
    from repro_torch.obs import validate_chrome_trace
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, cfg.vocab, MECH_PREFIX).tolist()
    tails = [rng.integers(1, cfg.vocab, int(n)).tolist()
             for n in rng.integers(16, 201, 8)]
    client = mech_client(api, params, device, prefix_cache=on, obs=obs)
    eng = client.engine
    sess = client.open_session()
    first = sess.submit(prefix + tails[0], MECH_NEW)
    alone = drive(eng, [first], layers)
    reqs = [sess.submit(prefix + t, MECH_NEW) for t in tails[1:]]
    together = drive(eng, reqs, layers)
    out = {"outputs": [first.output] + [r.output for r in reqs],
           "prefix_tokens": [r.prefix_tokens for r in reqs],
           "tokens_processed": eng.tokens_processed,
           "pages_adopted": eng.controller.pages_adopted,
           "alone": alone, "together": together}
    if on:
        assert out["prefix_tokens"] == [MECH_PREFIX] * 7, out
        assert out["pages_adopted"] == 7 * MECH_PREFIX // T, out
    if obs is not None:
        problems = validate_chrome_trace(obs.tracer.to_chrome())
        assert not problems, problems[:5]
        every = [first] + reqs
        steps = sum(r.ledger["steps"] for r in every)
        for comp in ("scheduler", "device", "persistence"):
            total = (obs.ledger.phase_totals("prefill")[comp]
                     + obs.ledger.phase_totals("decode")[comp])
            summed = sum(r.ledger[comp + "_ns"] for r in every)
            assert 0 <= total - summed <= 2 * steps, (comp, total, summed)
        out["trace_events"] = len(obs.tracer)
        out["overhead_shares"] = obs.ledger.breakdown()["shares"]
    return out


def mech_fork(api, params, cfg, device, on, layers=None):
    """(b): a 100-token prompt (the tail page holds 4 prompt tokens), forked
    after its 8th output token; parent and child go on greedily."""
    rng = np.random.default_rng(10)
    client = mech_client(api, params, device, prefix_cache=on)
    eng = client.engine
    req = client.open_session().submit(
        rng.integers(1, cfg.vocab, 100).tolist(), MECH_NEW)
    reqs, out = [req], {}
    if on:
        while len(req.output) < 8:
            eng.step()
        child = eng.fork(req)
        ctrl = eng.controller
        idx, filled = divmod(ctrl.seq_length(req.seq_id), T)
        src = int(ctrl.page_table()[req.seq_id][idx])
        dst = int(ctrl.page_table()[child.seq_id][idx])
        assert filled and src != dst and ctrl.pages_copied >= 1
        for pool in eng._pool_leaves():      # the CoW'd tail, bit for bit
            assert torch.equal(pool[:, src, :filled], pool[:, dst, :filled])
        reqs.append(child)
        out["pages_copied"] = ctrl.pages_copied
    drive(eng, reqs, layers)
    out["outputs"] = [r.output for r in reqs]
    return out


def trie_chain(pc, tokens) -> list:
    """The trie's nodes for ``tokens``' full pages, without touching the
    trie's LRU stamps or hit counts (``match_links`` would)."""
    level, out = pc._root, []
    for i in range(len(tokens) // pc.page_tokens):
        node = level.get(tuple(tokens[i * pc.page_tokens:
                                      (i + 1) * pc.page_tokens]))
        if node is None:
            break
        out.append(node)
        level = node.children
    return out


def mech_tier(api, params, cfg, device, on, layers=None):
    """(c): a request publishes a 16-page prefix; a flood of four distinct
    88-token prompts demotes it to the host; a 16-token request S and a
    request R with the prefix are admitted together: R's chain is
    promoted, and S's publish in the flip's step demotes a page into an
    arena slot the promotion has just freed."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, cfg.vocab, MECH_PREFIX).tolist()

    def prompt(n):
        return rng.integers(1, cfg.vocab, n).tolist()

    a_prompt, flood = prefix + prompt(8), [prompt(88) for _ in range(4)]
    s_prompt, r_prompt = prompt(T), prefix + prompt(12)
    client = mech_client(api, params, device, pool_pages=TIER_POOL,
                         prefix_cache=on,
                         host_cache_pages=TIER_HOST if on else 0)
    eng = client.engine
    sess = client.open_session()
    a = sess.submit(a_prompt, MECH_NEW)
    drive(eng, [a], layers)
    if on:
        nodes = trie_chain(eng.prefix_cache, prefix)
        assert len(nodes) == MECH_PREFIX // T
        before = [[v.clone() for v in eng._gather_page(nd.page)]
                  for nd in nodes]
    fl = [sess.submit(p, MECH_NEW) for p in flood]
    drive(eng, fl, layers)
    same_step = []
    if on:
        assert all(nd.on_host for nd in nodes), "chain not demoted whole"
        tier = eng.tier

        def after_step():
            same_step.append((eng.promote_events, tier.pages_demoted))
        same_step.append((0, tier.pages_demoted))
    s = sess.submit(s_prompt, MECH_NEW)
    r = sess.submit(r_prompt, MECH_NEW)
    res = drive(eng, [s, r], layers, after_step if on else None)
    out = {"outputs": [a.output] + [f.output for f in fl]
           + [s.output, r.output], "sr": res}
    if on:
        assert r.prefix_tokens == MECH_PREFIX
        assert tier.pages_demoted >= 16 and tier.pages_promoted >= 16
        for nd, want in zip(nodes, before):     # promoted bit for bit
            assert not nd.on_host
            for v, w in zip(eng._gather_page(nd.page), want):
                assert torch.equal(v, w)
        # a demotion in the step whose flip freed every arena slot
        flips = [i for i in range(1, len(same_step))
                 if same_step[i][0] > same_step[i - 1][0]]
        assert flips and same_step[flips[0]][1] > \
            same_step[flips[0] - 1][1], same_step
        out.update(pages_demoted=tier.pages_demoted,
                   pages_promoted=tier.pages_promoted,
                   promote_events=eng.promote_events,
                   promote_lag_ms=eng.promote_lag_ns
                   / eng.promote_events / 1e6,
                   demote_ms_per_page=tier.demote_ns
                   / tier.pages_demoted / 1e6,
                   arena_read_waits=tier.arena.read_waits)
    return out


def mech_spec(api, params, cfg, device, on, layers=None):
    """(d): a POSIX and a STRICT session, two requests each on prompts of a
    32-token motif repeated four times, with ``SpecConfig(k=4)``.  After
    every step each live STRICT sequence's crash replay equals its
    committed full pages."""
    from repro_torch.core import Mode, OpLog, PMDevice, replay_kv_commits
    from repro_torch.serve import SpecConfig
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab, 32).tolist() * 4 for _ in range(4)]
    oplog = OpLog(PMDevice(size=16 * 1024 * 1024), base_block=1,
                  num_blocks=64)
    client = mech_client(api, params, device, prefix_cache=False,
                         oplog=oplog)
    eng = client.engine
    spec = SpecConfig(k=4) if on else None
    posix = client.open_session(mode=Mode.POSIX, spec=spec)
    strict = client.open_session(mode=Mode.STRICT, spec=spec)
    reqs = [(strict if i % 2 else posix).submit(p, MECH_NEW)
            for i, p in enumerate(prompts)]
    checks = [0]

    def after_step():
        state = replay_kv_commits(oplog.scan())
        for r in reqs:
            if r.mode is Mode.STRICT and not r.done:
                assert state.get(r.seq_id, {}) == \
                    eng.controller.committed_extents(r.seq_id), r
                checks[0] += 1
    res = drive(eng, reqs, layers, after_step)
    assert checks[0] > 0
    out = {"outputs": [r.output for r in reqs], "drive": res,
           "replay_checks": checks[0]}
    if on:
        assert eng.spec_drafted_tokens > 0
        out.update(spec_steps=eng.spec_steps,
                   drafted=eng.spec_drafted_tokens,
                   accepted=eng.spec_accepted_tokens,
                   rollbacks=eng.spec_rollbacks,
                   accept_rate=eng.spec_accepted_tokens
                   / eng.spec_drafted_tokens)
    return out


def engine_mechanisms(cfg, device="cuda") -> dict:
    """Phase 9 on ``cfg`` (the CPU rehearsal runs it on the SMOKE config).

    A gate lane in float32 activations: each scenario twice from the same
    weights on fresh clients, with its mechanism and without (no prefix
    cache, spec or tier), every request's 32 greedy tokens equal in the
    two (float32 rounds the C=16 verify and the C=1 decode, or split plans
    of other batches, ~1e-6 apart; bf16 would flip argmaxes).  A timing
    lane in bf16, the serving dtype: (a), (c), (d) with and without, each
    request finishing with 32 tokens and the paging counts of the float32
    lane.  Every drive holds each step to one fused launch a layer."""
    from repro_torch.convert import cast_params
    from repro_torch.models import build_model, init_params
    from repro_torch.obs import Obs
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        lane = dataclasses.replace(cfg, dtype=dtype)
        api = build_model(lane)
        gen = torch.Generator(device=device).manual_seed(0)
        params = cast_params(init_params(api.init_specs(), gen,
                                         device=device), lane)
        layers = lane.n_layers if torch.device(device).type == "cuda" \
            else None
        args = (api, params, lane, device)
        a = {on: mech_prefix(*args, on, layers) for on in (True, False)}
        c = {on: mech_tier(*args, on, layers) for on in (True, False)}
        d = {on: mech_spec(*args, on, layers) for on in (True, False)}
        saved = (a[False]["tokens_processed"]
                 - a[True]["tokens_processed"])
        name = str(dtype).removeprefix("torch.")
        if dtype == torch.float32:
            b = {on: mech_fork(*args, on, layers) for on in (True, False)}
            e = mech_prefix(*args, True, layers, obs=Obs(trace=True))
            for what, x in (("a", a), ("c", c), ("d", d)):
                assert x[True]["outputs"] == x[False]["outputs"], what
            assert saved == 7 * MECH_PREFIX, saved
            assert b[True]["outputs"][0] == b[True]["outputs"][1] \
                == b[False]["outputs"][0]
            assert e["outputs"] == a[True]["outputs"]
            gate = {"pages_adopted": a[True]["pages_adopted"],
                    "pages_demoted": c[True]["pages_demoted"],
                    "pages_promoted": c[True]["pages_promoted"]}
            out[name] = {**gate, "tokens_saved": saved,
                         "pages_copied": b[True]["pages_copied"],
                         "spec_drafted": d[True]["drafted"],
                         "spec_accept_rate": d[True]["accept_rate"],
                         "strict_replay_checks": d[True]["replay_checks"],
                         "arena_read_waits": c[True]["arena_read_waits"],
                         "trace_events": e["trace_events"],
                         "obs_overhead_shares": e["overhead_shares"]}
        else:
            got = {"pages_adopted": a[True]["pages_adopted"],
                   "pages_demoted": c[True]["pages_demoted"],
                   "pages_promoted": c[True]["pages_promoted"]}
            assert got == gate, (got, gate)
            on, off = a[True]["together"], a[False]["together"]
            out[name] = {
                **got,
                "adopters_prefill_steps": [on["prefill_steps"],
                                           off["prefill_steps"]],
                "adopters_prefill_wall_ms": [on["prefill_ms"],
                                             off["prefill_ms"]],
                "adopters_ttft_ms_median": [statistics.median(on["ttft_ms"]),
                                            statistics.median(off["ttft_ms"])],
                "spec_decode_step_ms_median": [
                    d[True]["drive"]["decode_step_ms_median"],
                    d[False]["drive"]["decode_step_ms_median"]],
                "spec_decode_steps": [d[True]["drive"]["decode_steps"],
                                      d[False]["drive"]["decode_steps"]],
                "spec_accept_rate": d[True]["accept_rate"],
                "promote_lag_ms": c[True]["promote_lag_ms"],
                "demote_ms_per_page": c[True]["demote_ms_per_page"],
                "arena_read_waits": c[True]["arena_read_waits"]}
        del params, api, args
        release()
    return out


# ---------------------------------------------------------------------------
# phase 10: the engine cluster (prefix routing, the fault ladder, session
# migration) on qwen2-1.5b and mamba2-1.3b at full width and depth
# ---------------------------------------------------------------------------

CLUSTER_KILL_AFTER = 8           # qwen2: the victim's sessions' tokens at the kill
# the open-loop run of the bf16 lane: Poisson arrivals, and the kill's time
OPEN_LOOP_RATE, OPEN_LOOP_SEED, OPEN_LOOP_KILL_S = 2.0, 0, 3.0


def cluster_prompts(cfg) -> list:
    """Phase 2's 8 prompts (64-480 tokens) interleaved with 8 of two
    shared-prefix families (a 256-token prefix, tails of 16-160 tokens),
    so the router's affinity has work."""
    rng = np.random.default_rng(0)
    base = [rng.integers(1, cfg.vocab, int(n)).tolist()
            for n in rng.integers(64, 481, 8)]
    rng = np.random.default_rng(13)
    heads = [rng.integers(1, cfg.vocab, MECH_PREFIX).tolist()
             for _ in range(2)]
    fams = [heads[i % 2] + rng.integers(1, cfg.vocab, int(n)).tolist()
            for i, n in enumerate(rng.integers(16, 161, 8))]
    return [p for pair in zip(base, fams) for p in pair]


def cluster_client(api, params, device, **kw):
    """``ServeClient(n_engines=2, n_spares=1)`` at phase 2's geometry
    unless ``kw`` says otherwise, with one PMDevice + OpLog per engine
    (each engine is its own volume), and the logs in engine order."""
    from repro_torch.core import OpLog, PMDevice
    from repro_torch.serve import ServeClient
    logs = []

    def make_oplog():
        logs.append(OpLog(PMDevice(size=16 * 1024 * 1024), base_block=1,
                          num_blocks=64))
        return logs[-1]
    geometry = {"max_batch": B, "max_seq": MAX_SEQ, "page_tokens": T}
    client = ServeClient(api, params, n_engines=2, n_spares=1,
                         make_oplog=make_oplog, device=device,
                         **{**geometry, **kw})
    return client, logs


def busiest_mid_decode(after: int = CLUSTER_KILL_AFTER):
    """The qwen2 kill: the shard engine holding the most requests after
    the first tick, killed at the first tick at which each of its active
    sessions has ``after`` output tokens (its queued requests, if any,
    are requeued)."""
    box = {}

    def kill_when(c):
        if "victim" not in box:
            box["victim"] = max(range(2), key=lambda e: (
                len(c.engines[e].active) + len(c.engines[e].waiting), -e))
        eng = c.engines[box["victim"]]
        if eng.active and all(len(r.output) >= after
                              for r in eng.active.values()):
            return box["victim"]
        return None
    return kill_when


def busiest_after(ticks: int):
    """tests/test_cluster.py's kill: the busiest shard engine after
    ``ticks`` ticks."""
    def kill_when(c):
        if c.ticks < ticks:
            return None
        return max(range(2), key=lambda e: (len(c.engines[e].active),
                                            len(c.engines[e].waiting)))
    return kill_when


def cluster_run(client, logs, params, prompts, n_new, layers=None,
                kill_when=None,
                kernels=("paged_attention_append_chunk",)) -> dict:
    """Submit ``prompts`` (POSIX and STRICT sessions in turns of two) and
    tick the cluster until idle, host clock around each tick (ending in a
    synchronize on a CUDA device); ``kill_when(cluster)``, asked after
    each tick until it names an engine, kills it.  Gates: every request
    finishes with ``n_new`` tokens and a rid of its own; after every tick
    each live engine's STRICT log replays to the committed pages of its
    live STRICT sessions, and to nothing at the end; each live engine's
    pool is whole but for its trie's pins; every engine serves the
    weights ``params`` hold (one copy); with ``layers``, every model step
    of every engine launches each of ``kernels`` (the fused append and
    attention; MLA's append and attention) ``layers`` times and no other
    serving kernel (none at all for ``layers=0``)."""
    from repro_torch.core import Mode, replay_kv_commits
    from repro_torch.kernels import common
    from repro_torch.train.optimizer import leaves
    c = client.engine
    dev = c.engines[0].device
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    posix = client.open_session(mode=Mode.POSIX)
    strict = client.open_session(mode=Mode.STRICT)
    reqs = [(strict if (i // 2) % 2 else posix).submit(p, n_new)
            for i, p in enumerate(prompts)]
    migrations = []
    real_migrate = c._migrate

    def timed_migrate(src, targets):
        eng = c.engines[src]
        pages = sum(len(eng.controller.snapshot_seq(r.seq_id).pages)
                    for r in eng.active.values() if not r.promoting)
        sessions = len(eng.active)
        sync()
        t = time.perf_counter()
        real_migrate(src, targets)
        sync()
        migrations.append({"src": src, "targets": list(targets),
                           "sessions": sessions, "pages": pages,
                           "ms": (time.perf_counter() - t) * 1e3})
    c._migrate = timed_migrate
    token_t = {r.rid: [] for r in reqs}
    kill = detect = None
    replay_checks = 0
    sync()
    common.reset_launch_counts()
    steps0 = [e.steps for e in c.engines]
    t0 = time.perf_counter()
    while c.waiting or c.active:
        c.step()
        sync()
        now = time.perf_counter() - t0
        for r in reqs:
            token_t[r.rid] += [now] * (len(r.output) - len(token_t[r.rid]))
        for eid, log in enumerate(logs):
            if eid in c._killed:
                continue
            eng = c.engines[eid]
            state = replay_kv_commits(log.scan())
            for r in eng.active.values():
                if r.mode is Mode.STRICT and not r.promoting:
                    assert state.get(r.seq_id, {}) == \
                        eng.controller.committed_extents(r.seq_id), r.rid
                    replay_checks += 1
        if kill_when is not None and kill is None:
            victim = kill_when(c)
            if victim is not None:
                moved = [r.rid for r in c.engines[victim].active.values()]
                busy = sum(len(e.active) + len(e.waiting)
                           for i, e in enumerate(c.engines)
                           if i != victim and i not in c._killed)
                c.kill(victim)
                kill = {"engine": victim, "tick": c.ticks, "t": now,
                        "rids": moved, "queued": len(c.engines[victim].waiting),
                        "survivors_busy": busy}
        if kill is not None and detect is None and c.migrations:
            detect = {"tick": c.ticks, "t": now}
    wall = time.perf_counter() - t0
    del c._migrate                 # back to the method (and no cycle)
    for r in reqs:
        assert r.done and not r.truncated and len(r.output) == n_new, r
    assert len({r.rid for r in c.finished}) == len(c.finished) == len(reqs)
    live = [e for e in range(len(c.engines)) if e not in c._killed]
    for eid in live:
        eng = c.engines[eid]
        pinned = eng.prefix_cache.pinned_pages if eng.prefix_cache else 0
        assert eng.controller.pages_in_use == pinned, eid
        if eid < len(logs):
            assert replay_kv_commits(logs[eid].scan()) == {}, eid
    want = [x.data_ptr() for x in leaves(params)]
    for eng in c.engines:
        assert [x.data_ptr() for x in leaves(eng.params)] == want
    steps = sum(e.steps - s for e, s in zip(c.engines, steps0))
    if layers is not None:
        gated_launches(c.engines[0], kernels, layers * steps)
    st = c.stats()
    out = {"outputs": [r.output for r in reqs], "ticks": c.ticks,
           "engine_steps": steps, "wall_s": wall,
           "output_tokens_per_s": len(reqs) * n_new / wall,
           "engine_of_request": [r.engine_id for r in reqs],
           "router": st["router"], "migrations": st["migrations"],
           "sessions_migrated": st["sessions_migrated"],
           "sessions_requeued": st["sessions_requeued"],
           "restore_retries": st["restore_retries"],
           "steals": c.policy.steals, "remeshes": c.policy.remeshes,
           "deaths": c.monitor.deaths,
           "straggler_flags": c.monitor.straggler_flags,
           "strict_replay_checks": replay_checks,
           "migration_events": migrations}
    moved_pages = sum(m["pages"] for m in migrations)
    moved_sessions = sum(m["sessions"] for m in migrations)
    if moved_sessions:
        ms = sum(m["ms"] for m in migrations)
        out["migration_ms_per_session"] = ms / moved_sessions
        out["migration_ms_per_page"] = ms / moved_pages if moved_pages \
            else None
    if kill is not None:
        moved = [r for r in reqs if r.rid in kill["rids"]]
        gaps = []
        for r in moved:
            t = token_t[r.rid]
            gaps.append(max((b - a for a, b in zip(t, t[1:])
                             if a <= kill["t"] < b), default=0.0))
        out["kill"] = {
            "engine": kill["engine"], "tick": kill["tick"],
            "sessions": len(moved), "queued": kill["queued"],
            "survivors_busy": kill["survivors_busy"],
            "detect_ticks": detect["tick"] - kill["tick"] if detect else None,
            "detect_s": detect["t"] - kill["t"] if detect else None,
            "gap_across_kill_ms_max": max(gaps) * 1e3 if gaps else None,
            "dead_log_entries": (len(list(logs[kill["engine"]].scan()))
                                 if kill["engine"] < len(logs) else None)}
    return out


def cluster_open_loop(api, params, cfg, device, kill: bool) -> dict:
    """The bf16 lane's open-loop run: the 16 requests at Poisson arrivals
    (OPEN_LOOP_RATE a second, seed OPEN_LOOP_SEED) through
    ``OpenLoopDriver``; with ``kill``, the busiest shard engine dies
    OPEN_LOOP_KILL_S seconds in.  Every request finishes with its tokens."""
    from repro_torch.core import Mode
    from repro_torch.serve import ArrivalSpec, OpenLoopDriver, poisson_schedule
    client, _ = cluster_client(api, params, device)
    c = client.engine
    posix = client.open_session(mode=Mode.POSIX)
    strict = client.open_session(mode=Mode.STRICT)
    prompts = cluster_prompts(cfg)
    sched = poisson_schedule(len(prompts), OPEN_LOOP_RATE,
                             seed=OPEN_LOOP_SEED)
    workload = [ArrivalSpec(t, p, MECH_NEW,
                            session=strict if (i // 2) % 2 else posix)
                for i, (t, p) in enumerate(zip(sched, prompts))]

    def kill_busiest():
        c.kill(max((e for e in range(2) if e not in c._killed),
                   key=lambda e: (len(c.engines[e].active),
                                  len(c.engines[e].waiting))))
    res = OpenLoopDriver(client, session=posix).run(
        workload, faults=[(OPEN_LOOP_KILL_S, kill_busiest)] if kill else [])
    assert all(r.t_done is not None and r.n_output == MECH_NEW
               for r in res.records)
    pct = res.percentiles()
    st = c.stats()
    return {**{f"{m}_ms": {q: v * 1e3 for q, v in pct[m].items()}
               for m in ("ttft", "tpot", "latency")},
            "makespan_s": res.makespan,
            "output_tokens_per_s": res.throughput_tok_s,
            "ticks": c.ticks, "migrations": st["migrations"],
            "sessions_migrated": st["sessions_migrated"],
            "sessions_requeued": st["sessions_requeued"],
            "fault": st["fault"],
            "straggler_flags": c.monitor.straggler_flags}


def engine_cluster(qwen_cfg, mamba_cfg, device="cuda") -> dict:
    """Phase 10 (the CPU rehearsal runs it on the SMOKE configs).

    qwen2 in float32 activations (the gate lane): the 16 requests with
    and without the busiest engine killed mid-decode, every request's 32
    greedy tokens equal in the two, one steal, one death, at least one
    session migrated, the kill landing while the survivor serves and the
    victim's queued requests requeued, no straggler flagged in either
    run.  qwen2 in bf16
    (the timing lane): the same two runs, and an open-loop run with and
    without a kill.  mamba2 in float32: tests/test_cluster.py's kill at
    full width (2 engines and a spare, max_batch 2, 6 family prompts, 12
    tokens, the kill after 3 ticks), tokens equal, its recurrent state
    migrated.  ``cluster_run``'s gates hold in every run."""
    from repro_torch.convert import cast_params
    from repro_torch.models import build_model, init_params
    cuda = torch.device(device).type == "cuda"
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        lane = dataclasses.replace(qwen_cfg, dtype=dtype)
        api = build_model(lane)
        gen = torch.Generator(device=device).manual_seed(0)
        params = cast_params(init_params(api.init_specs(), gen,
                                         device=device), lane)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        prompts = cluster_prompts(lane)
        layers = lane.n_layers if cuda else None
        runs = {}
        for kill in (False, True):
            client, logs = cluster_client(api, params, device)
            runs[kill] = cluster_run(
                client, logs, params, prompts, MECH_NEW, layers,
                busiest_mid_decode() if kill else None)
            del client, logs
            if cuda:
                release()
        plain, killed = runs[False], runs[True]
        name = str(dtype).removeprefix("torch.")
        res = {"unkilled": {k: v for k, v in plain.items()
                            if k != "outputs"},
               "killed": {k: v for k, v in killed.items()
                          if k != "outputs"},
               "tokens_equal": killed["outputs"] == plain["outputs"]}
        if dtype == torch.float32:
            assert res["tokens_equal"], "a migrated session diverged"
            assert killed["steals"] == 1 and killed["deaths"] == 1, killed
            assert killed["sessions_migrated"] >= 1, killed
            # the kill lands while the survivor still serves, and the
            # victim's queued requests are requeued
            assert killed["kill"]["survivors_busy"] >= 1, killed
            assert killed["kill"]["queued"] >= 1, killed
            assert killed["sessions_requeued"] >= killed["kill"]["queued"]
            assert plain["straggler_flags"] == 0, plain
            assert killed["straggler_flags"] == 0, killed
        else:
            res["open_loop"] = {
                name: cluster_open_loop(api, params, lane, device, kill)
                for name, kill in (("unkilled", False), ("killed", True))}
        if cuda:
            res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"qwen2 {name}"] = res
        del params, api
        if cuda:
            release()
    lane = dataclasses.replace(mamba_cfg, dtype=torch.float32)
    api = build_model(lane)
    gen = torch.Generator(device=device).manual_seed(0)
    params = cast_params(init_params(api.init_specs(), gen, device=device),
                         lane)
    rng = np.random.default_rng(7)
    heads = [rng.integers(1, lane.vocab, 16).tolist() for _ in range(2)]
    prompts = [heads[i % 2] + rng.integers(1, lane.vocab, 6 + i % 5).tolist()
               for i in range(6)]
    runs = {}
    for kill in (False, True):
        client, logs = cluster_client(api, params, device, max_batch=2,
                                      max_seq=64, page_tokens=8,
                                      heartbeat_timeout=3.0)
        runs[kill] = cluster_run(client, logs, params, prompts, 12,
                                 0 if cuda else None,
                                 busiest_after(3) if kill else None)
        del client, logs
        if cuda:
            release()
    plain, killed = runs[False], runs[True]
    assert killed["outputs"] == plain["outputs"], "mamba2 state diverged"
    assert killed["sessions_migrated"] >= 1, killed
    out["mamba2 float32"] = {
        "unkilled": {k: v for k, v in plain.items() if k != "outputs"},
        "killed": {k: v for k, v in killed.items() if k != "outputs"},
        "tokens_equal": True}
    del params, api
    if cuda:
        release()
    return out


# ---------------------------------------------------------------------------
# phase 12: MoE and MLA on the serve path: deepseek-v2-lite-16b at full
# width and depth, grok-1-314b at full width on 2 of its 64 layers
# ---------------------------------------------------------------------------

# MLA's serve step: the latent append and the latent attention, unfused,
# once a layer each (the attention op's kernels: the latent kernel and, with
# context splits, their merge)
MLA_STEP = {"kv_append_chunk": 1, "paged_attention_chunk": 1}
MLA_OPS = {"paged_attention_chunk": ("paged_latent_kernel",
                                     "paged_attention_merge_kernel"),
           "kv_append_chunk": ("kv_append_kernel",)}
GROK_LAYERS = 2                  # of 64: the full model is ~632 GB in bf16
MLA_KILL_AFTER = 4               # the victim's sessions' tokens at the kill


def serving_weights(cfg):
    """Weights cast to ``cfg.dtype`` as they are born, with the init's
    seconds, bytes and peak device memory (one float32 leaf beside the
    bf16 tree)."""
    from repro_torch.models import build_model, init_params
    from repro_torch.train.optimizer import leaves
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(api.init_specs(), gen, device="cuda",
                         dtype=cfg.dtype)
    torch.cuda.synchronize()
    info = {"arch": cfg.name, "layers": cfg.n_layers,
            "attention_layers": attn_layers(cfg),
            "init_s": time.perf_counter() - t0,
            "params": sum(x.numel() for x in leaves(params)),
            "params_gb": sum(x.numel() * x.element_size()
                             for x in leaves(params)) / 1e9,
            "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    return api, params, info


def moe_serving(cfg) -> dict:
    """One MoE architecture on phase 2's path: bf16 weights cast as they
    are born (``serving_weights``: the float32 tree of deepseek would be
    64.8 GB), the 8 requests through ``ServeClient`` with each step's
    launches held to the attention's kernels a layer (``MLA_STEP`` for
    MLA, the fused op for GQA), a profiled prefill and decode window, the
    peak device memory of the serving, and one step's kernel path against
    its plain path on the same MoE routes (``path_vs_plain``)."""
    api, params, out = serving_weights(cfg)
    torch.cuda.reset_peak_memory_stats()
    out["serve"] = serve_main_path(api, params, cfg,
                                   MLA_STEP if cfg.mla else FUSED_STEP)
    out["profile"] = profile_windows(
        api, params, cfg, MLA_OPS if cfg.mla else {
            "paged_attention_append_chunk": PAGED_KERNELS})
    out["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["path_vs_plain"] = path_vs_plain(api, params, cfg)
    del params
    release()
    return out


def mla_cluster_kill(cfg, device="cuda", layers=None) -> dict:
    """deepseek's MLA pages migrating: ``ServeClient(n_engines=2,
    n_spares=1)`` in float32 activations and weights (``layers`` layers,
    None: all), tests/test_cluster.py's geometry and prompts (max_batch 2,
    pages of 8, six 22-26-token prompts of two families, 12 greedy tokens),
    with and without the busiest engine killed once each of its sessions
    has MLA_KILL_AFTER tokens.  At max_batch 2 a step routes at most 16
    rows, so T * top_k <= 4 E and every expert's capacity is exact: no
    pick drops, and a request's tokens do not depend on which requests
    share its steps (at phase 2's 8 x 16 rows capacity drops picks, and a
    requeued prefill's companions would decide them).  Gates: tokens
    equal, one steal, one death, a session migrated with its pages, every
    step of every engine launching MLA_STEP's kernels once a layer, and
    ``cluster_run``'s own."""
    from repro_torch.models import build_model, init_params
    cuda = torch.device(device).type == "cuda"
    lane = dataclasses.replace(cfg, dtype=torch.float32,
                               n_layers=layers or cfg.n_layers)
    api = build_model(lane)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(api.init_specs(), gen, device=device,
                         dtype=lane.dtype)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(7)
    heads = [rng.integers(1, lane.vocab, 16).tolist() for _ in range(2)]
    prompts = [heads[i % 2] + rng.integers(1, lane.vocab, 6 + i % 5).tolist()
               for i in range(6)]
    runs = {}
    for kill in (False, True):
        client, logs = cluster_client(api, params, device, max_batch=2,
                                      max_seq=64, page_tokens=8,
                                      heartbeat_timeout=3.0)
        runs[kill] = cluster_run(
            client, logs, params, prompts, 12,
            lane.n_layers if cuda else None,
            busiest_mid_decode(MLA_KILL_AFTER) if kill else None,
            kernels=tuple(MLA_STEP))
        del client, logs
        if cuda:
            release()
    plain, killed = runs[False], runs[True]
    res = {"layers": lane.n_layers,
           "unkilled": {k: v for k, v in plain.items() if k != "outputs"},
           "killed": {k: v for k, v in killed.items() if k != "outputs"},
           "tokens_equal": killed["outputs"] == plain["outputs"],
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                           if cuda else None)}
    assert res["tokens_equal"], "a migrated MLA session diverged"
    assert killed["steals"] == 1 and killed["deaths"] == 1, killed
    assert killed["sessions_migrated"] >= 1, killed
    assert sum(m["pages"] for m in killed["migration_events"]) > 0, killed
    del params, api
    if cuda:
        release()
    return res


# ---------------------------------------------------------------------------
# phase 13: the RG-LRU hybrid (recurrentgemma-9b) and the VLM backbone
# (internvl2-1b) on the serve path
# ---------------------------------------------------------------------------

def hybrid_serving(cfg) -> dict:
    """Phase 13 (a) and (b): recurrentgemma-9b at full width and all 38
    layers in bf16, served in chunks of RG_CHUNK with one request past the
    window, profiled at the same table and chunk, and one mixed step at
    that chunk whose slots sit past, across and below the window."""
    api, params, out = serving_weights(cfg)
    torch.cuda.reset_peak_memory_stats()
    out["serve"] = serve_main_path(api, params, cfg, FUSED_STEP,
                                   max_seq=RG_MAX_SEQ, chunk_tokens=RG_CHUNK,
                                   long_prompt=cfg.attn_window - 16)
    assert out["serve"]["long_request"]["tokens"] > cfg.attn_window
    out["profile"] = profile_windows(
        api, params, cfg, {"paged_attention_append_chunk": PAGED_KERNELS},
        max_seq=RG_MAX_SEQ, chunk_tokens=RG_CHUNK)
    out["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    seq = cfg.kv_pages_per_seq(RG_MAX_SEQ, T) * T
    w, C = cfg.attn_window, RG_CHUNK
    out["path_vs_plain"] = path_vs_plain(
        api, params, cfg, max_seq=RG_MAX_SEQ, C=C,
        lengths=[seq - C, seq - 4, w - C // 2, w // 2, 700, 0, 300, 0])
    del params
    release()
    return out


def vlm_serving(cfg) -> dict:
    """Phase 13 (c): internvl2-1b at full width and all 24 layers in bf16:
    phase 2's 8 requests, gated as phase 2's, and one step's kernel
    path against its plain path (phase 3's ``path_vs_plain``)."""
    api, params, out = serving_weights(cfg)
    out["serve"] = serve_main_path(api, params, cfg, FUSED_STEP)
    out["path_vs_plain"] = path_vs_plain(api, params, cfg)
    del params
    release()
    return out


# ---------------------------------------------------------------------------
# phase 11: the checkpointed trainer (the SplitFS store, the checkpoint
# manager, crash and resume, and the launch.train entry point)
# ---------------------------------------------------------------------------

RESUME_RTOL = 1e-5               # tests/test_train_serve.py:92
# staging files of phase 11's stores: each new file sorts the pool's whole
# free list (the store's contiguous allocator), so fewer, larger files
# make a save cheaper; one of them preallocated
CKPT_STAGING_BYTES = 2 * 1024 * 1024 * 1024
CKPT_STAGING_PREALLOC = 1


def state_equal(a, b) -> bool:
    """Every leaf bitwise equal, with its dtype and shape."""
    from repro_torch.train.optimizer import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def clone_tree(tree):
    """A copy of every leaf of nested dicts and tuples, on its device."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone_tree(v) for v in tree)
    return tree.detach().clone()


def ckpt_times(t: dict) -> dict:
    """A manager's ``last_save`` / ``last_restore`` in ms by part, with
    the bytes and GB/s."""
    out = {k + "_ms": v * 1e3 for k, v in t.items()
           if k not in ("bytes", "seconds")}
    out.update(bytes=t["bytes"], ms=t["seconds"] * 1e3,
               gb_per_s=t["bytes"] / t["seconds"] / 1e9)
    return out


def ckpt_store(nbytes: int, mode, staging_bytes: int, keep: int = 1,
               device=None):
    """A formatted volume for ``keep`` checkpoints of ``nbytes`` and the
    one being staged, on ``device`` when given (formatting a buffer already
    touched costs a tenth of a fresh one's first touch)."""
    from repro_torch.launch.train import checkpoint_volume
    return checkpoint_volume(nbytes, mode=mode, keep=keep,
                             staging_file_bytes=staging_bytes,
                             staging_prealloc=CKPT_STAGING_PREALLOC,
                             device=device)


def remount(store, mode, staging_bytes: int, **kw):
    """A fresh ``USplit`` over ``Volume.mount`` of the store's PM device,
    as a restarted process would build it."""
    from repro_torch.core import USplit, Volume
    vol = Volume.mount(store.device, store.volume.geometry)
    return USplit(vol, mode=mode, staging_file_bytes=staging_bytes,
                  staging_prealloc=CKPT_STAGING_PREALLOC,
                  staging_background=False, **kw)


def checkpointed_trainer(cfg, device="cuda", layers=None,
                         seq_len=TRAIN_S, batch=TRAIN_BATCH,
                         microbatches=TRAIN_MB,
                         staging_bytes=CKPT_STAGING_BYTES) -> dict:
    """Phase 11 (a) (the CPU rehearsal runs it on the SMOKE config at a
    small shape): ``run_training`` with a ``CheckpointManager(keep=1)`` at
    phase 4's shape, ``cfg``'s widths and ``layers`` layers (None: all),
    three saves and three restores of the whole state.

    (1, 2) On a fresh SYNC volume, 4 steps with a save every 2 and a crash
    after step 3; the save of step 2 keeps a device clone of the state it
    was given.  ``Volume.mount`` of the same PM device and a fresh manager
    over a STRICT ``USplit``: the resumed run restores step 2, bitwise
    equal to that clone (every leaf), its pipeline resumes at step 2, and
    its losses of steps 3-4 equal those of an uninterrupted run (rtol
    1e-5, or the spread of two uninterrupted runs where they differ).
    (4) The resumed run's save of step 4 is a STRICT one; the device is
    mounted again with oplog recovery, as a crash right after that save
    leaves it, and the restore equals the state saved, bitwise.  The
    crashed image is the device's own buffer: ``torn_copy`` with no torn
    tail copies it byte for byte, and at full depth the host cannot hold
    two volumes.  (3) Every relink commit copies nothing.  (5) POSIX
    ``save(blocking=False)``, one more in-place step, ``wait()``: the
    restore equals a device clone of the state before that step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import Mode
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import common
    from repro_torch.launch.train import state_bytes
    from repro_torch.models import build_model, init_params
    from repro_torch.train import (AdamWConfig, LoopConfig, make_train_step,
                                   run_training)
    from repro_torch.train.optimizer import leaves

    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = build_model(cfg)
    nbytes = state_bytes(api)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=4)
    loop = LoopConfig(steps=4, ckpt_every=2, microbatches=microbatches)

    def pipe():
        return TokenPipeline(cfg, global_batch=batch, seq_len=seq_len,
                             seed=0)

    saved = {}        # step -> device clone of the state its save was given
    saves, restores = [], []

    class Held(CheckpointManager):
        """Keeps a clone of the state each save is given, and holds each
        restore bitwise to the clone of its step."""

        def save(self, step, tree, extra=None, blocking=True):
            super().save(step, tree, extra, blocking)
            saves.append({"step": step, "mode": self.store.mode.name,
                          **ckpt_times(self.last_save)})
            saved[step] = clone_tree(tree)

        def restore(self, like, step=None):
            got = super().restore(like, step)
            if got is not None:
                restores.append({"step": got[0],
                                 "bitwise": state_equal(got[1],
                                                        saved.pop(got[0])),
                                 **ckpt_times(self.last_restore)})
            return got

    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "state_bytes": nbytes, "state_gb": nbytes / 1e9,
           "shape": {"batch": batch, "seq_len": seq_len,
                     "microbatches": microbatches},
           "staging_file_bytes": staging_bytes}
    t0 = time.perf_counter()
    store_a = ckpt_store(nbytes, Mode.SYNC, staging_bytes)
    out["pm_device_bytes"] = store_a.device.size
    out["first_format_s"] = time.perf_counter() - t0

    # (1, 2): crash after step 3, the save of step 2 behind it
    common.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run_training(api, pipe(), loop, opt, ckpt=Held(store_a, keep=1),
                     device=device, crash_at=3)
        raise AssertionError("crash_at=3 did not raise")
    except RuntimeError as e:
        assert "injected crash at step 3" in str(e), e
    out["crashed_run_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store_b = remount(store_a, Mode.STRICT, staging_bytes)
    out["remount_s"] = time.perf_counter() - t0
    copied = {"crashed": store_a.stats.copied_bytes}
    del store_a
    gc.collect()
    pipe_b = pipe()
    t0 = time.perf_counter()
    resumed = run_training(api, pipe_b, loop, opt,
                           ckpt=Held(store_b, keep=1), device=device)
    out["resumed_run_s"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in common.LAUNCHES.items() if v}
    if cuda and cfg.family != "ssm":
        # 5 steps; each layer's forward runs twice (remat "full"), its
        # backward once
        want = {"flash_attention": 5 * 2 * cfg.n_layers * microbatches,
                "flash_attention_bwd": 5 * cfg.n_layers * microbatches}
        for k, n in want.items():
            assert common.LAUNCHES[k] == n, (k, common.LAUNCHES)
    assert resumed.restored_from == 2 and resumed.steps_run == 2, resumed
    assert pipe_b.snapshot() == 4, pipe_b.snapshot()
    assert restores[0]["step"] == 2 and restores[0]["bitwise"], restores
    copied["resumed"] = store_b.stats.copied_bytes
    log_entries = store_b.stats.log_entries

    base = run_training(api, pipe(), loop, opt, device=device)
    again = run_training(api, pipe(), loop, opt, device=device)
    spread = max(abs(a - b) / abs(b)
                 for a, b in zip(again.losses[2:], base.losses[2:]))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(resumed.losses, base.losses[2:]))
    tol = RESUME_RTOL if spread == 0.0 else max(RESUME_RTOL, spread)
    out["resume"] = {
        "restored_from": resumed.restored_from,
        "losses_resumed_3_4": resumed.losses,
        "losses_uninterrupted_3_4": base.losses[2:],
        "losses_second_uninterrupted_3_4": again.losses[2:],
        "max_rel_diff": rel, "uninterrupted_spread": spread,
        "rtol": tol, "rtol_from": ("reference rtol 1e-5 (two uninterrupted "
                                   "runs bitwise equal)" if spread == 0.0
                                   else "max(1e-5, uninterrupted spread)")}
    assert rel <= tol, out["resume"]

    # (4): the STRICT save of step 4, recovered from the device as it stands
    t0 = time.perf_counter()
    store_c = remount(store_b, Mode.STRICT, staging_bytes,
                      oplog_slot=store_b.oplog_slot, recover=True)
    out["recover_mount_s"] = time.perf_counter() - t0
    del store_b
    gc.collect()
    got = Held(store_c, keep=1).restore(saved[4])
    assert got is not None and got[0] == 4, got and got[0]
    del got
    copied["recovered"] = store_c.stats.copied_bytes
    out["strict"] = {"restored_step": restores[1]["step"],
                     "bitwise": restores[1]["bitwise"],
                     "log_entries": log_entries}
    assert restores[1]["bitwise"], restores
    pm = store_c.device
    del store_c
    gc.collect()

    # (5) on a state one step past its init
    step, init_state = make_train_step(api, opt, microbatches=microbatches)
    gen = torch.Generator(device=device).manual_seed(1)
    state = init_state(init_params(api.init_specs(), gen, device=device),
                       device=device)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in pipe().batch_at(0).items()}
    state, m = step(state, data)
    float(m["loss"])
    store_p = ckpt_store(nbytes, Mode.POSIX, staging_bytes, device=pm)
    mgr = CheckpointManager(store_p, keep=1)
    want = clone_tree(state)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mgr.save(5, state, blocking=False)
    returned_ms = (time.perf_counter() - t0) * 1e3
    state, m = step(state, data)                  # in place
    float(m["loss"])
    mgr.wait()
    wait_ms = (time.perf_counter() - t0) * 1e3
    saves.append({"step": 5, "mode": "POSIX", **ckpt_times(mgr.last_save)})
    got = mgr.restore(state)
    restores.append({"step": got[0], "bitwise": state_equal(got[1], want),
                     **ckpt_times(mgr.last_restore)})
    out["posix_nonblocking"] = {
        "save_returned_ms": returned_ms, "save_waited_ms": wait_ms,
        "restored_step": got[0],
        "equals_state_before_the_step": restores[-1]["bitwise"],
        "state_changed_by_the_step": not state_equal(state, want)}
    if cuda:
        # the state, the step's activations and grads, the snapshot, and
        # this check's own clone of the state
        out["posix_nonblocking"]["peak_mem_gb"] = (
            torch.cuda.max_memory_allocated() / 2**30)
    copied["posix"] = store_p.stats.copied_bytes
    out["copied_bytes"] = copied
    out["saves"], out["restores"] = saves, restores
    assert got[0] == 5 and out["posix_nonblocking"][
        "equals_state_before_the_step"], out
    assert out["posix_nonblocking"]["state_changed_by_the_step"], out
    assert not any(copied.values()), copied
    del got, want, state, store_p, mgr, pm
    gc.collect()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 11 (b): the entry point's two runs of its docstring, each with the
# kernels its path must launch on the card
ENTRY_RUNS = (
    (["--arch", "qwen2-1.5b", "--smoke", "--steps", "8", "--ckpt-every",
      "4"], ("flash_attention", "flash_attention_bwd")),
    (["--arch", "mamba2-1.3b", "--smoke", "--steps", "8", "--ckpt-every",
      "4", "--mode", "strict", "--spares", "2"],
     ("ssd_chunk", "ssd_chunk_bwd")))


def entry_point_start(args: list, device="cuda"):
    """Start ``repro_torch.launch.train.main`` with ``args`` in a
    subprocess (as ``python -m repro_torch.launch.train`` runs it), which
    also prints its kernel launch counts; returns the process and its
    start time."""
    code = ("import json, sys; from repro_torch.kernels import common; "
            "from repro_torch.launch.train import main; main(sys.argv[1:]); "
            "print('launches', json.dumps(common.LAUNCHES))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, "-c", code, *args,
                             "--device", device], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, time.perf_counter()


def entry_point_run(args: list, kernels=(), device="cuda",
                    started=None) -> dict:
    """The run of ``args`` (``started`` by ``entry_point_start``, or
    started here): exit 0, a falling loss, ``copied_bytes=0`` and a
    launch of each of ``kernels``."""
    proc, t0 = started or entry_point_start(args, device)
    stdout, stderr = proc.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    lines = stdout.splitlines()
    assert proc.returncode == 0, (args, stdout[-2000:], stderr[-4000:])
    loss = next(l for l in lines if " steps, loss " in l)
    first, last = map(float, loss.split("loss ")[1].split(" ")[0:3:2])
    store = next(l for l in lines if l.startswith("[train] store:"))
    launches = json.loads(next(l for l in lines
                               if l.startswith("launches "))[9:])
    res = {"args": args, "rc": proc.returncode, "seconds": seconds,
           "loss_first": first, "loss_last": last, "store": store,
           "launches": {k: v for k, v in launches.items() if v}}
    assert last < first, res
    assert "copied_bytes=0," in store, res
    assert all(res["launches"].get(k) for k in kernels), res
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
    t_script = time.perf_counter()
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
    card = smi.stdout.strip()
    log(f"nvidia-smi: {card}")
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
        # the float32 kernel of paged_attention_chunk on its own
        attention_case(rng, 16, "attention C=16 float32",
                       dtype=torch.float32),
        # the float32 forward's tensor-core kernel at its mask edges
        flash_case(rng, "flash S=1000 ragged float32", 1000,
                   dtype=torch.float32),
        flash_case(rng, "flash S=1000 window=256 float32", 1000, window=256,
                   dtype=torch.float32),
        flash_case(rng, "flash S=1000 softcap=30 float32", 1000,
                   softcap=30.0, dtype=torch.float32),
        # MLA's latent: one pool of 576-wide rows passed as K and V, 16
        # heads (deepseek-v2-lite's serving shape), on the ragged / idle
        # table; the append at that row
        kv_append_case(rng, 16, "kv_append D=576 C=16", kv=1, d=576),
        kv_append_case(rng, 1, "kv_append D=576 C=1", kv=1, d=576),
        *(attention_case(rng, C, f"attention D=576 C={C}{tag} {dt}",
                         dtype=dtype, h=16, kv=1, d=576, alias=True,
                         **kw)
          for dt, dtype in (("bf16", torch.bfloat16),
                            ("float32", torch.float32))
          for C in (16, 1)
          for tag, kw in (("", {}), (" idle slot", {"idle": True}))),
        # the latent kernel at the MLA cluster's pages of 8 and on a full
        # table (every split live), float32 at D=576 windowed, and the
        # latent kernel where every chunk sees at most two pages
        *(attention_case(rng, C, f"attention D=576 C={C}{tag} bf16",
                         h=16, kv=1, d=576, alias=True, **kw)
          for tag, kw in ((" T=8", {"page_tokens": 8}),
                          (" full table", {"full": True}))
          for C in (16, 1)),
        attention_case(rng, 16, "attention D=576 C=16 window=256 float32",
                       dtype=torch.float32, h=16, kv=1, d=576, alias=True,
                       window=256),
        attention_case(rng, 16, "attention D=576 C=16 short contexts bf16",
                       h=16, kv=1, d=576, alias=True, short=True),
        # recurrentgemma-9b's attention (phase 13): 16 heads over one KV
        # head of 256 on a 129-page table under its 2048 window, at the
        # served prefill chunk (C=8: one row group), C=16 and decode, with
        # chunks past the window (the window floor drops key tiles) and
        # below it; internvl2-1b's (14 heads over 2 of 64)
        *(case(rng, C, f"{what} D=256 MQA C={C} window=2048 {tag}",
               window=RG_WINDOW, seq=RG_SEQ, starts=starts(C), **RG_HEADS,
               **extra)
          for what, case, extra in (("attention", attention_case, {}),
                                    ("fused", fused_case, {"library": True}))
          for C in (16, RG_CHUNK, 1)
          for tag, starts in (
              ("past the window", lambda C: lambda r: r.integers(
                  RG_WINDOW - 8, RG_SEQ - C + 1, B)),
              ("below the window", lambda C: lambda r: r.integers(
                  0, RG_WINDOW - C + 1, B)))),
        *(case(rng, C, f"{what} D=64 H=14 KV=2 C={C}", **VLM_HEADS, **extra)
          for what, case, extra in (("attention", attention_case, {}),
                                    ("fused", fused_case, {"library": True}))
          for C in (16, 1)),
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
    main_path = serve_main_path(api, params, cfg, FUSED_STEP)
    log("phase2", json.dumps(main_path))
    # the client's prefix cache is on, as in the reference; the prompts are
    # distinct, so no chain is adopted
    assert main_path["prefix_cache"] and main_path["pages_adopted"] == 0
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
    phase8 = serve_main_path(api, params, cfg, {})
    log("phase8", json.dumps(phase8))
    assert not phase8["prefix_cache"]    # refused for recurrent state
    log("phase8 profile", json.dumps(profile_windows(api, params, cfg)))
    log("phase8 peak_mem_gb",
        round(torch.cuda.max_memory_allocated() / 2**30, 3))
    del params
    release()

    # the float32 paged kernel's launches in each phase's float32 lanes,
    # summed over their gated runs
    f32_launches = {}

    def f32_phase(phase):
        f32_launches[phase] = {
            k: RUN_LAUNCHES[f"{k}:float32"]
            for k in ("paged_attention_chunk",
                      "paged_attention_append_chunk")}
        RUN_LAUNCHES.clear()

    RUN_LAUNCHES.clear()
    for lane, res in engine_mechanisms(get_config("qwen2-1.5b")).items():
        log(f"phase9 {lane}", json.dumps(res))
    f32_phase("phase9")

    t10 = time.perf_counter()
    for lane, res in engine_cluster(get_config("qwen2-1.5b"),
                                    get_config("mamba2-1.3b")).items():
        log(f"phase10 {lane}", json.dumps({"card": card, **res}))
    log(f"phase10 seconds {time.perf_counter() - t10:.1f}")
    f32_phase("phase10")

    t12 = time.perf_counter()
    log(f"phase12 starts at {t12 - t_script:.1f} s")
    ds_cfg = get_config("deepseek-v2-lite-16b")
    deepseek = moe_serving(ds_cfg)
    log("phase12 deepseek", json.dumps({"card": card, **deepseek}))
    grok = moe_serving(dataclasses.replace(get_config("grok-1-314b"),
                                           n_layers=GROK_LAYERS))
    log("phase12 grok", json.dumps({"card": card, **grok}))
    RUN_LAUNCHES.clear()
    log("phase12 deepseek kill", json.dumps({"card": card,
                                             **mla_cluster_kill(ds_cfg)}))
    f32_phase("phase12")
    log(f"phase12 seconds {time.perf_counter() - t12:.1f}")
    log("float32 paged launches", json.dumps(f32_launches))
    # the float32 lanes ran the float32 kernel: the fused op in phases 9
    # and 10 (qwen2), the latent width's in phase 12's kill (deepseek)
    assert f32_launches["phase9"]["paged_attention_append_chunk"] > 0
    assert f32_launches["phase10"]["paged_attention_append_chunk"] > 0
    assert f32_launches["phase12"]["paged_attention_chunk"] > 0

    t13 = time.perf_counter()
    log(f"phase13 starts at {t13 - t_script:.1f} s")
    rg = hybrid_serving(get_config("recurrentgemma-9b"))
    log("phase13 (a) recurrentgemma", json.dumps(
        {"card": card, **{k: v for k, v in rg.items()
                          if k != "path_vs_plain"}}))
    log("phase13 (b) recurrentgemma kernel vs plain", json.dumps(
        {"card": card, **rg["path_vs_plain"]}))
    vlm = vlm_serving(get_config("internvl2-1b"))
    log("phase13 (c) internvl2", json.dumps({"card": card, **vlm}))
    log(f"phase13 seconds {time.perf_counter() - t13:.1f}")

    t11 = time.perf_counter()
    log(f"phase11 starts at {t11 - t_script:.1f} s")
    # (b)'s two processes run beside (a), whose first minute formats its
    # PM volume on the host
    started = [entry_point_start(args) for args, _ in ENTRY_RUNS]
    try:
        log("phase11 (a)", json.dumps({"card": card, **checkpointed_trainer(
            get_config("qwen2-1.5b"), layers=PHASE11_LAYERS)}))
        release()
        for (args, kernels), run in zip(ENTRY_RUNS, started):
            log("phase11 (b)", json.dumps({"card": card, **entry_point_run(
                args, kernels, started=run)}))
    finally:
        for proc, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"phase11 seconds {time.perf_counter() - t11:.1f}; script "
        f"{time.perf_counter() - t_script:.1f} s")

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
            kernels[-1]["float32_launches"] = {
                p: f32_launches[p][name] for p in ("phase9", "phase10")}
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
    # the latent kernel and the append at MLA's row, on phase 12's path
    mla_launches = deepseek["serve"]["launches"]
    for name, case, cases in (
            ("kv_append_chunk", "kv_append D=576 C=16",
             ("kv_append D=576 C=16", "kv_append D=576 C=1")),
            ("paged_attention_chunk", "attention D=576 C=16 bf16",
             tuple(c["case"] for c in by.values()
                   if c["case"].startswith("attention D=576")))):
        c = by[case]
        kernels.append({
            "name": f"{name} (D=576, MLA)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "kv_append.cu" if name == "kv_append_chunk"
                else "paged_attention.cu"),
            "replaces": ("src/repro/kernels/kv_append/kernel.py:38"
                         if name == "kv_append_chunk" else
                         "src/repro/kernels/paged_attention/kernel.py:96"),
            "launches": mla_launches[name],
            "path": "phase 12: deepseek-v2-lite-16b serving",
            **({"float32_launches": {
                "phase12": f32_launches["phase12"][name]}}
               if name == "paged_attention_chunk" else {}),
            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "call_ms": c["ms_call"], "timing": c["ms_timing"],
            "cases": [{k: by[n].get(k) for k in (
                "case", "dtype", "splits", "kernel", "ms", "bound_ms",
                "bound_by", "plain_ms", "library_ms", "max_abs_err")}
                for n in cases]})
    # the fused op at recurrentgemma-9b's and internvl2-1b's rows, on phase
    # 13's paths (the standalone attention at those rows: phase 1 only),
    # each at the chunk its prefill steps run (recurrentgemma's: RG_CHUNK,
    # past the window)
    for tag, case, prefix, res in (
            ("D=256 MQA, window 2048", f"fused D=256 MQA C={RG_CHUNK} "
             "window=2048 past the window", "D=256 MQA", rg),
            ("D=64, 14 heads over 2", "fused D=64 H=14 KV=2 C=16",
             "D=64 H=14", vlm)):
        c = by[case]
        kernels.append({
            "name": f"paged_attention_append_chunk ({tag})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/kv_append/kernel.py:38 + "
                        "src/repro/kernels/paged_attention/kernel.py:96",
            "launches": res["serve"]["launches"][
                "paged_attention_append_chunk"],
            "launches_by_chunk": {
                c: n * res["attention_layers"]
                for c, n in res["serve"]["steps_by_chunk"].items()},
            "path": f"phase 13: {res['arch']} serving",
            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "call_ms": c["ms_call"], "timing": c["ms_timing"],
            "cases": [{k: x.get(k) for k in (
                "case", "C", "splits", "ms", "unfused_ms", "bound_ms",
                "bound_by", "plain_ms", "library_ms", "max_abs_err",
                "bitwise_vs_unfused")}
                for x in by.values() if prefix in x["case"]]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
