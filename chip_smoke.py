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
     against the unfused path and timed beside SDPA; and whisper-large-v3's
     shapes: the flash kernel non-causal at its cross attention (B=8,
     C=16 and C=1 queries against 1500 encoder frames) and its encoder
     (S=1500), 20 heads over 20 of 64, and the attention and the fused op
     at 20 heads over 20 of 64 on its 28-page table; and phase 15's
     training shapes, forward and backward (``train_flash_cases``): MLA's
     Q/K 192 wide beside V 128 (the op zero-pads V to 192, its pad timed
     on a line of its own) at 16 heads over 16, causal, in bf16 at the
     training sequence and in float32 at S=512, recurrentgemma's D=256 MQA
     under its 2048 window, internvl2's 4352 positions, and whisper's
     encoder (S=1500) and cross attention (448 queries against 1500 keys,
     the backward's first Sq != Sk shape), B=4, non-causal.  It times
     kernel, plain version and one PyTorch library call where there is one
     (a yardstick the port never calls; SDPA takes V's own width);
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
 11. drives SplitFS in the trainer: (a) qwen2-1.5b at full width on 2
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
 14. serves the encoder-decoder (run before phase 11): whisper-large-v3
     at full width and depth (32 encoder and 32 decoder layers, d_model
     1280, 20 heads of 64, vocab 51866, 1500 frames) in bf16: (a) 8 slots'
     random frames encoded and their cross K/V computed (timed), written
     into the client's caches (the engine never encodes, as the
     reference's), and phase 2's 8 requests served at ``max_seq=448``
     (whisper's decoder context) with prompts of 64-384 tokens, gated as
     phase 2's with 32 fused ops and 32 flash cross attentions a step;
     (b) phase 3's comparison from those cross K/V (logits and pools; the
     cross K/V come back unchanged); (c) a prefill and a decode window
     profiled from them.
 15. trains the other families (run before phase 11) at full width in
     bf16 as phase 4 trains qwen2 (``family_training``: 4 AdamW steps of
     4 microbatches, remat "full", finite losses, the first near ln V +
     sigma^2 / 2, exact flash forward and backward launches a step, one
     profiled step with both flash ops' kernels in the trace, and one
     microbatch's loss and grads through the kernels against the plain
     path at one seed, held to bounds of the family's own): deepseek-v2-
     lite-16b (MLA through the flash kernel at Q/K 192 and V 128, the
     MoE; the check in float32 activations), recurrentgemma-9b (the
     RG-LRU, D=256 MQA under the 2048 window, the layer tail; the peak
     memory of ``rglru_train``'s doubling scan at S=4096), internvl2-1b
     (256 patch embeddings + 4096 tokens) and whisper-large-v3 (1500
     frames, 448 decoder tokens: the encoder, the decoder's self and
     cross attentions).
 16. reduces the grads across ranks through the compressed codec (run
     before phase 11): (a) qwen2-1.5b at full width and depth over a
     one-rank NCCL group, phase 4's shape, ``run_training`` for 3 steps
     each of codec none, int8 and top-k from the same params, every
     reduction timed with CUDA events and each bucket held to the codec's
     identities (``CodecProbe``), the flash launches a step phase 4's,
     the residuals non-zero, int8's losses within ``POD_LOSS_TOL`` of
     none's; it prints the bucket plan, the residuals' GB, the int8
     wire's bytes against float32's, the codec's ms and share of a step
     and the peak memory; (b) two ranks spawned on the one card over
     gloo, each through ``run_training(pod_group=...)``, qwen2-1.5b at
     full width on 4 of 28 layers, 2 steps each of none and int8: every
     bucket's reduction within the rounding bound of the plain float32
     mean of both ranks' values, both ranks' params bitwise equal after
     every step, their residual rows different, int8 within (a)'s bound
     of none.
 17. serves across ranks through the mesh serve step (run before phase
     11): qwen2-72b at full width on 4 of its 80 layers, (a) unsharded
     through ``api.serve_step`` (8 prompts of 16-64 tokens in chunks of
     16, then 16 greedy decode steps) in float32 and bf16, each lane's
     tokens and logits kept; (b) the same weights' shards on gloo ranks
     spawned on the one card through ``serve.step.make_serve_step``,
     teacher-forced with (a)'s tokens: mesh (1, 4) in both lanes and
     (2, 2) in float32, every rank's logits within ``MESH_LOGIT_TOL`` of
     (a)'s at every step, its float32 greedy tokens equal to (a)'s where
     (a)'s top-2 gap exceeds twice the step's largest difference, the
     fused op launched once a layer a step and no other kernel, both
     runs timed by step; phase 1 holds the fused op at a rank's shape
     (16 heads over 2 KV heads of 128, C=16 and C=1).  The same for the
     MoE family and copied KV heads (``MESH_MODELS``, 8 decode steps):
     grok-1-314b at full width on 2 layers in bf16 and 1 in float32 at
     (1, 4) (12 heads over 2 KV heads, 2 whole experts a rank);
     deepseek-v2-lite-16b on 4 of 27 layers at (1, 4) in float32 and
     bf16 and at (2, 2) in float32 under both variants, ``shard_map``
     held to the unsharded step run on each data shard's rows alone (4
     heads, the whole latent, 16 experts a rank; one latent append and
     one latent attention a layer a step); qwen2-1.5b at full width and
     depth in bf16 at (1, 4) (3 heads over a copy of one KV head); the
     bf16 MoE lanes on their reference's routes (``RouteTape``); phase 1
     holds each rank's attention shape at C=16 and C=1.  The same for
     every other family (ROADMAP 7.4, 7.5), in float32, each rank's
     state or pools and cross K/V held too, to (a)'s final caches:
     mamba2-1.3b on 8 of 48 layers at (1, 4) and (2, 2) under both
     variants (16 SSD heads a rank, no kernel); recurrentgemma-9b on 5
     of 38 layers (one (rec, rec, attn) group and the two-layer rec
     tail) at (1, 4) in chunks of 8 (1024 of the 4096 LRU channels and 4
     heads over a copy of the one KV head a rank); whisper-large-v3 on 4
     of 32 decoder layers (and 4 of 32 encoder layers, whose output (a)
     computes once) at (1, 4) and (2, 2) (5 heads a rank, each rank's
     cross K/V computed from its own ``wk`` / ``wv``); internvl2-1b at
     full depth at (2, 2) (7 heads over one KV head a rank, the
     vocabulary whole).
 18. item 6's smoke sweep (run before phase 11): minitron-8b and
     starcoder2-7b at full width and depth in bf16, each through phase
     3's kernel path against plain path, the fused op launched once a
     layer a kernel step; phase 1 holds starcoder2's 36 heads over 4
     (a group of 9) at C=16 and C=1.
 19. the mesh train step (run before phase 11; ROADMAP 7.6): four gloo
     ranks spawned on the one card, their collectives probed first
     (``gloo_probe``: the FSDP pair ``all_gather_into_tensor`` and
     ``reduce_scatter_tensor`` too), each lane's ranks taking their
     shards of the same seed-0 params (drawn in turns) and their data
     rank's rows of the same batches, beside (a): each arch unsharded in
     this process, three AdamW steps in float32 (``make_train_step``;
     a bf16 lane's arch in bf16 too, ``run_training``).  Every float32
     lane is held to (a) by its losses, grad norms and every param
     gathered from the ranks' shards after step 3 (``TRAIN_MESH_TOL``;
     copies bitwise equal) and its launches a rank a step
     (``train_launches``).  The lanes, at full width: recurrentgemma-9b
     on 4 of 38 layers (a group and the tail's first rec) at (1, 4),
     1024 LRU channels and 4 heads over a copied KV head a rank, 4
     microbatches of one sequence of 1024 tokens, its (a) and its ranks
     each alone on the card (8 / 4 flash launches); qwen2-1.5b on 2 of
     28 layers, 2 microbatches of 2 x 1024 tokens: float32 at (1, 4) (3
     heads over a KV head copied on two ranks, its grads summed over the
     copy group), bf16 at (2, 2) through ``run_training(mesh=...)`` (its
     step time, peak memory a rank and loss gap to (a)'s logged);
     deepseek-v2-lite-16b on 1 of 27 layers
     at (2, 2) (8 heads, 32 whole experts and the whole latent a rank)
     on (a)'s top-k picks, every router's column 0 scaled by 16 so that
     expert 0 overflows each microbatch's capacity: the picks dropped a
     step, summed over the data ranks, must equal (a)'s and be above
     zero, the router and ``w_dkv`` bitwise equal across model ranks;
     mamba2-1.3b on 2 of 48 layers at (2, 2) (32 of 64 SSD heads a rank,
     B and C whole; 8 ``ssd_chunk`` and 4 ``ssd_chunk_bwd`` launches);
     whisper-large-v3 on 1 encoder and 1 decoder layer at (2, 2) (10
     heads a rank; 1500 frames, 448 tokens); qwen2-1.5b's pod lanes
     (ROADMAP 7.6d) at (pod, data, model) = (2, 1, 2), each pod 2 of the
     4 rows: under int8 (each pod the whole model, 6 heads over 1 a
     rank, its shards reduced with the other pod's on its own buckets)
     held to ``POD_TOL`` (its step-1 loss, before the codec acts, to
     ``TRAIN_MESH_TOL``), its params bitwise equal across the pods, and
     on every rank the error-feedback identity within its float32 bound
     (``PodProbe``), which pod 0's residuals in place of pod 1's, and
     the clip norm over every pod's pieces, must break; uncompressed
     ("pod" in FSDP and the batch, the (2, 2) view: FSDP over "data", 6
     heads over 1 KV head a rank) held to ``TRAIN_MESH_TOL``.
     internvl2-1b's lane (2 of 24 layers at (2, 2), 7 heads over 1, 256
     patch embeddings before 1024 tokens) runs in ``tools/mesh_gate.py``
     alone: the script's 1200 s do not hold it; so does qwen2-1.5b's
     float32 (2, 2) lane, the uncompressed pod lane's step.

Every phase runs its model at full depth, but grok-1-314b (2 of 64
layers: its bf16 weights are ~632 GB; 2 and 1 in phase 17), phase 11
(a)'s qwen2-1.5b (2
of its 28 layers, at full width: three saves and three restores of the
full-depth state took 462-598 s of the script's 1200 s) and phase 15's
deepseek-v2-lite-16b (4 of 27 layers) and recurrentgemma-9b (4 of 38):
their float32 training state does not fit 80 GB at full depth; and
phase 16 (b)'s two ranks (4 of 28 layers each, so both states fit the
one card and its float32 grads through the host fit the phase's time)
and phase 19's lanes (qwen2-1.5b on 2 of 28 layers, cut from 4 so the
others fit; deepseek-v2-lite-16b on 1 of 27, recurrentgemma-9b on 4 of
38, mamba2-1.3b on 2 of 48, whisper-large-v3 on 1 of 32 encoder and
decoder layers), so (a) and four ranks' collectives through the host fit
the script's 1200 s;
and phase 17's qwen2-72b (4 of 80 layers: the whole model's 145.4 GB of
bf16 weights need four cards, ``tools/mesh_serve.py``),
deepseek-v2-lite-16b (4 of 27 layers), mamba2-1.3b (8 of 48),
recurrentgemma-9b (5 of 38) and whisper-large-v3 (4 of 32 decoder and
encoder layers), so their float32 runs and the ranks' shards stay
within phase 17's time.

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
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.shapes import TRAIN_4K  # noqa: E402

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
PROMPTS = (64, 481)              # prompt lengths of the served requests
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
# phases 4-7 and 15: the training shape, TRAIN_4K's sequence
# (repro_torch/configs/shapes.py) at a batch of 4 (of its 256)
TRAIN_S, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = TRAIN_4K.seq_len, 4, 4, 4
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
# the bounds of train_path_vs_plain, by the reading each holds
TRAIN_BOUNDS = {"loss_abs_diff": LOSS_TOL, "grad_norm_rel_diff": GNORM_TOL,
                "leaf_rel_err_max": LEAF_TOL}
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
# whisper-large-v3 (phase 14): 20 heads over 20 of 64, the decoder's
# context of 448 tokens (max_target_positions of the published config: 28
# pages of 16) and 1500 encoder frames; a serve step launches the fused
# self attention and the flash cross attention once a decoder layer
WHISPER_HEADS = dict(h=20, kv=20, d=64)
WHISPER_MAX_SEQ = 448
WHISPER_PROMPTS = (64, 385)      # prompts of 64-384 tokens, + 32 new
WHISPER_FRAMES = 1500
CROSS_STEP = {"paged_attention_append_chunk": 1, "flash_attention": 1}
# phase 15: the other families' training at full width, bf16, phase 4's
# shape (4 steps of 4 microbatches of one sequence, AdamW, remat "full").
# Layer cuts where the float32 params, AdamW's two moments and the grad
# buffer (16 B a parameter), a microbatch's float32 grads (4 B more) and
# the loss over the vocabulary would not fit 80 GB: deepseek-v2-lite-16b
# on 4 of 27 layers (2.76 G parameters; all 27: 16.2 G), recurrentgemma-9b
# on 4 of 38 (one group of rec, rec, attn and one tail rec layer: 2.99 G,
# 2.10 G of them the embedding and the untied head; on 5 layers, 3.22 G,
# the step ran out of the card's 79.2 GiB in the backward).  internvl2-1b
# trains 256 patch embeddings + 4096 tokens a sequence, whisper-large-v3
# 1500 frames and its decoder context of 448 tokens (WHISPER_MAX_SEQ, the
# length phase 14 serves), both at full depth.
DS_TRAIN_LAYERS = 4
RG_TRAIN_LAYERS = 4
# each family's kernel path against its plain path: one microbatch's loss
# and grads at one seed, deepseek in float32 activations (bf16 routes that
# tie flip between the lanes; float32 also runs the 3xTF32 flash at
# D=192), the others in bf16.  Bounds from ``tools/train_gate.py`` at
# seeds 0-2 (H100 80GB HBM3, 700 W): the kernels' largest (loss gap,
# grad-norm gap, leaf error) against the smallest of two broken copies,
# whose forward or backward drops keys 128-255 (the loss gap of a broken
# backward is the kernels': its forward is right):
#   deepseek, float32: kernels <= (1.7e-5, 4.3e-5, 7.1e-4); broken
#     >= (1.2e-2 forward, 0.14, 0.29): phase 5's bounds
#   recurrentgemma, bf16: kernels <= (5.5e-5, 3.6e-5, 9.1e-3); broken
#     >= (2.8e-4 forward, 9.6e-3, 8.7e-2): phase 5's bounds (the loss gap
#     does not separate)
#   internvl2, bf16: kernels <= (5.4e-4, 5.6e-4, 1.3e-2); broken >=
#     (7.6e-3 forward, 2.4e-2, 0.73)
#   whisper, bf16: kernels <= (4.7e-4, 2.7e-4, 3.2e-2); broken >= (7.3e-5
#     forward: the loss gap does not separate, 0.21, 0.78)
FAMILY_BOUNDS = {
    "deepseek-v2-lite-16b": TRAIN_BOUNDS,
    "recurrentgemma-9b": TRAIN_BOUNDS,
    "internvl2-1b": {"loss_abs_diff": 2e-3, "grad_norm_rel_diff": 3e-3,
                     "leaf_rel_err_max": 5e-2},
    "whisper-large-v3": {"loss_abs_diff": 2e-3, "grad_norm_rel_diff": 1e-2,
                         "leaf_rel_err_max": 0.1},
}
# (arch, layers, tokens a sequence, seed of the check, float32 check)
PHASE15 = (("deepseek-v2-lite-16b", DS_TRAIN_LAYERS, TRAIN_S, 0, True),
           ("recurrentgemma-9b", RG_TRAIN_LAYERS, TRAIN_S, 1, False),
           ("internvl2-1b", None, TRAIN_S, 2, False),
           ("whisper-large-v3", None, WHISPER_MAX_SEQ, 0, False))
# phase 11 (a): qwen2-1.5b at full width on 2 of its 28 layers, a 3.92 GB
# state (three saves and three restores of the full 18.52 GB state took
# 462-598 s of the script's 1200 s; of the 10.66 GB state on 14 layers,
# 291-305 s, when phase 17 took the script to 1095-1183 s; the 7.29 GB
# state on 8 layers took phase 11 to 157.7-188.2 s, when phase 19's pod
# lanes took the script to 1051.3-1159.7 s as the host's speed varied,
# PERF.md §6)
PHASE11_LAYERS = 2
# phase 16: the compressed gradient reduction on qwen2-1.5b.  (a) one rank
# (NCCL) at full width and depth, phase 4's shape, 3 steps a codec from the
# same params; (b) two ranks on the one card over gloo (NCCL refuses two
# ranks on one device) at full width on 4 of 28 layers: ~0.42 G parameters,
# so ~1.7 GB of float32 grads a rank a step pass through the host, two
# ranks' state (~10 GB each with the residuals) fits beside each other,
# and the phase stays within its 120 s
POD_CODECS = ("none", "int8", "topk")
POD_STEPS = 3
POD_BUCKETS = 10                     # qwen2-1.5b at DEFAULT_BUCKET_ELEMS
POD_RANKS, POD_RANK_LAYERS, POD_RANK_STEPS = 2, 4, 2
POD_RANK_TIMEOUT = 300               # seconds for (b)'s two processes
# int8's losses against codec "none"'s at the same params and batches,
# the largest |loss_int8 - loss_none| over the 3 steps, read by
# ``python3 tools/codec_gate.py`` at seeds 0-2 (H100 80GB HBM3, 700 W):
# the codec 5.7e-4, 3.7e-4, 4.1e-3; a copy that drops the residual
# 6.2e-4, 3.2e-4, 3.9e-3 (three steps cannot show the lost feedback);
# a copy that truncates 1.5e-2, 2.5e-3, 1.0e-2.  The loss gap separates
# neither copy at every seed; ``CodecProbe``'s identities catch both at
# every seed (the new residual is not x - reduced; |reduced - x| reads
# 2.0 of scale / 2).  The bound sits 2x above the codec's largest reading
POD_LOSS_TOL = 8e-3
# phase 16's int8 bound, scale / 2 an element (over two ranks, the mean
# of the ranks' scale / 2), widened by float32's rounding of x / scale
# and q * scale (up to ~127 ulps of the block's largest |x|: ~3e-5 of
# scale / 2) and, over two ranks, of the two sums the mean takes
# (~3e-5 more); truncation reads up to 2, a mean never divided by the
# group's size ~254
INT8_ROUNDING_SLACK = 1e-4
# phase 17: the mesh serve step on qwen2-72b at full width (d_model 8192,
# 64 heads over 8 KV heads of 128, d_ff 29568, vocab 152064) on 4 of its
# 80 layers: 6.0 G parameters, 24.0 GB in float32 (the whole model: 72.7 G,
# 145.4 GB in bf16).  (a) unsharded in this process, float32 then bf16;
# (b) its shards on gloo ranks on the one card, mesh (1, 4) in both lanes
# and (2, 2) in float32: a rank holds 16 heads over 2 KV heads, a quarter
# of the FFN and of the vocabulary, and 1/data of the batch and pages.
# Phase 2's geometry (8 slots of MAX_SEQ tokens in pages of T), prompts
# of 16-64 tokens in chunks of T, then MESH_NEW greedy decode steps.
MESH_ARCH = "qwen2-72b"
MESH_LAYERS = 4
MESH_PROMPTS = (16, 65)
MESH_NEW = 16
MESH_LANES = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
MESH_RANKS = 4                       # one spawn of 4 ranks for every mesh
MESH_RANK_TIMEOUT = 600              # seconds for the ranks
# each rank's logits against (a)'s at every valid position of every step,
# the largest |difference| (logits up to ~10.3), read by ``python3
# tools/mesh_gate.py`` (H100 80GB HBM3, 700 W): the sharded step 3.8e-5 /
# 3.9e-5 in float32 at (1, 4) / (2, 2) and 0.13 in bf16 (two bf16 ulps
# at 8-16); a copy whose MLP all_reduce drops rank 1's partial sum 6.65 /
# 8.74 in float32 and 6.64 in bf16.  Each bound sits near the geometric
# middle of its lane's two readings
MESH_LOGIT_TOL = {torch.float32: 1e-2, torch.bfloat16: 1.0}
# the MoE family and replicated KV heads on the same geometry and ranks,
# MESH_NEW_MORE decode steps:
#   grok-1-314b at full width (d_model 6144, 48 heads over 8 KV heads of
#     128, softcap 30, 8 experts of 32768 top-2, vocab 131072): 2 of 64
#     layers born in bf16 (11.45 G parameters, 22.90 GB) and 1 layer in
#     float32 (6.53 G, 26.1 GB), each at (1, 4): a rank holds 12 heads
#     over 2 KV heads and 2 whole experts;
#   deepseek-v2-lite-16b at full width on 4 of 27 layers (2.76 G, 11.0 GB
#     in float32): (1, 4) in float32 and bf16, (2, 2) in float32 under
#     both variants, ``shard_map`` held to the unsharded step run on each
#     data shard's rows alone (its own capacity count): a rank holds 4
#     heads, the whole 576-wide latent pool, 16 experts and 704 of the
#     shared experts' 2816 FFN columns;
#   qwen2-1.5b at full width and depth born in bf16 at (1, 4): 3 heads a
#     rank over a copy of the one KV head they read.
# The bf16 MoE lanes run on their reference's routes (``pinned``).  The
# largest |logit difference| of every rank, read by ``python3
# tools/mesh_gate.py --phase17 --broken --broken-moe --broken-count``
# (H100 80GB HBM3, 700 W), against a copy whose MoE all_reduce drops rank
# 1's experts (MLP's, for qwen2-1.5b) and a ``gspmd`` copy that counts
# capacity shard-locally, read with deepseek's router column 0 x 16 (an
# expert overflows): grok float32 3.17e-5 / dropped experts 8.83, bf16
# 0.146 / 8.02 (unpinned: up to 4.29, its routes flipped); deepseek
# float32 1.01e-5-1.07e-5 (overflowing router 1.9e-5-4.03e-5) / dropped
# 3.67-5.03 / shard-local count at (2, 2) 3.24-3.32, bf16 0.078
# (overflowing 0.18) / 3.54; qwen2-1.5b bf16 0.094 / the MLP's dropped
# 3.14.  Each bound sits near the geometric middle of its lane's
# correct reading and its nearest broken one
MESH_NEW_MORE = 8                    # decode steps of the models below
GROK_TOL = {torch.float32: 1e-2, torch.bfloat16: 1.0}
DEEPSEEK_TOL = {torch.float32: 1e-2, torch.bfloat16: 0.5}
QWEN_MESH_TOL = {torch.bfloat16: 0.5}
# the other families (ROADMAP 7.4, 7.5), float32 at full width,
# MESH_NEW_MORE decode steps, each rank's logits and its final caches
# (SSM and RG-LRU state, pools, cross K/V) held to (a)'s: the largest
# |difference| of every rank's logits / final caches from (a)'s, read by
# ``python3 tools/mesh_gate.py --phase17 --broken --broken-state-out
# --broken-norm-gate --broken-cross`` (H100 80GB HBM3, 700 W), against
# copies that drop rank 1's out_proj partial, its gated norm's (Mamba2)
# or gates' (RG-LRU) partial, its cross attention's partial (whisper) or
# its MLP's (internvl2):
#   mamba2-1.3b 3.16e-5-1.05e-4 / 7.15e-5-4.46e-4; out_proj 5.80-6.47 /
#     27.6-46.1, norm 1.57-3.98 / 4.23-18.9;
#   recurrentgemma-9b 1.81e-5 / 3.93e-6-4.17e-6; out_proj 1.51 / 0.70-0.82,
#     gates 0.38 / 0.64-1.45;
#   whisper-large-v3 3.58e-6-8.34e-6 / 2.91e-6-4.20e-6; cross 1.32-1.75 /
#     1.23-2.02;
#   internvl2-1b 5.25e-6-5.48e-6 / 5.25e-6-5.78e-6; MLP 3.12-3.32 /
#     4.13-5.15.
# Each bound (logits, caches) sits near the geometric middle of its
# lane's correct reading and its nearest broken one
MAMBA_MESH_TOL = ({torch.float32: 1e-2}, {torch.float32: 4e-2})
RG_MESH_TOL = ({torch.float32: 3e-3}, {torch.float32: 2e-3})
WHISPER_MESH_TOL = ({torch.float32: 3e-3}, {torch.float32: 2e-3})
VLM_MESH_TOL = ({torch.float32: 4e-3}, {torch.float32: 5e-3})
MAMBA_MESH_LAYERS = 8
RG_MESH_LAYERS = 5                   # one (rec, rec, attn) group + the tail
WHISPER_MESH_LAYERS = 4              # decoder and encoder layers
# phase 1's repetitions a callable: event-timed calls (their median, the
# ``_call`` times) and traced calls (their device time summed, ``ms``).
# At 30 and 20 they took 43.6 and 42.9 s of the cases' 122.5 s (H100
# 80GB HBM3, 700 W; ``case_s`` and ``timing_s`` of each phase-1 line); most
# of the event timing is each shape's warm-up, which the count leaves
PHASE1_CALLS, PHASE1_TRACED = 10, 10
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
    trace (ts and dur in microseconds; a file a process, so ranks that
    profile at once do not share one)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"profile.{os.getpid()}.tmp.json"
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
    got = traced_call(fn, reps)
    return None if got is None else got[0]


def traced_call(fn, reps: int = 20):
    """``device_ms``'s two traces, and what else they show: (device ms per
    call, the kernel names of the traced single call, device ms per call
    by kernel over the ``reps`` calls), or None as ``device_ms``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    one = device_events(prof)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    if not one or len(ev) != reps * len(one):
        log(f"  cupti: {len(ev)} device events for {reps} calls of "
            f"{len(one)}")
        return None
    split = {}
    for e in ev:
        key = e["name"].replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0]
        split[key] = split.get(key, 0.0) + e["dur"] / reps / 1e3
    return (sum(e["dur"] for e in ev) / reps / 1e3,
            [e["name"] for e in one], split)


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


def timed_case(case):
    """A phase-1 case function whose result holds its host seconds
    (``case_s``), what phase 1's time is made of."""
    import functools

    @functools.wraps(case)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = case(*args, **kwargs)
        out["case_s"] = time.perf_counter() - t0
        return out
    return run


def traced_timings(**fns):
    """``timings`` (PHASE1_CALLS event-timed calls, PHASE1_TRACED traced
    ones), and for each callable the kernel names of its traced single
    call and its device ms by kernel (None and {} where its trace stayed
    off), so a case's kernel check and split take no trace of their
    own."""
    t, names, split = {}, {}, {}
    spent = {"events_s": 0.0, "cupti_s": 0.0}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        call = time_ms(fn, reps=PHASE1_CALLS)
        t1 = time.perf_counter()
        got = traced_call(fn, PHASE1_TRACED)
        if got is None:
            got = traced_call(fn, PHASE1_TRACED)
        spent["events_s"] += t1 - t0
        spent["cupti_s"] += time.perf_counter() - t1
        t[name] = call if got is None else got[0]
        t[name + "_call"] = call
        t[name + "_timing"] = "events" if got is None else "cupti"
        names[name] = None if got is None else got[1]
        split[name] = {} if got is None else got[2]
    t["timing_s"] = spent
    return t, names, split


def timings(**fns) -> dict:
    """For each named callable: device ms per call (CUPTI) as ``<name>``
    and the event-timed call as ``<name>_call``.  A trace whose event count
    is off is taken once more; if it stays off, ``<name>`` falls back to
    the event-timed call and ``<name>_timing`` says so."""
    return traced_timings(**fns)[0]


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


@timed_case
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


@timed_case
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
    t, names, _ = traced_timings(**fns)
    t = {"library_ms": None, **t}
    kernel = (PAGED_KERNELS[3] if d > 256 and dtype == torch.bfloat16
              else PAGED_KERNELS[0] if dtype == torch.bfloat16
              else PAGED_KERNELS[1])
    return {"case": name, "C": C, "dtype": str(dtype), "H": h, "KV": kv,
            "D": d, "T": ptok, "aliased_pools": alias, "splits": splits,
            "max_abs_err": err, "tolerance": {"atol": tol, "rtol": tol}, **t,
            "kernel": kernel if d <= 256 else check_ran(
                name, fns["ms"], (kernel,), names["ms"]),
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


@timed_case
def fused_case(rng, C: int, name: str, *, window=None, straddle=False,
               idle=False, dtype=torch.bfloat16, h=H, kv=KV, d=D,
               seq=MAX_SEQ, starts=None, library=False,
               softcap=None) -> dict:
    """The serve step's fused append and attention
    (``paged_attention_append_chunk``) against the unfused kernel path on
    the same inputs, ``kv_append_chunk`` on each pool and then
    ``paged_attention_chunk``: the outputs bitwise equal and the pools
    byte-equal off the null page 0; against the plain path (the two plain
    appends and the plain attention) to PAGED_TOL; timed beside the
    unfused path's sum and the plain path.  ``h``, ``kv``, ``d``: the
    heads and head dim; ``seq``: the table's tokens a slot; ``starts``:
    the chunks' start positions, drawn by ``starts(rng)``; ``library``:
    time SDPA's attention alone on the updated pools beside it (with no
    softcap: SDPA has none); ``softcap``: the logits' tanh cap."""
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
    kw = dict(window=window, softcap=softcap)

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
    t, names, _ = traced_timings(**fns)
    t = {"library_ms": None, **t}
    return {"case": name, "C": C, "dtype": str(dtype), "H": h, "KV": kv,
            "D": d, "table_pages": seq // T, "splits": splits,
            "bitwise_vs_unfused": bitwise, "pools_equal_off_page0":
            pools_equal, "max_abs_err": err,
            "tolerance": {"atol": tol, "rtol": tol},
            "kernel": check_ran(name, fns["ms"], PAGED_KERNELS[:1]
                                if dtype == torch.bfloat16
                                else PAGED_KERNELS[1:2], names["ms"]),
            **t, "ms_over_unfused": t["ms"] / t["unfused_ms"],
            **paged_bound(starts, C, window, seq // T, q.element_size(),
                          append=True, h=h, kv=kv, d=d)}


def visible_keys(Sq: int, Sk: int, causal: bool, window) -> int:
    """Keys the mask lets each query row see, summed over the rows."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def flash_inputs(rng, S, dtype, D=128, Sk=None, B=1, h=H, kv=KV, Dv=None):
    """q [B, S, h, D], k [B, Sk, kv, D] and v [B, Sk, kv, Dv] (D unless
    given)."""
    Sk = S if Sk is None else Sk
    return (randn(rng, B, S, h, D, dtype=dtype),
            randn(rng, B, Sk, kv, D, dtype=dtype),
            randn(rng, B, Sk, kv, D if Dv is None else Dv, dtype=dtype))


def v_pad_ms(q, pads, wide) -> dict:
    """Device time of the flash op's V pad: ``pads`` (V and the tensors of
    its width) zero-padded to q's head dim by ``pad_v``, and ``wide`` (the
    output or dV, q's width) sliced back to V's width."""
    from repro_torch.kernels.flash_attention.ops import pad_v
    Dv = pads[0].shape[-1]

    def pad():
        pad_v(q, *pads)
        return wide[..., :Dv].contiguous()
    return {"pad_" + k: x for k, x in timings(ms=pad).items()}


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


@timed_case
def flash_case(rng, name: str, S: int, *, causal=True, window=None,
               softcap=None, dtype=torch.bfloat16, D=128, Sk=None, B=1,
               h=H, kv=KV, Dv=None) -> dict:
    """``S`` query rows against ``Sk`` keys (S unless given), ``B``
    sequences of ``h`` heads over ``kv``; V ``Dv`` wide (D unless given).
    With ``Dv < D`` the op's output (V padded, the output sliced) is held
    to the plain version; ``ms`` times the kernel on the padded V and
    ``pad_ms`` the pad and the slice."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention_fwd
    from repro_torch.kernels.flash_attention.ops import pad_v

    q, k, v = flash_inputs(rng, S, dtype, D, Sk, B, h, kv, Dv)
    Sk, Dv = k.shape[1], v.shape[-1]
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = attention_fwd(q, k, v, **kw)
    ref, ref_lse = attention_fwd(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[dtype]
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    if not (out.shape == (B, S, h, Dv) and
            torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
            and lse_err <= LSE_ATOL and torch.isfinite(out).all()):
        raise AssertionError(f"{name}: kernel vs plain max |err| {err}, "
                             f"lse {lse_err}")
    (vp,) = pad_v(q, v)
    fns = dict(ms=lambda: attention_fwd(q, k, vp, **kw),
               plain_ms=lambda: attention_fwd(q, k, v, impl="ref", **kw))
    if softcap is None:
        # yardstick: SDPA on [B, H, S, D] views built outside the timed call
        (qt, kt, vt), skw = sdpa_args(q, k, v, causal, window)
        fns["library_ms"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **skw)
    t, names, _ = traced_timings(**fns)
    t = {"library_ms": None, **t}
    if Dv != D:
        t.update(v_pad_ms(q, (v,), q))
    ran = check_ran(name, fns["ms"], (FLASH_KERNELS[dtype],), names["ms"])
    flops = 2 * B * h * (D + Dv) * visible_keys(S, Sk, causal, window)
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size() + lse.numel() * 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
    lib = t["library_ms"]
    return {"case": name, "S": S, "Sk": Sk, "B": B, "H": h, "KV": kv,
            "D": D, "Dv": Dv, "dtype": str(dtype), "kernel": ran,
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "tolerance": {"atol": atol, "rtol": rtol, "lse_atol": LSE_ATOL},
            **t, "tflops": flops / t["ms"] / 1e9,
            "ms_over_library": None if lib is None else t["ms"] / lib,
            **bound(nbytes, flops, peak)}


@timed_case
def flash_bwd_case(rng, name: str, S: int, *, causal=True, window=None,
                   softcap=None, dtype=torch.bfloat16, D=128, Sk=None, B=1,
                   h=H, kv=KV, Dv=None) -> dict:
    """The backward kernel against the plain backward on the same forward
    residuals and upstream gradient; timed beside the plain backward and
    SDPA's backward, and forward + backward through autograd beside SDPA's
    forward + backward.  Shapes as ``flash_case``; with ``Dv < D``,
    ``ms`` times the kernel on V, out and dO padded to D and ``pad_ms``
    the pad and dV's slice."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention, attention_bwd, attention_fwd
    from repro_torch.kernels.flash_attention.ops import pad_v

    q, k, v = flash_inputs(rng, S, dtype, D, Sk, B, h, kv, Dv)
    Sk, Dv = k.shape[1], v.shape[-1]
    g = randn(rng, B, S, h, Dv, dtype=dtype)
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
    vp, outp, gp = pad_v(q, v, out, g)
    fns = dict(ms=lambda: attention_bwd(q, k, vp, outp, lse, gp, **kw),
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
    t, names, split = traced_timings(**fns)
    t = {"library_ms": None, "library_fwd_bwd_ms": None, **t}
    if Dv != D:
        t.update(v_pad_ms(q, (v, out, g), vp))
    ran = check_ran(name, fns["ms"], FLASH_BWD_KERNELS[dtype], names["ms"])
    # the products of the forward's size: S and dQ, dK (2 D a pair each),
    # dP and dV (2 Dv); each input (q, k, v, out, dO, lse) read once, each
    # grad written once
    flops = 2 * B * h * (3 * D + 2 * Dv) * visible_keys(S, Sk, causal,
                                                        window)
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * out.numel() + 2 * (k.numel() + v.numel())
              ) * esz + lse.numel() * 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
    lib = t["library_ms"]
    return {"case": name, "S": S, "Sk": Sk, "B": B, "H": h, "KV": kv,
            "D": D, "Dv": Dv, "dtype": str(dtype),
            "kernel": ran, "ms_by_kernel": split["ms"] or kernel_split(
                fns["ms"]),
            "max_abs_err": max(errs.values()), "grad_max_abs_err": errs,
            "grad_rel_err": rel,
            "tolerance": {"atol": f"{atol} x grad_max_abs", "rtol": rtol},
            **t, "tflops": flops / t["ms"] / 1e9,
            "ms_over_library": None if lib is None else t["ms"] / lib,
            **bound(nbytes, flops, peak)}


def train_flash_cases(rng, run=None) -> list:
    """Phase 15's flash shapes, forward and backward, each against its
    plain version: MLA's Q/K 192 wide beside V 128 (16 heads over 16,
    causal) at the training sequence in bf16 and at S=512 in float32;
    recurrentgemma's D=256 MQA under its 2048 window; internvl2's 256
    patches + 4096 tokens (14 heads over 2 of 64); whisper's encoder (S =
    1500) and cross attention (its 448 decoder tokens against 1500 frames),
    B=4, 20 heads over 20 of 64, non-causal.  ``run(case, rng, name, *a,
    **kw)`` calls each case (default: the call itself)."""
    run = run or (lambda case, *a, **kw: case(*a, **kw))
    mla = dict(h=16, kv=16, D=192, Dv=128)
    wh = dict(B=TRAIN_BATCH, h=20, kv=20, D=64, causal=False)
    vlm_s = TRAIN_S + 256
    cases = []
    for case, tag in ((flash_case, "flash"), (flash_bwd_case, "flash bwd")):
        cases += [
            run(case, rng, f"{tag} S={TRAIN_S} causal D=192 Dv=128 H=KV=16 "
                "(MLA)", TRAIN_S, **mla),
            run(case, rng, f"{tag} S=512 causal D=192 Dv=128 H=KV=16 "
                "float32 (MLA)", 512, dtype=torch.float32, **mla),
            run(case, rng, f"{tag} S={TRAIN_S} D=256 H=16 KV=1 window=2048 "
                "(recurrentgemma)", TRAIN_S, window=RG_WINDOW, h=16, kv=1,
                D=256),
            run(case, rng, f"{tag} S={vlm_s} D=64 H=14 KV=2 (internvl2)",
                vlm_s, h=14, kv=2, D=64),
            run(case, rng, f"{tag} S={WHISPER_FRAMES} B={TRAIN_BATCH} "
                "H=KV=20 D=64 non-causal (whisper encoder)", WHISPER_FRAMES,
                **wh),
            run(case, rng, f"{tag} Sq={WHISPER_MAX_SEQ} Sk={WHISPER_FRAMES} "
                f"B={TRAIN_BATCH} H=KV=20 D=64 non-causal (whisper cross)",
                WHISPER_MAX_SEQ, Sk=WHISPER_FRAMES, **wh)]
    return cases


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


def check_ran(name: str, fn, kernels, traced=None) -> str:
    """The kernels a traced call of ``fn`` ran must include ``kernels``: a
    time filed under them is never another's (a trace that lost every
    event shows nothing; one that lost some is taken again).  ``traced``:
    the kernel names of a call of ``fn`` that ``traced_timings`` already
    recorded, read first."""
    ran = traced or []
    if not all(any(k in n for n in ran) for k in kernels):
        ran = kernel_names(fn, kernels)
    missing = [k for k in kernels if not any(k in n for n in ran)]
    if ran and missing:
        raise AssertionError(f"{name}: no {missing} in {ran}")
    return " + ".join(kernels) if ran else "no events traced"


@timed_case
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
    t, names, _ = traced_timings(**fns)
    t = {"library_ms": None, **t}
    esz = args[0].element_size()
    return {"case": name, "Bp": Bp, "L": L, "H": H, "P": P, "N": N,
            "dtype": str(dtype),
            "kernel": check_ran(name, fns["ms"], SSD_FWD_KERNELS,
                                names["ms"]),
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


@timed_case
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
    t, names, _ = traced_timings(**fns)
    t = {"library_ms": None, **t}
    esz = args[0].element_size()
    return {"case": name, "Bp": Bp, "L": L, "H": H, "P": P, "N": N,
            "dtype": str(dtype),
            "kernel": check_ran(name, fns["ms"], SSD_BWD_KERNELS,
                                names["ms"]),
            "max_abs_err": max(errs.values()), "grad_max_abs_err": errs,
            "tolerance": {"float32": f"{SSD_GRAD_TOL} (atol x grad_max_abs"
                          ", rtol)", "bf16": str(SSD_TOL[torch.bfloat16])},
            **t, **bound(*ssd_work(Bp, L, H, P, N, esz, "bwd"))}


@timed_case
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
    t, names, _ = traced_timings(**fns)
    t = {"library_ms": None, **t}
    atol, rtol = SSD_GRAD_TOL
    return {"case": name, "Bp": Bp, "L": L, "H": H, "P": P, "N": N,
            "kernel": check_ran(name, fns["ms"],
                                SSD_FWD_KERNELS + SSD_BWD_KERNELS,
                                names["ms"]),
            "max_abs_err": max(errs.values()),
            "grad_max_abs_err": errs,
            "tolerance": {"atol": f"{atol} x grad_max_abs", "rtol": rtol},
            **t, **bound(*ssd_work(Bp, L, H, P, N, 4, "both"))}


# ---------------------------------------------------------------------------
# phase 2: the main path at full width
# ---------------------------------------------------------------------------


def attn_layers(cfg) -> int:
    """The attention layers of a serve step: an encoder-decoder's decoder
    layers (the encoder runs outside the step), else the pattern's."""
    if cfg.family == "encdec":
        return cfg.n_dec_layers
    return sum(k == "attn" for k in cfg.pattern_for_layers())


def serve_main_path(api, params, cfg, per_layer_step: dict, *,
                    max_seq=MAX_SEQ, chunk_tokens=None,
                    long_prompt=None, prompts=PROMPTS,
                    prepare=None) -> dict:
    """8 requests (prompts of ``prompts`` = [lo, hi) tokens, 64-480 unless
    given, 32 greedy tokens each) in a POSIX and a STRICT session through
    ``ServeClient(max_batch=8, page_tokens=16)``, and with ``long_prompt``
    one more POSIX request of that many tokens and LONG_NEW greedy ones,
    submitted first; ``prepare(engine)`` runs on the client's engine
    before any request (an encoder-decoder's cross K/V).  Gates,
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
    if prepare is not None:
        prepare(client.engine)
    posix = client.open_session(mode=Mode.POSIX)
    strict = client.open_session(mode=Mode.STRICT)
    every = []
    if long_prompt is not None:
        every.append((posix.submit(np.random.default_rng(5).integers(
            1, cfg.vocab, long_prompt).tolist(), LONG_NEW), LONG_NEW))
    rng = np.random.default_rng(0)
    for i, n in enumerate(rng.integers(*prompts, 8)):
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
                    chunk_tokens=None, prompts=PROMPTS,
                    prepare=None) -> dict:
    """Where a serve step's time goes: a CUPTI trace over two all-prefill
    steps and over four decode-only steps of 8 fresh requests, served as
    ``serve_main_path`` serves them (``max_seq``, ``chunk_tokens``,
    ``prompts``, ``prepare``)."""
    from repro_torch.serve import ServeClient

    client = ServeClient(api, params, max_batch=8, max_seq=max_seq,
                         page_tokens=T, chunk_tokens=chunk_tokens,
                         device="cuda")
    if prepare is not None:
        prepare(client.engine)
    sess = client.open_session()
    rng = np.random.default_rng(2)
    for n in rng.integers(*prompts, 8):
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


def cache_groups(caches) -> dict:
    """name -> (pools or state, stacked) of every part of a cache tree
    that a step writes: an LM's ``group/<key>`` (stacked over layers) and
    ``tail/<key>``, an encoder-decoder's ``pools`` (stacked)."""
    out = {f"{part}/{key}": (v, part == "group")
           for part in ("group", "tail")
           for key, v in caches.get(part, {}).items()}
    if "pools" in caches:
        out["pools"] = (caches["pools"], True)
    return out


def path_vs_plain(api, params, cfg, *, max_seq=MAX_SEQ, C=T,
                  lengths=None, cross=None) -> dict:
    """One mixed prefill + decode ``serve_step`` of the whole model at
    chunk width ``C`` (slots of C, 1 and 5 new tokens and an idle one),
    run twice from clones of the same caches: with the kernels and with
    ``impl="ref"`` (a MoE's routes pinned by ``RoutePin``).  The context
    before it: three kernel steps of 16 tokens or, given ``lengths``,
    random pools and recurrent state (N(0, 1) in each leaf's dtype) under
    those lengths; the table holds ``cfg.kv_pages_per_seq(max_seq)``
    pages a slot; ``cross``, an encoder-decoder's (cross_k, cross_v),
    is written into the caches first.  The logits, every pool off the
    null page and every recurrent state leaf are held to PATH_REL_TOL of
    their largest value; the cross K/V, which a step only reads, must
    come back equal."""
    rng = np.random.default_rng(1)
    caches = api.init_caches(B, max_seq, T, device="cuda")
    seq = cfg.kv_pages_per_seq(max_seq, T) * T
    caches["page_table"].copy_(page_table(rng, idle=(B - 1,), seq=seq))
    if cross is not None:
        caches["cross_k"].copy_(cross[0])
        caches["cross_v"].copy_(cross[1])
    if lengths is None:
        for _ in range(3):      # fill some context with the kernels
            n = torch.tensor([16, 16, 16, 9, 16, 16, 16, 0],
                             dtype=torch.int32, device="cuda")
            tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B, T))
                                   .astype(np.int32)).cuda()
            _, caches = api.serve_step(params, tok, caches, n)
    else:
        gen = torch.Generator(device="cuda").manual_seed(13)
        for v, _ in cache_groups(caches).values():
            for t in (v.values() if isinstance(v, dict) else v):
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
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
    refs = cache_groups(cr)
    for name, (v, stacked) in cache_groups(ck).items():
        ref = refs[name][0]
        if isinstance(v, dict):                 # recurrent state
            pairs = [(leaf, v[leaf], ref[leaf]) for leaf in v]
        else:                                   # pools, off the null page
            off = (slice(None), slice(1, None)) if stacked \
                else slice(1, None)
            pairs = [(f"pool{i}", x[off], y[off])
                     for i, (x, y) in enumerate(zip(v, ref))]
        for leaf, x, y in pairs:
            err = float((x.float() - y.float()).abs().max())
            top = float(y.float().abs().max())
            res["leaves"][f"{name}/{leaf}"] = {"max_abs_err": err,
                                               "max_abs": top}
            if err > PATH_REL_TOL * top:
                bad.append(f"{name}/{leaf}")
    for key in ("cross_k", "cross_v"):
        if key in ck and not torch.equal(ck[key], cr[key]):
            bad.append(key)
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
# phase 14: the encoder-decoder (whisper-large-v3) on the serve path
# ---------------------------------------------------------------------------

def encdec_serving(cfg) -> dict:
    """Phase 14: whisper-large-v3 at full width and depth (32 encoder and
    32 decoder layers) in bf16.  (a) 8 slots' random frames (numpy seed 3)
    encoded and their cross K/V computed (``encode`` +
    ``encdec_prefill_cross``, timed), written into the client's caches,
    and phase 2's 8 requests served at WHISPER_MAX_SEQ with prompts of
    WHISPER_PROMPTS tokens, every step launching the fused op and the
    flash forward once a decoder layer and nothing else; (b) phase 3's
    mixed step from those cross K/V, kernel path against plain path;
    (c) a prefill and a decode window profiled from the same cross
    K/V."""
    from repro_torch.models.encdec import encdec_prefill_cross, encode
    api, params, out = serving_weights(cfg)
    torch.cuda.reset_peak_memory_stats()
    frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)).cuda()

    def encode_cross():
        with torch.no_grad():
            return encdec_prefill_cross(params, cfg,
                                        encode(params, cfg, frames))

    encode_cross()                      # warm
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cross = encode_cross()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    assert all(torch.isfinite(x).all() for x in cross)
    out["encode_cross_ms"] = statistics.median(times)
    out["encode_cross_ms_all"] = times
    out["cross_bytes"] = sum(x.numel() * x.element_size() for x in cross)

    def prepare(eng):                   # the harness writes the cross K/V
        eng.caches["cross_k"].copy_(cross[0])
        eng.caches["cross_v"].copy_(cross[1])

    out["serve"] = serve_main_path(api, params, cfg, CROSS_STEP,
                                   max_seq=WHISPER_MAX_SEQ,
                                   prompts=WHISPER_PROMPTS, prepare=prepare)
    out["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["path_vs_plain"] = path_vs_plain(api, params, cfg,
                                         max_seq=WHISPER_MAX_SEQ,
                                         cross=cross)
    out["profile"] = profile_windows(
        api, params, cfg, {"paged_attention_append_chunk": PAGED_KERNELS,
                           "flash_attention": (
                               FLASH_KERNELS[torch.bfloat16],)},
        max_seq=WHISPER_MAX_SEQ, prompts=WHISPER_PROMPTS, prepare=prepare)
    del params, cross
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
    step, init_state, _ = make_train_step(api, opt, microbatches=microbatches)
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


def train_main_path(api, cfg, expected: dict, seq_len: int = TRAIN_S
                    ) -> dict:
    """``expected``: each kernel wrapper the step must launch, with its
    launches per step; ``seq_len`` tokens a sequence (a VLM's patches and
    an encoder-decoder's frames come beside them, from the pipeline)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import common
    from repro_torch.train import AdamWConfig, LoopConfig, run_training

    pipe = TokenPipeline(cfg, global_batch=TRAIN_BATCH, seq_len=seq_len,
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
    # loss is about ln(V) + sigma^2 / 2 (0.31 for qwen2, 0.41 for mamba2).
    # An untied head (deepseek, recurrentgemma) is ``lm_head`` [d_model, V]
    # drawn N(0, 0.02^2) too (its ParamSpec's scale=0.02): each logit is
    # again a sum of d_model unit-RMS inputs times N(0, 0.02^2) weights, so
    # sigma and the offset are the same formula (0.41 for deepseek, 0.82
    # for recurrentgemma); whisper's LayerNorm leaves zero-mean unit-
    # variance rows (0.26), internvl2's text logits as qwen2's (0.18)
    offset = 0.02 ** 2 * cfg.d_model / 2
    expect0 = math.log(cfg.vocab) + offset
    assert abs(res.losses[0] - expect0) < 0.5, (res.losses, expect0)
    for kernel, per_step in expected.items():
        assert launches[kernel] == per_step * TRAIN_STEPS, (kernel, launches)
    step_s = statistics.median(res.step_seconds[1:])
    tokens = TRAIN_BATCH * seq_len
    return {"losses": res.losses, "step_seconds": res.step_seconds,
            "step_s_median_2_4": step_s, "tokens_per_step": tokens,
            "tokens_per_s": tokens / step_s, "launches": launches,
            "launches_per_step": {k: launches[k] // TRAIN_STEPS
                                  for k in expected},
            "expected_per_step": expected,
            "first_loss_expected": expect0,
            "first_loss_offset_measured": res.losses[0] - math.log(cfg.vocab),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def train_batch(cfg, n: int, seed: int = 0, seq_len: int = TRAIN_S) -> dict:
    from repro_torch.data import TokenPipeline
    b = TokenPipeline(cfg, global_batch=n, seq_len=seq_len,
                      seed=seed).batch_at(0)
    return {k: torch.from_numpy(x).cuda() for k, x in b.items()}


def fresh_params(api, seed: int = 0):
    from repro_torch.models import init_params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return init_params(api.init_specs(), gen, device="cuda")


def train_profile(api, cfg, expected: dict, ops: dict,
                  seq_len: int = TRAIN_S) -> dict:
    """One warm train step, then a CUPTI window over the next, holding the
    step to ``expected`` launches (as train_main_path); ``ops`` maps each
    op to the names of its kernels in the trace, and each must show."""
    from repro_torch.kernels import common
    from repro_torch.train import AdamWConfig, make_train_step

    step, init_state, _ = make_train_step(
        api, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS),
        microbatches=TRAIN_MB)
    box = {"state": init_state(fresh_params(api))}
    batch = train_batch(cfg, TRAIN_BATCH, seq_len=seq_len)

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


def train_path_vs_plain(api, cfg, seed: int = 0,
                        bounds: dict = TRAIN_BOUNDS,
                        seq_len: int = TRAIN_S) -> dict:
    """Loss and grads of one microbatch through the kernel and through the
    plain version, from the parameters and batch of ``seed``;
    ``within_tolerance`` says whether every bound in ``bounds`` (reading
    -> its largest value) held."""
    from repro_torch.train import make_loss_and_grad
    from repro_torch.train.optimizer import leaves

    params = fresh_params(api, seed)
    batch = train_batch(cfg, 1, seed, seq_len)
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


# ---------------------------------------------------------------------------
# phase 15: the other families' training at full width
# ---------------------------------------------------------------------------


def train_launches(cfg, microbatches: int = TRAIN_MB) -> dict:
    """Flash launches a train step of ``microbatches``: under remat
    "full" a layer group's forward runs again in the backward, so an
    attention in a checkpointed group launches the forward twice and the
    backward once; a hybrid's tail runs outside the checkpoints (once).
    An encoder-decoder checkpoints every encoder and decoder layer: the
    encoder's self attention, the decoder's self and cross attentions.
    Mamba2's SSD op likewise: ``ssd_chunk`` twice and ``ssd_chunk_bwd``
    once a layer."""
    if cfg.family == "encdec":
        n = cfg.n_enc_layers + 2 * cfg.n_dec_layers
        return {"flash_attention": 2 * n * microbatches,
                "flash_attention_bwd": n * microbatches}
    if cfg.family == "ssm":
        return {"ssd_chunk": 2 * cfg.n_layers * microbatches,
                "ssd_chunk_bwd": cfg.n_layers * microbatches}
    kinds = cfg.pattern_for_layers()
    pattern = cfg.block_pattern or ("attn",)
    n_group = (cfg.n_layers // len(pattern)) * len(pattern)
    grouped = sum(k == "attn" for k in kinds[:n_group])
    tail = sum(k == "attn" for k in kinds[n_group:])
    return {"flash_attention": (2 * grouped + tail) * microbatches,
            "flash_attention_bwd": (grouped + tail) * microbatches}


def rglru_scan_peak(cfg, seq_len: int = TRAIN_S) -> dict:
    """Device memory of one RG-LRU layer's ``rglru_train`` (its doubling
    scan keeps log2 S float32 [B, S, L] pairs for the backward) at one
    ``seq_len``-token sequence, bf16 activations: what the forward keeps
    for the backward, and the peaks of the forward and of the backward,
    each above the memory held before it."""
    from repro_torch.models import init_params
    from repro_torch.models.ssm import rglru_init, rglru_train
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(rglru_init(cfg), gen, device="cuda")
    x = torch.randn(1, seq_len, cfg.d_model, device="cuda",
                    generator=gen).to(cfg.dtype).requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = rglru_train(p, cfg, x)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - base
    fwd_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - base
    L = cfg.lru_width or cfg.d_model
    return {"seq_len": seq_len, "lru_width": L,
            "scan_rounds": math.ceil(math.log2(seq_len)),
            "float32_BSL_gb": seq_len * L * 4 / 2**30,
            "kept_for_backward_gb": kept / 2**30,
            "forward_peak_gb": fwd_peak / 2**30,
            "backward_peak_gb": bwd_peak / 2**30}


def family_training(arch: str, layers, seq_len: int, seed: int,
                    bounds: dict, float32_check: bool) -> dict:
    """Phase 4's four AdamW steps (phase 4's gates: finite losses, the
    first near ln V + sigma^2 / 2, exact flash launches a step), a
    profiled step whose flash kernels must show in the trace by name,
    and phase 5's kernel path against the plain path at ``seed``, in
    float32 activations with ``float32_check``, held to ``bounds``;
    ``layers`` cuts the depth (None: all)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = build_model(cfg)
    expected = train_launches(cfg)
    out = {"arch": arch, "layers": cfg.n_layers,
           "published_layers": get_config(arch).n_layers,
           "seq_len": seq_len, "batch": TRAIN_BATCH,
           "microbatches": TRAIN_MB, "remat": cfg.remat}
    out["train"] = train_main_path(api, cfg, expected, seq_len)
    if cfg.family == "vlm":
        out["train"]["positions_per_step"] = TRAIN_BATCH * (
            seq_len + cfg.n_patch_tokens)
    if cfg.family == "encdec":
        out["train"]["frames_per_step"] = TRAIN_BATCH * cfg.enc_frames
    release()
    out["profile"] = train_profile(
        api, cfg, expected,
        {"flash_attention": tuple(FLASH_KERNELS.values()),
         "flash_attention_bwd": FLASH_BWD_KERNELS[torch.bfloat16]},
        seq_len)
    release()
    if cfg.family == "hybrid":
        out["rglru_scan"] = rglru_scan_peak(cfg, seq_len)
        release()
    check_cfg = dataclasses.replace(cfg, dtype=torch.float32) \
        if float32_check else cfg
    out["path_vs_plain"] = train_path_vs_plain(
        build_model(check_cfg), check_cfg, seed, bounds, seq_len)
    release()
    out["seconds"] = time.perf_counter() - t0
    return out


def phase15(card: str) -> dict:
    """Every family of PHASE15 through ``family_training``, each logged
    (its gated check failing the phase)."""
    out = {}
    for arch, layers, seq_len, seed, f32 in PHASE15:
        res = family_training(arch, layers, seq_len, seed,
                              FAMILY_BOUNDS[arch], f32)
        log(f"phase15 {arch}", json.dumps(
            {"card": card, **{k: v for k, v in res.items()
                              if k != "path_vs_plain"}}))
        check_train_path(f"phase15 {arch} kernel vs plain",
                         res["path_vs_plain"])
        out[arch] = res
    return out


# ---------------------------------------------------------------------------
# phase 16: the compressed gradient reduction across ranks
# ---------------------------------------------------------------------------


class CodecProbe:
    """Wraps the train step's reduction (``compression.
    bucketed_compressed_psum``, or ``train.step.exact_mean`` for codec
    "none") and its AdamW update while it is entered.  CUDA events time
    each reduction; then, outside the timed region, every bucket of a
    compressed call is held to the plain float32 mean over the group of
    each rank's ``x = flat + err`` (all-reduced beside the codec's own
    reduction): top-k exactly, ``reduced == mean(x - new_err)`` with
    ``x - new_err`` this rank's kept entries (each ``x`` or zero, no
    dropped entry above a kept one, the residual the dropped ones); int8
    within the group's mean of ``scale / 2`` (the rounding bound,
    ``scale`` of ``x``'s block), and on one rank ``new_err == x -
    reduced`` bitwise with ``|reduced + new_err - x|`` within ``scale /
    2``.  Over more than one rank, the parameters are compared bitwise
    with rank 0's after each AdamW update.  ``readings`` keeps the largest of each reading, ``ms`` the
    reductions' times, ``check_s`` the host seconds the checks took,
    ``residuals`` the last residual rows."""

    def __init__(self):
        from repro_torch.dist import compression
        import repro_torch.train.step as train_step
        self.compression, self.train_step = compression, train_step
        self.ms, self.check_s = [], []
        self.readings = Counter()
        self.failures = []
        self.residuals = []
        self.params_equal = []
        self.group = None

    def __enter__(self):
        self.real = (self.compression.bucketed_compressed_psum,
                     self.train_step.exact_mean,
                     self.train_step.adamw_update)
        self.compression.bucketed_compressed_psum = self.psum
        self.train_step.exact_mean = self.mean
        self.train_step.adamw_update = self.update
        return self

    def __exit__(self, *exc):
        (self.compression.bucketed_compressed_psum,
         self.train_step.exact_mean,
         self.train_step.adamw_update) = self.real

    def timed(self, fn, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        end.synchronize()
        self.ms.append(start.elapsed_time(end))
        return out

    def mean(self, grads, group):
        self.group = group
        out = self.timed(self.real[1], grads, group)
        self.check_s.append(0.0)
        return out

    def psum(self, tree, residuals, group, *, plan, codec, topk_frac):
        self.group = group
        out, new = self.timed(self.real[0], tree, residuals, group,
                              plan=plan, codec=codec, topk_frac=topk_frac)
        t0 = time.perf_counter()
        self.check(tree, residuals, out, new, plan, codec, group)
        self.residuals = new
        self.check_s.append(time.perf_counter() - t0)
        return out, new

    def update(self, cfg, params, grads, state):
        import torch.distributed as dist
        from repro_torch.tree import leaves
        out = self.real[2](cfg, params, grads, state)
        if dist.get_world_size(self.group) == 1:
            return out
        t0 = time.perf_counter()
        same = torch.ones((), device="cuda")
        for p in leaves(out[0]):
            p0 = p.clone()
            dist.broadcast(p0, group=self.group, group_src=0)
            same *= torch.equal(p0.view(torch.int32), p.view(torch.int32))
            del p0
        dist.all_reduce(same, op=dist.ReduceOp.MIN, group=self.group)
        self.params_equal.append(bool(same.item()))
        self.check_s[-1] += time.perf_counter() - t0
        return out

    def read(self, key: str, value: float) -> None:
        self.readings[key] = max(self.readings[key], value)

    @staticmethod
    def group_mean(x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x / dist.get_world_size(group)

    def check(self, tree, residuals, out, new, plan, codec, group) -> None:
        import torch.distributed as dist
        from repro_torch.tree import leaves
        c = self.compression
        one = dist.get_world_size(group) == 1
        grads, reduced = leaves(tree), leaves(out)
        for b in range(plan.num_buckets):
            x = c.bucket_flat(grads, plan, b) + residuals[b]
            red = c.bucket_flat(reduced, plan, b)
            e = new[b]
            if codec == "topk":
                sent = x - e
                kept = sent != 0
                if not (torch.equal(sent[kept], x[kept])
                        and torch.equal(e[~kept], x[~kept])):
                    self.failures.append((b, "top-k's residual is not "
                                          "the dropped entries"))
                if not torch.equal(red, self.group_mean(sent, group)):
                    self.failures.append((b, "top-k's mean is not the "
                                          "kept entries' mean"))
                ax = x.abs()
                lo = ax[kept].min() if kept.any() else x.new_zeros(())
                hi = ax[~kept].max() if (~kept).any() else x.new_zeros(())
                if hi > lo:
                    self.failures.append((b, "a dropped entry tops a kept"))
                self.read("kept_share", float(kept.float().mean()))
                continue
            half = torch.clamp_min(
                x.reshape(-1, c.BLOCK).abs().amax(1, keepdim=True) / 127.0,
                torch.finfo(torch.float32).tiny) / 2
            # float32 rounding of x / scale and of q * scale adds up to
            # ~127 ulps of the block's largest |x|, 3e-5 of scale / 2
            bound = self.group_mean(half, group).expand(
                -1, c.BLOCK).reshape(-1)
            err_r = float(((red - self.group_mean(x, group)).abs()
                           / bound).max())
            self.read("codec_err_over_half_scale", err_r)
            if one:
                if not torch.equal(e, x - red):
                    self.failures.append((b, "new_err != x - reduced"))
                tel_r = float(((red + e - x).abs() / bound).max())
                self.read("telescope_over_half_scale", tel_r)
                err_r = max(err_r, tel_r)
            if err_r > 1 + INT8_ROUNDING_SLACK:
                self.failures.append((b, "outside the int8 rounding bound"))


def pod_plan_summary(plan) -> dict:
    """The bucket plan and what its residuals and wire hold."""
    from repro_torch.dist.compression import BLOCK
    n, padded = sum(plan.sizes), sum(plan.padded_sizes)
    wire = padded + 4 * (padded // BLOCK)
    return {"buckets": plan.num_buckets, "leaves": sum(map(len,
                                                          plan.groups)),
            "elements": n, "largest_bucket": max(plan.sizes),
            "residual_gb": 4 * padded / 1e9,
            "int8_wire_bytes": wire, "float32_wire_bytes": 4 * n,
            "int8_over_float32": wire / (4 * n)}


def pod_one_rank(cfg, seed: int = 0, codecs=POD_CODECS,
                 steps: int = POD_STEPS, expected=None) -> dict:
    """Phase 16 (a): ``run_training`` over a one-rank NCCL group (a
    FileStore in a temporary directory) for ``steps`` steps of each codec,
    params and batches from ``seed``, through a ``CodecProbe``; each run's
    flash launches a step are read for ``expected``."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import common
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, LoopConfig, run_training
    from repro_torch.train.step import grad_bucket_plan

    api = build_model(cfg)
    out = {"plan": pod_plan_summary(grad_bucket_plan(api)), "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            for codec in codecs:
                pipe = TokenPipeline(cfg, global_batch=TRAIN_BATCH,
                                     seq_len=TRAIN_S, seed=seed)
                release()
                torch.cuda.reset_peak_memory_stats()
                common.reset_launch_counts()
                with CodecProbe() as probe:
                    res = run_training(
                        api, pipe, LoopConfig(steps=steps,
                                              microbatches=TRAIN_MB,
                                              seed=seed, codec=codec),
                        AdamWConfig(lr=3e-4, warmup_steps=2,
                                    total_steps=TRAIN_STEPS),
                        device="cuda", pod_group=dist.group.WORLD)
                launches = dict(common.LAUNCHES)
                step_ms = [1e3 * (a - b) for a, b in
                           zip(res.step_seconds, probe.check_s)]
                out["runs"][codec] = {
                    "losses": res.losses, "codec_ms": probe.ms,
                    "step_ms_without_checks": step_ms,
                    "check_s": probe.check_s,
                    "codec_share": [m / t for m, t in zip(probe.ms,
                                                          step_ms)],
                    "readings": dict(probe.readings),
                    "failures": probe.failures,
                    "params_equal": probe.params_equal,
                    "residual_nonzero": any(bool(e.any())
                                            for e in probe.residuals),
                    "launches": launches,
                    "launches_per_step": {
                        k: launches.get(k, 0) / steps
                        for k in (expected or {})},
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
                del res, probe
        finally:
            dist.destroy_process_group()
    release()
    none = out["runs"].get("none")
    for codec, run in out["runs"].items():
        if none is not None and codec != "none":
            run["loss_gap_vs_none"] = max(
                abs(a - b) for a, b in zip(run["losses"], none["losses"]))
    return out


def check_pod_one_rank(res: dict, expected: dict) -> None:
    """Phase 16 (a)'s gates."""
    plan = res["plan"]
    assert plan["buckets"] == POD_BUCKETS, plan
    for codec, run in res["runs"].items():
        assert all(map(math.isfinite, run["losses"])), (codec, run)
        assert run["launches_per_step"] == expected, (codec, run)
        assert not run["failures"], (codec, run["failures"])
        if codec != "none":
            assert run["residual_nonzero"], codec
    assert res["runs"]["int8"]["loss_gap_vs_none"] <= POD_LOSS_TOL, res


def pod_rank(rank: int, world: int, store_path: str, out_path: str,
             layers: int, steps: int) -> None:
    """Phase 16 (b), one rank: a gloo group over ``store_path`` on the one
    card, ``run_training(pod_group=...)`` on qwen2-1.5b at full width on
    ``layers`` layers, ``steps`` steps of codecs none and int8 from the
    same params (seed 0), this rank's rows of phase 4's global batch of
    four in microbatches of one, through a ``CodecProbe`` (each bucket
    held to the plain mean of both ranks' ``x``, both ranks' params
    compared bitwise after every step); after int8 each rank's residual
    rows, per bucket (sum, sum of squares in float64), gathered to
    compare."""
    import datetime
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import common
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, LoopConfig, run_training

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    group = dist.group.WORLD
    out = {"rank": rank}
    # gloo's all_reduce and broadcast on the card's tensors, first
    probe = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(probe, group=group)
    dist.broadcast(probe, src=0, group=group)
    out["gloo_all_reduce_broadcast"] = \
        probe.tolist() == [world * (world + 1) / 2] * 4
    assert out["gloo_all_reduce_broadcast"], probe
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=layers)
    api = build_model(cfg)
    out["runs"] = {}
    for codec in ("none", "int8"):
        pipe = TokenPipeline(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_S,
                             seed=0)
        common.reset_launch_counts()
        with CodecProbe() as probe:
            res = run_training(
                api, pipe, LoopConfig(steps=steps,
                                      microbatches=TRAIN_MB // world,
                                      seed=0, codec=codec),
                AdamWConfig(lr=3e-4, warmup_steps=2,
                            total_steps=TRAIN_STEPS),
                device="cuda", pod_group=group)
        run = {"losses": res.losses, "step_s": res.step_seconds,
               "check_s": probe.check_s, "codec_ms": probe.ms,
               "params_equal": probe.params_equal,
               "readings": dict(probe.readings),
               "failures": probe.failures,
               "launches": dict(common.LAUNCHES)}
        if probe.residuals:
            nb = len(probe.residuals)
            stats = torch.zeros((world, nb, 2), dtype=torch.float64,
                                device="cuda")
            for b, e in enumerate(probe.residuals):
                stats[rank, b, 0] = e.double().sum()
                stats[rank, b, 1] = e.double().square().sum()
            dist.all_reduce(stats, group=group)
            run["residual_rows_differ"] = not torch.equal(stats[0],
                                                          stats[1])
            run["residual_nonzero"] = bool(stats.abs().sum() > 0)
        out["runs"][codec] = run
        del res, probe
        release()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))


def pod_two_ranks(layers: int = POD_RANK_LAYERS,
                  steps: int = POD_RANK_STEPS, entry=None) -> dict:
    """Phase 16 (b): ``pod_rank`` in two processes spawned with
    ``torch.multiprocessing``, each within ``POD_RANK_TIMEOUT``; both are
    killed at the deadline.  ``entry`` (``tools/codec_gate.py``'s broken
    copies) takes ``_pod_rank_entry``'s place."""
    import tempfile
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            entry or _pod_rank_entry, args=(POD_RANKS, tmp, layers, steps),
            nprocs=POD_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + POD_RANK_TIMEOUT
        try:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"phase 16 (b): the ranks ran past "
                                       f"{POD_RANK_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(POD_RANKS)]
    return {"ranks": ranks, "layers": layers, "steps": steps,
            "seconds": time.perf_counter() - t0}


def _pod_rank_entry(rank, world, tmp, layers, steps):
    pod_rank(rank, world, os.path.join(tmp, "store"),
             os.path.join(tmp, f"rank{rank}.json"), layers, steps)


def check_pod_two_ranks(res: dict, expected: dict) -> None:
    """Phase 16 (b)'s gates: the ranks' params bitwise equal after every
    step, every bucket's reduction within the bound of the plain mean of
    both ranks' values, their residual rows differ, the same losses on
    both ranks, and int8's losses within (a)'s bound of none's."""
    r0, r1 = res["ranks"]
    for codec in ("none", "int8"):
        a, b = r0["runs"][codec], r1["runs"][codec]
        for r in (a, b):
            assert r["params_equal"] == [True] * res["steps"], res
            assert not r["failures"], (codec, r["failures"])
        assert a["losses"] == b["losses"], res
        assert all(map(math.isfinite, a["losses"])), res
        for r in (a, b):
            for k, n in expected.items():
                assert r["launches"].get(k, 0) == n * res["steps"], (k, r)
    for r in (r0, r1):
        assert r["runs"]["int8"]["residual_rows_differ"], res
        assert r["runs"]["int8"]["residual_nonzero"], res
    gap = max(abs(x - y) for x, y in zip(r0["runs"]["int8"]["losses"],
                                         r0["runs"]["none"]["losses"]))
    res["int8_loss_gap_vs_none"] = gap
    assert gap <= POD_LOSS_TOL, res


def phase16(card: str) -> dict:
    """Phase 16 (a) and (b), each logged, then gated."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b")
    flash_step = {"flash_attention": 2 * cfg.n_layers * TRAIN_MB,
                  "flash_attention_bwd": cfg.n_layers * TRAIN_MB}
    t0 = time.perf_counter()
    one = pod_one_rank(cfg, expected=flash_step)
    one["seconds"] = time.perf_counter() - t0
    log("phase16 (a)", json.dumps({"card": card, **one}))
    # each rank runs TRAIN_MB / POD_RANKS microbatches of its layers
    rank_step = {k: v // cfg.n_layers * POD_RANK_LAYERS // POD_RANKS
                 for k, v in flash_step.items()}
    two = pod_two_ranks()
    log("phase16 (b)", json.dumps({"card": card, **two}))
    check_pod_one_rank(one, flash_step)
    check_pod_two_ranks(two, rank_step)
    return {"one_rank": one, "two_ranks": two}


# ---------------------------------------------------------------------------
# phase 17: the mesh serve step (serve/step.py) over a ("data", "model")
# mesh of gloo ranks on the one card
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshModel:
    """One model of phase 17: ``arch`` at full width on ``layers`` of its
    layers (None: all), its weights drawn from seed 0 in float32 (a bf16
    lane casts them) or born in ``born``; ``runs``: (mesh shape, lane,
    variant) in the order the ranks run them (a shape's float32 lanes
    first); ``tol``: each lane dtype's logit bound; ``cache_tol`` (None:
    not held): each lane dtype's bound of every rank's final caches
    against (a)'s; ``new``: the greedy decode steps after the prompts;
    ``chunk``: the prefill chunk; ``max_seq``: a slot's tokens.  An
    encoder-decoder's ``layers`` cut its decoder and its encoder
    alike."""
    key: str
    arch: str
    layers: Optional[int]
    born: Optional[torch.dtype]
    runs: tuple
    tol: dict
    new: int = MESH_NEW
    chunk: int = T
    max_seq: int = MAX_SEQ
    cache_tol: Optional[dict] = None

    def config(self):
        from repro_torch.configs import get_config
        cfg = get_config(self.arch)
        if self.layers is None:
            return cfg
        if cfg.family == "encdec":
            return dataclasses.replace(cfg, n_layers=self.layers,
                                       n_enc_layers=self.layers,
                                       n_dec_layers=self.layers)
        return dataclasses.replace(cfg, n_layers=self.layers)

    def shapes(self) -> list:
        return list(dict.fromkeys(shape for shape, _, _ in self.runs))

    def refs(self) -> list:
        """(lane, parts) of every unsharded run the lanes are held to:
        the whole batch, or (``shard_map`` at data > 1) each data
        shard's rows alone."""
        return list(dict.fromkeys(
            (lane, shape[0] if variant == "shard_map" else 1)
            for shape, lane, variant in self.runs))


MESH_MODELS = (
    MeshModel("qwen2-72b", MESH_ARCH, MESH_LAYERS, None,
              (((1, 4), "float32", "gspmd"), ((1, 4), "bfloat16", "gspmd"),
               ((2, 2), "float32", "gspmd")), MESH_LOGIT_TOL),
    MeshModel("grok-1-314b bf16", "grok-1-314b", 2, torch.bfloat16,
              (((1, 4), "bfloat16", "gspmd"),), GROK_TOL, MESH_NEW_MORE),
    MeshModel("grok-1-314b float32", "grok-1-314b", 1, None,
              (((1, 4), "float32", "gspmd"),), GROK_TOL, MESH_NEW_MORE),
    MeshModel("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", 4, None,
              (((1, 4), "float32", "gspmd"), ((1, 4), "bfloat16", "gspmd"),
               ((2, 2), "float32", "gspmd"),
               ((2, 2), "float32", "shard_map")), DEEPSEEK_TOL,
              MESH_NEW_MORE),
    MeshModel("qwen2-1.5b", "qwen2-1.5b", None, torch.bfloat16,
              (((1, 4), "bfloat16", "gspmd"),), QWEN_MESH_TOL,
              MESH_NEW_MORE),
    MeshModel("mamba2-1.3b", "mamba2-1.3b", MAMBA_MESH_LAYERS, None,
              (((1, 4), "float32", "gspmd"), ((1, 4), "float32", "shard_map"),
               ((2, 2), "float32", "gspmd"),
               ((2, 2), "float32", "shard_map")), MAMBA_MESH_TOL[0],
              MESH_NEW_MORE, cache_tol=MAMBA_MESH_TOL[1]),
    MeshModel("recurrentgemma-9b", "recurrentgemma-9b", RG_MESH_LAYERS, None,
              (((1, 4), "float32", "gspmd"),), RG_MESH_TOL[0],
              MESH_NEW_MORE, chunk=RG_CHUNK, cache_tol=RG_MESH_TOL[1]),
    MeshModel("whisper-large-v3", "whisper-large-v3", WHISPER_MESH_LAYERS,
              None, (((1, 4), "float32", "gspmd"),
                     ((2, 2), "float32", "gspmd")), WHISPER_MESH_TOL[0],
              MESH_NEW_MORE, max_seq=WHISPER_MAX_SEQ,
              cache_tol=WHISPER_MESH_TOL[1]),
    MeshModel("internvl2-1b", "internvl2-1b", None, None,
              (((2, 2), "float32", "gspmd"),), VLM_MESH_TOL[0],
              MESH_NEW_MORE, cache_tol=VLM_MESH_TOL[1]),
)


def lane_key(lane: str, variant: str) -> str:
    """A run's key in a rank's results: the lane, and its variant where
    it is not ``gspmd``."""
    return lane if variant == "gspmd" else f"{lane} {variant}"


def mesh_prompts(vocab: int, span=MESH_PROMPTS) -> tuple:
    """Phase 17's 8 prompts (lengths drawn from ``span``, seed 17),
    zero-padded to their longest: (tokens [B, longest], lengths)."""
    rng = np.random.default_rng(17)
    lengths = rng.integers(*span, B)
    tokens = rng.integers(1, vocab, (B, int(lengths.max())))
    for b, n in enumerate(lengths):
        tokens[b, n:] = 0
    return tokens.astype(np.int32), lengths.astype(np.int32)


def mesh_drive(step, params, caches, prompts, lengths, *,
               rows=slice(None), forced=None, new=MESH_NEW,
               chunk=T) -> list:
    """Phase 17's requests through ``step``: the prompts in chunks of
    ``chunk`` (a slot whose prompt is done takes n_new 0), then ``new``
    greedy decode steps.  ``rows``: this rank's batch rows.  ``forced``: the
    records of another run, whose tokens are fed (teacher forcing).  Each
    record: the tokens and n_new fed (every row of ``prompts``), the
    step's logits (this rank's rows, float32 on the card) and its host ms
    (synchronized)."""
    batch, longest = prompts.shape
    chunks = -(-longest // chunk)
    records = []
    nxt = np.zeros(batch, np.int64)
    for s in range(chunks + new):
        if forced is not None:
            tok, n_new = forced[s]["tokens"], forced[s]["n_new"]
        elif s < chunks:
            tok = np.zeros((batch, chunk), np.int32)
            part = prompts[:, s * chunk:(s + 1) * chunk]
            tok[:, :part.shape[1]] = part
            n_new = np.clip(lengths - s * chunk, 0, chunk).astype(np.int32)
        else:
            tok = nxt.astype(np.int32)[:, None]
            n_new = np.ones(batch, np.int32)
        t0 = time.perf_counter()
        rows_tok = torch.from_numpy(np.ascontiguousarray(tok[rows]))
        logits, caches = step(params, rows_tok.cuda(), caches,
                              torch.from_numpy(n_new[rows]).cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        logits = logits.float()
        records.append({"tokens": tok, "n_new": n_new, "logits": logits,
                        "ms": ms})
        if forced is None:
            # each slot's next token: the argmax at its last valid position
            last = torch.from_numpy(np.maximum(n_new - 1, 0)).long().cuda()
            pick = logits[torch.arange(batch, device="cuda"), last]
            pick = pick.argmax(-1).cpu().numpy()
            done = (s >= chunks) | (np.minimum(lengths, (s + 1) * chunk)
                                    == lengths) & (n_new > 0)
            nxt = np.where(done, pick, nxt)
    return records


def leaf_sum(x: torch.Tensor) -> float:
    """A leaf's fingerprint: its sum accumulated in float32, with no copy
    (the same reduction of the same values on the same card gives the
    same bits)."""
    return float(x.sum(dtype=torch.float32))


def merged_caches(parts: list):
    """One cache tree from the final caches of runs over consecutive row
    blocks (a data shard's rows each): each leaf's parts concatenated on
    the dim a data split cuts (a pool's pages, a state's or the cross
    K/V's rows: the dim after a stacked leaf's layer dim), so that a
    rank's ``shard_params`` block of it is what the rank's run should
    hold.  The page table stays part 0's (page ids local to a part)."""
    from repro_torch.tree import map_with_path

    def one(path, *xs):
        name = "/".join(map(str, path))
        if len(xs) == 1 or name == "page_table":
            return xs[0]
        return torch.cat(xs, dim=1 if name.startswith(
            ("group", "pools", "cross")) else 0)

    return map_with_path(one, *parts)


def caches_compare(caches, ref, cspecs, mesh) -> dict:
    """This rank's final caches against its block of (a)'s
    (``merged_caches``): the largest |difference| of each leaf but the
    page table (a layout, not a result), and of all of them."""
    from repro_torch.dist.sharding import shard_params
    from repro_torch.tree import map_with_path

    want = shard_params(ref, cspecs, mesh)
    errs = {}

    def one(path, got, w):
        name = "/".join(map(str, path))
        if name == "page_table":
            return
        assert tuple(got.shape) == tuple(w.shape), (name, got.shape, w.shape)
        errs[name] = float((got.float().cpu() - w.float()).abs().max()) \
            if got.numel() else 0.0

    map_with_path(one, caches, want)
    return {"cache_max_abs_err": max(errs.values()),
            "cache_max_abs_err_by_leaf": errs}


def mesh_reference(tmp: str, model: MeshModel) -> dict:
    """Phase 17 (a) for one model: the unsharded run in this process.  Its
    weights (seed 0, as ``init_params`` draws them, in float32 or born in
    ``model.born``), each leaf's sum saved for the ranks, whose own draws
    must equal it; then each of ``model.refs()``: a lane (the float32
    weights cast for a bf16 one) over the whole batch, or over each data
    shard's rows alone, its records saved for the ranks (tokens, n_new,
    logits on the host; the parts' rows side by side) and, where
    ``model.cache_tol`` holds them, its final caches (``merged_caches``).
    An encoder-decoder's frames (numpy seed 3) are encoded once a lane
    (``encode``, saved for the ranks, which compute their own heads'
    cross K/V from it) and each part's cross K/V written into its
    caches."""
    from repro_torch.convert import cast_params
    from repro_torch.kernels import common
    from repro_torch.models import build_model, init_params
    from repro_torch.models.encdec import encdec_prefill_cross, encode
    from repro_torch.tree import leaves, map_with_path

    t_model = time.perf_counter()
    base = model.config()
    out = {"model": model.key, "arch": base.name, "layers": base.n_layers}
    prompts, lengths = mesh_prompts(base.vocab)
    out["prompt_lengths"] = lengths.tolist()
    api = build_model(base)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(api.init_specs(), gen, dtype=model.born)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(x.numel() for x in leaves(params))
    out["params_gb"] = sum(x.numel() * x.element_size()
                           for x in leaves(params)) / 1e9
    sums = map_with_path(lambda _, x: leaf_sum(x), params)
    Path(tmp, f"sums-{model.key}.json").write_text(json.dumps(sums))
    for lane, parts in model.refs():
        dtype = dict(MESH_LANES)[lane]
        cfg = dataclasses.replace(base, dtype=dtype)
        api = build_model(cfg)
        weights = params if model.born is not None or \
            dtype == torch.float32 else cast_params(params, cfg)
        enc = None
        if cfg.family == "encdec":
            frames = torch.from_numpy(np.random.default_rng(3)
                                      .standard_normal((B, cfg.enc_frames,
                                                        cfg.d_model))
                                      .astype(np.float32)).cuda()
            with torch.no_grad():
                enc = encode(weights, cfg, frames)
            torch.save(enc.cpu(), Path(tmp, f"enc-{model.key}-{lane}.pt"))
            del frames
        common.reset_launch_counts()
        runs, tapes, finals = [], [], []
        pin = pinned(cfg)
        per = B // parts
        for part in range(parts):
            rows = slice(part * per, (part + 1) * per)
            caches = api.init_caches(per, model.max_seq, T)
            if enc is not None:
                caches["cross_k"], caches["cross_v"] = encdec_prefill_cross(
                    weights, cfg, enc[rows])
            with RouteTape() if pin else contextlib.nullcontext() as tape:
                runs.append(mesh_drive(api.serve_step, weights, caches,
                                       prompts[rows], lengths[rows],
                                       new=model.new, chunk=model.chunk))
            if pin:
                tapes.append(tape.picks)
            if model.cache_tol:
                finals.append(map_with_path(lambda _, x: x.cpu(), caches))
            del caches
        launches = dict(common.LAUNCHES)
        recs = [{"tokens": np.concatenate([r[s]["tokens"] for r in runs]),
                 "n_new": np.concatenate([r[s]["n_new"] for r in runs]),
                 "logits": torch.cat([r[s]["logits"] for r in runs]),
                 "ms": sum(r[s]["ms"] for r in runs)}
                for s in range(len(runs[0]))]
        logits = [r["logits"] for r in recs]
        assert all(torch.isfinite(x).all() for x in logits), lane
        assert all(x.shape[-1] == cfg.vocab for x in logits), lane
        assert launches == step_launches(
            cfg, launches, attn_layers(cfg) * len(recs) * parts), \
            (lane, parts, launches)
        torch.save([{"tokens": r["tokens"], "n_new": r["n_new"],
                     "logits": r["logits"].cpu()} for r in recs],
                   Path(tmp, f"ref-{model.key}-{lane}-{parts}.pt"))
        if model.cache_tol:
            torch.save(merged_caches(finals),
                       Path(tmp, f"caches-{model.key}-{lane}-{parts}.pt"))
        if pin:            # each call's picks, the parts' rows side by side
            torch.save([torch.cat(calls) for calls in zip(*tapes)],
                       Path(tmp, f"picks-{model.key}-{lane}-{parts}.pt"))
        out[lane if parts == 1 else f"{lane} rows of {parts}"] = {
            **step_ms(recs, prompts.shape[1], model.chunk),
            "launches": launches}
        del weights, recs, logits, runs, tapes, finals, enc
        release()
    del params
    release()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["reserved_after_gb"] = torch.cuda.memory_reserved() / 2**30
    out["seconds"] = time.perf_counter() - t_model
    return out


def pinned(cfg) -> bool:
    """Whether a lane's MoE routes are pinned to its reference's: in bf16,
    where the ranks' partial sums, added in another order than the
    unsharded step's, flip near-tied picks (grok-1-314b's bf16 lane read
    logit gaps up to 4.29 unpinned, a copy that drops a rank's experts
    8.92: H100 80GB HBM3, 700 W, ``tools/mesh_gate.py``).  The float32
    lanes route on their own."""
    return bool(cfg.n_experts) and cfg.dtype != torch.float32


class RouteTape:
    """The MoE's top-k picks of a run, call by call (one call a layer a
    step; in training a layer a microbatch, forward and remat recompute):
    recorded when ``picks`` is None; else replayed on ``rows`` of the
    recorded batch (a rank's data shard's), or on the ``shard``-th block
    of each call's tokens as large as the rank's own, in place of the
    call's own picks, which are compared with them (``flips``: the token
    rows whose own picks differ)."""

    def __init__(self, picks=None, rows=slice(None), shard=None):
        from repro_torch.models import layers
        self.layers, self.inner = layers, layers.top_k_experts
        self.replay = picks is not None
        self.picks = picks if self.replay else []
        self.rows, self.shard = rows, shard
        self.calls = self.flips = 0

    def __enter__(self):
        self.layers.top_k_experts = self.pick
        return self

    def __exit__(self, *exc):
        self.layers.top_k_experts = self.inner

    def pick(self, logits, K):
        vals, own = self.inner(logits, K)
        if not self.replay:
            self.picks.append(own.cpu())
            return vals, own
        ref = self.picks[self.calls]
        self.calls += 1
        if self.shard is not None:
            lo = self.shard * own.shape[0]
        else:
            per = ref.shape[0] // B          # tokens a row: the chunk
            lo = (self.rows.start or 0) * per
        ref = ref[lo:lo + own.shape[0]].to(own.device)
        self.flips += int((own != ref).any(-1).sum())
        return logits.gather(1, ref), ref


def step_launches(cfg, launches: dict, n: int) -> dict:
    """The counts ``n`` attention-layer steps of ``cfg``'s serve step
    give: one fused launch (GQA; and an encoder-decoder's cross attention
    through the flash forward), or one latent append and one latent
    attention (MLA), a layer a step, each in float32 its float32
    instantiation's where it counts one; no other kernel (Mamba2 and the
    RG-LRU launch none)."""
    want = {k: 0 for k in launches}
    ops = ("kv_append_chunk", "paged_attention_chunk") if cfg.mla else \
        ("paged_attention_append_chunk",)
    if cfg.family == "encdec":
        ops += ("flash_attention",)
    for op in ops:
        want[op] = n
        if cfg.dtype == torch.float32 and f"{op}:float32" in want:
            want[f"{op}:float32"] = n
    return want


def step_ms(recs: list, longest: int, chunk: int = T) -> dict:
    chunks = -(-longest // chunk)
    pre = [r["ms"] for r in recs[:chunks]]
    dec = [r["ms"] for r in recs[chunks:]]
    return {"steps": len(recs), "prefill_steps": len(pre),
            "prefill_ms": pre, "decode_ms_median": statistics.median(dec),
            "decode_ms": dec}


def mesh_compare(recs: list, ref: list, rows, lane: str) -> dict:
    """This rank's logits against (a)'s rows at every valid position: the
    largest |difference| a step (and the largest |logit|); in float32, the
    greedy token (argmax) equal to (a)'s wherever (a)'s top-2 gap exceeds
    twice the step's largest difference (the measured noise)."""
    errs, scale, checked, positions, wrong = [], 0.0, 0, 0, []
    for s, (r, w) in enumerate(zip(recs, ref)):
        n_new = w["n_new"][rows]
        want = w["logits"][rows].to(r["logits"].device)
        got = r["logits"]
        err = 0.0
        for b in range(got.shape[0]):
            k = int(n_new[b])
            if k:
                err = max(err, float((got[b, :k] - want[b, :k]).abs().max()))
                scale = max(scale, float(want[b, :k].abs().max()))
        errs.append(err)
        if lane != "float32":
            continue
        for b in range(got.shape[0]):
            k = int(n_new[b])
            if not k:
                continue
            top = want[b, :k].topk(2, dim=-1).values
            gap = top[:, 0] - top[:, 1]
            sure = gap > 2 * err
            positions += k
            checked += int(sure.sum())
            same = got[b, :k].argmax(-1) == want[b, :k].argmax(-1)
            bad = torch.nonzero(sure & ~same).flatten().tolist()
            wrong += [(s, b, c) for c in bad]
    return {"max_abs_err": max(errs), "max_abs_err_by_step": errs,
            "logit_max_abs": scale, "positions": positions,
            "tokens_checked": checked, "tokens_wrong": wrong}


def gloo_probe(rank: int, world: int) -> dict:
    """The mesh steps' collectives on this device's tensors: all_reduce
    and all_gather in float32 and bf16, all_gather of int64 (the MoE's
    expert counts), and the train step's FSDP pair, all_gather_into_tensor
    and reduce_scatter_tensor, in float32 and bf16, each result checked
    (torch's backend table lists several gloo collectives as CPU-only)."""
    import torch.distributed as dist

    probe = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(2 * world, device="cuda", dtype=dtype) + 10 * rank
        got = torch.empty(2 * world * world, device="cuda", dtype=dtype)
        dist.all_gather_into_tensor(got, x)
        want = torch.cat([torch.arange(2 * world, device="cuda") + 10 * r
                          for r in range(world)])
        probe[f"all_gather_into_tensor {dtype}"] = torch.equal(
            got.float(), want.float())
        out = torch.empty(2, device="cuda", dtype=dtype)
        dist.reduce_scatter_tensor(out, x)
        total = sum(torch.arange(2 * world, device="cuda") + 10 * r
                    for r in range(world))
        probe[f"reduce_scatter_tensor {dtype}"] = torch.equal(
            out.float(), total[2 * rank:2 * rank + 2].float())
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        if dtype != torch.int64:
            x = torch.full((4,), float(rank + 1), device="cuda", dtype=dtype)
            dist.all_reduce(x)
            probe[f"all_reduce {dtype}"] = x.tolist() == [
                world * (world + 1) / 2] * 4
        got = [torch.empty(2, device="cuda", dtype=dtype)
               for _ in range(world)]
        dist.all_gather(got, torch.full((2,), rank, device="cuda",
                                        dtype=dtype))
        probe[f"all_gather {dtype}"] = [float(g[0]) for g in got] == \
            list(map(float, range(world)))
    return probe


def cache_leaves(caches) -> list:
    """(path, leaf) of every leaf of a cache tree but the page table and
    the lengths."""
    from repro_torch.tree import map_with_path
    out = []
    map_with_path(lambda path, x: out.append((path, x)), caches)
    return [(p, x) for p, x in out if p[0] not in ("page_table", "lengths")]


def mesh_rank(rank: int, world: int, tmp: str, models: tuple,
              out_path: str) -> None:
    """Phase 17 (b), one rank of every model's meshes in turn: a gloo
    group over a FileStore on the one card (NCCL refuses two ranks on one
    device), its collectives on the card's tensors probed first, while
    (a) runs; once (a) is done (its ``refs-done`` file), for each model
    and mesh its shard of each leaf drawn as (a) drew it (the whole leaf
    from the same seed, its sum checked, sliced, freed; one rank at a
    time, so one whole leaf is on the card), then each of the mesh's runs
    through ``make_serve_step`` with its variant, teacher-forced with its
    reference's tokens, its logits held to the reference's
    (``mesh_compare``) and, where ``model.cache_tol`` holds them, its
    final caches to its block of the reference's (``caches_compare``),
    its launches counted.  An encoder-decoder's rank computes its own KV
    heads' cross K/V from (a)'s encoder output of its rows
    (``encdec_prefill_cross`` over its shards)."""
    import datetime
    import torch.distributed as dist
    from repro_torch.convert import cast_params
    from repro_torch.dist.sharding import shard_params
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, init_params
    from repro_torch.models.encdec import encdec_prefill_cross
    from repro_torch.models.spec import stays_float32
    from repro_torch.serve.step import make_serve_step
    from repro_torch.tree import leaves, map_with_path

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    probe = gloo_probe(rank, world)
    assert all(probe.values()), probe
    while not Path(tmp, "refs-done").exists():
        time.sleep(0.2)                 # the spawner's deadline bounds it
    meshes, results = {}, []
    for model in models:
        base = model.config()
        sums = json.loads(Path(tmp, f"sums-{model.key}.json").read_text())
        prompts, lengths = mesh_prompts(base.vocab)
        for shape in model.shapes():
            t_mesh = time.perf_counter()
            if shape not in meshes:
                meshes[shape] = make_mesh(shape)
            mesh = meshes[shape]
            out = {"model": model.key, "rank": rank, "mesh": list(shape),
                   "coords": mesh.coords, "gloo_probe": probe}
            api = build_model(base)
            caches = api.init_caches(B, model.max_seq, T)
            _, pspecs, cspecs = make_serve_step(api, mesh, caches)
            del caches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(0)
            bad = []

            def draw(path, spec, pspec, total):
                """The whole leaf, drawn in (a)'s order, its sum checked,
                then this rank's shard (the whole leaf freed); the ranks
                take turns at a leaf of a GiB or more (its float32 draw)."""
                dtype = None if model.born is None or stays_float32(path) \
                    else model.born
                big = math.prod(spec.shape) * 4 >= 2**30
                mine = None
                for turn in range(world if big else 1):
                    if turn == rank or not big:
                        full = init_params(spec, gen, dtype=dtype)
                        if leaf_sum(full) != total:
                            bad.append("/".join(path))
                        mine = shard_params(full, pspec, mesh)
                        del full
                        if big:
                            torch.cuda.empty_cache()
                    if big:
                        dist.barrier()
                return mine

            params = map_with_path(draw, api.init_specs(), pspecs, sums)
            torch.cuda.synchronize()
            out["shard_s"] = time.perf_counter() - t0
            out["shard_gb"] = sum(x.numel() * x.element_size()
                                  for x in leaves(params)) / 1e9
            assert not bad, ("the rank's draws differ from (a)'s", bad)
            d = mesh.coords["data"] if "data" in cspecs["lengths"] else 0
            per = B // (mesh.shape["data"] if "data" in cspecs["lengths"]
                        else 1)
            rows = slice(d * per, (d + 1) * per)
            for shape_, lane, variant in model.runs:
                if shape_ != shape:
                    continue
                t_lane = time.perf_counter()
                dtype = dict(MESH_LANES)[lane]
                cfg = dataclasses.replace(base, dtype=dtype)
                api = build_model(cfg)
                if model.born is None and dtype != torch.float32:
                    params = cast_params(params, cfg)
                release()
                caches = api.init_caches(B, model.max_seq, T)
                step, _, cspecs = make_serve_step(api, mesh, caches,
                                                  variant=variant)
                caches = shard_params(caches, cspecs, mesh)
                if cfg.family == "encdec":        # this rank's KV heads
                    enc = torch.load(Path(tmp, f"enc-{model.key}-{lane}.pt"))
                    caches["cross_k"], caches["cross_v"] = \
                        encdec_prefill_cross(params, cfg, enc[rows].cuda())
                    del enc
                parts = shape[0] if variant == "shard_map" else 1
                ref = torch.load(Path(tmp, f"ref-{model.key}-{lane}-"
                                      f"{parts}.pt"), weights_only=False)
                pin = pinned(cfg)
                tape = RouteTape(torch.load(Path(
                    tmp, f"picks-{model.key}-{lane}-{parts}.pt")), rows) \
                    if pin else contextlib.nullcontext()
                torch.cuda.synchronize()
                common.reset_launch_counts()
                with tape:
                    recs = mesh_drive(step, params, caches, prompts,
                                      lengths, rows=rows, forced=ref,
                                      new=model.new, chunk=model.chunk)
                launches = dict(common.LAUNCHES)
                res = mesh_compare(recs, ref, rows, lane)
                if model.cache_tol:
                    res.update(caches_compare(caches, torch.load(Path(
                        tmp, f"caches-{model.key}-{lane}-{parts}.pt"),
                        mmap=True), cspecs, mesh))
                if pin:
                    res.update(routes_pinned=True, moe_calls=tape.calls,
                               route_flips=tape.flips)
                res["finite"] = all(bool(torch.isfinite(r["logits"]).all())
                                    for r in recs)
                res["logit_sums"] = [float(r["logits"].double().sum())
                                     for r in recs]
                res["cache_shapes"] = {
                    "/".join(map(str, path)): list(x.shape)
                    for path, x in cache_leaves(caches)}
                res["variant"] = variant
                res["held_to"] = "the whole batch" if parts == 1 else \
                    f"each of {parts} data shards' rows alone"
                out[lane_key(lane, variant)] = {
                    **step_ms(recs, prompts.shape[1], model.chunk), **res,
                    "launches": launches,
                    "seconds": time.perf_counter() - t_lane}
                del caches, recs, ref
                release()
            del params
            release()
            out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
            out["seconds"] = time.perf_counter() - t_mesh
            results.append(out)
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(results))


def _mesh_rank_entry(rank, world, tmp, models):
    mesh_rank(rank, world, tmp, models,
              os.path.join(tmp, f"rank-{rank}.json"))


def mesh_spawn(tmp: str, models: tuple, entry=None):
    """Phase 17 (b)'s ranks: ``mesh_rank`` in a process a rank, spawned
    once with ``torch.multiprocessing`` for every model's meshes (each
    has MESH_RANKS ranks).  ``entry`` (``tools/mesh_gate.py``'s broken
    copies) takes ``_mesh_rank_entry``'s place."""
    import torch.multiprocessing as mp

    return mp.start_processes(entry or _mesh_rank_entry,
                              args=(MESH_RANKS, tmp, models),
                              nprocs=MESH_RANKS, join=False,
                              start_method="spawn")


def mesh_join(ctx, tmp: str, models: tuple, t0: float) -> dict:
    """Waits for the ranks, all within MESH_RANK_TIMEOUT of their spawn
    at ``t0`` (killed at the deadline); returns each (model, mesh)'s
    ranks."""
    deadline = t0 + MESH_RANK_TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"phase 17 (b): the ranks ran past "
                                   f"{MESH_RANK_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [json.loads(Path(tmp, f"rank-{r}.json").read_text())
             for r in range(MESH_RANKS)]
    units = [(m, shape) for m in models for shape in m.shapes()]
    return {"seconds": time.perf_counter() - t0, "meshes": [
        {"model": m.key, "mesh": list(shape),
         "seconds": ranks[0][i]["seconds"], "ranks": [r[i] for r in ranks]}
        for i, (m, shape) in enumerate(units)]}


def check_mesh(res: dict, model: MeshModel) -> None:
    """Phase 17 (b)'s gates on every rank of one (model, mesh): finite
    logits within the model's bound of its reference's at every step; in
    float32 every greedy token equal to the reference's where its top-2
    gap exceeds the noise; with ``cache_tol``, its final caches within
    their bound of its block of the reference's; the attention's kernels
    launched once a layer a step (``step_launches``) and no other
    kernel; the ranks of a data shard with the same logits."""
    base = model.config()
    keys = []
    for shape, lane, variant in model.runs:
        if list(shape) != res["mesh"]:
            continue
        dtype = dict(MESH_LANES)[lane]
        key = lane_key(lane, variant)
        keys.append(key)
        for r in res["ranks"]:
            x = r[key]
            assert x["finite"], (model.key, key, r["rank"])
            assert x["max_abs_err"] <= model.tol[dtype], \
                (model.key, key, r["rank"], x["max_abs_err_by_step"])
            if model.cache_tol:
                assert x["cache_max_abs_err"] <= model.cache_tol[dtype], \
                    (model.key, key, r["rank"],
                     x["cache_max_abs_err_by_leaf"])
            assert not x["tokens_wrong"], (model.key, key, r["rank"],
                                           x["tokens_wrong"])
            if dtype == torch.float32:
                assert x["tokens_checked"] > 0, (model.key, key, r["rank"])
            cfg = dataclasses.replace(base, dtype=dtype)
            assert x["launches"] == step_launches(
                cfg, x["launches"], attn_layers(cfg) * x["steps"]), \
                (model.key, key, r["rank"], x["launches"])
    m = res["mesh"][1]
    for key in keys:
        for r in res["ranks"]:
            twin = res["ranks"][r["rank"] // m * m]
            assert r[key]["logit_sums"] == twin[key]["logit_sums"], \
                (model.key, key, r["rank"])


def phase17(card: str, entry=None, models=MESH_MODELS) -> dict:
    """Phase 17: the ranks spawned first (their start-up and gloo probe
    run beside (a)), then (a) for each model, then (b) on each model's
    meshes, every one logged, then each gated.  ``entry``: as ``mesh_spawn``'s,
    whose meshes are then logged and not gated."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mesh_spawn(tmp, models, entry)
        try:
            refs = {}
            for model in models:
                refs[model.key] = mesh_reference(tmp, model)
                log(f"phase17 (a) {model.key}",
                    json.dumps({"card": card, **refs[model.key]}))
            Path(tmp, "refs-done").write_text("")
        except BaseException:
            for p in ctx.processes:
                p.kill()
            raise
        ranks = mesh_join(ctx, tmp, models, t0)
        log(f"phase17 (b) seconds {ranks['seconds']:.1f} (from the spawn)")
        by_key = {m.key: m for m in models}
        for res in ranks["meshes"]:
            shape = res["mesh"]
            log(f"phase17 (b) {res['model']} {shape[0]}x{shape[1]}",
                json.dumps({"card": card, **res}))
        for res in ranks["meshes"] if entry is None else ():
            check_mesh(res, by_key[res["model"]])
    return {"reference": refs, **ranks}


# ---------------------------------------------------------------------------
# phase 18: item 6's smoke sweep, the dense architectures no other phase
# serves, at full width and depth in bf16
# ---------------------------------------------------------------------------

SWEEP_ARCHS = ("minitron-8b", "starcoder2-7b")


def smoke_sweep(arch: str) -> dict:
    """``arch`` at full width and depth, born in bf16
    (``serving_weights``), through phase 3's ``path_vs_plain``: three
    kernel steps of context, then one mixed step with the kernels and
    with the plain path; the fused op launched once a layer a kernel step
    and no other kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    cfg = get_config(arch)
    api, params, out = serving_weights(cfg)
    common.reset_launch_counts()
    out["path_vs_plain"] = path_vs_plain(api, params, cfg)
    launches = dict(common.LAUNCHES)
    out["launches"] = launches
    assert launches == step_launches(cfg, launches, 4 * cfg.n_layers), \
        (arch, launches)
    del params
    release()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 19: the mesh train step (train/step.py over a ("data", "model")
# mesh: FSDP and tensor parallelism) on gloo ranks on the one card
# ---------------------------------------------------------------------------

TRAIN_MESH_S = 1024
TRAIN_MESH_BATCH, TRAIN_MESH_MB, TRAIN_MESH_STEPS = 4, 2, 3
TRAIN_MESH_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)


@dataclasses.dataclass(frozen=True)
class TrainMeshModel:
    """A phase-19 architecture: its depth (an encoder-decoder's, each
    stack's), every MoE router's column 0 scale (None: as drawn), its
    microbatches a step and tokens a sequence, whether its lanes hold
    the card alone ((a) then runs it first and waits for the ranks to
    finish its lanes before the next arch), and Adam's eps."""
    layers: int
    router_scale: Optional[float] = None
    microbatches: int = TRAIN_MESH_MB
    seq: int = TRAIN_MESH_S
    alone: bool = False
    eps: float = 1e-8


TRAIN_MESH_MODELS = {
    # 4 of 38: one (rec, rec, attn) group and the tail's first rec, the
    # fewest layers that run the tail; 3.0 G parameters, the untied table
    # and head 2.1 G of them: (a)'s float32 state ~60 GB, the four ranks'
    # ~48 GB, so each holds the card alone; one row a microbatch keeps a
    # rank's [1, 1024, 256000] float32 logits (gathered over "model") and
    # their grad within the rest (PERF.md §4)
    "recurrentgemma-9b": TrainMeshModel(4, microbatches=4, alone=True),
    "qwen2-1.5b": TrainMeshModel(2),      # of 28
    # 1 of 27 (2 layers took 88 s of four gloo ranks, PERF.md §6); router
    # column 0 x 16 (as phase 17's overflow case): expert 0 overflows each
    # microbatch's capacity (384 rows of 2048 tokens x 6 picks), so the
    # count over "data" decides which picks drop
    "deepseek-v2-lite-16b": TrainMeshModel(1, router_scale=16.0),
    # 2 of 48; Adam's eps 1e-6: at 1e-8 the tied table's near-zero grads
    # (rows the batch never reads) turn rounding into updates of ~lr, and
    # two correct unsharded runs, kernel and plain paths, part by 1.16e-3
    # there after three steps, above the param gate (``tools/mesh_gate.py
    # --noise``, PERF.md §6)
    "mamba2-1.3b": TrainMeshModel(2, eps=1e-6),
    # 1 encoder and 1 decoder layer of 32 each; 448 tokens, its target
    # length, against 1500 frames
    "whisper-large-v3": TrainMeshModel(1, seq=WHISPER_MAX_SEQ),
    "internvl2-1b": TrainMeshModel(2),    # of 24; 256 patches + the text
}
# the pod lanes (train/step.py over a ("pod", "data", "model") mesh):
# qwen2-1.5b at (2, 1, 2), each pod half of the global batch, through the
# int8 pod reduction on each rank's own buckets, then uncompressed ("pod"
# joins FSDP and the batch: the (2, 2) view, rank for rank and row for
# row the float32 (2, 2) lane, which it replaces here), both in float32
POD_SHAPE = (2, 1, 2)
POD_CODECS = ("int8", "none")
POD_LANES = tuple(("qwen2-1.5b", POD_SHAPE, codec) for codec in POD_CODECS)
TRAIN_MESH_LANES = (("recurrentgemma-9b", (1, 4), "float32"),
                    ("qwen2-1.5b", (1, 4), "float32"),
                    ("qwen2-1.5b", (2, 2), "bfloat16"),
                    ("deepseek-v2-lite-16b", (2, 2), "float32"),
                    ("mamba2-1.3b", (2, 2), "float32"),
                    ("whisper-large-v3", (2, 2), "float32")) + POD_LANES
# internvl2-1b's lane (23 s of the ranks, PERF.md §6) does not fit the
# script's 1200 s beside the others; the VLM's trunk is the dense lanes'
# code, its prefix held by tests/test_torch_train_mesh_state.py on the
# CPU.  qwen2-1.5b's float32 (2, 2) lane is the uncompressed pod lane's
# step on the same ranks and rows (their readings are bitwise equal,
# PERF.md §6).  Both run on the card with ``tools/mesh_gate.py
# --phase19``, which picks from these
TRAIN_MESH_GATE_ONLY = (("qwen2-1.5b", (2, 2), "float32"),
                        ("internvl2-1b", (2, 2), "float32"))
TRAIN_MESH_GATE_LANES = TRAIN_MESH_LANES + TRAIN_MESH_GATE_ONLY
TRAIN_MESH_RANKS = 4
TRAIN_MESH_TIMEOUT = 600             # seconds for the ranks, from the spawn
# float32 lanes against the unsharded float32 step on the same card, over
# three steps: the largest relative loss and grad-norm gaps and the largest
# param gap.  Near the geometric middle of the correct readings (loss
# 2.8e-7, grad norm 2.5e-6, params 4.6e-5) and the nearest broken copy's,
# ``python3 tools/mesh_gate.py --phase19 --broken-copies
# --broken-data-mean``: without the copied KV heads' grad sum, loss
# 6.8e-3, grad norm 3.9e-2, params 5.5e-3 at (1, 4); without the division
# by the data size, grad norm 1.0 at (2, 2), where Adam and the clip
# leave loss and params as they were.  The MoE lane (deepseek, (2, 2))
# reads 1.7e-7 / 7.5e-7 / 6.6e-5, and its broken copies (``--broken-train-
# count``, ``--broken-router-entry``, ``--broken-latent-entry``) 4.6e-3-
# 6.3e-2 / 4.5e-3-0.14 / 5.5e-3, beside their own gates: other dropped
# picks; the router and ``norm2`` or ``w_dkv`` and ``norm1`` copies that
# differ across model ranks (PERF.md §6)
TRAIN_MESH_TOL = {"loss_rel_gap": 5e-5, "grad_norm_rel_gap": 3e-4,
                  "param_abs_gap": 5e-4}
# the int8 pod lane against the unsharded float32 step, whose grads are
# exact where the lane's are the codec's (``python3 tools/mesh_gate.py
# --pod --broken-pod-residuals --broken-pod-norm --broken-pod-rows``,
# PERF.md §6; each reading the same to the last digit in every run):
# correct loss 1.44e-3, grad norm 9.73e-3, params 5.160e-3, step-1 loss
# equal (it is read before the codec acts, so it is held to
# ``TRAIN_MESH_TOL``); every pod reading pod 0's rows 3.59e-2 / 0.212 /
# 5.538e-3, step 1 1.87e-4; every pod keeping pod 0's residuals 1.73e-3
# / 9.75e-3 / 5.10e-3 (its identity gap 7.6e-3 against a bound of
# 4.0e-6: ``PodProbe``); the clip norm over every pod's pieces 6.4e-4 /
# 0.425 / 5.12e-3.  The loss bound sits 3.5x above the correct reading
# and 7x below the rows', the grad-norm bound near the geometric middle
# of the correct and the rows' (4.5e-2); params, which Adam moves by
# ~lr whatever the grads, at the geometric middle of 5.160e-3 and the
# rows' 5.538e-3
POD_TOL = {"loss_rel_gap": 5e-3, "grad_norm_rel_gap": 5e-2,
           "param_abs_gap": 5.35e-3}


def train_lane_key(arch: str, shape, lane: str) -> str:
    return f"{arch} {lane} {'x'.join(map(str, shape))}"


def lane_dtype(lane: str):
    """A lane's dtype: float32, but for the bf16 lane."""
    return torch.bfloat16 if lane == "bfloat16" else torch.float32


def lane_codec(lane: str) -> str:
    """The pod reduction's codec of a float32 lane: a pod lane's own,
    else none."""
    return lane if lane in POD_CODECS else "none"


def lane_view(api, shape, lane: str) -> tuple:
    """The ("data", "model") mesh shape a lane's shards are on, each
    rank's coords on it, and the ranks whose shards make up the whole
    tree (the first ranks of the view, row-major): the mesh a train step
    over ``shape`` shards on (``train.step.shard_mesh``)."""
    from repro_torch.launch.mesh import plain_mesh
    from repro_torch.train.step import shard_mesh
    views = [shard_mesh(api, plain_mesh(shape, r), lane_codec(lane))
             for r in range(math.prod(shape))]
    view = tuple(views[0].shape.values())
    return view, [v.coords for v in views], list(range(math.prod(view)))


def train_mesh_opt(arch: str):
    """The lanes' AdamW settings, with the arch's eps."""
    from repro_torch.train import AdamWConfig
    return AdamWConfig(**TRAIN_MESH_OPT, eps=TRAIN_MESH_MODELS[arch].eps)


def train_mesh_config(arch: str, dtype):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n = TRAIN_MESH_MODELS[arch].layers
    stacks = dict(n_enc_layers=n, n_dec_layers=n) \
        if cfg.family == "encdec" else {}
    return dataclasses.replace(cfg, n_layers=n, dtype=dtype, **stacks)


def train_mesh_params(api, arch: str):
    """The seed-0 global params on the card, every MoE router's column 0
    scaled by the arch's ``router_scale``."""
    from repro_torch.models import init_params
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(api.init_specs(), gen, device="cuda")
    scale = TRAIN_MESH_MODELS[arch].router_scale
    if scale is not None:
        for block in params["group"].values():
            block["moe"]["router"][..., 0] *= scale
    return params


def train_mesh_batches(arch: str, cfg) -> list:
    """The global batches of the three steps (numpy, from seed 0; an
    encoder-decoder's frames and a VLM's patch embeddings with them)."""
    from repro_torch.data import TokenPipeline
    pipe = TokenPipeline(cfg, global_batch=TRAIN_MESH_BATCH,
                         seq_len=TRAIN_MESH_MODELS[arch].seq, seed=0)
    return [pipe.batch_at(i) for i in range(TRAIN_MESH_STEPS)]


def train_mesh_expected(arch: str) -> dict:
    """Kernel launches of one rank's step (``train_launches``)."""
    return train_launches(train_mesh_config(arch, torch.float32),
                            TRAIN_MESH_MODELS[arch].microbatches)


class DropCount:
    """Within it, the picks every MoE routing drops past its expert's
    capacity (``layers.moe_route``'s ``keep``; the forward's and the remat
    recompute's), added up on the device."""

    def __enter__(self):
        from repro_torch.models import layers
        self.layers, self.inner = layers, layers.moe_route
        self.total = torch.zeros((), dtype=torch.int64, device="cuda")

        def route(p, cfg, xt):
            out = self.inner(p, cfg, xt)
            self.total += (~out[2]).sum()
            return out

        layers.moe_route = route
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.inner

    def take(self) -> int:
        n = int(self.total)
        self.total.zero_()
        return n


class PodProbe:
    """Within it, a rank's compressed pod reduction
    (``compression.bucketed_compressed_psum`` over its own buckets) and
    its AdamW update are watched, step by step.  Each bucket's ``x = g +
    err`` (the codec's input), the exact float32 mean over the pods of
    its grads ``g`` (all-reduced beside the codec's reduction) and the
    applied mean (the codec's output) are kept, the exact and applied
    means summed over the steps; ``finish`` then reads the error-feedback
    identity: sum of applied means + the pods' mean final residual ==
    sum of exact means.  In float32 the two sides part by rounding alone:
    at each step ``x`` (one rounding, |x| <= M_t, M_t the largest |x|
    over the pods), the pods' sums of dequantized and of exact values
    (one rounding each, of at most 2 M_t: |deq| <= |x| + scale / 2, a
    residual is at most scale / 2 = M / 254) and the two running sums (one
    rounding each, of at most t M), and the final sum and mean (the
    residual subtraction ``x - deq`` is exact, Sterbenz): at most
    ``(5 + 2 T) u sum_t M_t`` (u = 2^-24, T steps), bounded here by
    ``8 T u sum_t M_t``.  ``collapsed`` reads the same identity with pod
    0's final residual in place of every pod's (the reference's collapsed
    residuals, ``repro/dist/sharding.py:60-67``), and at step 1 the clip
    norm is read again over the default group, every pod's pieces
    counted (``world_norm``).  CUDA events time each reduction."""

    U = 2.0 ** -24

    def __init__(self):
        from repro_torch.dist import compression
        import repro_torch.train.step as train_step
        self.compression, self.train_step = compression, train_step
        self.applied, self.exact, self.peaks, self.ms = [], [], [], []
        self.norms = []
        self.group = self.residuals = None

    def __enter__(self):
        self.real = (self.compression.bucketed_compressed_psum,
                     self.train_step.adamw_update)
        self.compression.bucketed_compressed_psum = self.psum
        self.train_step.adamw_update = self.update
        return self

    def __exit__(self, *exc):
        (self.compression.bucketed_compressed_psum,
         self.train_step.adamw_update) = self.real

    def psum(self, tree, residuals, group, *, plan, codec, topk_frac):
        import torch.distributed as dist
        flat = self.compression.bucket_flat
        pods = dist.get_world_size(group)
        peak = torch.zeros((), device="cuda")
        exact = []
        for b in range(plan.num_buckets):
            g = flat(tree, plan, b).clone()
            peak = torch.maximum(peak, (g + residuals[b]).abs().max())
            dist.all_reduce(g, group=group)
            exact.append(g.div_(pods))
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, new = self.real[0](tree, residuals, group, plan=plan,
                                codec=codec, topk_frac=topk_frac)
        end.record()
        end.synchronize()
        self.ms.append(start.elapsed_time(end))
        applied = [flat(out, plan, b).clone()
                   for b in range(plan.num_buckets)]
        if not self.applied:
            self.applied, self.exact = applied, exact
        else:
            for acc, x in zip(self.applied + self.exact, applied + exact):
                acc.add_(x)
        self.peaks.append(float(peak))
        self.group, self.residuals = group, new
        return out, new

    def update(self, cfg, params, grads, state, *, norm):
        from repro_torch.train.optimizer import sharded_norm
        if not self.norms:
            self.norms = [float(norm(grads)), float(sharded_norm(
                grads, owned=norm.keywords["owned"]))]
        return self.real[1](cfg, params, grads, state, norm=norm)

    def finish(self) -> dict:
        """The identity's readings on this rank (a collective over the
        pods)."""
        import torch.distributed as dist
        pods = dist.get_world_size(self.group)
        gap = collapsed = 0.0
        for s_app, s_ex, e in zip(self.applied, self.exact, self.residuals):
            first = e.clone()
            dist.broadcast(first, group=self.group, group_src=0)
            mean = e.clone()
            dist.all_reduce(mean, group=self.group)
            mean.div_(pods)
            gap = max(gap, float((s_app + mean - s_ex).abs().max()))
            collapsed = max(collapsed,
                            float((s_app + first - s_ex).abs().max()))
        steps = len(self.peaks)
        return {"ef_identity_gap": gap,
                "ef_identity_bound": 8 * steps * self.U * sum(self.peaks),
                "ef_collapsed_gap": collapsed, "codec_ms": self.ms,
                "world_norm_rel_gap": self.norms[1] / self.norms[0] - 1}


def train_mesh_reference(tmp: str, lanes=TRAIN_MESH_LANES) -> dict:
    """Phase 19 (a): the unsharded steps in this process, from the same
    seed-0 params the ranks draw, for each arch of ``lanes``: float32
    through ``make_train_step`` (losses, grad norms and an MoE's dropped
    picks a step saved for the comparison, the final params kept on the
    host, an MoE's top-k picks recorded for the ranks to replay) and,
    where a lane is bf16, bf16 through ``run_training`` (its losses).
    Each arch's ``refs-{arch}`` file then lets the ranks start its lanes,
    so the next arch's steps here run beside them; after an arch whose
    lanes hold the card alone, this waits for the ranks' ``ranks-{arch}``
    file."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import LoopConfig, run_training
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    out, finals = {}, {}
    for arch in dict.fromkeys(a for a, _, _ in lanes):
        model = TRAIN_MESH_MODELS[arch]
        cfg = train_mesh_config(arch, torch.float32)
        api = build_model(cfg)
        step, init_state, _ = make_train_step(
            api, train_mesh_opt(arch), microbatches=model.microbatches)
        torch.cuda.reset_peak_memory_stats()
        state = init_state(train_mesh_params(api, arch))
        ref = out[f"{arch} float32"] = {"loss": [], "grad_norm": [],
                                        "dropped": []}
        t_arch = time.perf_counter()
        with DropCount() as drops, RouteTape() as tape:
            for b in train_mesh_batches(arch, cfg):
                state, m = step(state, {k: torch.from_numpy(v).cuda()
                                        for k, v in b.items()})
                ref["loss"].append(float(m["loss"]))
                ref["grad_norm"].append(float(m["grad_norm"]))
                ref["dropped"].append(drops.take())
        if cfg.n_experts:
            torch.save(tape.picks, Path(tmp, f"picks-{arch}.pt"))
        ref["seconds"] = time.perf_counter() - t_arch
        ref["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        finals[arch] = [p.cpu() for p in leaves(state["params"])]
        del state
        release()
        if (arch, "bfloat16") in {(a, ln) for a, _, ln in lanes}:
            cfg16 = train_mesh_config(arch, torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            res = run_training(
                build_model(cfg16), TokenPipeline(
                    cfg16, global_batch=TRAIN_MESH_BATCH,
                    seq_len=model.seq, seed=0),
                LoopConfig(steps=TRAIN_MESH_STEPS,
                           microbatches=model.microbatches),
                train_mesh_opt(arch), device="cuda")
            out[f"{arch} bfloat16"] = {
                "loss": res.losses, "step_s": res.step_seconds,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
            release()
        Path(tmp, f"refs-{arch}").write_text("")
        while model.alone and not Path(tmp, f"ranks-{arch}").exists():
            time.sleep(0.2)             # the spawner's deadline bounds it
    out["seconds"] = time.perf_counter() - t0
    return out, finals


def train_mesh_rank(rank: int, world: int, tmp: str, out_path: str,
                    lanes=TRAIN_MESH_LANES) -> None:
    """Phase 19 (b), one rank: a gloo group over a FileStore on the one
    card, its collectives probed on the card's tensors while (a) runs;
    then each of ``lanes`` on its mesh, once (a) is done with its arch:
    float32 through ``make_train_step(mesh=...)`` from the seed-0 global
    params (its shards kept), this data rank's rows of each global batch
    (``mesh_rows``), its flash launches and an MoE's dropped picks
    counted step by step and its param shards saved for (a)'s
    comparison; bf16 through ``run_training(mesh=...)``.  An MoE lane
    replays (a)'s top-k picks on its data shard's tokens (``RouteTape``:
    float32 sums in another order flip near-tied picks once Adam has
    moved the weights, PERF.md §6) and counts the tokens whose own picks
    differ; which picks fit their expert's capacity is still counted
    here, over "data".  The ranks draw the global params in turns, so
    one whole tree is on the card at a time; after the lanes of an arch
    that holds the card alone, rank 0 writes ``ranks-{arch}``."""
    import datetime
    import torch.distributed as dist
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import LoopConfig, run_training
    from repro_torch.train.step import (batch_rows, make_train_step,
                                        shard_mesh)
    from repro_torch.tree import leaves

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    probe = gloo_probe(rank, world)
    assert all(probe.values()), probe
    meshes = {shape: make_mesh(shape)          # in one order on every rank
              for shape in dict.fromkeys(s for _, s, _ in lanes)}
    out = {"rank": rank, "gloo_probe": probe, "lanes": {}}
    for arch, shape, lane in lanes:
        while not Path(tmp, f"refs-{arch}").exists():
            time.sleep(0.2)             # the spawner's deadline bounds it
        t_lane = time.perf_counter()
        mesh = meshes[shape]
        model = TRAIN_MESH_MODELS[arch]
        cfg = train_mesh_config(arch, lane_dtype(lane))
        api = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        rec = {"coords": mesh.coords}
        if lane == "bfloat16":
            common.reset_launch_counts()
            res = run_training(
                api, TokenPipeline(cfg, global_batch=TRAIN_MESH_BATCH,
                                   seq_len=model.seq, seed=0),
                LoopConfig(steps=TRAIN_MESH_STEPS,
                           microbatches=model.microbatches),
                train_mesh_opt(arch),
                device="cuda", mesh=mesh)
            rec.update(loss=res.losses, step_s=res.step_seconds,
                       launches=dict(common.LAUNCHES))
        else:
            codec = lane_codec(lane)
            step, init_state, _ = make_train_step(
                api, train_mesh_opt(arch), microbatches=model.microbatches,
                mesh=mesh, codec=codec)
            for turn in range(world):   # one global tree at a time
                if turn == rank:
                    state = init_state(train_mesh_params(api, arch))
                    release()
                dist.barrier()
            take = batch_rows(TRAIN_MESH_BATCH, model.microbatches, mesh,
                              shard_mesh(api, mesh, codec))
            rec.update(loss=[], grad_norm=[], step_s=[], launches=[],
                       dropped=[], route_flips=[])
            tape = RouteTape(torch.load(Path(tmp, f"picks-{arch}.pt")),
                             shard=mesh.coords["data"]) \
                if cfg.n_experts else RouteTape()
            probe = PodProbe() if lane == "int8" else \
                contextlib.nullcontext()
            with DropCount() as drops, tape, probe:
                for b in train_mesh_batches(arch, cfg):
                    batch = {k: torch.from_numpy(v[take]).cuda()
                             for k, v in b.items()}
                    common.reset_launch_counts()
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    rec["loss"].append(float(m["loss"]))
                    rec["step_s"].append(time.perf_counter() - t0)
                    rec["grad_norm"].append(float(m["grad_norm"]))
                    rec["launches"].append(dict(common.LAUNCHES))
                    rec["dropped"].append(drops.take())
                    rec["route_flips"].append(
                        tape.flips - sum(rec["route_flips"]))
            if lane == "int8":
                rec.update(probe.finish())
                del probe
            key = train_lane_key(arch, shape, lane)
            part = Path(tmp, f"shards-{key}-{rank}.part")
            torch.save([p.cpu() for p in leaves(state["params"])], part)
            os.replace(part, Path(tmp, f"shards-{key}-{rank}.pt"))
            del state
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        release()
        rec["seconds"] = time.perf_counter() - t_lane
        out["lanes"][train_lane_key(arch, shape, lane)] = rec
        if model.alone and (arch, shape, lane) == [
                x for x in lanes if x[0] == arch][-1]:
            dist.barrier()              # every rank has let go of the card
            if rank == 0:
                Path(tmp, f"ranks-{arch}").write_text("")
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))


def _train_mesh_rank_entry(rank, world, tmp, lanes):
    train_mesh_rank(rank, world, tmp, os.path.join(tmp, f"rank-{rank}.json"),
                    lanes)


def train_mesh_param_gaps(tmp: str, arch: str, shape, key: str,
                          final: list, lane: str = "float32") -> dict:
    """A float32 lane's params after step 3 against (a)'s: every rank's
    shard of each leaf against (a)'s same block (the largest gap and its
    leaf), and every leaf gathered from the ranks' shards
    (``gather_params``: the copies of a replicated leaf or of a copied KV
    head must be bitwise equal; the leaves where they differ are
    listed); a pod lane under the codec gathers pod 0's ranks and holds
    each rank's shards to its counterpart's in pod 1, bitwise
    (``lane_view``).  The ranks' shard files are removed."""
    from repro_torch.dist.sharding import (gather_params, shard_params,
                                           train_specs)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.tree import map_with_path

    cfg = train_mesh_config(arch, torch.float32)
    api = build_model(cfg)
    view, coords, whole = lane_view(api, shape, lane)
    mesh = Mesh(shape={"data": view[0], "model": view[1]},
                coords={"data": 0, "model": 0}, groups={})
    like = api.init_specs()
    flat = []
    map_with_path(lambda path, _, s: flat.append(("/".join(path), s)), like,
                  train_specs(cfg, mesh, like))
    files = [Path(tmp, f"shards-{key}-{r}.pt")
             for r in range(TRAIN_MESH_RANKS)]
    shards = [torch.load(f) for f in files]
    for f in files:
        f.unlink()
    gap, where, differ = 0.0, None, []
    for i, (name, spec) in enumerate(flat):
        try:
            gather_params([shards[r][i] for r in whole], spec, mesh)
        except ValueError:               # two holders of a piece differ
            differ.append(name)
        for r, s in enumerate(shards):   # each rank's own shard
            mine = dataclasses.replace(mesh, coords=coords[r])
            g = float((s[i] - shard_params(final[i], spec, mine)).abs().max())
            if g > gap:
                gap, where = g, name
    out = {"param_abs_gap": gap, "param_abs_gap_leaf": where,
           "params_compared": len(flat),
           "leaves_whose_copies_differ": differ}
    if len(whole) < len(shards):         # every pod holds the whole tree
        out["pods_bitwise_equal"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for r in whole for a, b in zip(shards[r],
                                           shards[r + len(whole)]))
    return out


def train_mesh_compare(refs: dict, ranks: list, params: dict,
                       lanes=TRAIN_MESH_LANES) -> dict:
    """(a) against the ranks of each lane: float32 losses and grad norms
    (relative gaps), an MoE's dropped picks a step (summed over the data
    ranks: the ranks of one data rank route alike) and the params'
    readings (``params``: ``train_mesh_param_gaps`` by lane); bf16
    losses.  ``ranks``: every rank's record."""
    out = {}
    for arch, shape, lane in lanes:
        key = train_lane_key(arch, shape, lane)
        recs = [r["lanes"][key] for r in ranks]
        # (a)'s float32 steps are the reference of every float32 lane
        ref = refs[f"{arch} bfloat16" if lane == "bfloat16"
                   else f"{arch} float32"]
        model = TRAIN_MESH_MODELS[arch]
        res = {"arch": arch, "layers": model.layers,
               "microbatches": model.microbatches, "seq_len": model.seq,
               "mesh": list(shape), "lane": lane,
               "loss": recs[0]["loss"], "reference_loss": ref["loss"],
               "loss_rel_gap": max(abs(a / b - 1) for a, b in
                                   zip(recs[0]["loss"], ref["loss"])),
               "losses_equal_on_every_rank": all(
                   r["loss"] == recs[0]["loss"] for r in recs),
               "finite": all(math.isfinite(x) for r in recs
                             for x in r["loss"]),
               "step_s": [r["step_s"] for r in recs],
               "step_s_median_2_3": statistics.median(
                   recs[0]["step_s"][1:]),
               "tokens_per_s": TRAIN_MESH_BATCH * model.seq
               / statistics.median(recs[0]["step_s"][1:]),
               "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in recs],
               "seconds_by_rank": [r["seconds"] for r in recs]}
        if lane == "bfloat16":
            res["reference_step_s"] = ref["step_s"]
            res["reference_peak_mem_gb"] = ref["peak_mem_gb"]
            res["launches_by_rank"] = [r["launches"] for r in recs]
            out[key] = res
            continue
        res["grad_norm"] = recs[0]["grad_norm"]
        res["reference_grad_norm"] = ref["grad_norm"]
        res["grad_norm_rel_gap"] = max(abs(a / b - 1) for a, b in zip(
            recs[0]["grad_norm"], ref["grad_norm"]))
        res["launches_by_step"] = [r["launches"] for r in recs]
        res["dropped"] = [sum(r["dropped"][s] for r in recs
                              if r["coords"]["model"] == 0)
                          for s in range(TRAIN_MESH_STEPS)]
        res["reference_dropped"] = ref["dropped"]
        res["route_flips_by_rank"] = [r["route_flips"] for r in recs]
        res.update(params[key])
        if lane == "int8":
            res["step1_loss_rel_gap"] = abs(
                recs[0]["loss"][0] / ref["loss"][0] - 1)
            for k in ("ef_identity_gap", "ef_identity_bound",
                      "ef_collapsed_gap", "world_norm_rel_gap"):
                res[f"{k}_by_rank"] = [r[k] for r in recs]
            res["codec_ms_by_rank"] = [r["codec_ms"] for r in recs]
            res["codec_share_of_step"] = [
                sum(r["codec_ms"][1:]) / 1e3 / sum(r["step_s"][1:])
                for r in recs]
        out[key] = res
    return out


def check_train_mesh(res: dict) -> None:
    """Phase 19's gates: every lane finite, the same losses on every
    rank; each float32 lane within ``TRAIN_MESH_TOL`` of the unsharded
    step, the copies of every piece bitwise equal, an MoE's dropped picks
    a step above zero and the unsharded step's; every rank's flash (and
    Mamba2's SSD) launches a float32 step the expected ones."""
    for key, r in res.items():
        assert r["finite"] and r["losses_equal_on_every_rank"], (key, r)
        if r["lane"] == "bfloat16":
            continue
        for k, bound in (POD_TOL if r["lane"] == "int8"
                         else TRAIN_MESH_TOL).items():
            assert r[k] <= bound, (key, k, r[k], bound)
        assert not r["leaves_whose_copies_differ"], (key, r)
        if r["lane"] == "int8":
            # step 1's loss is taken before the codec has changed a param
            assert r["step1_loss_rel_gap"] <= \
                TRAIN_MESH_TOL["loss_rel_gap"], (key, r)
            assert r["pods_bitwise_equal"], (key, r)
            for gap, bound, collapsed, world in zip(
                    r["ef_identity_gap_by_rank"],
                    r["ef_identity_bound_by_rank"],
                    r["ef_collapsed_gap_by_rank"],
                    r["world_norm_rel_gap_by_rank"]):
                assert gap <= bound < collapsed, (key, r)
                assert world > POD_TOL["grad_norm_rel_gap"], (key, r)
        if TRAIN_MESH_MODELS[r["arch"]].router_scale is not None:
            assert r["dropped"] == r["reference_dropped"], (key, r)
            assert all(n > 0 for n in r["dropped"]), (key, r)
        want = train_mesh_expected(r["arch"])
        for per_rank in r["launches_by_step"]:
            for launches in per_rank:
                assert {k: launches.get(k, 0) for k in want} == want, \
                    (key, launches)


def phase19(card: str, entry=None, lanes=TRAIN_MESH_LANES) -> dict:
    """Phase 19: the ranks spawned first (their start-up and gloo probe
    beside (a)), then (a), then the comparison, logged, then gated (not
    with ``entry``: ``tools/mesh_gate.py``'s broken copies)."""
    import tempfile
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(entry or _train_mesh_rank_entry,
                                 args=(TRAIN_MESH_RANKS, tmp, lanes),
                                 nprocs=TRAIN_MESH_RANKS, join=False,
                                 start_method="spawn")
        pending = {train_lane_key(*x): x for x in lanes
                   if x[2] != "bfloat16"}
        params = {}

        def compare_done() -> None:
            """Each float32 lane whose shards are all written, compared
            while the ranks run the later lanes."""
            for key, (arch, shape, lane) in list(pending.items()):
                if all(Path(tmp, f"shards-{key}-{r}.pt").exists()
                       for r in range(TRAIN_MESH_RANKS)):
                    params[key] = train_mesh_param_gaps(
                        tmp, arch, shape, key, finals[arch], lane)
                    del pending[key]
                    if all(a != arch for a, _, _ in pending.values()):
                        del finals[arch]

        try:
            refs, finals = train_mesh_reference(tmp, lanes)
            log("phase19 (a)", json.dumps({"card": card, **refs}))
            deadline = t0 + TRAIN_MESH_TIMEOUT
            while not ctx.join(timeout=2):
                compare_done()
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"phase 19 (b): the ranks ran past "
                                       f"{TRAIN_MESH_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        log(f"phase19 (b) seconds {time.perf_counter() - t0:.1f} "
            "(from the spawn)")
        compare_done()
        ranks = [json.loads(Path(tmp, f"rank-{r}.json").read_text())
                 for r in range(TRAIN_MESH_RANKS)]
        res = train_mesh_compare(refs, ranks, params, lanes)
    for key, r in res.items():
        log(f"phase19 (b) {key}", json.dumps({"card": card, **r}))
    if entry is None:
        check_train_mesh(res)
    return {"reference": refs, "lanes": res}


def phase1_cases() -> list:
    """Phase 1: every case, each kernel against its plain version, drawn
    in this order from one generator (seed 0)."""
    rng = np.random.default_rng(0)
    return [
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
        # whisper-large-v3 (phase 14): the cross attention, C=16 (prefill)
        # and C=1 (decode) queries of 8 sequences against their 1500
        # encoder frames, and the encoder's self attention at S=1500, all
        # non-causal with 20 heads over 20 of 64; the decoder's fused self
        # attention at that row (a group of one) on its 28-page table,
        # with contexts of 64-416 tokens as phase 14 serves
        *(flash_case(rng, f"flash Sq={C} Sk={WHISPER_FRAMES} B={B} H=KV=20 "
                     f"D=64 non-causal ({what})", C, Sk=WHISPER_FRAMES,
                     B=B, h=20, kv=20, D=64, causal=False)
          for C, what in ((16, "cross, prefill"), (1, "cross, decode"))),
        flash_case(rng, f"flash S={WHISPER_FRAMES} B={B} H=KV=20 D=64 "
                   "non-causal (encoder)", WHISPER_FRAMES, B=B, h=20, kv=20,
                   D=64, causal=False),
        *(case(rng, C, f"{what} D=64 H=KV=20 C={C}", **WHISPER_HEADS,
               seq=WHISPER_MAX_SEQ,
               starts=lambda r, C=C: r.integers(64, 417 - C, B), **extra)
          for what, case, extra in (("attention", attention_case, {}),
                                    ("fused", fused_case, {"library": True}))
          for C in (16, 1)),
        # phase 15's training shapes
        *train_flash_cases(rng),
        # qwen2-72b's attention on one rank of phase 17's model=4 mesh: 16
        # heads over 2 KV heads of 128 (a group of 8: C x 8 = 128 query
        # rows at C=16)
        *(fused_case(rng, C, f"fused D=128 H=16 KV=2 C={C} (qwen2-72b, a "
                     "rank of model=4)", h=16, kv=2, d=128, library=True)
          for C in (16, 1)),
        # phase 17's other ranks at model=4: grok-1-314b's 12 heads over 2
        # KV heads with its softcap, qwen2-1.5b's 3 heads over a copy of
        # one KV head, and deepseek's latent at 4 heads (C x 4 = 64 query
        # rows at C=16); phase 18's starcoder2-7b, 36 heads over 4 (a
        # group of 9: 144 query rows at C=16) under its 4096 window
        *(fused_case(rng, C, f"fused D=128 H=12 KV=2 C={C} softcap=30 "
                     "(grok-1-314b, a rank of model=4)", h=12, kv=2, d=128,
                     softcap=30.0, library=True)
          for C in (16, 1)),
        *(fused_case(rng, C, f"fused D=128 H=3 KV=1 C={C} (qwen2-1.5b, a "
                     "rank of model=4)", h=3, kv=1, d=128, library=True)
          for C in (16, 1)),
        *(attention_case(rng, C, f"attention D=576 H=4 C={C} bf16 "
                         "(deepseek-v2-lite-16b, a rank of model=4)", h=4,
                         kv=1, d=576, alias=True)
          for C in (16, 1)),
        *(fused_case(rng, C, f"fused D=128 H=36 KV=4 C={C} window=4096 "
                     "(starcoder2-7b)", h=36, kv=4, d=128, window=4096,
                     library=True)
          for C in (16, 1)),
        *state_mesh_cases(rng),
        *train_mesh_flash_cases(rng),
        *ssd_mesh_cases(rng),
    ]


def train_mesh_flash_cases(rng) -> list:
    """Phase 19's flash shapes, forward and backward, each against its
    plain version: a rank of qwen2-1.5b's (2, 2) mesh (6 heads over 1 KV
    head, one sequence of 1024 a microbatch) in float32 and bf16 and of
    its (1, 4) mesh (3 heads over a copied KV head, two sequences) in
    float32; a rank of minitron-8b's (1, 4) mesh in
    ``tools/mesh_train.py`` (8 heads over 2, S=4096, bf16); a rank of
    deepseek-v2-lite-16b's (2, 2) mesh (MLA: 8 heads, Q/K 192 beside V
    128, which the op pads) in float32 and bf16; and, in float32, a rank
    of recurrentgemma-9b's (1, 4) mesh (4 heads over a copied KV head of
    256, window 2048, one sequence a microbatch), of whisper-large-v3's
    (2, 2) mesh (10 heads over 10 of 64: the encoder at 1500 frames, the
    decoder's self attention at 448 tokens and its cross attention
    against the 1500 frames) and of internvl2-1b's (2, 2) mesh (7 heads
    over 1 of 64, 256 patches and 1024 tokens)."""
    s = TRAIN_MESH_S
    f32 = dict(dtype=torch.float32)
    cases = []
    for case, tag in ((flash_case, "flash"), (flash_bwd_case, "flash bwd")):
        cases += [
            case(rng, f"{tag} S={s} D=128 H=6 KV=1 float32 (qwen2-1.5b, a "
                 "rank of (2, 2))", s, h=6, kv=1, dtype=torch.float32),
            case(rng, f"{tag} S={s} D=128 H=6 KV=1 (qwen2-1.5b, a rank of "
                 "(2, 2))", s, h=6, kv=1),
            case(rng, f"{tag} S={s} B=2 D=128 H=3 KV=1 float32 (qwen2-1.5b, "
                 "a rank of (1, 4))", s, B=2, h=3, kv=1,
                 dtype=torch.float32),
            case(rng, f"{tag} S={TRAIN_S} D=128 H=8 KV=2 (minitron-8b, a "
                 "rank of (1, 4))", TRAIN_S, h=8, kv=2)]
        for dtype, name in ((torch.float32, " float32"), (torch.bfloat16,
                                                          "")):
            cases.append(case(
                rng, f"{tag} S={s} causal D=192 Dv=128 H=KV=8{name} "
                "(deepseek-v2-lite-16b, a rank of (2, 2))", s, h=8, kv=8,
                D=192, Dv=128, dtype=dtype))
        w, f = WHISPER_MAX_SEQ, WHISPER_FRAMES
        cases += [
            case(rng, f"{tag} S={s} D=256 H=4 KV=1 window={RG_WINDOW} "
                 "float32 (recurrentgemma-9b, a rank of (1, 4))", s, h=4,
                 kv=1, D=256, window=RG_WINDOW, **f32),
            case(rng, f"{tag} S={f} D=64 H=KV=10 non-causal float32 "
                 "(whisper-large-v3 encoder, a rank of (2, 2))", f, h=10,
                 kv=10, D=64, causal=False, **f32),
            case(rng, f"{tag} S={w} D=64 H=KV=10 float32 (whisper-large-v3 "
                 "decoder, a rank of (2, 2))", w, h=10, kv=10, D=64, **f32),
            case(rng, f"{tag} Sq={w} Sk={f} D=64 H=KV=10 non-causal float32 "
                 "(whisper-large-v3 cross, a rank of (2, 2))", w, Sk=f,
                 h=10, kv=10, D=64, causal=False, **f32),
            case(rng, f"{tag} S={s + 256} D=64 H=7 KV=1 float32 "
                 "(internvl2-1b, a rank of (2, 2))", s + 256, h=7, kv=1,
                 D=64, **f32)]
    return cases


# a rank of mamba2-1.3b's (2, 2) mesh in phase 19: one sequence of 1024
# tokens a microbatch (4 chunks of 256), 32 of its 64 SSD heads
SSD_MESH_RANK = dict(Bp=4, L=256, H=32, P=64, N=128)


def ssd_mesh_cases(rng) -> list:
    """``ssd_chunk`` forward and backward at a rank's heads of phase 19's
    Mamba2 lane, each against its plain version."""
    return [ssd_case(rng, "ssd B'=4 L=256 H=32 float32 (mamba2-1.3b, a "
                     "rank of (2, 2))", **SSD_MESH_RANK),
            ssd_bwd_case(rng, "ssd bwd B'=4 L=256 H=32 float32 "
                         "(mamba2-1.3b, a rank of (2, 2))", **SSD_MESH_RANK)]


def state_mesh_cases(rng) -> list:
    """Phase 17's ranks of the other families, each at a rank's shape:
    recurrentgemma-9b's attention at model=4 (4 heads over a copy of the
    one KV head of 256, window 2048, the served chunk of 8 and decode,
    past the window), whisper-large-v3's self attention (5 heads over 5
    of 64) and cross attention (5 heads against 1500 frames, B=8, C=16
    and 1) at model=4, and internvl2-1b's attention at model=2 (7 heads
    over 1 of 64)."""
    past = lambda r, C: r.integers(RG_WINDOW - 8, RG_SEQ - C + 1, B)
    return [
        *(fused_case(rng, C, f"fused D=256 H=4 KV=1 C={C} window=2048 "
                     "(recurrentgemma-9b, a rank of model=4)", h=4, kv=1,
                     d=256, window=RG_WINDOW, seq=RG_SEQ,
                     starts=lambda r, C=C: past(r, C), library=True)
          for C in (RG_CHUNK, 1)),
        *(fused_case(rng, C, f"fused D=64 H=KV=5 C={C} (whisper-large-v3, "
                     "a rank of model=4)", h=5, kv=5, d=64,
                     seq=WHISPER_MAX_SEQ,
                     starts=lambda r, C=C: r.integers(64, 417 - C, B),
                     library=True)
          for C in (16, 1)),
        *(flash_case(rng, f"flash Sq={C} Sk={WHISPER_FRAMES} B={B} H=KV=5 "
                     "D=64 non-causal (whisper-large-v3 cross, a rank of "
                     "model=4)", C, Sk=WHISPER_FRAMES, B=B, h=5, kv=5, D=64,
                     causal=False)
          for C in (16, 1)),
        *(fused_case(rng, C, f"fused D=64 H=7 KV=1 C={C} (internvl2-1b, a "
                     "rank of model=2)", h=7, kv=1, d=64, library=True)
          for C in (16, 1)),
    ]


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

    cases = phase1_cases()
    for c in cases:
        log("phase1", json.dumps(c))
    log(f"phase1 seconds {time.perf_counter() - t0:.1f} (build included)")
    log("phase1 V pad", json.dumps([
        {k: c[k] for k in ("case", "ms", "pad_ms", "pad_ms_call")}
        for c in cases if "pad_ms" in c]))

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

    t14 = time.perf_counter()
    log(f"phase14 starts at {t14 - t_script:.1f} s")
    whisper = encdec_serving(get_config("whisper-large-v3"))
    log("phase14 (a) whisper", json.dumps(
        {"card": card, **{k: v for k, v in whisper.items()
                          if k not in ("path_vs_plain", "profile")}}))
    log("phase14 (b) whisper kernel vs plain", json.dumps(
        {"card": card, **whisper["path_vs_plain"]}))
    log("phase14 (c) whisper profile", json.dumps(
        {"card": card, **whisper["profile"]}))
    log(f"phase14 seconds {time.perf_counter() - t14:.1f}")

    t15 = time.perf_counter()
    log(f"phase15 starts at {t15 - t_script:.1f} s")
    families = phase15(card)
    log(f"phase15 seconds {time.perf_counter() - t15:.1f}")

    t16 = time.perf_counter()
    log(f"phase16 starts at {t16 - t_script:.1f} s")
    pods = phase16(card)
    log(f"phase16 seconds {time.perf_counter() - t16:.1f}")

    t17 = time.perf_counter()
    log(f"phase17 starts at {t17 - t_script:.1f} s")
    meshes = phase17(card)
    log(f"phase17 seconds {time.perf_counter() - t17:.1f}")

    t18 = time.perf_counter()
    log(f"phase18 starts at {t18 - t_script:.1f} s")
    sweep = {}
    for arch in SWEEP_ARCHS:
        sweep[arch] = smoke_sweep(arch)
        log(f"phase18 {arch}", json.dumps({"card": card, **sweep[arch]}))
    log(f"phase18 seconds {time.perf_counter() - t18:.1f}")

    t19 = time.perf_counter()
    log(f"phase19 starts at {t19 - t_script:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    mesh_train = phase19(card)["lanes"]
    log(f"phase19 seconds {time.perf_counter() - t19:.1f}")

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
    for tag, case, prefix, res, phase in (
            ("D=256 MQA, window 2048", f"fused D=256 MQA C={RG_CHUNK} "
             "window=2048 past the window", "D=256 MQA", rg, 13),
            ("D=64, 14 heads over 2", "fused D=64 H=14 KV=2 C=16",
             "D=64 H=14", vlm, 13),
            ("D=64, 20 heads over 20", "fused D=64 H=KV=20 C=16",
             "D=64 H=KV=20", whisper, 14)):
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
            "path": f"phase {phase}: {res['arch']} serving",
            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "call_ms": c["ms_call"], "timing": c["ms_timing"],
            "cases": [{k: x.get(k) for k in (
                "case", "C", "splits", "ms", "unfused_ms", "bound_ms",
                "bound_by", "plain_ms", "library_ms", "max_abs_err",
                "bitwise_vs_unfused")}
                for x in by.values() if prefix in x["case"]]})
    # the flash forward on phase 14's serve path: the cross attention,
    # once a decoder layer and step (the encoder's self attention runs
    # outside the step, 32 launches an encode)
    c = by[f"flash Sq=16 Sk={WHISPER_FRAMES} B={B} H=KV=20 D=64 non-causal "
           "(cross, prefill)"]
    kernels.append({
        "name": "flash_attention (cross attention, whisper)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
        "launches": whisper["serve"]["launches"]["flash_attention"],
        "launches_by_chunk": {
            k: n * whisper["attention_layers"]
            for k, n in whisper["serve"]["steps_by_chunk"].items()},
        "path": f"phase 14: {whisper['arch']} serving",
        **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")},
        "call_ms": c["ms_call"], "timing": c["ms_timing"],
        "cases": [{k: x.get(k) for k in (
            "case", "S", "Sk", "ms", "bound_ms", "bound_by", "plain_ms",
            "library_ms", "ms_over_library", "max_abs_err")}
            for x in by.values() if "H=KV=20" in x["case"]
            and x["case"].startswith("flash S")]})
    # the flash forward and backward on phase 15's training paths, each
    # family beside its phase-1 case
    shape_of = {
        "deepseek-v2-lite-16b": "S=4096 causal D=192 Dv=128 H=KV=16 (MLA)",
        "recurrentgemma-9b": "S=4096 D=256 H=16 KV=1 window=2048 "
                             "(recurrentgemma)",
        "internvl2-1b": "S=4352 D=64 H=14 KV=2 (internvl2)",
        "whisper-large-v3": f"Sq={WHISPER_MAX_SEQ} Sk={WHISPER_FRAMES} "
                            f"B={TRAIN_BATCH} H=KV=20 D=64 non-causal "
                            "(whisper cross)"}
    for arch, res in families.items():
        for name, case, src in (
                ("flash_attention", f"flash {shape_of[arch]}",
                 "src/repro_torch/kernels/csrc/flash_attention.cu"),
                ("flash_attention_bwd", f"flash bwd {shape_of[arch]}",
                 "src/repro_torch/kernels/csrc/flash_attention_bwd.cu")):
            c = by[case]
            kernels.append({
                "name": f"{name} ({arch} training)", "route": "cuda",
                "source": src,
                "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
                "launches": res["train"]["launches"][name],
                "path": f"phase 15: {arch} training",
                **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
                "call_ms": c["ms_call"], "timing": c["ms_timing"],
                **({"pad_ms": c["pad_ms"]} if "pad_ms" in c else {})})
    # the flash forward and backward on phase 16's path: (a)'s train steps
    # through every codec over a one-rank group (phase 4's shape)
    runs = pods["one_rank"]["runs"]
    for name, case, src in (
            ("flash_attention", "flash S=4096 causal",
             "src/repro_torch/kernels/csrc/flash_attention.cu"),
            ("flash_attention_bwd", "flash bwd S=4096 causal",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu")):
        c = by[case]
        kernels.append({
            "name": f"{name} (qwen2-1.5b, compressed reduction)",
            "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
            "launches": sum(r["launches"][name] for r in runs.values()),
            "launches_by_codec": {k: r["launches"][name]
                                  for k, r in runs.items()},
            "launches_two_ranks": [r["runs"][k]["launches"][name]
                                   for r in pods["two_ranks"]["ranks"]
                                   for k in r["runs"]],
            "path": "phase 16: qwen2-1.5b training, one rank, codecs "
                    + ", ".join(runs),
            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
            "call_ms": c["ms_call"], "timing": c["ms_timing"]})
    # the flash forward and backward (Mamba2's SSD op) on phase 19's
    # path: every rank of each arch's lanes, every step, at a rank's
    # phase-1 shape (whisper's: the cross attention's)
    s19 = TRAIN_MESH_S
    flash_pair = (("flash_attention", "flash ",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:92"),
                  ("flash_attention_bwd", "flash bwd ",
                   "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention/kernel.py:92"))
    ssd_pair = (("ssd_chunk", "ssd ",
                 "src/repro_torch/kernels/csrc/ssd_chunk.cu",
                 "src/repro/kernels/ssd_chunk/kernel.py:50"),
                ("ssd_chunk_bwd", "ssd bwd ",
                 "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
                 "src/repro/kernels/ssd_chunk/kernel.py:50"))
    for arch, case, pair in (
            ("qwen2-1.5b", f"S={s19} D=128 H=6 KV=1 float32 "
                           "(qwen2-1.5b, a rank of (2, 2))", flash_pair),
            ("deepseek-v2-lite-16b",
             f"S={s19} causal D=192 Dv=128 H=KV=8 float32 "
             "(deepseek-v2-lite-16b, a rank of (2, 2))", flash_pair),
            ("recurrentgemma-9b", f"S={s19} D=256 H=4 KV=1 window="
             f"{RG_WINDOW} float32 (recurrentgemma-9b, a rank of (1, 4))",
             flash_pair),
            ("mamba2-1.3b", "B'=4 L=256 H=32 float32 (mamba2-1.3b, a rank "
             "of (2, 2))", ssd_pair),
            ("whisper-large-v3", f"Sq={WHISPER_MAX_SEQ} Sk={WHISPER_FRAMES} "
             "D=64 H=KV=10 non-causal float32 (whisper-large-v3 cross, a "
             "rank of (2, 2))", flash_pair),
            ("internvl2-1b", f"S={s19 + 256} D=64 H=7 KV=1 float32 "
             "(internvl2-1b, a rank of (2, 2))", flash_pair)):
        lanes = {k: r for k, r in mesh_train.items() if r["arch"] == arch}
        if not lanes:
            continue
        for name, tag, src, replaces in pair:
            c = by[f"{tag}{case}"]
            by_lane = {k: sum(n.get(name, 0) for per_rank in r.get(
                "launches_by_step", [r.get("launches_by_rank", [])])
                for n in per_rank) for k, r in lanes.items()}
            kernels.append({
                "name": f"{name} ({arch}, mesh training)", "route": "cuda",
                "source": src, "replaces": replaces,
                "launches": sum(by_lane.values()),
                "launches_by_lane": by_lane,
                "path": f"phase 19: {arch} on four gloo ranks, "
                        + ", ".join(lanes),
                **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
                "call_ms": c["ms_call"], "timing": c["ms_timing"],
                **({"pad_ms": c["pad_ms"]} if "pad_ms" in c else {})})
    # the fused op on phase 17's path: every rank of the (1, 4) mesh, one
    # launch a layer a step in each lane, at its per-rank shape
    c = by["fused D=128 H=16 KV=2 C=16 (qwen2-72b, a rank of model=4)"]
    tp = meshes["meshes"][0]
    tp_runs = [lane_key(lane, v) for shape, lane, v in MESH_MODELS[0].runs
               if shape == (1, 4)]
    kernels.append({
        "name": "paged_attention_append_chunk (qwen2-72b, a rank of the "
                "(1, 4) mesh)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/kv_append/kernel.py:38 + "
                    "src/repro/kernels/paged_attention/kernel.py:96",
        "launches": sum(r[lane]["launches"]["paged_attention_append_chunk"]
                        for r in tp["ranks"] for lane in tp_runs),
        "launches_by_rank": [
            {lane: r[lane]["launches"]["paged_attention_append_chunk"]
             for lane in tp_runs} for r in tp["ranks"]],
        "path": "phase 17: qwen2-72b mesh serving, 4 gloo ranks",
        **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")},
        "call_ms": c["ms_call"], "timing": c["ms_timing"],
        "cases": [{k: x.get(k) for k in (
            "case", "C", "splits", "ms", "unfused_ms", "bound_ms",
            "bound_by", "plain_ms", "library_ms", "max_abs_err",
            "bitwise_vs_unfused")}
            for x in by.values() if "qwen2-72b" in x["case"]]})
    # the attention's kernels on phase 17's other ranks, each at a rank's
    # shape: every rank of every mesh of the model, every run
    for key, op, case, prefix, tag in (
            ("grok-1-314b", "paged_attention_append_chunk",
             "fused D=128 H=12 KV=2 C=16 softcap=30 (grok-1-314b, a rank "
             "of model=4)", "(grok-1-314b, a rank", "12 heads over 2"),
            ("qwen2-1.5b", "paged_attention_append_chunk",
             "fused D=128 H=3 KV=1 C=16 (qwen2-1.5b, a rank of model=4)",
             "(qwen2-1.5b, a rank", "3 heads over a copied KV head"),
            ("deepseek-v2-lite-16b", "paged_attention_chunk",
             "attention D=576 H=4 C=16 bf16 (deepseek-v2-lite-16b, a rank "
             "of model=4)", "(deepseek-v2-lite-16b, a rank",
             "D=576, MLA, 4 heads"),
            ("deepseek-v2-lite-16b", "kv_append_chunk", "kv_append D=576 "
             "C=16", "kv_append D=576", "D=576, MLA, the replicated latent"),
            ("recurrentgemma-9b", "paged_attention_append_chunk",
             "fused D=256 H=4 KV=1 C=8 window=2048 (recurrentgemma-9b, a "
             "rank of model=4)", "(recurrentgemma-9b, a rank",
             "D=256, 4 heads over a copied KV head, window 2048"),
            ("whisper-large-v3", "paged_attention_append_chunk",
             "fused D=64 H=KV=5 C=16 (whisper-large-v3, a rank of model=4)",
             "(whisper-large-v3, a rank", "5 heads over 5"),
            ("whisper-large-v3", "flash_attention",
             f"flash Sq=16 Sk={WHISPER_FRAMES} B={B} H=KV=5 D=64 non-causal "
             "(whisper-large-v3 cross, a rank of model=4)",
             "(whisper-large-v3 cross, a rank",
             "cross attention, 5 heads against 1500 frames"),
            ("internvl2-1b", "paged_attention_append_chunk",
             "fused D=64 H=7 KV=1 C=16 (internvl2-1b, a rank of model=2)",
             "(internvl2-1b, a rank", "7 heads over 1")):
        c = by[case]
        units = [u for u in meshes["meshes"]
                 if u["model"].startswith(key)]
        by_run = {f"{u['model']} {u['mesh'][0]}x{u['mesh'][1]} {k} rank "
                  f"{r['rank']}": r[k]["launches"][op]
                  for u in units for r in u["ranks"]
                  for k in r if isinstance(r[k], dict)
                  and "launches" in r[k]}
        kernels.append({
            "name": f"{op} ({key}, {tag}, a rank of phase 17's meshes)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + {
                "kv_append_chunk": "kv_append.cu",
                "flash_attention": "flash_attention.cu"}.get(
                    op, "paged_attention.cu"),
            "replaces": {
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:92",
                "kv_append_chunk": "src/repro/kernels/kv_append/kernel.py:38",
                "paged_attention_chunk":
                    "src/repro/kernels/paged_attention/kernel.py:96",
                "paged_attention_append_chunk":
                    "src/repro/kernels/kv_append/kernel.py:38 + "
                    "src/repro/kernels/paged_attention/kernel.py:96"}[op],
            "launches": sum(by_run.values()), "launches_by_run": by_run,
            "path": f"phase 17: {key} mesh serving, 4 gloo ranks",
            **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
            "call_ms": c["ms_call"], "timing": c["ms_timing"],
            "cases": [{k: x.get(k) for k in (
                "case", "C", "splits", "ms", "unfused_ms", "bound_ms",
                "bound_by", "plain_ms", "library_ms", "max_abs_err",
                "bitwise_vs_unfused")}
                for x in by.values() if prefix in x["case"]]})
    # the fused op on phase 18's starcoder2-7b: 36 heads over 4
    c = by["fused D=128 H=36 KV=4 C=16 window=4096 (starcoder2-7b)"]
    kernels.append({
        "name": "paged_attention_append_chunk (starcoder2-7b, 36 heads over "
                "4)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/kv_append/kernel.py:38 + "
                    "src/repro/kernels/paged_attention/kernel.py:96",
        "launches": sweep["starcoder2-7b"]["launches"][
            "paged_attention_append_chunk"],
        "launches_minitron_8b": sweep["minitron-8b"]["launches"][
            "paged_attention_append_chunk"],
        "path": "phase 18: starcoder2-7b kernel path against plain path",
        **{k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms")},
        "call_ms": c["ms_call"], "timing": c["ms_timing"],
        "cases": [{k: x.get(k) for k in (
            "case", "C", "splits", "ms", "unfused_ms", "bound_ms",
            "bound_by", "plain_ms", "library_ms", "max_abs_err",
            "bitwise_vs_unfused")}
            for x in by.values() if "(starcoder2-7b)" in x["case"]]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
