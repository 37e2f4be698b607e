#!/usr/bin/env python3
"""A model at full width trained by the mesh train step over NCCL, one
rank a card.

    torchrun --standalone --nproc-per-node 4 tools/mesh_train.py \
        [--arch minitron-8b] [--layers N] [--meshes 2x2,1x4] [--steps 4] \
        [--codec int8|topk|none] [--out build/mesh_train.json]

For each mesh of ``--meshes`` the ranks train ``--arch`` (default
minitron-8b at all 32 layers: ~7.7 G parameters, whose float32 params,
moments and grad buffers, ~123 GB, do not fit one card; grok-1-314b
with ``--layers 2``, 11.45 G; deepseek-v2-lite-16b with ``--layers 20``,
12.12 G: whole experts a model rank, the router and MLA's latent whole
on each; recurrentgemma-9b at all 38 layers, 10.45 G: a model rank's
LRU channels and query heads over a copied KV head; mamba2-1.3b,
whisper-large-v3 (``--layers`` cuts both stacks) and internvl2-1b too)
through
``repro_torch.train.step.make_train_step(mesh=...)``: FSDP over "data",
tensor parallelism over "model", bf16 compute on float32 master params,
remat "full".  Each rank holds its shard of the params (drawn on its own
card from a seed a leaf, a block and a layer, as ``tools/mesh_serve.py``
draws them: the global leaf never exists) and makes its moments on it.
The batch is ``chip_smoke.py`` phase 4's: TRAIN_4K sequences (4096
tokens; whisper's 448 against 1500 frames, internvl2's after 256 patch
embeddings) cut to 4, in microbatches of one sequence a data rank (2 at
(2, 2), 4 at (1, 4)), each data rank its rows of each (``mesh_rows``);
``--steps`` AdamW steps.  Logged: each card's name and power limit
(``nvidia-smi``), the init's seconds and each rank's shard GB, the
losses, trained tokens/s and the median step time of steps 2 to the
last (host clock to the loss on the host), each rank's peak memory and
flash (Mamba2: ``ssd_chunk``) launches a step, and a CUPTI window over
one more step: each rank's device busy time against its host's wall
time (the idle share), the kernels' and NCCL's time.  A mesh of
``--meshes`` may have a pod axis, ``PxDxM``: the pod reduction runs
through ``--codec`` (default int8) on each rank's own buckets, or
uncompressed, where "pod" joins FSDP and the batch (``--codec none``);
each pod takes its rows of the batch (``batch_rows``), and the codec's
time a step (CUDA events around ``bucketed_compressed_psum``) and its
share of the step are logged.  Rank 0 builds the kernels while the
others wait at a barrier; rank 0 writes the summary to ``--out`` after
each mesh (a later mesh that runs out of memory leaves the earlier ones)
and prints it last.  A collective that waits 300 s fails the run.  Needs
a CUDA card a rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mesh_serve import local_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.dist import compression  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamWConfig  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from repro_torch.train.step import (batch_rows, make_train_step,  # noqa: E402
                                    pod_buckets, shard_mesh)
from repro_torch.tree import leaves  # noqa: E402


def seq_len(cfg) -> int:
    """Tokens a sequence: phase 4's, or an encoder-decoder's target
    length (phase 15's)."""
    return cs.WHISPER_MAX_SEQ if cfg.family == "encdec" else cs.TRAIN_S


class CodecTimer:
    """CUDA events around every ``bucketed_compressed_psum`` while it is
    entered: the codec's milliseconds, one entry a step."""

    def __enter__(self):
        self.ms, self.inner = [], compression.bucketed_compressed_psum

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.inner(*a, **kw)
            end.record()
            end.synchronize()
            self.ms.append(start.elapsed_time(end))
            return out

        compression.bucketed_compressed_psum = timed
        return self

    def __exit__(self, *exc):
        compression.bucketed_compressed_psum = self.inner


def train_on(api, shape, steps: int, codec: str) -> dict:
    """One mesh: this rank's shards drawn, ``steps`` timed steps, then a
    profiled one."""
    cfg = api.cfg
    mesh = make_mesh(shape)
    view = shard_mesh(api, mesh, codec)
    # one sequence a data rank: the pods' and data ranks' product
    microbatches = cs.TRAIN_BATCH // (mesh.shape.get("pod", 1)
                                      * mesh.shape["data"])
    step, _, specs = make_train_step(
        api, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps + 1),
        microbatches=microbatches, mesh=mesh, codec=codec)
    cs.release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = local_params(api, specs, view, torch.float32)
    state = {"params": params, "opt": adamw_init(params)}
    if view is mesh.in_pod:
        state["err"] = compression.init_residuals(
            pod_buckets(api, view, specs).plan, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shard_gb = sum(x.numel() * x.element_size() for x in leaves(params)) / 1e9
    take = batch_rows(cs.TRAIN_BATCH, microbatches, mesh, view)
    pipe = TokenPipeline(cfg, global_batch=cs.TRAIN_BATCH,
                         seq_len=seq_len(cfg), seed=0)
    batches = [{k: torch.from_numpy(v[take]).cuda()
                for k, v in pipe.batch_at(i).items()}
               for i in range(steps + 1)]
    box = {"state": state}
    losses, step_s, launches = [], [], []

    def one(batch):
        common.reset_launch_counts()
        box["state"], metrics = step(box["state"], batch)
        losses.append(float(metrics["loss"]))
        launches.append(dict(common.LAUNCHES))

    dist.barrier()
    with CodecTimer() as codec_t:
        for b in batches[:steps]:
            t0 = time.perf_counter()
            one(b)
            step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = cs.profiled_window(lambda: one(batches[steps]), 1, {
        "flash_attention": list(cs.FLASH_KERNELS.values()),
        "flash_attention_bwd": list(cs.FLASH_BWD_KERNELS[torch.bfloat16]),
        "ssd_chunk": list(cs.SSD_FWD_KERNELS),
        "ssd_chunk_bwd": list(cs.SSD_BWD_KERNELS), "nccl": ["nccl"]})
    median = statistics.median(step_s[1:])
    want = cs.train_launches(cfg, microbatches)
    out = {"mesh": dict(mesh.shape), "coords": mesh.coords,
           "microbatches": microbatches, "init_s": init_s,
           "shard_gb": shard_gb, "losses": losses, "step_s": step_s,
           "step_s_median_2_last": median,
           "tokens_per_s": cs.TRAIN_BATCH * seq_len(cfg) / median,
           "peak_mem_gb": peak, "launches_per_step": launches[0],
           "codec": codec if "err" in state else "none",
           "codec_ms": codec_t.ms,
           "codec_share_2_last": sum(codec_t.ms[1:]) / 1e3
           / sum(step_s[1:]) if codec_t.ms else 0.0,
           "launches_ok": all({k: n.get(k, 0) for k in want} == want
                              for n in launches),
           "finite": all(math.isfinite(x) for x in losses),
           "profile": profile}
    del box, state, params, batches
    cs.release()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--meshes", default="2x2,1x4")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--codec", default="int8",
                    choices=compression.CODECS + ("none",),
                    help="the pod reduction's codec on a PxDxM mesh")
    ap.add_argument("--out", default=str(ROOT / "build" / "mesh_train.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_train: needs a CUDA card a rank", file=sys.stderr)
        return 2
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl", timeout=datetime.timedelta(seconds=300))
    rank, world = dist.get_rank(), dist.get_world_size()
    t_start = time.perf_counter()
    if rank == 0:                   # one build; the others load it
        common.library()
    dist.barrier()
    common.library()
    build_s = time.perf_counter() - t_start
    cfg = get_config(args.arch)
    if args.layers:
        stacks = dict(n_enc_layers=args.layers, n_dec_layers=args.layers) \
            if cfg.family == "encdec" else {}
        cfg = dataclasses.replace(cfg, n_layers=args.layers, **stacks)
    api = build_model(cfg)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    out = {"cards": smi, "arch": cfg.name, "layers": cfg.n_layers,
           "params": sum(math.prod(s.shape)
                         for s in leaves(api.init_specs())),
           "seq_len": seq_len(cfg), "batch": cs.TRAIN_BATCH,
           "steps": args.steps, "backend": str(dist.get_backend()),
           "runs": []}
    for text in args.meshes.split(","):
        shape = tuple(int(x) for x in text.split("x"))
        mine = {"rank": rank, "build_s": build_s,
                **train_on(api, shape, args.steps, args.codec)}
        r = [None] * world
        dist.all_gather_object(r, mine)
        out["runs"].append({
            "mesh": r[0]["mesh"], "codec": r[0]["codec"],
            "losses": r[0]["losses"], "tokens_per_s": r[0]["tokens_per_s"],
            "step_s_median_2_last": r[0]["step_s_median_2_last"],
            "same_losses_on_every_rank": all(
                x["losses"] == r[0]["losses"] for x in r),
            "ranks": r})
        if rank == 0:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
    ok = True
    if rank == 0:
        print(json.dumps(out), flush=True)
        ok = all(x["finite"] and x["launches_ok"] for r in out["runs"]
                 for x in r["ranks"]) \
            and all(r["same_losses_on_every_rank"] for r in out["runs"])
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
