#!/usr/bin/env python3
"""qwen2-72b at full width and depth served by the mesh serve step over
NCCL, one rank a card.

    torchrun --standalone --nproc-per-node 4 tools/mesh_serve.py \
        [--layers 80] [--new 32] [--out build/mesh_serve.json]

Each rank holds its shard of qwen2-72b's bf16 weights (a quarter of the
heads, KV heads, FFN and vocabulary at model=4: 36.4 GB of the model's
145.4 GB), drawn on its own card from a seed a leaf and a block (a leaf
the mesh leaves whole is drawn alike on every rank), and serves
``chip_smoke.py`` phase 2's geometry through
``repro_torch.serve.step.make_serve_step`` on ``make_host_mesh()`` (1,
world): 8 prompts of 64-480 tokens in chunks of 16, then ``--new``
greedy decode steps.  Logged: each card's name and power limit
(``nvidia-smi``), the init's seconds, prefill and decode step times
(host clock, synchronized), output tokens/s, each rank's peak memory and
fused launches (one a layer a step), whether every rank picked the
same tokens (the gathered logits are the same on every rank), and a
CUPTI window over ``PROFILE_STEPS`` more decode steps: each rank's
device busy time against its host's wall time (the idle share), the
fused op's and NCCL's kernel time a step.  Rank 0
writes the summary to ``--out`` and prints it last.  Needs a CUDA card a
rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.sharding import shard_block, shard_params  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build_model, init_params  # noqa: E402
from repro_torch.models.spec import init_std, stays_float32  # noqa: E402
from repro_torch.serve.step import make_serve_step  # noqa: E402
from repro_torch.tree import leaves, map_with_path  # noqa: E402

PROFILE_STEPS = 4                    # decode steps in the CUPTI window


def local_params(api, pspecs, mesh, dtype, seed: int = 0) -> dict:
    """This rank's block of each leaf, drawn at its own shape on the card
    (the global leaf never exists) by ``init_params`` at the whole leaf's
    scale (``init_std``), each from a generator seeded by the leaf's index
    and this rank's block of it, so a leaf the mesh leaves whole is drawn
    alike on every rank."""
    gen = torch.Generator(device="cuda")
    index = itertools.count()

    def draw(path, spec, pspec):
        shape, block = shard_block(spec.shape, pspec, mesh)
        gen.manual_seed(seed + 1000 * next(index) + block)
        local = dataclasses.replace(spec, shape=shape, scale=init_std(spec))
        return init_params(local, gen, dtype=spec.dtype
                           if stays_float32(path) else dtype)

    return map_with_path(draw, api.init_specs(), pspecs)


def profile_decode(step, params, last: dict, steps: int) -> dict:
    """A CUPTI window over ``steps`` greedy decode steps after the run
    (``chip_smoke.profiled_window``: device busy time, the union of kernel
    and copy intervals, against the host's wall time), with the fused op's
    and NCCL's kernels apart.  ``last`` holds the run's last caches and
    logits; every rank runs it (the steps' collectives)."""
    n_new = torch.ones(cs.B, dtype=torch.int32, device="cuda")

    def decode():
        tok = last["logits"][:, -1].argmax(-1).to(torch.int32)[:, None]
        last["logits"], last["caches"] = step(params, tok, last["caches"],
                                              n_new)

    return cs.profiled_window(decode, steps, {
        "paged_attention_append_chunk": ["paged_attention"],
        "nccl": ["nccl"]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--out", default=str(ROOT / "build" / "mesh_serve.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_serve: needs a CUDA card a rank", file=sys.stderr)
        return 2
    local_rank = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl")
    rank, world = dist.get_rank(), dist.get_world_size()
    t_start = time.perf_counter()
    if rank == 0:                   # one build; the others load it
        common.library()
    dist.barrier()
    common.library()
    build_s = time.perf_counter() - t_start
    cfg = get_config("qwen2-72b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = build_model(cfg)
    mesh = make_host_mesh()
    caches = api.init_caches(cs.B, cs.MAX_SEQ, cs.T, device="cuda")
    step, pspecs, cspecs = make_serve_step(api, mesh, caches)
    caches = shard_params(caches, cspecs, mesh)
    cs.release()
    t0 = time.perf_counter()
    params = local_params(api, pspecs, mesh, cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shard_gb = sum(x.numel() * x.element_size()
                   for x in leaves(params)) / 1e9
    prompts, lengths = cs.mesh_prompts(cfg.vocab, cs.PROMPTS)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    last: dict = {}

    def kept(*a):
        """``step``, its last caches and logits kept for the profile."""
        last["logits"], last["caches"] = step(*a)
        return last["logits"], last["caches"]

    t0 = time.perf_counter()
    recs = cs.mesh_drive(kept, params, caches, prompts, lengths,
                         new=args.new)
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    profile = profile_decode(step, params, last, PROFILE_STEPS)
    picks = torch.stack([r["logits"][:, -1].argmax(-1) for r in recs])
    finite = all(bool(torch.isfinite(r["logits"]).all()) for r in recs)
    mine = {"rank": rank, "coords": mesh.coords, "init_s": init_s,
            "build_s": build_s, "shard_gb": shard_gb,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "finite": finite,
            "decode_profile": profile,
            "picks_sum": int(picks.sum()),
            **cs.step_ms(recs, prompts.shape[1])}
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        steps = len(recs)
        out = {"cards": smi, "arch": cfg.name, "layers": cfg.n_layers,
               "mesh": mesh.shape, "backend": str(dist.get_backend()),
               "prompt_lengths": lengths.tolist(), "new_tokens": args.new,
               "wall_s": wall,
               "output_tokens_per_s": cs.B * args.new / wall,
               "same_picks_on_every_rank": len({r["picks_sum"]
                                                for r in every}) == 1,
               "fused_launches_ok": all(
                   r["launches"]["paged_attention_append_chunk"]
                   == cfg.n_layers * steps for r in every),
               "ranks": every}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
        print(json.dumps(out), flush=True)
        ok = out["same_picks_on_every_rank"] and out["fused_launches_ok"] \
            and all(r["finite"] for r in every)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if rank != 0 or ok else 1


if __name__ == "__main__":
    sys.exit(main())
