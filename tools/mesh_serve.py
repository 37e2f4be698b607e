#!/usr/bin/env python3
"""A model at full width served by the mesh serve step over NCCL, one
rank a card.

    torchrun --standalone --nproc-per-node 4 tools/mesh_serve.py \
        [--arch qwen2-72b] [--layers N] [--mesh DxM] [--variant gspmd] \
        [--new 32] [--out build/mesh_serve.json]

Each rank holds its shard of the model's bf16 weights (at model=4:
qwen2-72b's quarter of the heads, KV heads, FFN and vocabulary, 36.4 GB
of its 145.4 GB; grok-1-314b's 12 heads over 2 KV heads and 2 of its 8
experts, ~2.46 GB a layer; deepseek-v2-lite-16b's 4 heads, the whole
latent, 16 of its 64 experts and a quarter of the shared experts;
mamba2-1.3b's 16 SSD heads with the whole B and C; recurrentgemma-9b's
1024 LRU channels and 4 heads over a copy of the KV head;
whisper-large-v3's 5 heads of the decoder), drawn on its own card from
a seed a leaf, a block and a layer (a block the mesh leaves whole, or
copies, is drawn alike on every rank that holds it; a stacked leaf is
drawn a layer at a time, so no float32 copy of a whole leaf is made; a
leaf with whole segments beside split ones, Mamba2's ``in_proj`` and
conv, is drawn whole from its seed on every rank and sliced), and
serves ``chip_smoke.py`` phase 2's geometry through
``repro_torch.serve.step.make_serve_step`` on a ("data", "model") mesh
of ``--mesh`` (default ``1 x world``): 8 prompts of 64-480 tokens
(whisper: 64-384 in slots of 448, after each rank writes its own heads'
cross K/V of random encoder states of its rows, 1500 frames) in chunks
of 16 (each data shard its own rows), then ``--new`` greedy decode
steps.  Logged: each card's name and power limit
(``nvidia-smi``), the init's seconds, prefill and decode step times
(host clock, synchronized), output tokens/s, each rank's peak memory and
kernel launches (the attention's, once a layer a step), whether the
ranks of each data shard picked the same tokens (the gathered logits
are the same on them), and a CUPTI window over ``PROFILE_STEPS`` more
decode steps: each rank's device busy time against its host's wall time
(the idle share), the attention's and NCCL's kernel time a step.  Rank 0
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
from repro_torch.dist.sharding import (Segments, shard_block,  # noqa: E402
                                       shard_params)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, init_params  # noqa: E402
from repro_torch.models.spec import init_std, stays_float32  # noqa: E402
from repro_torch.serve.step import make_serve_step  # noqa: E402
from repro_torch.tree import leaves, map_with_path  # noqa: E402

PROFILE_STEPS = 4                    # decode steps in the CUPTI window


def local_params(api, pspecs, mesh, dtype, seed: int = 0) -> dict:
    """This rank's block of each leaf, drawn at its own shape on the card
    (the global leaf never exists) by ``init_params`` at the whole leaf's
    scale (``init_std``), from a generator seeded by the leaf's index,
    this rank's block of it and, for a leaf stacked over layers, the
    layer (drawn one at a time into the block), so a block the mesh
    leaves whole or copies is drawn alike on every rank that holds it."""
    gen = torch.Generator(device="cuda")
    index = itertools.count()

    def draw(path, spec, pspec):
        shape, block = shard_block(spec.shape, pspec, mesh)
        base = seed + 1000 * next(index) + block
        out = spec.dtype if stays_float32(path) else dtype
        if any(isinstance(e, Segments) for e in pspec):
            gen.manual_seed(base - block)       # the same on every rank
            return shard_params(init_params(spec, gen, dtype=out), pspec,
                                mesh)
        if spec.logical[0] != "layers" or spec.init != "normal":
            gen.manual_seed(base)
            local = dataclasses.replace(spec, shape=shape,
                                        scale=init_std(spec))
            return init_params(local, gen, dtype=out)
        full = torch.empty(shape, dtype=out, device="cuda")
        layer = dataclasses.replace(spec, shape=shape[1:],
                                    logical=spec.logical[1:],
                                    scale=init_std(spec))
        for i in range(shape[0]):
            gen.manual_seed(base * 1000 + i)
            full[i].copy_(init_params(layer, gen, dtype=out))
        return full

    return map_with_path(draw, api.init_specs(), pspecs)


def profile_decode(step, params, last: dict, steps: int, ops: dict) -> dict:
    """A CUPTI window over ``steps`` greedy decode steps after the run
    (``chip_smoke.profiled_window``: device busy time, the union of kernel
    and copy intervals, against the host's wall time), with the ``ops``
    kernels and NCCL's apart.  ``last`` holds the run's last caches and
    logits; every rank runs it (the steps' collectives)."""
    n_new = torch.ones(last["logits"].shape[0], dtype=torch.int32,
                       device="cuda")

    def decode():
        tok = last["logits"][:, -1].argmax(-1).to(torch.int32)[:, None]
        last["logits"], last["caches"] = step(params, tok, last["caches"],
                                              n_new)

    return cs.profiled_window(decode, steps, {**ops, "nccl": ["nccl"]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--mesh", default=None, help="DxM (default 1xworld)")
    ap.add_argument("--variant", default="gspmd")
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
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = build_model(cfg)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh \
        else (1, world)
    mesh = make_mesh(shape)
    encdec = cfg.family == "encdec"
    max_seq, span = (cs.WHISPER_MAX_SEQ, cs.WHISPER_PROMPTS) if encdec \
        else (cs.MAX_SEQ, cs.PROMPTS)
    caches = api.init_caches(cs.B, max_seq, cs.T, device="cuda")
    step, pspecs, cspecs = make_serve_step(api, mesh, caches,
                                           variant=args.variant)
    caches = shard_params(caches, cspecs, mesh)
    cs.release()
    t0 = time.perf_counter()
    params = local_params(api, pspecs, mesh, cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shard_gb = sum(x.numel() * x.element_size()
                   for x in leaves(params)) / 1e9
    prompts, lengths = cs.mesh_prompts(cfg.vocab, span)
    split = "data" in cspecs["lengths"]
    per = cs.B // (mesh.shape["data"] if split else 1)
    d = mesh.coords["data"] if split else 0
    rows = slice(d * per, (d + 1) * per)
    if encdec:                      # this rank's heads' cross K/V
        from repro_torch.models.encdec import encdec_prefill_cross
        enc = torch.randn((cs.B, cfg.enc_frames, cfg.d_model),
                          generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            caches["cross_k"], caches["cross_v"] = encdec_prefill_cross(
                params, cfg, enc[rows].to("cuda", cfg.dtype))
        del enc
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    last: dict = {}

    def kept(*a):
        """``step``, its last caches and logits kept for the profile."""
        last["logits"], last["caches"] = step(*a)
        return last["logits"], last["caches"]

    t0 = time.perf_counter()
    recs = cs.mesh_drive(kept, params, caches, prompts[rows], lengths[rows],
                         new=args.new)
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    ops = {"paged_attention_chunk": ["paged_latent"],
           "kv_append_chunk": ["kv_append"]} if cfg.mla else {
        "paged_attention_append_chunk": ["paged_attention"]} \
        if cs.attn_layers(cfg) else {}
    if encdec:
        ops["flash_attention"] = ["flash"]
    profile = profile_decode(step, params, last, PROFILE_STEPS, ops)
    picks = torch.stack([r["logits"][:, -1].argmax(-1) for r in recs])
    finite = all(bool(torch.isfinite(r["logits"]).all()) for r in recs)
    steps = len(recs)
    mine = {"rank": rank, "coords": mesh.coords, "init_s": init_s,
            "build_s": build_s, "shard_gb": shard_gb,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "finite": finite,
            "launches_ok": launches == cs.step_launches(
                cfg, launches, cs.attn_layers(cfg) * steps),
            "decode_profile": profile,
            "picks": picks.flatten().tolist(),
            **cs.step_ms(recs, prompts.shape[1])}
    every = [None] * world
    dist.all_gather_object(every, mine)
    ok = True
    if rank == 0:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        shards = {}
        for r in every:
            shards.setdefault(r["coords"].get("data", 0), []).append(
                r.pop("picks"))
        out = {"cards": smi, "arch": cfg.name, "layers": cfg.n_layers,
               "mesh": mesh.shape, "variant": args.variant,
               "backend": str(dist.get_backend()),
               "prompt_lengths": lengths.tolist(), "new_tokens": args.new,
               "wall_s": wall,
               "output_tokens_per_s": cs.B * args.new / wall,
               "same_picks_in_each_data_shard": all(
                   all(p == ps[0] for p in ps) for ps in shards.values()),
               "launches_ok": all(r["launches_ok"] for r in every),
               "ranks": every}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
        print(json.dumps(out), flush=True)
        ok = out["same_picks_in_each_data_shard"] and out["launches_ok"] \
            and all(r["finite"] for r in every)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
