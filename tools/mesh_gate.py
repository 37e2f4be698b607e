#!/usr/bin/env python3
"""chip_smoke.py's phases 17 and 19 (the mesh serve and train steps) on
their own, and what their gates can tell apart.

    python3 tools/mesh_gate.py [--phase17] [--broken] [--broken-moe]
                               [--broken-count] [--broken-state-out]
                               [--broken-norm-gate] [--broken-cross]
                               [--cases] [--phase1] [--windows]
                               [--models KEY,...] [--phase19]
                               [--broken-copies] [--broken-data-mean]
                               [--broken-train-count]
                               [--broken-router-entry]
                               [--broken-latent-entry]
                               [--broken-norm-sum] [--broken-gate-sum]
                               [--broken-bc-entry] [--broken-cross-entry]
                               [--broken-segment-norm] [--noise]
                               [--train-archs ARCH,...] [--pod]
                               [--broken-pod-residuals]
                               [--broken-pod-norm] [--broken-pod-rows]

``--phase17`` runs ``chip_smoke.phase17`` on every model of
``MESH_MODELS`` (or the ``--models`` keys): (a) unsharded in this
process, (b) gloo ranks on the card at each model's meshes, a failing
gate logged with its error.  The broken copies are patched into the
spawned ranks, where the step runs, and each logs, for every rank and
run, the largest logit difference to its reference and the greedy tokens
that differ where the reference's top-2 gap exceeds the noise:

  * ``--broken``: the MLP's all_reduce drops rank 1's partial sum (the
    dense models: qwen2-72b, qwen2-1.5b, internvl2-1b);
  * ``--broken-state-out``: Mamba2's and the RG-LRU's ``out_proj``
    all_reduce drops rank 1's partial sum (mamba2-1.3b,
    recurrentgemma-9b);
  * ``--broken-norm-gate``: Mamba2's gated norm's sum of squares and the
    RG-LRU's gate pre-activations lose rank 1's partials (mamba2-1.3b,
    recurrentgemma-9b);
  * ``--broken-cross``: the cross attention's all_reduce drops rank 1's
    partial sum (whisper-large-v3);
  * ``--broken-moe``: the MoE's all_reduce drops rank 1's partial sum of
    its experts (and shared experts) (grok-1-314b, deepseek-v2-lite-16b);
  * ``--broken-count``: under ``gspmd`` every data shard counts the MoE's
    capacity over its own rows (deepseek-v2-lite-16b), read with router
    column 0 of every layer scaled by ``OVERFLOW_SCALE`` (in (a) and in the
    ranks) so that an expert overflows, beside the correct step on the
    same weights.

``--phase19`` runs ``chip_smoke.phase19`` (the mesh train step on four
gloo ranks against the unsharded step), gated, on the lanes of
``--train-archs`` (default: ``TRAIN_MESH_LANES`` and qwen2-1.5b's
float32 (1, 4) lane, which the script's time left here; internvl2-1b's
lane, ``TRAIN_MESH_GATE_LANES``, runs only when named); its broken
copies, patched into the spawned ranks and logged ungated, give the
readings ``TRAIN_MESH_TOL`` lies below:

  * ``--broken-copies``: a copied KV head's grads are not summed over its
    copy group (``train.step.reduce_mesh_grads``; each copy keeps its own
    query heads' part; the (1, 4) lane);
  * ``--broken-data-mean``: the grads are summed over "data" but not
    divided by the data size (the (2, 2) lanes);
  * ``--broken-train-count``: each data shard counts the MoE's capacity
    over its own rows (``layers.data_size`` 1; the deepseek lane, whose
    router overflows);
  * ``--broken-router-entry``: no ``model_entry`` on the MoE's routing
    weights, so the router's grad keeps only this rank's experts' part;
  * ``--broken-latent-entry``: no ``model_entry`` on MLA's latent, so
    ``w_dkv``'s grad keeps only this rank's heads' part;
  * ``--broken-norm-sum``: Mamba2's gated norm's sum of squares with an
    identity backward (``model_all_reduce`` for ``model_psum``), so each
    rank's input grads miss the other heads' part of the norm's;
  * ``--broken-gate-sum``: the same for the RG-LRU's gate
    pre-activations;
  * ``--broken-bc-entry``: no ``model_entry`` on Mamba2's B and C, so
    their columns of ``in_proj`` and the conv keep this rank's heads'
    part of the grad and their copies part;
  * ``--broken-cross-entry``: no ``model_entry`` on the encoder's output
    before the decoder's cross attentions, so the encoder's grads keep
    this rank's heads' part;
  * ``--broken-segment-norm``: the clip norm's old count
    (``first_holder``), which drops the z, x and dt blocks of Mamba2's
    ``Segments`` leaves on model ranks 1..m-1.

``--pod`` runs phase 19's pod lanes alone (``POD_LANES``: qwen2-1.5b
at (pod, data, model) = (2, 1, 2) under int8 and uncompressed), gated;
its broken copies, logged ungated, run those lanes too:

  * ``--broken-pod-residuals``: after every pod reduction pod 1's ranks
    take pod 0's residuals (the reference's collapsed residuals,
    ``repro/dist/sharding.py:60-67``): the error-feedback identity breaks;
  * ``--broken-pod-norm``: the clip norm sums over the default group,
    every pod's pieces, so it reads sqrt(2) too large;
  * ``--broken-pod-rows``: every pod takes pod 0's rows of the batch
    (``train.step.batch_rows``), so half the batch is never read: the
    identity and the pods' bitwise equality hold, the gaps to the
    unsharded step do not.

``--broken-train-count``, ``--broken-router-entry`` and
``--broken-latent-entry`` run the deepseek-v2-lite-16b lane alone;
``--broken-norm-sum``, ``--broken-bc-entry`` and
``--broken-segment-norm`` the mamba2-1.3b lane, ``--broken-gate-sum``
the recurrentgemma-9b lane, ``--broken-cross-entry`` the
whisper-large-v3 lane.

``--noise`` runs phase 19 (a)'s unsharded float32 steps of each arch of
``--train-archs`` (default: mamba2-1.3b and qwen2-1.5b) twice, through
the kernels and through their plain versions (``impl="ref"``), from the
same params and batches: how far two correct runs part over the three
steps, the floor under the mesh lanes' readings.

``--cases`` holds the fused op, the latent attention and the flash cross
attention at each rank's shape, and the flash forward and backward and
``ssd_chunk``'s at phase 19's and ``tools/mesh_train.py``'s (phase 1's
per-rank cases, and ``ssd_chunk`` at 16 heads, a rank of (1, 4));
``--phase1`` runs every phase-1 case and logs its seconds; ``--windows``
times 20 CUPTI windows of one small kernel, the cost of a window. With no
flag it does ``--phase17``, ``--broken`` and ``--cases``. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import itertools
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
from repro_torch.models import (blocks, encdec, layers, shardctx,  # noqa: E402
                                ssm)

OVERFLOW_SCALE = 16.0                # as tests/test_torch_serve_step_moe.py
DENSE = ("qwen2-72b", "qwen2-1.5b", "internvl2-1b")
MOE = ("grok-1-314b bf16", "grok-1-314b float32", "deepseek-v2-lite-16b")
STATE = ("mamba2-1.3b", "recurrentgemma-9b")
CROSS = ("whisper-large-v3",)


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def drop_rank_1(x: torch.Tensor) -> torch.Tensor:
    """An all_reduce without rank 1's partial sum."""
    if shardctx.model_rank() == 1:
        x = torch.zeros_like(x)
    return shardctx.model_all_reduce(x)


def broken_rank_entry(rank, world, tmp, models):
    """``chip_smoke._mesh_rank_entry`` with ``drop_rank_1`` patched into
    the MLP (and the MoE, which calls the same name)."""
    layers.model_all_reduce = drop_rank_1
    cs._mesh_rank_entry(rank, world, tmp, models)


def broken_moe_entry(rank, world, tmp, models):
    """``drop_rank_1`` patched into the MoE alone: its one all_reduce of
    the routed and shared experts' partials loses rank 1's."""
    inner = layers.moe_apply

    def moe_apply(p, cfg, x):
        layers.model_all_reduce = drop_rank_1
        try:
            return inner(p, cfg, x)
        finally:
            layers.model_all_reduce = shardctx.model_all_reduce

    blocks.moe_apply = moe_apply
    cs._mesh_rank_entry(rank, world, tmp, models)


def dropping_in(fn, module) -> callable:
    """``fn`` with ``module.model_all_reduce`` dropping rank 1's partial
    sum while it runs (and summing whole after)."""
    def inner(*a, **k):
        module.model_all_reduce = drop_rank_1
        try:
            return fn(*a, **k)
        finally:
            module.model_all_reduce = shardctx.model_all_reduce
    return inner


def broken_state_out_entry(rank, world, tmp, models):
    """``drop_rank_1`` patched into Mamba2's and the RG-LRU's
    ``out_proj`` sums (the serve functions' own all_reduces; the
    RG-LRU's gates, summed in ``_rglru_coeffs``, stay whole)."""
    ssm.mamba2_serve = blocks.mamba2_serve = dropping_in(ssm.mamba2_serve,
                                                         ssm)
    serve = dropping_in(ssm.rglru_serve, ssm)
    inner = ssm._rglru_coeffs

    def coeffs(*a, **k):
        ssm.model_all_reduce = shardctx.model_all_reduce
        try:
            return inner(*a, **k)
        finally:
            ssm.model_all_reduce = drop_rank_1

    ssm._rglru_coeffs = coeffs
    ssm.rglru_serve = blocks.rglru_serve = serve
    cs._mesh_rank_entry(rank, world, tmp, models)


def broken_norm_gate_entry(rank, world, tmp, models):
    """Mamba2's gated norm's sum of squares and the RG-LRU's gate
    pre-activations without rank 1's partials; the output projections
    and the MLP summed whole."""
    ssm.rmsnorm_gated = dropping_in(ssm.rmsnorm_gated, layers)
    ssm._rglru_coeffs = dropping_in(ssm._rglru_coeffs, ssm)
    cs._mesh_rank_entry(rank, world, tmp, models)


def broken_cross_entry(rank, world, tmp, models):
    """``drop_rank_1`` patched into the cross attention alone: its
    all_reduce of the heads' ``wo`` partials loses rank 1's."""
    from repro_torch.models import attention
    encdec.gqa_cross = dropping_in(encdec.gqa_cross, attention)
    cs._mesh_rank_entry(rank, world, tmp, models)


def broken_copies_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with no copy-group sum of a copied KV head's
    grads."""
    from repro_torch.train import step
    inner = step.reduce_mesh_grads
    step.reduce_mesh_grads = lambda grads, plan, group, data: inner(
        grads, [(over_data, None) for over_data, _ in plan], group, data)
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_data_mean_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with the grads' sum over "data" never divided by
    the data size."""
    from repro_torch.train import step
    inner = step.reduce_mesh_grads
    step.reduce_mesh_grads = lambda grads, plan, group, data: inner(
        grads, plan, group, 1)
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_train_count_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with each data shard counting the MoE's capacity
    over its own rows."""
    layers.data_size = lambda: 1
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def skipping_entry(fn, module, which: int):
    """``fn`` with its ``which``-th call (from 0) of ``module``'s
    ``model_entry`` the identity, in every call of ``fn`` (the forward
    and the remat recompute)."""
    def inner(*a, **k):
        calls = itertools.count()
        module.model_entry = lambda x: (
            x if next(calls) == which else shardctx.model_entry(x))
        try:
            return fn(*a, **k)
        finally:
            module.model_entry = shardctx.model_entry
    return inner


def broken_router_entry_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with no entry on the MoE's routing weights (the
    first ``model_entry`` of ``moe_apply``)."""
    blocks.moe_apply = skipping_entry(layers.moe_apply, layers, 0)
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_latent_entry_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with no entry on MLA's latent (the second
    ``model_entry`` of ``_mla_qkv``, after the one before ``wq``)."""
    from repro_torch.models import attention
    attention._mla_qkv = skipping_entry(attention._mla_qkv, attention, 1)
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_norm_sum_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with the gated norm's sum backward the
    identity."""
    layers.model_psum = shardctx.model_all_reduce
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_gate_sum_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with the RG-LRU gates' sum backward the
    identity."""
    ssm.model_psum = shardctx.model_all_reduce
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_bc_entry_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with no entry on Mamba2's B and C (the second
    ``model_entry`` of ``mamba2_train``, after the one on ``u``)."""
    blocks.mamba2_train = skipping_entry(ssm.mamba2_train, ssm, 1)
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_cross_entry_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with no entry on the encoder's output."""
    encdec.model_entry = lambda x: x
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_segment_norm_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with the clip norm counting a ``Segments`` leaf on
    model rank 0 alone."""
    from repro_torch.dist import sharding
    from repro_torch.train import step
    step.norm_share = sharding.first_holder
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_pod_residuals_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with every pod's residuals replaced by pod 0's
    after each pod reduction."""
    import torch.distributed as dist
    from repro_torch.dist import compression
    inner = compression.bucketed_compressed_psum

    def collapsed(tree, residuals, group, **kw):
        out, new = inner(tree, residuals, group, **kw)
        for e in new:
            dist.broadcast(e, group=group, group_src=0)
        return out, new

    compression.bucketed_compressed_psum = collapsed
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_pod_norm_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with the clip norm over the default group."""
    from repro_torch.train import step
    inner = step.sharded_norm
    step.sharded_norm = lambda tree, owned, group=None: inner(tree, owned)
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def broken_pod_rows_entry(rank, world, tmp, lanes):
    """Phase 19's ranks with every pod taking pod 0's rows."""
    import dataclasses
    from repro_torch.train import step
    inner = step.batch_rows

    def pod0(n, microbatches, mesh, view):
        return inner(n, microbatches, dataclasses.replace(
            mesh, coords={**mesh.coords, "pod": 0}), view)

    step.batch_rows = pod0
    cs._train_mesh_rank_entry(rank, world, tmp, lanes)


def path_gaps(arch: str) -> dict:
    """Phase 19 (a)'s three unsharded float32 steps of ``arch`` through
    the kernels and through their plain versions: the largest relative
    loss and grad-norm gaps of the steps, each step's, and the largest
    param gap after them with its leaf."""
    from repro_torch.models import build_model
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves, map_with_path

    cfg = cs.train_mesh_config(arch, torch.float32)
    api = build_model(cfg)
    runs = {}
    for impl in (None, "ref"):
        step, init_state, _ = make_train_step(
            api, cs.train_mesh_opt(arch),
            microbatches=cs.TRAIN_MESH_MODELS[arch].microbatches, impl=impl)
        state = init_state(cs.train_mesh_params(api, arch))
        rec = {"loss": [], "grad_norm": []}
        for b in cs.train_mesh_batches(arch, cfg):
            state, m = step(state, {k: torch.from_numpy(v).cuda()
                                    for k, v in b.items()})
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
        rec["params"] = [p.cpu() for p in leaves(state["params"])]
        runs[impl] = rec
        del state
        cs.release()
    names = []
    map_with_path(lambda path, _: names.append("/".join(path)),
                  api.init_specs())
    gaps = [float((a - b).abs().max()) for a, b in
            zip(runs[None]["params"], runs["ref"]["params"])]
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    rel = {k: [abs(a / b - 1) for a, b in zip(runs[None][k], runs["ref"][k])]
           for k in ("loss", "grad_norm")}
    return {"arch": arch, "loss_rel_gap_by_step": rel["loss"],
            "grad_norm_rel_gap_by_step": rel["grad_norm"],
            "loss_rel_gap": max(rel["loss"]),
            "grad_norm_rel_gap": max(rel["grad_norm"]),
            "param_abs_gap": gaps[worst], "param_abs_gap_leaf": names[worst],
            "lr": cs.TRAIN_MESH_OPT["lr"],
            "eps": cs.TRAIN_MESH_MODELS[arch].eps}


def train_readings(out: dict) -> list:
    return [{k: r.get(k) for k in (
        "arch", "mesh", "lane", "loss_rel_gap", "step1_loss_rel_gap",
        "grad_norm_rel_gap",
        "param_abs_gap", "param_abs_gap_leaf", "leaves_whose_copies_differ",
        "pods_bitwise_equal", "ef_identity_gap_by_rank",
        "ef_identity_bound_by_rank", "ef_collapsed_gap_by_rank",
        "world_norm_rel_gap_by_rank", "codec_ms_by_rank",
        "codec_share_of_step", "dropped",
        "reference_dropped", "step_s_median_2_3", "peak_mem_gb_by_rank",
        "seconds_by_rank")}
            for r in out["lanes"].values()]


def broken_count_entry(rank, world, tmp, models):
    """Under ``gspmd``, every data shard's capacity count over its own
    rows only (the ``shard_map`` count), on the overflowing router."""
    layers.data_size = lambda: 1
    overflow_entry(rank, world, tmp, models)


def overflow_entry(rank, world, tmp, models):
    """``chip_smoke._mesh_rank_entry`` with the router's column 0 scaled
    (``scaled_init``)."""
    scaled_init()
    cs._mesh_rank_entry(rank, world, tmp, models)


def scaled_init() -> None:
    """``init_params`` (which phase 17 imports at each call) with every
    MoE router's column 0 multiplied by OVERFLOW_SCALE: in a whole tree
    drawn at once ((a)) and in a router leaf drawn alone (a rank's
    draw: the ``ParamSpec`` whose logical axes end ("embed", None))."""
    import repro_torch.models as models_pkg
    from repro_torch.models.spec import is_spec

    inner = models_pkg.init_params

    def init_params(tree, generator, **kw):
        out = inner(tree, generator, **kw)
        if is_spec(tree):
            if tuple(tree.logical[-2:]) == ("embed", None):
                out[..., 0] *= OVERFLOW_SCALE
            return out

        def walk(node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v)
                elif k == "router":
                    v[..., 0] *= OVERFLOW_SCALE
        walk(out)
        return out

    models_pkg.init_params = init_params


def readings(out: dict) -> list:
    rows = []
    for mesh in out["meshes"]:
        for r in mesh["ranks"]:
            for key, x in r.items():
                if isinstance(x, dict) and "max_abs_err" in x:
                    rows.append({k: x.get(k) for k in (
                        "max_abs_err", "cache_max_abs_err",
                        "logit_max_abs", "positions", "tokens_checked",
                        "prefill_ms", "decode_ms_median", "seconds")}
                        | {"model": mesh["model"], "mesh": mesh["mesh"],
                           "rank": r["rank"], "run": key,
                           "tokens_wrong": len(x["tokens_wrong"])})
    return rows


def windows(reps: int = 20) -> dict:
    """The host seconds of ``reps`` CUPTI windows around one launch."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 20, device="cuda")
    out = {}
    for acts in (("cuda",), ("cpu", "cuda")):
        kinds = [getattr(ProfilerActivity, a.upper()) for a in acts]
        t0 = time.perf_counter()
        for _ in range(reps):
            with profile(activities=kinds) as prof:
                x.add_(1)
                torch.cuda.synchronize()
            cs.trace_events(prof)
        out["+".join(acts)] = (time.perf_counter() - t0) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    for flag in ("phase17", "broken", "broken-moe", "broken-count",
                 "broken-state-out", "broken-norm-gate", "broken-cross",
                 "cases", "phase1", "windows", "phase19", "broken-copies",
                 "broken-data-mean", "broken-train-count",
                 "broken-router-entry", "broken-latent-entry",
                 "broken-norm-sum", "broken-gate-sum", "broken-bc-entry",
                 "broken-cross-entry", "broken-segment-norm", "noise", "pod",
                 "broken-pod-residuals", "broken-pod-norm",
                 "broken-pod-rows"):
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--models", default=None,
                    help="comma-separated MESH_MODELS keys (default: all)")
    ap.add_argument("--train-archs", default=None,
                    help="comma-separated archs of phase 19's lanes "
                         "(default: all)")
    args = ap.parse_args()
    every = not (args.phase17 or args.broken or args.broken_moe
                 or args.broken_count or args.broken_state_out
                 or args.broken_norm_gate or args.broken_cross
                 or args.cases or args.phase1 or args.windows
                 or args.phase19 or args.broken_copies
                 or args.broken_data_mean or args.broken_train_count
                 or args.broken_router_entry or args.broken_latent_entry
                 or args.broken_norm_sum or args.broken_gate_sum
                 or args.broken_bc_entry or args.broken_cross_entry
                 or args.broken_segment_norm or args.noise or args.pod
                 or args.broken_pod_residuals or args.broken_pod_norm
                 or args.broken_pod_rows)
    if not torch.cuda.is_available():
        print("mesh_gate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    common.library()
    emit(build_s=time.perf_counter() - t0)
    keys = args.models.split(",") if args.models else None
    chosen = tuple(m for m in cs.MESH_MODELS if keys is None or m.key in keys)
    failed = []

    def among(names) -> tuple:
        return tuple(m for m in chosen if m.key in names)

    def attempt(name: str, fn) -> None:
        """Run one part, its error logged; the later parts still run."""
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            failed.append(name)
            emit(part=name, error=traceback.format_exc())
        emit(part=name, seconds=time.perf_counter() - t0)

    def cases() -> None:
        rng = np.random.default_rng(0)
        for C in (16, 1):
            for h, kv, cap, tag in ((16, 2, None, "qwen2-72b"),
                                    (12, 2, 30.0, "grok-1-314b"),
                                    (3, 1, None, "qwen2-1.5b")):
                emit(case=cs.fused_case(
                    rng, C, f"fused D=128 H={h} KV={kv} C={C} ({tag})",
                    h=h, kv=kv, d=128, softcap=cap, library=True))
            emit(case=cs.attention_case(
                rng, C, f"attention D=576 H=4 C={C} (deepseek)", h=4, kv=1,
                d=576, alias=True))
        for case in cs.state_mesh_cases(rng) + cs.train_mesh_flash_cases(
                rng) + cs.ssd_mesh_cases(rng):
            emit(case=case)
        rank4 = dict(cs.SSD_MESH_RANK, H=16)
        emit(case=cs.ssd_case(rng, "ssd B'=4 L=256 H=16 float32 "
                              "(mamba2-1.3b, a rank of (1, 4))", **rank4))
        emit(case=cs.ssd_bwd_case(rng, "ssd bwd B'=4 L=256 H=16 float32 "
                                  "(mamba2-1.3b, a rank of (1, 4))",
                                  **rank4))

    def phase1() -> None:
        got = cs.phase1_cases()
        emit(cases=len(got), events_timed=[
            c["case"] for c in got if c.get("ms_timing") == "events"],
             case_s=sum(c["case_s"] for c in got),
             timing_s={k: sum(c["timing_s"][k] for c in got)
                       for k in ("events_s", "cupti_s")})

    def run(lane: str, models: tuple, entry=None, init=None) -> None:
        if not models:
            return
        inner = None
        if init is not None:          # (a)'s weights too
            import repro_torch.models as models_pkg
            inner = models_pkg.init_params
            init()
        try:
            emit(lane=lane, readings=readings(
                cs.phase17(card, entry=entry, models=models)))
        finally:
            if inner is not None:
                models_pkg.init_params = inner

    if args.windows:
        attempt("windows", lambda: emit(window_s=windows()))
    if args.cases or every:
        attempt("cases", cases)
    if args.phase1:
        attempt("phase1", phase1)
    if args.phase17 or every:
        attempt("phase17", lambda: run("phase 17", chosen))
    if args.broken or every:
        attempt("broken", lambda: run("MLP all_reduce drops rank 1",
                                      among(DENSE), broken_rank_entry))
    if args.broken_moe:
        attempt("broken-moe", lambda: run(
            "MoE all_reduce drops rank 1's experts", among(MOE),
            broken_moe_entry))
    if args.broken_state_out:
        attempt("broken-state-out", lambda: run(
            "out_proj all_reduce drops rank 1", among(STATE),
            broken_state_out_entry))
    if args.broken_norm_gate:
        attempt("broken-norm-gate", lambda: run(
            "norm / gate all_reduce drops rank 1", among(STATE),
            broken_norm_gate_entry))
    if args.broken_cross:
        attempt("broken-cross", lambda: run(
            "cross attention all_reduce drops rank 1", among(CROSS),
            broken_cross_entry))
    if args.broken_count:
        ds = among(("deepseek-v2-lite-16b",))
        attempt("overflow", lambda: run(
            "overflowing router, correct step", ds, overflow_entry,
            scaled_init))
        attempt("broken-count", lambda: run(
            "overflowing router, gspmd counts shard-locally", ds,
            broken_count_entry, scaled_init))
    archs = args.train_archs.split(",") if args.train_archs else None
    lanes = tuple(x for x in cs.TRAIN_MESH_GATE_LANES
                  if (x[0] in archs if archs else x[0] != "internvl2-1b"))

    def arch_lanes(arch: str) -> tuple:
        return tuple(x for x in cs.TRAIN_MESH_LANES if x[0] == arch)

    moe_lanes = arch_lanes("deepseek-v2-lite-16b")
    mamba_lanes = arch_lanes("mamba2-1.3b")
    if args.noise:
        for arch in archs or ("mamba2-1.3b", "qwen2-1.5b"):
            attempt(f"noise {arch}", lambda arch=arch: emit(
                noise=path_gaps(arch)))
    if args.phase19:
        attempt("phase19", lambda: emit(lane="phase 19", readings=(
            train_readings(cs.phase19(card, lanes=lanes)))))
    if args.pod:
        attempt("pod", lambda: emit(lane="phase 19 pod lanes", readings=(
            train_readings(cs.phase19(card, lanes=cs.POD_LANES)))))
    for flag, entry, what, on in (
            (args.broken_copies, broken_copies_entry,
             "copied KV heads' grads not summed", lanes),
            (args.broken_data_mean, broken_data_mean_entry,
             "grads not divided by the data size", lanes),
            (args.broken_train_count, broken_train_count_entry,
             "each data shard counts its own rows", moe_lanes),
            (args.broken_router_entry, broken_router_entry_entry,
             "no entry on the routing weights", moe_lanes),
            (args.broken_latent_entry, broken_latent_entry_entry,
             "no entry on MLA's latent", moe_lanes),
            (args.broken_norm_sum, broken_norm_sum_entry,
             "the gated norm's sum, identity backward", mamba_lanes),
            (args.broken_gate_sum, broken_gate_sum_entry,
             "the RG-LRU gates' sum, identity backward",
             arch_lanes("recurrentgemma-9b")),
            (args.broken_bc_entry, broken_bc_entry_entry,
             "no entry on Mamba2's B and C", mamba_lanes),
            (args.broken_cross_entry, broken_cross_entry_entry,
             "no entry on the encoder's output",
             arch_lanes("whisper-large-v3")),
            (args.broken_segment_norm, broken_segment_norm_entry,
             "the clip norm's old count of Segments leaves", mamba_lanes),
            (args.broken_pod_residuals, broken_pod_residuals_entry,
             "every pod keeps pod 0's residuals", cs.POD_LANES),
            (args.broken_pod_norm, broken_pod_norm_entry,
             "the clip norm over every pod's pieces", cs.POD_LANES),
            (args.broken_pod_rows, broken_pod_rows_entry,
             "every pod takes pod 0's rows", cs.POD_LANES)):
        if flag:
            attempt(what, lambda entry=entry, what=what, on=on: emit(
                lane=what, readings=train_readings(
                    cs.phase19(card, entry=entry, lanes=on))))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
