"""The port's train step over a ("pod", "data", "model") mesh
(``train.step.make_train_step(mesh=...)`` with a pod axis, and
``run_training``) against the JAX package's ``make_train_step`` on host
meshes of the same shapes, on the CPU.

As ``tests/torch_train_mesh_pair.py`` does: one JAX subprocess writes the
float32 SMOKE weights (``PRNGKey(0)``) and a batch a case from numpy seed
0 (8 x 32 tokens, and an encoder-decoder's frames), then one JAX
subprocess a case and mesh (four host devices) runs the reference's step
(``compress_pod_grads`` for int8 and top-k) beside the port's ranks: four
gloo processes that build both (2, 1, 2) and (2, 2, 1) over one
FileStore, and two that build (2, 1, 1).  Three AdamW steps (lr 1e-3,
one warmup step of four), 2 microbatches.

The cases:

- qwen2-1.5b, uncompressed (``codec="none"``: "pod" joins FSDP and the
  batch, the (pod * data, model) view) at (2, 1, 2) and (2, 2, 1):
  losses and grad norms within ``LOSS_RTOL``, gathered params within
  ``PARAM_ATOL`` of the reference's (the dense mesh file's bounds);
- qwen2-1.5b, int8 and top-k at (2, 1, 1), where a rank's buckets are
  the reference's global ones: within the same bounds;
- qwen2-1.5b, int8 and top-k at (2, 1, 2) and (2, 2, 1), where each rank
  buckets its own shards (``train.step.shard_buckets``; a deliberate
  difference, ROADMAP queue 3): step 1's reduced grads and new residuals
  equal, bitwise, a recomputation here (each pod's grads gathered from
  its ranks, cut again with ``shard_params``, bucketed, quantized or
  sparsified pod by pod, their mean taken); the params after step 3 lie
  within twice the reference's own distance from its uncompressed
  params; the params are bitwise equal across pods and the residuals
  differ;
- deepseek-v2-lite-16b with router column 0 x 16 at (2, 2, 1), int8:
  expert 0 overflows, and each pod counts its capacity over its own
  rows: the picks its data ranks drop at step 1 equal the port's
  unsharded step on the pod's rows, and step 1's loss is the
  reference's (a count over the whole batch parts from it);
- mamba2-1.3b at (2, 1, 2), int8: the residuals of B and C (whole on
  every model rank) are equal across the model ranks, those of the
  split columns are not;
- whisper-large-v3 at (2, 1, 2), none and int8: an encoder-decoder's
  pod reduction is uncompressed, held to the reference's;
- a checkpoint written at (2, 1, 2) under int8 resumes there bitwise,
  its residuals in the global ``[P * n]`` layout of a pod group; loaded
  at (2, 2, 1) and by a two-rank pod group with no mesh, then gathered
  for a save again, its residual bytes are unchanged.

Measured on the CPU: uncompressed losses within 7.9e-8 relative of the
reference, grad norms 2.5e-7, params 7.1e-5 (whisper 7.8e-8, 1.2e-7,
2.0e-5); at (2, 1, 1) int8 losses 7.8e-8, grad norms 2.8e-6, params
3.5e-5, top-k 0, 1.4e-7, 1.5e-8; at (2, 1, 2) and (2, 2, 1) the port's
compressed params lie 1.00-1.03 times the reference's own distance from
its uncompressed ones (int8 4.1e-3, top-k 2.9e-3); deepseek's step-1
loss equals the reference's, where a count over the whole batch reads
9.6e-5 relative off, and its pods drop 12 and 26 picks.
"""

from __future__ import annotations

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import compression
from repro_torch.dist.sharding import (Segments, gather_params,
                                       holder_pieces, shard_params,
                                       train_specs)
from repro_torch.launch.mesh import POD_AXES, rank_coords
from repro_torch.models import build_model, layers
from repro_torch.train import AdamWConfig
from repro_torch.train.step import make_train_step, shard_buckets
from repro_torch.tree import leaves, map_with_path
from torch_mesh_pair import env, popen, shape_mesh, wait_all

FOUR, TWO = ((2, 1, 2), (2, 2, 1)), ((2, 1, 1),)
B, S, MB, STEPS = 8, 32, 2, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
TOPK_FRAC = 0.01
OVERFLOW_SCALE = 16.0
CODECS = ("int8", "topk")
# case -> (arch, {mesh: codecs}, router column 0's scale)
CASES = {
    "qwen2-1.5b": ("qwen2-1.5b", {(2, 1, 2): ("none",) + CODECS,
                                  (2, 2, 1): ("none",) + CODECS,
                                  (2, 1, 1): CODECS}, None),
    "deepseek-overflow": ("deepseek-v2-lite-16b", {(2, 2, 1): ("int8",)},
                          OVERFLOW_SCALE),
    "mamba2-1.3b": ("mamba2-1.3b", {(2, 1, 2): ("int8",)}, None),
    "whisper-large-v3": ("whisper-large-v3", {(2, 1, 2): ("none", "int8")},
                         None),
}

_INPUTS_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.spec import init_params

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    save = {}
    for case, (arch, scale) in cases.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32)
        params = init_params(build_model(cfg).init_specs(),
                             jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            name = "/".join(k.key for k in path)
            x = np.array(leaf)
            if scale is not None and name.endswith("moe/router"):
                x[..., 0] *= scale
            save[case + "/params/" + name] = x
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (%(B)d, %(S)d + 1)).astype(np.int32)
        save[case + "/batch/tokens"] = toks[:, :-1]
        save[case + "/batch/targets"] = toks[:, 1:]
        if cfg.family == "encdec":
            save[case + "/batch/frames"] = rng.standard_normal(
                (%(B)d, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    np.savez(out_dir + "/inputs.npz", **save)
""" % dict(B=B, S=S))

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.train.optimizer import AdamWConfig
    from repro.train.step import make_train_step

    out_dir, case, arch, shape, codecs = sys.argv[1:6]
    dims = tuple(int(x) for x in shape.split("x"))
    assert len(jax.devices()) >= int(np.prod(dims)), jax.devices()
    ref = np.load(out_dir + "/inputs.npz")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=jnp.float32)
    api = build_model(cfg)

    def nest(prefix):
        tree = {}
        for key in ref.files:
            if key.startswith(prefix):
                *path, last = key[len(prefix):].split("/")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = jnp.asarray(ref[key])
        return tree

    params, batch = nest(case + "/params/"), nest(case + "/batch/")
    devs = np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims)
    mesh = jax.sharding.Mesh(devs, ("pod", "data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 3)
    save = {}
    for codec in codecs.split(","):
        step, _, bsh, init = make_train_step(
            api, mesh, AdamWConfig(**%(OPT)r), microbatches=%(MB)d,
            compress_pod_grads=codec != "none",
            codec="int8" if codec == "none" else codec,
            topk_frac=%(FRAC)r, donate=False)
        with jax.set_mesh(mesh):
            state = init(params)
            b = jax.device_put(batch, bsh)
            losses, norms = [], []
            for _ in range(%(STEPS)d):
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        save[codec + "/loss"] = np.asarray(losses)
        save[codec + "/grad_norm"] = np.asarray(norms)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            save[codec + "/params/" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
    np.savez(out_dir + f"/jax-{case}-{shape}.npz", **save)
""" % dict(OPT=OPT, MB=MB, STEPS=STEPS, FRAC=TOPK_FRAC))

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    world, rank = int(sys.argv[1]), int(sys.argv[2])
    store_path, out_dir = sys.argv[3], sys.argv[4]
    runs = json.loads(sys.argv[5])     # [case, arch, mesh, codec]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import Mode, PMDevice, USplit, Volume, VolumeGeometry
    from repro_torch.data import TokenPipeline
    from repro_torch.dist import compression
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, layers
    from repro_torch.train import AdamWConfig, LoopConfig, run_training
    from repro_torch.train import loop as loop_mod
    from repro_torch.train import step as step_mod
    from repro_torch.dist.sharding import train_specs
    from repro_torch.tree import map_with_path, unflatten

    meshes = {tuple(m): make_mesh(m) for m in
              dict.fromkeys(tuple(m) for _, _, m, _ in runs)}
    ref = np.load(out_dir + "/inputs.npz")
    save, out = {}, {}

    def nest(prefix):
        tree = {}
        for key in ref.files:
            if key.startswith(prefix):
                *path, last = key[len(prefix):].split("/")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = ref[key].copy()   # the step updates in place
        return tree

    def keep(prefix, tree):
        map_with_path(lambda path, x: save.__setitem__(
            prefix + "/".join(map(str, path)), x.detach().numpy().copy()),
            tree)

    # step 1's reduction: its input and output pieces and new residuals
    calls = []
    inner_psum = compression.bucketed_compressed_psum

    def psum(tree, residuals, group, **kw):
        got, new = inner_psum(tree, residuals, group, **kw)
        if not calls:
            calls.append(([t.clone() for t in tree],
                          [t.clone() for t in got], [e.clone() for e in new]))
        return got, new

    compression.bucketed_compressed_psum = psum
    # the picks each MoE routing drops (forward and remat recompute)
    drops = []
    inner_route = layers.moe_route

    def route(p, cfg, xt):
        res = inner_route(p, cfg, xt)
        drops.append(int((~res[2]).sum()))
        return res

    layers.moe_route = route
    opt = AdamWConfig(**%(OPT)r)

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch, smoke=True),
                                   dtype=torch.float32)

    for case, arch, shape, codec in runs:
        mesh = meshes[tuple(shape)]
        api = build_model(cfg_of(arch))
        tag = case + "/" + "x".join(map(str, shape)) + "/" + codec
        step, init, specs = step_mod.make_train_step(
            api, opt, microbatches=%(MB)d, mesh=mesh, codec=codec,
            topk_frac=%(FRAC)r)
        view = step_mod.shard_mesh(api, mesh, codec)
        rows = step_mod.batch_rows(%(B)d, %(MB)d, mesh, view)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                 for k, v in nest(case + "/batch/").items()}
        state = init(convert.params_from_numpy(nest(case + "/params/"),
                                               device="cpu"), device="cpu")
        calls.clear()
        losses, norms, dropped = [], [], []
        for _ in range(%(STEPS)d):
            drops.clear()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            dropped.append(sum(drops))
        save[tag + "/loss"] = np.asarray(losses)
        save[tag + "/grad_norm"] = np.asarray(norms)
        save[tag + "/dropped"] = np.asarray(dropped)
        keep(tag + "/params/", state["params"])
        if "err" in state:
            sb = step_mod.pod_buckets(api, view, specs)
            like = api.init_specs()
            units_in, units_out, err1 = calls[0]
            keep(tag + "/grads/", unflatten(like, sb.join(units_in)))
            keep(tag + "/reduced/", unflatten(like, sb.join(units_out)))
            keep(tag + "/err1/", err1)
            keep(tag + "/err/", state["err"])
            keep(tag + "/err_leaves/", unflatten(like,
                                                 sb.unbucket(state["err"])))

    if world == 4:
        # a checkpoint at (2, 1, 2) under int8 resumes bitwise; its
        # residuals round-trip through (2, 2, 1) and a two-rank pod group
        layers.moe_route = inner_route
        compression.bucketed_compressed_psum = inner_psum
        api = build_model(cfg_of("qwen2-1.5b"))
        lopt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)

        def store():
            geometry = VolumeGeometry(meta_blocks=256, journal_blocks=512,
                                      oplog_slots=1, oplog_blocks=64)
            vol = Volume.format(PMDevice(size=256 * 1024 * 1024), geometry)
            return USplit(vol, mode=Mode.SYNC, staging_file_bytes=8 << 20,
                          staging_prealloc=2, staging_background=False)

        def train(mesh, ckpt=None, crash_at=None, pod_group=None):
            pipe = TokenPipeline(api.cfg, global_batch=8, seq_len=16, seed=7)
            return run_training(api, pipe, LoopConfig(
                steps=4, ckpt_every=2, microbatches=2, codec="int8"), lopt,
                ckpt=ckpt, device="cpu", crash_at=crash_at, mesh=mesh,
                pod_group=pod_group)

        ck = {"whole": train(meshes[(2, 1, 2)]).losses}
        ckpt = CheckpointManager(store()) if rank == 0 else None
        try:
            train(meshes[(2, 1, 2)], ckpt, crash_at=3)
            raise AssertionError("no crash")
        except RuntimeError as e:
            assert "injected crash at step 3" in str(e), e
        res = train(meshes[(2, 1, 2)], ckpt)
        ck["resumed"] = [res.restored_from] + res.losses
        plan = step_mod.grad_bucket_plan(api)
        err0 = None
        if rank == 0:
            like = {"err": [torch.empty(0) for _ in range(plan.num_buckets)]}
            err0 = ckpt.restore(like, step=2)[1]["err"]
            keep("ckpt/err0/", err0)
        # (2, 2, 1): resumed by run_training, and by hand scattered and
        # gathered again as its restore and save do
        mesh = meshes[(2, 2, 1)]
        ck["restored_221"] = train(mesh, ckpt).restored_from
        view = mesh.in_pod
        specs = train_specs(api.cfg, view, api.init_specs())
        sb = step_mod.pod_buckets(api, view, specs)
        mine = loop_mod.scatter_pod_residuals(err0, api, mesh, specs, sb,
                                              plan, "cpu")
        back = loop_mod.gather_pod_residuals(mine, api, mesh, specs, sb,
                                             plan)
        if rank == 0:
            keep("ckpt/221/", back)
        # a pod group of ranks 0 and 1, no mesh
        group = dist.new_group([0, 1])
        if rank < 2:
            ck["restored_group"] = train(None, ckpt,
                                         pod_group=group).restored_from
            rows = loop_mod._broadcast_state(
                {"params": {}, "opt": {}, "err": [
                    torch.zeros(n) for n in plan.padded_sizes]},
                {"params": {}, "opt": {}, "err": err0}, group)["err"]
            back = loop_mod.gather_residuals(rows, group)
            if rank == 0:
                keep("ckpt/group/", back)
        out["ckpt"] = ck
    np.savez(f"{out_dir}/rank-{world}-{rank}.npz", **save)
    with open(f"{out_dir}/rank-{world}-{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""" % dict(OPT=OPT, B=B, MB=MB, STEPS=STEPS, FRAC=TOPK_FRAC))


def tag(mesh) -> str:
    return "x".join(map(str, mesh))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, then a JAX process a case and mesh beside the port's
    ranks: four that run the (2, 1, 2) and (2, 2, 1) runs and the
    checkpoint, two that run the (2, 1, 1) runs.  Returns (the JAX
    outputs by (case, mesh), the ranks' arrays and records by world)."""
    out = tmp_path_factory.mktemp("pod")
    wait_all([popen([_INPUTS_SCRIPT, str(out), json.dumps(
        {c: (a, scale) for c, (a, _, scale) in CASES.items()})], env())])
    procs = [popen([_JAX_SCRIPT, str(out), case, arch, tag(mesh),
                    ",".join(codecs)], env(4))
             for case, (arch, meshes, _) in CASES.items()
             for mesh, codecs in meshes.items()]
    for world, meshes in ((4, FOUR), (2, TWO)):
        todo = [[case, arch, mesh, codec]
                for case, (arch, by_mesh, _) in CASES.items()
                for mesh in meshes for codec in by_mesh.get(mesh, ())]
        store = out / f"store-{world}"
        procs += [popen([_RANK_SCRIPT, str(world), str(r), str(store),
                         str(out), json.dumps(todo)], env())
                  for r in range(world)]
    wait_all(procs)
    jax_out = {(case, mesh): np.load(out / f"jax-{case}-{tag(mesh)}.npz")
               for case, (_, meshes, _) in CASES.items() for mesh in meshes}
    ranks = {world: [(np.load(out / f"rank-{world}-{r}.npz"), json.loads(
        (out / f"rank-{world}-{r}.json").read_text())) for r in range(world)]
             for world in (4, 2)}
    inputs = dict(np.load(out / "inputs.npz"))
    return jax_out, ranks, inputs


def api_of(case: str):
    return build_model(dataclasses.replace(
        get_config(CASES[case][0], smoke=True), dtype=torch.float32))


def rank_arrays(ranks, mesh) -> list:
    return [a for a, _ in ranks[4 if mesh in FOUR else 2]]


def coords(mesh, r: int) -> dict:
    return rank_coords(dict(zip(POD_AXES, mesh)), r)


def view_mesh(mesh, codec: str, case: str):
    """The shape-only mesh a run's shards are on, and the ranks whose
    shards make up the whole tree: pod 0's where the pod reduction is
    compressed, every rank on the (pod * data, model) view else."""
    pods, d, m = mesh
    if codec == "none" or api_of(case).cfg.family == "encdec":
        return shape_mesh(pods * d, m), list(range(pods * d * m))
    return shape_mesh(d, m), list(range(d * m))


def gathered(ranks, case: str, mesh, codec: str, what: str,
             ranks_of=None) -> dict:
    """``what`` of a run gathered from its ranks' shards by the
    reference's path name (copies of a replicated piece must be bitwise
    equal)."""
    api = api_of(case)
    view, which = view_mesh(mesh, codec, case)
    which = ranks_of or which
    specs = train_specs(api.cfg, view, api.init_specs())
    arrays = rank_arrays(ranks, mesh)
    run = f"{case}/{tag(mesh)}/{codec}"
    got = {}

    def one(path, _, spec):
        name = "/".join(map(str, path))
        blocks = [torch.from_numpy(arrays[r][f"{run}/{what}/{name}"])
                  for r in which]
        got[name] = gather_params(blocks, spec, view).numpy()

    map_with_path(one, api.init_specs(), specs)
    return got


def check_reference(jax_out, ranks, case: str, mesh, codec: str,
                    ref_codec=None) -> None:
    ref = jax_out[(case, mesh)]
    key = ref_codec or codec
    run = f"{case}/{tag(mesh)}/{codec}"
    for a in rank_arrays(ranks, mesh):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[f"{run}/{k}"], ref[f"{key}/{k}"],
                                       rtol=LOSS_RTOL, atol=0)
    for name, x in gathered(ranks, case, mesh, codec, "params").items():
        np.testing.assert_allclose(x, ref[f"{key}/params/{name}"],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mesh", FOUR, ids=tag)
def test_uncompressed_pod_is_fsdp_on_the_merged_view(runs, mesh):
    jax_out, ranks, _ = runs
    check_reference(jax_out, ranks, "qwen2-1.5b", mesh, "none")


@pytest.mark.parametrize("codec", CODECS)
def test_one_rank_a_pod_matches_the_reference(runs, codec):
    """At (2, 1, 1) a rank's buckets are the reference's global ones."""
    jax_out, ranks, _ = runs
    check_reference(jax_out, ranks, "qwen2-1.5b", (2, 1, 1), codec)


def recompute(ranks, mesh, codec: str) -> list:
    """Step 1's reduction of every rank, recomputed here: (the reduced
    grad leaves, the new residuals) a rank."""
    case = "qwen2-1.5b"
    api = api_of(case)
    pods, d, m = mesh
    view = shape_mesh(d, m)
    like = api.init_specs()
    specs = train_specs(api.cfg, view, like)
    flat_specs = []
    map_with_path(lambda _, __, s: flat_specs.append(s), like, specs)
    shapes = [s.shape for s in leaves(like)]
    run = f"{case}/{tag(mesh)}/{codec}"
    arrays = rank_arrays(ranks, mesh)
    names = []
    map_with_path(lambda path, _: names.append("/".join(map(str, path))),
                  like)
    per_pod = d * m
    wholes = [[gather_params([torch.from_numpy(
        arrays[p * per_pod + r][f"{run}/grads/{n}"])
        for r in range(per_pod)], spec, view) for n, spec in zip(
        names, flat_specs)] for p in range(pods)]
    sent, kept = [], []
    for r in range(pods * per_pod):
        c = coords(mesh, r)
        mine = dataclasses.replace(view, coords={"data": c["data"],
                                                 "model": c["model"]})
        sb = shard_buckets(shapes, flat_specs, mine)
        shards = [shard_params(w, s, mine) for w, s in
                  zip(wholes[c["pod"]], flat_specs)]
        for x, n in zip(shards, names):        # the rank's own grads
            assert torch.equal(x, torch.from_numpy(
                arrays[r][f"{run}/grads/{n}"])), (r, n)
        out, err = [], []
        for flat in sb.bucket(shards):
            x = flat + torch.zeros_like(flat)
            if codec == "int8":
                q, scale, pad, new = compression.quantize_with_feedback(
                    flat, torch.zeros_like(flat))
                out.append(compression.dequantize_int8(q, scale, pad,
                                                       flat.shape))
            else:
                vals, _ = compression.topk_sparsify(x, TOPK_FRAC)
                new = x - vals
                out.append(vals)
            err.append(new)
        sent.append((sb, out))
        kept.append(err)
    got = []
    for r in range(pods * per_pod):
        sb, _ = sent[r]
        partners = [sent[r % per_pod + p * per_pod][1] for p in range(pods)]
        mean = [sum(xs[1:], xs[0]) / pods for xs in zip(*partners)]
        got.append((sb.unbucket(mean), kept[r], names))
    return got


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mesh", FOUR, ids=tag)
def test_rank_buckets_recomputed_bitwise(runs, mesh, codec):
    """Step 1's reduced grads and residuals of every rank equal a
    recomputation from the pods' gathered grads, bitwise."""
    _, ranks, _ = runs
    run = f"qwen2-1.5b/{tag(mesh)}/{codec}"
    for r, (reduced, err, names) in enumerate(recompute(ranks, mesh, codec)):
        a = rank_arrays(ranks, mesh)[r]
        for x, n in zip(reduced, names):
            np.testing.assert_array_equal(x.numpy(), a[f"{run}/reduced/{n}"],
                                          err_msg=f"rank {r} {n}")
        for b, e in enumerate(err):
            np.testing.assert_array_equal(e.numpy(), a[f"{run}/err1/{b}"],
                                          err_msg=f"rank {r} bucket {b}")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mesh", FOUR, ids=tag)
def test_compressed_params_near_the_reference(runs, mesh, codec):
    """The params after step 3 lie within twice the reference's own
    distance from its uncompressed params (its buckets are global, the
    port's a rank's own)."""
    jax_out, ranks, _ = runs
    ref = jax_out[("qwen2-1.5b", mesh)]
    got = gathered(ranks, "qwen2-1.5b", mesh, codec, "params")
    own = max(float(np.abs(ref[f"{codec}/params/{n}"]
                           - ref[f"none/params/{n}"]).max()) for n in got)
    ours = max(float(np.abs(x - ref[f"none/params/{n}"]).max())
               for n, x in got.items())
    assert 0 < own and ours <= 2 * own, (ours, own)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mesh", FOUR, ids=tag)
def test_pods_agree_and_their_residuals_differ(runs, mesh, codec):
    _, ranks, _ = runs
    arrays = rank_arrays(ranks, mesh)
    run = f"qwen2-1.5b/{tag(mesh)}/{codec}"
    half = len(arrays) // 2
    for r in range(half):
        a, b = arrays[r], arrays[r + half]
        for k in a.files:
            if k.startswith(run + "/params/"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        errs = [k for k in a.files if k.startswith(run + "/err/")]
        assert errs and any(not np.array_equal(a[k], b[k]) for k in errs)
        np.testing.assert_array_equal(a[run + "/loss"], b[run + "/loss"])


def unsharded(inputs: dict, case: str, rows) -> tuple:
    """The port's unsharded step 1 on ``rows`` of the case's batch: its
    loss and the picks its routings drop (forward and recompute)."""
    api = api_of(case)
    prefix = f"{case}/params/"
    params = {}
    for key, x in inputs.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = params
            for k in path:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(x.copy())
    batch = {k: torch.from_numpy(inputs[f"{case}/batch/{k}"][rows].copy())
             for k in ("tokens", "targets")}
    step, init, _ = make_train_step(api, AdamWConfig(**OPT), microbatches=MB)
    drops = []
    inner = layers.moe_route

    def route(p, cfg, xt):
        res = inner(p, cfg, xt)
        drops.append(int((~res[2]).sum()))
        return res

    layers.moe_route = route
    try:
        _, metrics = step(init(params, device="cpu"), batch)
    finally:
        layers.moe_route = inner
    return float(metrics["loss"]), sum(drops)


def test_moe_capacity_is_counted_per_pod(runs):
    """Router column 0 x 16 at (2, 2, 1): each pod counts the capacity
    over its own rows, so the picks its data ranks drop at step 1 are
    the unsharded step's on the pod's rows, and step 1's loss is the
    reference's; counted over the whole batch, it is not."""
    jax_out, ranks, inputs = runs
    case, mesh = "deepseek-overflow", (2, 2, 1)
    arrays = rank_arrays(ranks, mesh)
    run = f"{case}/{tag(mesh)}/int8"
    ref = jax_out[(case, mesh)]["int8/loss"][0]
    for p in range(2):
        got = sum(a[f"{run}/dropped"][0] for a in arrays[2 * p:2 * p + 2])
        _, want = unsharded(inputs, case, list(range(4 * p, 4 * p + 4)))
        assert got == want > 0, (p, got, want)
    np.testing.assert_allclose(arrays[0][f"{run}/loss"][0], ref,
                               rtol=LOSS_RTOL)
    whole, _ = unsharded(inputs, case, list(range(B)))
    assert abs(whole / ref - 1) > LOSS_RTOL, (whole, ref)


def test_mamba2_whole_segments_have_equal_residuals(runs):
    """Mamba2's B and C (whole on every model rank, in ``Segments``
    leaves) keep the same residuals on both model ranks of a pod, and the
    split z, x and dt columns their own."""
    _, ranks, _ = runs
    case, mesh = "mamba2-1.3b", (2, 1, 2)
    api = api_of(case)
    view = shape_mesh(1, 2)
    like = api.init_specs()
    specs = train_specs(api.cfg, view, like)
    arrays = rank_arrays(ranks, mesh)
    run = f"{case}/{tag(mesh)}/int8"
    seen = []

    def one(path, leaf, spec):
        if not any(isinstance(e, Segments) for e in spec):
            return
        name = "/".join(map(str, path))
        for p in range(2):
            pair = [torch.from_numpy(arrays[2 * p + m][
                f"{run}/err_leaves/{name}"]) for m in range(2)]
            for (d, start, width), key in holder_pieces(spec, leaf.shape,
                                                        view):
                a, b = (x.narrow(d, start, width) for x in pair)
                if "model" in key:
                    assert not torch.equal(a, b), (name, start)
                else:
                    assert torch.equal(a, b) and a.abs().max() > 0, (
                        name, start)
                    seen.append(name)

    map_with_path(one, like, specs)
    assert seen


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_encdec_pod_reduction_is_uncompressed(runs, codec):
    jax_out, ranks, _ = runs
    check_reference(jax_out, ranks, "whisper-large-v3", (2, 1, 2), codec,
                    ref_codec="none")


def test_checkpoint_resumes_bitwise(runs):
    """A crash after step 3 at (2, 1, 2) under int8, resumed from step 2:
    steps 3-4 as in the run that never stopped, on every rank."""
    _, ranks, _ = runs
    for _, rec in ranks[4]:
        ck = rec["ckpt"]
        assert ck["resumed"][0] == 2
        assert ck["resumed"][1:] == ck["whole"][2:]


@pytest.mark.parametrize("where", ["221", "group"])
def test_checkpoint_residuals_round_trip(runs, where):
    """The checkpoint's residuals are the global ``[P * n]`` buffers of
    the global bucket plan; restored at (2, 2, 1), or by a two-rank pod
    group with no mesh, and gathered again as a save does, their bytes are
    unchanged; ``run_training`` resumes from the checkpoint on both."""
    _, ranks, _ = runs
    a, rec = ranks[4][0]
    plan = build_plan()
    saved = [a[f"ckpt/err0/{b}"] for b in range(plan.num_buckets)]
    assert [x.shape for x in saved] == [(2 * n,) for n in plan.padded_sizes]
    assert any(x.any() for x in saved)
    for b, x in enumerate(saved):
        np.testing.assert_array_equal(a[f"ckpt/{where}/{b}"].view(np.int32),
                                      x.view(np.int32))
    assert rec["ckpt"][f"restored_{where}"] == 4
    if where == "group":
        assert ranks[4][1][1]["ckpt"]["restored_group"] == 4


def build_plan():
    from repro_torch.train.step import grad_bucket_plan
    return grad_bucket_plan(api_of("qwen2-1.5b"))


def test_a_pod_axis_of_one_and_a_bad_codec_raise(tmp_path):
    """A pod axis of 1 is a (data, model) mesh; an unknown codec raises
    over a mesh as without one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="pod axis of 1"):
            make_mesh((1, 1, 1))
        with pytest.raises(ValueError, match="unknown codec"):
            make_train_step(api_of("qwen2-1.5b"), AdamWConfig(),
                            mesh=make_mesh((1, 1)), codec="fp8")
    finally:
        dist.destroy_process_group()


def test_shard_buckets_are_the_global_plan_on_one_rank():
    """On a mesh of one rank a rank's buckets are ``grad_bucket_plan``'s:
    the plans coincide, as at (P, 1, 1)."""
    api = api_of("qwen2-1.5b")
    like = api.init_specs()
    specs = train_specs(api.cfg, shape_mesh(1, 1), like)
    flat = []
    map_with_path(lambda _, __, s: flat.append(s), like, specs)
    sb = shard_buckets([s.shape for s in leaves(like)], flat,
                       shape_mesh(1, 1), bucket_elems=1 << 12)
    assert sb.plan == compression.plan_buckets(
        [int(np.prod(s.shape)) for s in leaves(like)], bucket_elems=1 << 12)
    assert all(ps == (None,) for ps in sb.pieces)
