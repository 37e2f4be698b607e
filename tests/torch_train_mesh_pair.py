"""The harness of ``tests/test_torch_train_mesh_state.py`` and
``tests/test_torch_train_mesh_encdec.py``: the port's mesh train step
(``train.step.make_train_step(mesh=...)``) against the JAX package's
``make_train_step`` on host meshes of the same shapes, on the CPU, for
the families whose batches carry more than tokens or whose layers carry
state (Mamba2, the RG-LRU hybrid, the VLM, the encoder-decoder).

As ``tests/test_torch_train_mesh.py`` does: one JAX subprocess writes the
float32 SMOKE weights (``PRNGKey(0)``) and a batch a case from numpy seed
0: 8 x 32 tokens, then the frames [8, enc_frames, D] of an
encoder-decoder or the patch embeddings [8, n_patch_tokens, D] of a VLM;
then one JAX subprocess a case (four host devices) runs
``jax.value_and_grad`` of the unsharded loss and the reference's step on
each of its meshes, beside the port's ranks (a gloo group over a
FileStore a mesh, every process with its own timeout), each taking its
data rank's rows of every batch leaf (``mesh_rows``).  Three AdamW steps
(lr 1e-3, one warmup step of four), 2 microbatches.

Each rank saves, a case: step 1's grads (reduced over the mesh), the
losses and grad norms of three steps, its shards of the params and of
both moments after them, and its collectives of step 2 by kind and by
the mesh axis of their group.  A case named in ``norm_cases`` also saves
the clip norm of step 1's grads as ``sharded_norm`` reads it with
``norm_share`` and with ``first_holder`` alone.  At (1, 2) the ranks
then run each broken form named (``BREAKS``: a function of the step or
the model patched for the run) on its case, saved under
``broken/{name}``.
"""

from __future__ import annotations

import dataclasses
import json
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.dist.sharding import gather_params, shard_params, train_specs
from repro_torch.launch.mesh import rank_coords
from repro_torch.models import build_model
from repro_torch.tree import map_with_path
from torch_mesh_pair import env, popen, shape_mesh, tag, wait_all

MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
BROKEN_MESH = (1, 2)
B, S, MB, STEPS = 8, 32, 2, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

_INPUTS_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.spec import init_params

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    save = {}
    for case, arch in cases.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32)
        params = init_params(build_model(cfg).init_specs(),
                             jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            save[case + "/params/" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (%(B)d, %(S)d + 1)).astype(np.int32)
        save[case + "/batch/tokens"] = toks[:, :-1]
        save[case + "/batch/targets"] = toks[:, 1:]
        if cfg.family == "encdec":
            save[case + "/batch/frames"] = rng.standard_normal(
                (%(B)d, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            save[case + "/batch/patch_embeds"] = rng.standard_normal(
                (%(B)d, cfg.n_patch_tokens, cfg.d_model)).astype(np.float32)
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

    out_dir, case, arch, meshes = sys.argv[1:5]
    meshes = json.loads(meshes)
    assert len(jax.devices()) >= 4, jax.devices()
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

    def keep(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            save[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

    params, batch = nest(case + "/params/"), nest(case + "/batch/")
    save = {}
    loss, grads = jax.jit(jax.value_and_grad(api.loss))(params, batch)
    keep("grads/", grads)
    for d, m in meshes:
        devs = np.array(jax.devices()[:d * m]).reshape(d, m)
        mesh = jax.sharding.Mesh(devs, ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
        step, _, bsh, init = make_train_step(
            api, mesh, AdamWConfig(**%(OPT)r), microbatches=%(MB)d,
            donate=False)
        with jax.set_mesh(mesh):
            state = init(params)
            b = jax.device_put(batch, bsh)
            losses, norms = [], []
            for _ in range(%(STEPS)d):
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        save[f"{d}x{m}/loss"] = np.asarray(losses)
        save[f"{d}x{m}/grad_norm"] = np.asarray(norms)
        keep(f"{d}x{m}/params/", state["params"])
    np.savez(out_dir + f"/jax-{case}.npz", **save)
""" % dict(OPT=OPT, MB=MB, STEPS=STEPS))

_RANK_SCRIPT = textwrap.dedent("""
    import collections, dataclasses, itertools, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    d, m = (int(x) for x in sys.argv[1].split("x"))
    rank, store_path, out_dir = int(sys.argv[2]), sys.argv[3], sys.argv[4]
    cases, broken, norm_cases = (json.loads(x) for x in sys.argv[5:8])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, d * m),
                            rank=rank, world_size=d * m)

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import (blocks, build_model, encdec, layers,
                                    shardctx, ssm)
    from repro_torch.train import AdamWConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import sharded_norm
    from repro_torch.tree import map_with_path

    mesh = make_mesh((d, m))
    groups = {id(g): axis for axis, g in mesh.groups.items()}
    groups.update({id(g): "copies" for g in mesh.copy_groups.values()})
    ref = np.load(out_dir + "/inputs.npz")
    save, out = {}, {"collectives": {}, "norm": {}}

    # every collective, counted by kind and by the mesh axis of its group
    counts = collections.Counter()

    def counted(name, fn):
        def inner(*a, group=None, **k):
            counts[(name, groups.get(id(group), "mesh"))] += 1
            return fn(*a, group=group, **k)
        return inner

    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor"):
        setattr(dist, name, counted(name, getattr(dist, name)))

    def skip_bc_entry(fn):
        # Mamba2's second model_entry (on B and C, after the one on u)
        # the identity, in every call (the forward and the recompute)
        def inner(*a, **k):
            calls = itertools.count()
            ssm.model_entry = lambda x: (
                x if next(calls) == 1 else shardctx.model_entry(x))
            try:
                return fn(*a, **k)
            finally:
                ssm.model_entry = shardctx.model_entry
        return inner

    # name -> what it patches: (module, attribute, broken value)
    BREAKS = {
        # the gated norm's sum of squares with an identity backward
        "norm-sum": (layers, "model_psum", shardctx.model_all_reduce),
        # the RG-LRU's gate pre-activations, the same
        "gate-sum": (ssm, "model_psum", shardctx.model_all_reduce),
        # no entry on Mamba2's B and C
        "bc-entry": (blocks, "mamba2_train", skip_bc_entry(ssm.mamba2_train)),
        # no entry on the encoder's output before the cross attentions
        "cross-entry": (encdec, "model_entry", lambda x: x),
        # the clip norm's old count: a Segments leaf whole over "model"
        "segment-norm": (step_mod, "norm_share", sharding.first_holder),
    }

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

    opt = AdamWConfig(**%(OPT)r)

    def run(tag, case, arch):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32)
        api = build_model(cfg)
        rows = step_mod.mesh_rows(%(B)d, %(MB)d, d, mesh.coords["data"])
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                 for k, v in nest(case + "/batch/").items()}
        step, init, specs = step_mod.make_train_step(
            api, opt, microbatches=%(MB)d, mesh=mesh)
        # step 1's grads, reduced over the mesh
        lg = step_mod.make_mesh_loss_and_grad(api, mesh, specs, %(MB)d)
        _, grads = lg(sharding.shard_params(convert.params_from_numpy(
            nest(case + "/params/"), device="cpu"), specs, mesh), batch)
        keep(tag + "/grads/", grads)
        if tag in norm_cases:
            norms = []
            for share in (sharding.norm_share, sharding.first_holder):
                owned = []
                map_with_path(lambda _, __, s: owned.append(share(s, mesh)),
                              api.init_specs(), specs)
                norms.append(float(sharded_norm(grads, owned)))
            out["norm"][tag] = norms
        del grads
        state = init(convert.params_from_numpy(nest(case + "/params/"),
                                               device="cpu"), device="cpu")
        losses, gnorms = [], []
        for s in range(%(STEPS)d):
            counts.clear()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            if s == 1:
                out["collectives"][tag] = [
                    [k, a, n] for (k, a), n in sorted(counts.items())]
        save[tag + "/loss"] = np.asarray(losses)
        save[tag + "/grad_norm"] = np.asarray(gnorms)
        keep(tag + "/params/", state["params"])
        keep(tag + "/mu/", state["opt"]["mu"])
        keep(tag + "/nu/", state["opt"]["nu"])

    for case, (arch, meshes) in cases.items():
        if [d, m] in meshes:
            run(case, case, arch)
    if [d, m] == %(BROKEN_MESH)r:
        for name, case in broken.items():
            module, attr, value = BREAKS[name]
            inner = getattr(module, attr)
            setattr(module, attr, value)
            try:
                run(f"broken/{name}", case, cases[case][0])
            finally:
                setattr(module, attr, inner)
    np.savez(f"{out_dir}/rank-{d}x{m}-{rank}.npz", **save)
    with open(f"{out_dir}/rank-{d}x{m}-{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""" % dict(OPT=OPT, B=B, MB=MB, STEPS=STEPS, BROKEN_MESH=list(BROKEN_MESH)))


def run_cases(out: Path, cases: dict, broken: dict, norm_cases=()):
    """``cases``: case -> (arch, meshes); ``broken``: a ``BREAKS`` name ->
    the case it runs on at ``BROKEN_MESH``; ``norm_cases``: the cases
    whose clip norm the ranks read both ways.  The inputs, then a JAX
    process a case beside the port's ranks (a gloo group a mesh, each
    rank running every case of its mesh).  Returns (the JAX outputs by
    case, the ranks' arrays and records by mesh)."""
    wait_all([popen([_INPUTS_SCRIPT, str(out), json.dumps(
        {c: a for c, (a, _) in cases.items()})], env())])
    procs = [popen([_JAX_SCRIPT, str(out), case, arch, json.dumps(meshes)],
                   env(4)) for case, (arch, meshes) in cases.items()]
    meshes = sorted({m for _, ms in cases.values() for m in ms})
    for d, m in meshes:
        store = out / f"store-{d}x{m}"
        procs += [popen([_RANK_SCRIPT, f"{d}x{m}", str(r), str(store),
                         str(out), json.dumps(cases), json.dumps(broken),
                         json.dumps(list(norm_cases))], env())
                  for r in range(d * m)]
    wait_all(procs)
    jax_out = {c: np.load(out / f"jax-{c}.npz") for c in cases}
    ranks = {mesh: [(np.load(out / f"rank-{tag(mesh)}-{r}.npz"),
                     json.loads((out / f"rank-{tag(mesh)}-{r}.json")
                                .read_text()))
                    for r in range(mesh[0] * mesh[1])] for mesh in meshes}
    return jax_out, ranks


def smoke_api(arch: str):
    return build_model(dataclasses.replace(get_config(arch, smoke=True),
                                           dtype=torch.float32))


def specs_of(arch: str, mesh) -> tuple:
    """(the ``ParamSpec`` tree, the train specs at ``mesh``)."""
    like = smoke_api(arch).init_specs()
    return like, train_specs(smoke_api(arch).cfg, shape_mesh(*mesh), like)


def gathered(ranks, mesh, arch: str, run: str, what: str) -> dict:
    """``what`` (params, grads, mu, nu) of ``run`` gathered from the
    ranks' shards (copies of a replicated piece must be bitwise equal),
    by the reference's path name."""
    like, specs = specs_of(arch, mesh)
    out = {}

    def one(path, _, spec):
        name = "/".join(path)
        blocks = [torch.from_numpy(a[f"{run}/{what}/{name}"])
                  for a, _ in ranks[mesh]]
        out[name] = gather_params(blocks, spec, shape_mesh(*mesh)).numpy()

    map_with_path(one, like, specs)
    return out


def check_losses(jax_out, ranks, case: str, mesh) -> None:
    ref = jax_out[case]
    for a, _ in ranks[mesh]:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[f"{case}/{key}"],
                                       ref[f"{tag(mesh)}/{key}"],
                                       rtol=LOSS_RTOL, atol=0)
        # every rank reports the mesh's loss and norm, bitwise
        np.testing.assert_array_equal(a[f"{case}/loss"],
                                      ranks[mesh][0][0][f"{case}/loss"])


def check_params(jax_out, ranks, arch: str, case: str, mesh) -> None:
    ref = jax_out[case]
    got = gathered(ranks, mesh, arch, case, "params")
    assert set(got) == {k[len(f"{tag(mesh)}/params/"):] for k in ref.files
                        if k.startswith(f"{tag(mesh)}/params/")}
    for name, x in got.items():
        np.testing.assert_allclose(x, ref[f"{tag(mesh)}/params/{name}"],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def check_grads(jax_out, ranks, arch: str, case: str, mesh) -> None:
    ref = jax_out[case]
    for name, g in gathered(ranks, mesh, arch, case, "grads").items():
        np.testing.assert_allclose(g, ref[f"grads/{name}"], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def broken_reading(jax_out, ranks, arch: str, case: str, name: str) -> dict:
    """How far the broken run ``name`` lands from the reference at
    ``BROKEN_MESH``, each rank's own shards against the same blocks of
    the reference's whole leaves (a broken run's copies may differ, so
    nothing is gathered): the largest relative loss and grad-norm gaps
    of the three steps, the largest param gap after them, and step 1's
    grads as the largest ratio of an element's error to its bound
    (``GRAD_ATOL + GRAD_RTOL * |ref|``: above 1 misses it)."""
    mesh = BROKEN_MESH
    ref = jax_out[case]
    run = f"broken/{name}"
    like, specs = specs_of(arch, mesh)
    first = ranks[mesh][0][0]
    out = {k: float(np.max(np.abs(first[f"{run}/{k}"]
                                  / ref[f"{tag(mesh)}/{k}"] - 1)))
           for k in ("loss", "grad_norm")}
    out["params"] = out["grads"] = 0.0

    def one(path, _, spec):
        name_ = "/".join(path)
        for r, (a, _) in enumerate(ranks[mesh]):
            mine = dataclasses.replace(shape_mesh(*mesh), coords=rank_coords(
                shape_mesh(*mesh).shape, r))
            want = shard_params(torch.from_numpy(
                ref[f"{tag(mesh)}/params/{name_}"]), spec, mine).numpy()
            out["params"] = max(out["params"], float(np.abs(
                a[f"{run}/params/{name_}"] - want).max()))
            want = shard_params(torch.from_numpy(ref[f"grads/{name_}"]),
                                spec, mine).numpy()
            excess = np.abs(a[f"{run}/grads/{name_}"] - want) / (
                GRAD_ATOL + GRAD_RTOL * np.abs(want))
            out["grads"] = max(out["grads"], float(excess.max()))

    map_with_path(one, like, specs)
    return out
