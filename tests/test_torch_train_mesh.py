"""The port's mesh train step (``train.step.make_train_step(mesh=...)``:
FSDP over "data", tensor parallelism over "model") against the JAX
package's ``make_train_step`` on host meshes of the same shapes, on the
CPU.

As ``tests/torch_mesh_pair.py`` does: one JAX subprocess writes the
float32 SMOKE weights of qwen2-1.5b, minitron-8b, starcoder2-7b and
qwen2-72b (``PRNGKey(0)``) and a batch of 8 x 32 tokens; then one JAX
subprocess an architecture (four host devices) runs the reference's step
on (1, 2), (2, 1), (2, 2) and (1, 4) and ``jax.value_and_grad`` of the
unsharded loss, beside the port's ranks (a gloo group over a FileStore a
mesh, every process with its own timeout), each taking its data rank's
rows of the batch (``mesh_rows``).  Three AdamW steps (lr 1e-3, one
warmup step of four), 2 microbatches.  At (1, 4) every architecture's two
KV heads are copied onto two ranks each.

Gates, set from the reference's own spread across mesh shapes (its (2, 2)
and (1, 4) losses within 1e-7 relative of (1, 1), its params within
2.1e-5): losses and grad norms within rtol 1e-5; every gathered param
within atol 1e-4; step 1's gathered grads within rtol 1e-4 / atol 1e-6 of
``jax.value_and_grad`` (``tests/test_torch_train.py``'s bounds).  Measured
on the CPU: losses within 1.6e-7 relative, grad norms 3.2e-7, grads
3.3e-6 of each leaf's largest; params 6.3e-5, but minitron-8b's 9.96e-5
at one element of a ``wv`` whose grad is near zero, which Adam divides
by its own size (the unsharded port reads 8.0e-5 there).

The ranks also hold each differentiable collective of
``models.shardctx`` to its arithmetic on two ranks, the mesh's grad norm
to the global norm of the tree it shards, and a checkpoint written at
(2, 2) resumed by the unsharded trainer and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist.sharding import gather_params, shard_params, train_specs
from repro_torch.models import build_model, init_params, lm
from repro_torch.models.shardctx import training_mesh
from repro_torch.train import AdamWConfig, LoopConfig, run_training
from repro_torch.train.step import make_train_step, mesh_rows
from repro_torch.tree import leaves, map_with_path
from torch_mesh_pair import env, popen, shape_mesh, tag, wait_all

ARCHS = ("qwen2-1.5b", "minitron-8b", "starcoder2-7b", "qwen2-72b")
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
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

    out_dir, archs = sys.argv[1], json.loads(sys.argv[2])
    save = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32)
        params = init_params(build_model(cfg).init_specs(),
                             jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            save[arch + "/params/" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
        save[arch + "/tokens"] = np.random.default_rng(0).integers(
            0, cfg.vocab, (%(B)d, %(S)d + 1)).astype(np.int32)
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

    out_dir, arch, meshes = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    assert len(jax.devices()) >= 4, jax.devices()
    ref = np.load(out_dir + "/inputs.npz")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=jnp.float32)
    api = build_model(cfg)
    params = {}
    prefix = arch + "/params/"
    for key in ref.files:
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = params
            for k in path:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(ref[key])
    toks = ref[arch + "/tokens"]
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])}

    def keep(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            save[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

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
    np.savez(out_dir + f"/jax-{arch}.npz", **save)
""" % dict(OPT=OPT, MB=MB, STEPS=STEPS))

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys, threading
    import numpy as np
    import torch
    import torch.distributed as dist

    d, m = (int(x) for x in sys.argv[1].split("x"))
    rank, store_path, out_dir = int(sys.argv[2]), sys.argv[3], sys.argv[4]
    archs = json.loads(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, d * m),
                            rank=rank, world_size=d * m)

    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import Mode, PMDevice, USplit, Volume, VolumeGeometry
    from repro_torch.data import TokenPipeline
    from repro_torch.dist.sharding import (axis_dim, first_holder,
                                           shard_params)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import shardctx
    from repro_torch.train import AdamWConfig, LoopConfig, run_training
    from repro_torch.train.optimizer import global_norm, sharded_norm
    from repro_torch.train.step import (make_mesh_loss_and_grad,
                                        make_train_step, mesh_rows)
    from repro_torch.tree import leaves, map_with_path, unflatten

    mesh = make_mesh((d, m))
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

    opt = AdamWConfig(**%(OPT)r)
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32)
        api = build_model(cfg)
        toks = torch.from_numpy(ref[arch + "/tokens"])
        rows = mesh_rows(%(B)d, %(MB)d, d, mesh.coords["data"])
        batch = {"tokens": toks[rows, :-1].contiguous(),
                 "targets": toks[rows, 1:].contiguous()}
        step, init, specs = make_train_step(api, opt, microbatches=%(MB)d,
                                            mesh=mesh)
        # step 1's grads, reduced over the mesh
        lg = make_mesh_loss_and_grad(api, mesh, specs, %(MB)d)
        _, grads = lg(shard_params(convert.params_from_numpy(
            nest(arch + "/params/"), device="cpu"), specs, mesh), batch)
        keep(arch + "/grads/", grads)
        state = init(convert.params_from_numpy(nest(arch + "/params/"),
                                               device="cpu"), device="cpu")
        losses, norms = [], []
        for _ in range(%(STEPS)d):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        save[arch + "/loss"] = np.asarray(losses)
        save[arch + "/grad_norm"] = np.asarray(norms)
        keep(arch + "/params/", state["params"])
        keep(arch + "/mu/", state["opt"]["mu"])
        if arch == archs[0]:
            # the mesh's norm of the shards of a known tree: each shared
            # piece once, the global norm of the whole tree
            tree = convert.params_from_numpy(nest(arch + "/params/"),
                                             device="cpu")
            owned = []
            map_with_path(lambda _, __, s: owned.append(first_holder(s, mesh)),
                          api.init_specs(), specs)
            out["norm"] = [float(sharded_norm(shard_params(tree, specs, mesh),
                                              owned)),
                           float(global_norm(tree))]

    # each differentiable collective against its arithmetic, two ranks
    def inputs(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(3, 4, 6, generator=g)

    if (d, m) in ((1, 2), (2, 1)):
        group = mesh.groups["model" if m == 2 else "data"]
        r = dist.get_rank(group)
        xs = [inputs(i) for i in range(2)]           # every rank's input
        us = [inputs(10 + i) for i in range(2)]      # every rank's grad in
        errs = {}

        def run(name, fn, want_y, want_dx, u):
            x = xs[r].clone().requires_grad_()
            y = fn(x)
            (dx,) = torch.autograd.grad(y, x, u)
            errs[name] = [float((y - want_y).abs().max()),
                          float((dx - want_dx).abs().max())]

        if m == 2:
            with shardctx.training_mesh(model=group):
                # sum forward, identity backward (one replicated grad in)
                run("model_all_reduce", shardctx.model_all_reduce,
                    xs[0] + xs[1], us[0], us[0])
                # identity forward, the ranks' grads summed backward
                run("model_entry", shardctx.model_entry, xs[r],
                    us[0] + us[1], us[r])
                # blocks concatenated forward, this rank's block backward
                wide = torch.cat([inputs(20), inputs(21)], dim=-1)
                run("gather_vocab", shardctx.gather_vocab,
                    torch.cat(xs, dim=-1), wide[..., 6 * r:6 * (r + 1)],
                    wide)
        else:
            for dim in (0, 1):
                with shardctx.training_mesh(data=group, dims={"w": dim}):
                    whole = torch.cat(xs, dim=dim)
                    wide = [torch.cat([inputs(30 + i), inputs(40 + i)],
                                      dim=dim) for i in range(2)]
                    total = (wide[0] + wide[1]).narrow(dim, 3 * r if dim == 0
                                                       else 4 * r,
                                                       xs[0].shape[dim])
                    run(f"fsdp_gather dim {dim}",
                        lambda x: shardctx.fsdp_params({"w": x}, ())["w"],
                        whole, total, wide[r])
        out["collectives"] = errs

    if (d, m) == (2, 2):
        # the backward on another thread, as autograd's CUDA device thread
        # runs it: the remat recompute must still see the groups
        cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                                  dtype=torch.float32)
        api = build_model(cfg)
        _, _, specs = make_train_step(api, opt, mesh=mesh)
        dims = map_with_path(lambda _, __, s: axis_dim(s, "data"),
                             api.init_specs(), specs)
        shards = shard_params(convert.params_from_numpy(
            nest("qwen2-1.5b/params/"), device="cpu"), specs, mesh)
        flat = [x.requires_grad_() for x in leaves(shards)]
        toks = torch.from_numpy(ref["qwen2-1.5b/tokens"][:2])
        with shardctx.training_mesh(mesh.groups["model"],
                                    mesh.groups["data"], dims):
            loss = api.loss(unflatten(shards, flat),
                            {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
            here = torch.autograd.grad(loss, flat, retain_graph=True)
        there = {}

        def backward():
            try:
                there["grads"] = torch.autograd.grad(loss, flat)
            except Exception as e:
                there["error"] = repr(e)

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
        out["thread"] = there.get("error") or all(
            torch.equal(a, b) for a, b in zip(here, there["grads"]))

        # a checkpoint written on the mesh resumes unsharded, and the other
        # way round
        lopt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)

        def store():
            geometry = VolumeGeometry(meta_blocks=256, journal_blocks=512,
                                      oplog_slots=1, oplog_blocks=64)
            vol = Volume.format(PMDevice(size=256 * 1024 * 1024), geometry)
            return USplit(vol, mode=Mode.SYNC, staging_file_bytes=8 << 20,
                          staging_prealloc=2, staging_background=False)

        def train(on_mesh, ckpt=None, crash_at=None):
            pipe = TokenPipeline(cfg, global_batch=8, seq_len=16, seed=7)
            return run_training(api, pipe, LoopConfig(
                steps=4, ckpt_every=2, microbatches=2), lopt, ckpt=ckpt,
                device="cpu", crash_at=crash_at,
                mesh=mesh if on_mesh else None)

        ck = {"mesh": train(True).losses}
        if rank == 0:
            ck["one"] = train(False).losses
        ckpt = CheckpointManager(store()) if rank == 0 else None
        try:
            train(True, ckpt, crash_at=2)
            raise AssertionError("no crash")
        except RuntimeError as e:
            assert "injected crash at step 2" in str(e), e
        if rank == 0:
            res = train(False, ckpt)
            ck["mesh_to_one"] = [res.restored_from] + res.losses
            ckpt = CheckpointManager(store())
            try:
                train(False, ckpt, crash_at=2)
                raise AssertionError("no crash")
            except RuntimeError as e:
                assert "injected crash at step 2" in str(e), e
        res = train(True, ckpt)
        ck["one_to_mesh"] = [res.restored_from] + res.losses
        out["ckpt"] = ck
    np.savez(f"{out_dir}/rank-{d}x{m}-{rank}.npz", **save)
    with open(f"{out_dir}/rank-{d}x{m}-{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""" % dict(OPT=OPT, B=B, MB=MB, STEPS=STEPS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, then a JAX process an architecture beside the port's
    ranks (a gloo group a mesh, each rank running every architecture).
    Returns (the JAX outputs by arch, the ranks' arrays and records by
    mesh)."""
    out = tmp_path_factory.mktemp("train_mesh")
    wait_all([popen([_INPUTS_SCRIPT, str(out), json.dumps(ARCHS)], env())])
    procs = [popen([_JAX_SCRIPT, str(out), arch, json.dumps(MESHES)], env(4))
             for arch in ARCHS]
    for d, m in MESHES:
        store = out / f"store-{d}x{m}"
        procs += [popen([_RANK_SCRIPT, f"{d}x{m}", str(r), str(store),
                         str(out), json.dumps(ARCHS)], env())
                  for r in range(d * m)]
    wait_all(procs)
    jax_out = {a: np.load(out / f"jax-{a}.npz") for a in ARCHS}
    ranks = {mesh: [(np.load(out / f"rank-{tag(mesh)}-{r}.npz"),
                     json.loads((out / f"rank-{tag(mesh)}-{r}.json")
                                .read_text()))
                    for r in range(mesh[0] * mesh[1])] for mesh in MESHES}
    return jax_out, ranks


def smoke_api(arch: str):
    return build_model(dataclasses.replace(get_config(arch, smoke=True),
                                           dtype=torch.float32))


def gathered(ranks, mesh, arch: str, what: str) -> dict:
    """``what`` (params, grads, mu) of ``arch`` gathered from the ranks'
    shards (copies of a replicated piece must be bitwise equal), by the
    reference's path name."""
    api = smoke_api(arch)
    like = api.init_specs()
    specs = train_specs(api.cfg, shape_mesh(*mesh), like)
    out = {}

    def one(path, _, spec):
        name = "/".join(path)
        blocks = [torch.from_numpy(a[f"{arch}/{what}/{name}"])
                  for a, _ in ranks[mesh]]
        out[name] = gather_params(blocks, spec, shape_mesh(*mesh)).numpy()

    map_with_path(one, like, specs)
    return out


CASES = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES, ids=lambda x: (
    x if isinstance(x, str) else tag(x)))
def test_losses_and_grad_norms_match_the_reference(runs, arch, mesh):
    jax_out, ranks = runs
    ref = jax_out[arch]
    for a, _ in ranks[mesh]:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[f"{arch}/{key}"],
                                       ref[f"{tag(mesh)}/{key}"],
                                       rtol=LOSS_RTOL, atol=0)
        # every rank reports the mesh's loss and norm, bitwise
        np.testing.assert_array_equal(a[f"{arch}/loss"],
                                      ranks[mesh][0][0][f"{arch}/loss"])


@pytest.mark.parametrize("arch,mesh", CASES, ids=lambda x: (
    x if isinstance(x, str) else tag(x)))
def test_gathered_params_match_the_reference(runs, arch, mesh):
    jax_out, ranks = runs
    ref = jax_out[arch]
    got = gathered(ranks, mesh, arch, "params")
    assert set(got) == {k[len(f"{tag(mesh)}/params/"):] for k in ref.files
                        if k.startswith(f"{tag(mesh)}/params/")}
    for name, x in got.items():
        np.testing.assert_allclose(x, ref[f"{tag(mesh)}/params/{name}"],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch,mesh", CASES, ids=lambda x: (
    x if isinstance(x, str) else tag(x)))
def test_step_one_grads_match_value_and_grad(runs, arch, mesh):
    jax_out, ranks = runs
    ref = jax_out[arch]
    for name, g in gathered(ranks, mesh, arch, "grads").items():
        np.testing.assert_allclose(g, ref[f"grads/{name}"], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_copies_and_replicated_leaves_stay_bitwise_equal(runs, mesh):
    """gather_params raises where two holders of a piece differ: every
    copied KV head and every leaf replicated over an axis, params and
    moments, after three steps.  At (1, 4) ranks 0 and 1 hold one KV head
    and ranks 2 and 3 the other."""
    _, ranks = runs
    for arch in ARCHS:
        for what in ("params", "mu"):
            gathered(ranks, mesh, arch, what)
    if mesh == (1, 4):
        a = [r for r, _ in ranks[mesh]]
        key = "qwen2-1.5b/params/group/b0_attn/attn/wk"
        np.testing.assert_array_equal(a[0][key], a[1][key])
        np.testing.assert_array_equal(a[2][key], a[3][key])
        assert not np.array_equal(a[0][key], a[2][key])


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_mesh_norm_counts_each_shared_piece_once(runs, mesh):
    _, ranks = runs
    for _, rec in ranks[mesh]:
        got, want = rec["norm"]
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", ["model_all_reduce", "model_entry",
                                  "gather_vocab", "fsdp_gather dim 0",
                                  "fsdp_gather dim 1"])
def test_differentiable_collectives_match_their_arithmetic(runs, name):
    _, ranks = runs
    mesh = (2, 1) if name.startswith("fsdp") else (1, 2)
    for _, rec in ranks[mesh]:
        y_err, dx_err = rec["collectives"][name]
        assert y_err == 0.0 and dx_err == 0.0, (name, y_err, dx_err)


def test_backward_on_another_thread_sees_the_groups(runs):
    """On the card autograd runs the backward, and so the remat'd
    recompute with its collectives, on its device thread, which does not
    see the caller's context: ``shardctx.bind`` carries the groups into
    it.  The same grads, bitwise, as a backward on the caller's thread."""
    _, ranks = runs
    for _, rec in ranks[(2, 2)]:
        assert rec["thread"] is True, rec["thread"]


@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_checkpoint_resumes_across_mesh_shapes(runs, direction):
    """A (2, 2) checkpoint resumed by the unsharded trainer on rank 0, and
    an unsharded one resumed at (2, 2) on every rank: steps 3-4 as in a
    run that never stopped."""
    _, ranks = runs
    recs = [rec["ckpt"] for _, rec in ranks[(2, 2)]]
    whole = recs[0]["one"] if direction == "mesh_to_one" \
        else recs[0]["mesh"]
    np.testing.assert_allclose(recs[0]["mesh"], recs[0]["one"],
                               rtol=LOSS_RTOL)
    for ck in recs[:1] if direction == "mesh_to_one" else recs:
        restored_from, *losses = ck[direction]
        assert restored_from == 2
        np.testing.assert_allclose(losses, whole[2:], rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch,item", [
    ("mamba2-1.3b", "7.6d"), ("recurrentgemma-9b", "7.6d"),
    ("whisper-large-v3", "7.6d"), ("internvl2-1b", "7.6d")])
def test_other_families_raise(arch, item):
    """The other families train over the mesh
    (``tests/test_torch_train_mesh_state.py`` and
    ``tests/test_torch_train_mesh_encdec.py`` hold them to the
    reference), with a pod axis too (``item``, done:
    ``tests/test_torch_train_pod_mesh.py``).  What still raises for
    them: a pod group beside a mesh, which points at the mesh's pod axis
    and no longer waits for ``item``, and a monitor or a policy over a
    mesh (ROADMAP item 7.6e)."""
    api = build_model(get_config(arch, smoke=True))
    assert callable(make_train_step(api, AdamWConfig(),
                                    mesh=shape_mesh(2, 2))[0])
    with pytest.raises(ValueError, match="pod axis") as err:
        make_train_step(api, AdamWConfig(), mesh=shape_mesh(2, 2),
                        pod_group=object())
    assert item not in str(err.value)
    with pytest.raises(ValueError, match="pod axis") as err:
        run_training(api, None, LoopConfig(), AdamWConfig(), device="cpu",
                     mesh=shape_mesh(2, 2), pod_group=object())
    assert item not in str(err.value)
    for fault in ("monitor", "policy"):
        with pytest.raises(ValueError, match="item 7.6e"):
            run_training(api, None, LoopConfig(), AdamWConfig(),
                         device="cpu", mesh=shape_mesh(2, 2),
                         **{fault: object()})


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-lite-16b"])
def test_moe_family_builds_a_mesh_step(arch):
    """The MoE family trains over the mesh
    (``tests/test_torch_train_mesh_moe.py`` holds it to the reference)."""
    api = build_model(get_config(arch, smoke=True))
    step, init, specs = make_train_step(api, AdamWConfig(),
                                        mesh=shape_mesh(2, 2))
    assert callable(step) and callable(init)
    assert specs["group"]["b0_attn"]["moe"]["router"] == (None, "data")


def test_a_pod_group_beside_a_mesh_raises():
    """One way to ask for a pod: the mesh's pod axis, not a group beside
    it."""
    api = smoke_api("qwen2-1.5b")
    with pytest.raises(ValueError, match=r"make_mesh\(\(pod, data, model"):
        make_train_step(api, AdamWConfig(), mesh=shape_mesh(2, 2),
                        pod_group=object())
    with pytest.raises(ValueError, match=r"make_mesh\(\(pod, data, model"):
        run_training(api, None, LoopConfig(), AdamWConfig(), device="cpu",
                     mesh=shape_mesh(2, 2), pod_group=object())


def test_rows_of_each_microbatch():
    """Microbatch i is rows [i*mb, (i+1)*mb); data rank 1 of 2 takes the
    second half of each."""
    assert mesh_rows(8, 2, 2, 1) == [2, 3, 6, 7]
    assert mesh_rows(8, 2, 1, 0) == list(range(8))
    with pytest.raises(ValueError, match="does not split"):
        mesh_rows(8, 2, 3, 0)


def _two_steps(step, init, arch: str) -> tuple:
    api = smoke_api(arch)
    state = init(init_params(api.init_specs(),
                             torch.Generator().manual_seed(3),
                             device="cpu"), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, api.cfg.vocab, (4, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    out = []
    for _ in range(2):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state


def test_no_mesh_is_the_unsharded_step_bit_for_bit():
    """``mesh=None`` and a mesh of one rank give the same state, bitwise,
    and the model code under a training context without groups is the
    code without one: every new collective point is the identity."""
    api = smoke_api("qwen2-1.5b")
    opt = AdamWConfig(**OPT)
    a = make_train_step(api, opt, microbatches=2)
    b = make_train_step(api, opt, microbatches=2, mesh=shape_mesh(1, 1))
    assert a[2] is None and b[2] is not None
    (ma, sa), (mb_, sb) = _two_steps(*a[:2], "qwen2-1.5b"), \
        _two_steps(*b[:2], "qwen2-1.5b")
    assert ma == mb_
    for x, y in zip(leaves(sa), leaves(sb)):
        assert torch.equal(x, y)
    params = convert.params_from_numpy(convert.to_numpy(sa["params"]),
                                       device="cpu")
    toks = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    flat = [p.requires_grad_() for p in leaves(params)]
    loss = lm.lm_loss(params, api.cfg, toks, toks)
    plain = torch.autograd.grad(loss, flat)
    dims = map_with_path(lambda *_: 0, params)
    with training_mesh(None, None, dims):
        loss2 = lm.lm_loss(params, api.cfg, toks, toks)
        ctx = torch.autograd.grad(loss2, flat)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(x, y) for x, y in zip(plain, ctx))


def test_specs_shard_and_gather_back():
    """Every dense architecture's full-width train specs shard a SMOKE
    tree and gather it back exactly on each mesh; at (1, 4) a copied KV
    head's block is held by two ranks."""
    api = smoke_api("qwen2-1.5b")
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    for d, m in MESHES:
        specs = train_specs(api.cfg, shape_mesh(d, m), api.init_specs())
        shards = []
        for r in range(d * m):
            mesh = dataclasses.replace(shape_mesh(d, m), coords={
                "data": r // m, "model": r % m})
            shards.append(shard_params(params, specs, mesh))
        back = gather_params(shards, specs, shape_mesh(d, m))
        assert all(torch.equal(x, y) for x, y in zip(leaves(back),
                                                     leaves(params)))
        attn = specs["group"]["b0_attn"]["attn"]
        assert attn["wq"] == (None, "data", "model")
        assert attn["wo"] == (None, "model", "data")
        assert attn["bq"] == (None, "model")
        assert specs["embed"] == ("model", "data")
        if m == 4:                       # two KV heads, each on two ranks
            assert attn["wk"][-1].blocks == 2
