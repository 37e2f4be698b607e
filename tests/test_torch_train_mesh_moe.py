"""The port's mesh train step for the MoE family (grok-1-314b: GQA with a
softcap and 4 experts top-2 at SMOKE width; deepseek-v2-lite-16b: MLA and
8 experts top-2 plus a shared expert) against the JAX package's
``make_train_step`` on host meshes of the same shapes, on the CPU.

As ``tests/test_torch_train_mesh.py`` does: one JAX subprocess writes the
float32 SMOKE weights (``PRNGKey(0)``) and a batch of 8 x 32 tokens a
case; then one JAX subprocess a case (four host devices) runs the
reference's step on each of its meshes and its unsharded
``make_loss_and_grad`` (the capacity is a microbatch's), beside the
port's ranks (a gloo group over a FileStore a mesh, every process with
its own timeout), each taking its data rank's rows of the batch
(``mesh_rows``).  Three AdamW steps (lr 1e-3, one warmup step of four,
eps 1e-6), 2 microbatches of 4 x 32 tokens.

The cases: both architectures on (1, 2), (2, 1), (2, 2) and (1, 4)
(whole experts a rank, the router and MLA's latent whole on every model
rank; grok's two KV heads copied at (1, 4)); grok with 6 experts at
(1, 4), where "model" does not divide the experts and their FFN splits;
and deepseek with router column 0 of every layer scaled by
``OVERFLOW_SCALE`` = 16 at (2, 1) and (2, 2), so that expert 0 overflows
each microbatch's capacity (64 rows: 2 x 128 tokens x 2 picks / 8) and
the count over "data" decides which picks drop.  There the ranks also run
the step with each data shard counting its own rows (the ``shard_map``
rule, ``layers.data_size`` patched to 1), which must not match.

Gates, the dense file's: losses and grad norms within rtol 1e-5; every
gathered param within atol 1e-4; step 1's gathered grads within rtol
1e-4 / atol 1e-6 of the reference's.  Every leaf a mesh axis leaves
whole (the router, ``w_dkv``, the norms; both moments too) stays bitwise
equal across its holders after three steps (``gather_params`` raises
otherwise).

Adam's eps is 1e-6 here, not the default 1e-8: at 1e-8 an element whose
grad cancels to ~1e-9 takes an update of up to ``lr`` whose size rests on
rounding (g / (|g| + eps) with |g| ~ eps), and with it the port's
unsharded step parts from the reference's beyond these gates on the
overflow case (step 2's grad norm) though step 1's grads agree, as do
single elements of grok's ``lm_head`` at (2, 1).  At 1e-6 such updates
shrink below the gates' reach and every other quantity is held as
tightly as the dense file holds it.
"""

from __future__ import annotations

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist.sharding import gather_params, train_specs
from repro_torch.models import build_model, layers
from repro_torch.train import AdamWConfig
from repro_torch.train.step import make_train_step
from repro_torch.tree import map_with_path
from torch_mesh_pair import env, popen, shape_mesh, tag, wait_all

MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
OVERFLOW_SCALE = 16.0           # as tests/test_torch_serve_step_moe.py
# case -> (arch, meshes, config overrides, router column 0's scale)
CASES = {
    "grok-1-314b": ("grok-1-314b", MESHES, {}, 1.0),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", MESHES, {}, 1.0),
    "grok-6-experts": ("grok-1-314b", ((1, 4),), {"n_experts": 6}, 1.0),
    "deepseek-overflow": ("deepseek-v2-lite-16b", ((2, 1), (2, 2)), {},
                          OVERFLOW_SCALE),
}
OVERFLOW = "deepseek-overflow"
B, S, MB, STEPS = 8, 32, 2, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-6)
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
    for case, (arch, _, over, scale) in cases.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32, **over)
        params = init_params(build_model(cfg).init_specs(),
                             jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            name = "/".join(k.key for k in path)
            leaf = np.array(leaf)
            if name.endswith("moe/router"):
                leaf[..., 0] *= scale
            save[case + "/params/" + name] = leaf
        save[case + "/tokens"] = np.random.default_rng(0).integers(
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
    from repro.train.step import make_loss_and_grad, make_train_step

    out_dir, case, arch = sys.argv[1:4]
    meshes, over = json.loads(sys.argv[4]), json.loads(sys.argv[5])
    assert len(jax.devices()) >= 4, jax.devices()
    ref = np.load(out_dir + "/inputs.npz")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=jnp.float32, **over)
    api = build_model(cfg)
    params = {}
    prefix = case + "/params/"
    for key in ref.files:
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = params
            for k in path:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(ref[key])
    toks = ref[case + "/tokens"]
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])}

    def keep(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            save[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

    save = {}
    loss, grads = jax.jit(make_loss_and_grad(api, %(MB)d))(params, batch)
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
    import collections, dataclasses, json, sys, threading
    import numpy as np
    import torch
    import torch.distributed as dist

    d, m = (int(x) for x in sys.argv[1].split("x"))
    rank, store_path, out_dir = int(sys.argv[2]), sys.argv[3], sys.argv[4]
    cases = json.loads(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, d * m),
                            rank=rank, world_size=d * m)

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import axis_dim, shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, layers, shardctx
    from repro_torch.train import AdamWConfig
    from repro_torch.train.step import (make_mesh_loss_and_grad,
                                        make_train_step, mesh_rows)
    from repro_torch.tree import leaves, map_with_path, unflatten

    mesh = make_mesh((d, m))
    groups = {id(g): axis for axis, g in mesh.groups.items()}
    groups.update({id(g): "copies" for g in mesh.copy_groups.values()})
    ref = np.load(out_dir + "/inputs.npz")
    save, out = {}, {"collectives": {}}

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

    # the picks each routing drops (forward and remat recompute)
    drops = []
    route = layers.moe_route

    def counting_route(p, cfg, xt):
        res = route(p, cfg, xt)
        drops.append(int((~res[2]).sum()))
        return res

    layers.moe_route = counting_route

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
    for case, (arch, meshes, over, _) in cases.items():
        if [d, m] not in meshes:
            continue
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, **over)
        api = build_model(cfg)
        toks = torch.from_numpy(ref[case + "/tokens"])
        rows = mesh_rows(%(B)d, %(MB)d, d, mesh.coords["data"])
        batch = {"tokens": toks[rows, :-1].contiguous(),
                 "targets": toks[rows, 1:].contiguous()}
        step, init, specs = make_train_step(api, opt, microbatches=%(MB)d,
                                            mesh=mesh)
        # step 1's grads, reduced over the mesh
        lg = make_mesh_loss_and_grad(api, mesh, specs, %(MB)d)
        _, grads = lg(shard_params(convert.params_from_numpy(
            nest(case + "/params/"), device="cpu"), specs, mesh), batch)
        keep(case + "/grads/", grads)
        runs = [(case, None)]
        if case == "%(OVERFLOW)s":      # each data shard counting its own
            runs.append((case + "/per-shard", lambda: 1))
        for tag, size in runs:
            if size is not None:
                layers.data_size = size
            state = init(convert.params_from_numpy(nest(case + "/params/"),
                                                   device="cpu"),
                         device="cpu")
            losses, norms, dropped = [], [], []
            for s in range(%(STEPS)d):
                drops.clear()
                counts.clear()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
                dropped.append(sum(drops))
                if s == 1 and size is None:
                    out["collectives"][case] = [
                        [k, a, n] for (k, a), n in sorted(counts.items())]
            layers.data_size = shardctx.data_size
            save[tag + "/loss"] = np.asarray(losses)
            save[tag + "/grad_norm"] = np.asarray(norms)
            save[tag + "/dropped"] = np.asarray(dropped)
            keep(tag + "/params/", state["params"])
            keep(tag + "/mu/", state["opt"]["mu"])
            keep(tag + "/nu/", state["opt"]["nu"])

    if (d, m) == (2, 2):
        # autograd runs the backward, so the remat recompute and its
        # expert count over "data", on its device thread: the groups
        # must reach it
        case = "%(OVERFLOW)s"
        arch, _, over, _ = cases[case]
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, **over)
        api = build_model(cfg)
        _, _, specs = make_train_step(api, opt, mesh=mesh)
        dims = map_with_path(lambda _, __, s: axis_dim(s, "data"),
                             api.init_specs(), specs)
        shards = shard_params(convert.params_from_numpy(
            nest(case + "/params/"), device="cpu"), specs, mesh)
        flat = [x.requires_grad_() for x in leaves(shards)]
        toks = torch.from_numpy(ref[case + "/tokens"])
        rows = mesh_rows(4, 1, d, mesh.coords["data"])
        counts_in = torch.arange(8, dtype=torch.int64) * (rank + 1)
        there = {}
        with shardctx.training_mesh(mesh.groups["model"],
                                    mesh.groups["data"], dims):
            here_prefix = shardctx.data_prefix(counts_in)
            bound = shardctx.bind(shardctx.data_prefix)
            loss = api.loss(unflatten(shards, flat),
                            {"tokens": toks[rows, :-1],
                             "targets": toks[rows, 1:]})
            here = torch.autograd.grad(loss, flat, retain_graph=True)

        def elsewhere():
            try:
                there["bound"] = bound(counts_in)
                there["unbound"] = shardctx.data_prefix(counts_in)
                there["grads"] = torch.autograd.grad(loss, flat)
            except Exception as e:
                there["error"] = repr(e)

        worker = threading.Thread(target=elsewhere)
        worker.start()
        worker.join()
        out["thread"] = there.get("error") or {
            "prefix": here_prefix.tolist(),
            "bound": there["bound"].tolist(),
            "unbound": there["unbound"].tolist(),
            "grads_equal": all(torch.equal(a, b)
                               for a, b in zip(here, there["grads"]))}
    np.savez(f"{out_dir}/rank-{d}x{m}-{rank}.npz", **save)
    with open(f"{out_dir}/rank-{d}x{m}-{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""" % dict(OPT=OPT, B=B, MB=MB, STEPS=STEPS, OVERFLOW=OVERFLOW))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, then a JAX process a case beside the port's ranks (a
    gloo group a mesh, each rank running every case of its mesh).
    Returns (the JAX outputs by case, the ranks' arrays and records by
    mesh, the inputs)."""
    out = tmp_path_factory.mktemp("train_mesh_moe")
    wait_all([popen([_INPUTS_SCRIPT, str(out), json.dumps(CASES)], env())])
    procs = [popen([_JAX_SCRIPT, str(out), case, arch, json.dumps(meshes),
                    json.dumps(over)], env(4))
             for case, (arch, meshes, over, _) in CASES.items()]
    for d, m in MESHES:
        store = out / f"store-{d}x{m}"
        procs += [popen([_RANK_SCRIPT, f"{d}x{m}", str(r), str(store),
                         str(out), json.dumps(CASES)], env())
                  for r in range(d * m)]
    wait_all(procs)
    jax_out = {c: np.load(out / f"jax-{c}.npz") for c in CASES}
    ranks = {mesh: [(np.load(out / f"rank-{tag(mesh)}-{r}.npz"),
                     json.loads((out / f"rank-{tag(mesh)}-{r}.json")
                                .read_text()))
                    for r in range(mesh[0] * mesh[1])] for mesh in MESHES}
    return jax_out, ranks, dict(np.load(out / "inputs.npz"))


def case_api(case: str):
    arch, _, over, _ = CASES[case]
    return build_model(dataclasses.replace(get_config(arch, smoke=True),
                                           dtype=torch.float32, **over))


def gathered(ranks, mesh, case: str, what: str, run: str = None) -> dict:
    """``what`` (params, grads, mu, nu) of ``case`` (or of its ``run``)
    gathered from the ranks' shards (copies of a replicated piece must be
    bitwise equal), by the reference's path name."""
    api = case_api(case)
    like = api.init_specs()
    specs = train_specs(api.cfg, shape_mesh(*mesh), like)
    out = {}

    def one(path, _, spec):
        name = "/".join(path)
        blocks = [torch.from_numpy(a[f"{run or case}/{what}/{name}"])
                  for a, _ in ranks[mesh]]
        out[name] = gather_params(blocks, spec, shape_mesh(*mesh)).numpy()

    map_with_path(one, like, specs)
    return out


PAIRS = [(c, m) for c, (_, ms, _, _) in CASES.items() for m in ms]
IDS = [f"{c}-{tag(m)}" for c, m in PAIRS]


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_losses_and_grad_norms_match_the_reference(runs, case, mesh):
    jax_out, ranks, _ = runs
    ref = jax_out[case]
    for a, _ in ranks[mesh]:
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[f"{case}/{key}"],
                                       ref[f"{tag(mesh)}/{key}"],
                                       rtol=LOSS_RTOL, atol=0)
        # every rank reports the mesh's loss and norm, bitwise
        np.testing.assert_array_equal(a[f"{case}/loss"],
                                      ranks[mesh][0][0][f"{case}/loss"])


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_gathered_params_match_the_reference(runs, case, mesh):
    jax_out, ranks, _ = runs
    ref = jax_out[case]
    got = gathered(ranks, mesh, case, "params")
    assert set(got) == {k[len(f"{tag(mesh)}/params/"):] for k in ref.files
                        if k.startswith(f"{tag(mesh)}/params/")}
    for name, x in got.items():
        np.testing.assert_allclose(x, ref[f"{tag(mesh)}/params/{name}"],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_step_one_grads_match_value_and_grad(runs, case, mesh):
    jax_out, ranks, _ = runs
    ref = jax_out[case]
    for name, g in gathered(ranks, mesh, case, "grads").items():
        np.testing.assert_allclose(g, ref[f"grads/{name}"], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_replicated_leaves_stay_bitwise_equal(runs, mesh):
    """gather_params raises where two holders of a piece differ: the
    router, MLA's ``w_dkv``, the norms (whole over "model") and grok's
    copied KV heads at (1, 4), params and both moments, after three
    steps.  Where "model" splits, the router and ``w_dkv`` are the same
    bytes on every model rank."""
    _, ranks, _ = runs
    for case, (_, meshes, _, _) in CASES.items():
        if mesh in meshes:
            for what in ("params", "mu", "nu"):
                gathered(ranks, mesh, case, what)
    a = [r for r, _ in ranks[mesh]]
    for key in ("deepseek-v2-lite-16b/params/group/b0_attn/moe/router",
                "deepseek-v2-lite-16b/params/group/b0_attn/attn/w_dkv",
                "grok-1-314b/nu/group/b0_attn/moe/router"):
        for r in range(1, mesh[1]):          # the model ranks of data rank 0
            np.testing.assert_array_equal(a[0][key], a[r][key])


def unsharded_drops(inputs: dict) -> np.ndarray:
    """The picks the port's unsharded step drops, a step, on the overflow
    case: each routing counted, forward and remat recompute, as the ranks
    count them."""
    api = case_api(OVERFLOW)
    prefix = f"{OVERFLOW}/params/"
    tree = {}
    for key, x in inputs.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[last] = x.copy()
    toks = torch.from_numpy(inputs[f"{OVERFLOW}/tokens"])
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    step, init, _ = make_train_step(api, AdamWConfig(**OPT), microbatches=MB)
    state = init(convert.params_from_numpy(tree, device="cpu"), device="cpu")
    drops, out = [], []
    inner = layers.moe_route

    def route(p, cfg, xt):
        res = inner(p, cfg, xt)
        drops.append(int((~res[2]).sum()))
        return res

    layers.moe_route = route
    try:
        for _ in range(STEPS):
            drops.clear()
            state, _ = step(state, batch)
            out.append(sum(drops))
    finally:
        layers.moe_route = inner
    return np.asarray(out)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=tag)
def test_overflow_is_counted_over_data(runs, mesh):
    """Router column 0 x 16: expert 0 overflows each microbatch's
    capacity, so picks drop.  Counted over "data", the picks the data
    ranks drop add up to the unsharded step's, and the port matches the
    reference (the parity tests above); a rank that counts its own rows
    (the ``shard_map`` rule) drops others and parts from the reference."""
    jax_out, ranks, inputs = runs
    ref = jax_out[OVERFLOW]
    first = [a for a, _ in ranks[mesh][::mesh[1]]]   # model rank 0 of each
    got = sum(a[f"{OVERFLOW}/dropped"] for a in first)
    shard = sum(a[f"{OVERFLOW}/per-shard/dropped"] for a in first)
    assert got[0] > 0, got
    np.testing.assert_array_equal(got, unsharded_drops(inputs))
    assert (shard != got).any(), (shard, got)
    loss = ranks[mesh][0][0][f"{OVERFLOW}/per-shard/loss"]
    params = gathered(ranks, mesh, OVERFLOW, "params",
                      run=f"{OVERFLOW}/per-shard")
    loss_gap = float(np.max(np.abs(loss / ref[f"{tag(mesh)}/loss"] - 1)))
    param_gap = max(float(np.abs(x - ref[f"{tag(mesh)}/params/{n}"]).max())
                    for n, x in params.items())
    assert loss_gap > LOSS_RTOL and param_gap > PARAM_ATOL, (loss_gap,
                                                             param_gap)


def test_backward_on_another_thread_sees_the_data_group(runs):
    """On the card autograd runs the backward, and so the remat'd
    recompute with the MoE's expert count over "data", on its device
    thread, which does not see the caller's context: under ``bind``,
    ``data_prefix`` there gathers the earlier data shards' counts (rank
    r's counts are ``arange(8) * (r + 1)``), without it sees no group
    (zeros), and the backward gives the caller's grads bitwise."""
    _, ranks, _ = runs
    for r, (_, rec) in enumerate(ranks[(2, 2)]):
        t = rec["thread"]
        assert isinstance(t, dict), t
        # data rank 1 (ranks 2, 3) adds data rank 0's counts: ranks 0, 1
        earlier = [r % 2 + 1] if r >= 2 else []
        want = [sum(i * k for k in earlier) for i in range(8)]
        assert t["prefix"] == want and t["bound"] == want, (r, t)
        assert t["unbound"] == [0] * 8, (r, t)
        assert t["grads_equal"] is True, (r, t)


def model_all_reduces(case: str) -> int:
    """The all_reduces over "model" of one step at model > 1: a
    microbatch's embedding sum and output head entry, and a layer's
    attention sum (forward and remat recompute), its column entries
    (GQA: ``x``; MLA: ``x`` before ``wq`` and the latent), the MoE's sum
    (the recompute stops before it: nothing after it is saved) and its
    two entries (the routing weights; the dispatched rows, one entry
    with the shared experts' input)."""
    cfg = case_api(case).cfg
    attn = 2 + (2 if cfg.mla else 1)
    return MB * (2 + cfg.n_layers * (attn + 1 + 2))


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_collectives_a_step(runs, case, mesh):
    """Each rank's collectives in step 2, by the mesh axis of their group:
    over "model" ``model_all_reduces`` and one logits gather a microbatch;
    over "data" one ``all_gather`` of the [E] expert counts a layer a
    microbatch, forward and recompute (``shardctx.data_prefix``)."""
    _, ranks, _ = runs
    d, m = mesh
    cfg = case_api(case).cfg
    for _, rec in ranks[mesh]:
        got = {(k, a): n for k, a, n in rec["collectives"][case]}
        assert got.get(("all_reduce", "model"), 0) == (
            model_all_reduces(case) if m > 1 else 0), got
        assert got.get(("all_gather", "model"), 0) == (
            MB if m > 1 else 0), got
        assert got.get(("all_gather", "data"), 0) == (
            2 * cfg.n_layers * MB if d > 1 else 0), got


def test_moe_train_specs():
    """The reference's rules on the full-width configs at (2, 2): whole
    experts a model rank with FSDP on D, the router and MLA's latent
    whole over "model"; where "model" does not divide the experts (grok
    with 6 at (1, 4)) they stay whole and their FFN splits."""
    mesh = shape_mesh(2, 2)
    ds = build_model(get_config("deepseek-v2-lite-16b"))
    specs = train_specs(ds.cfg, mesh, ds.init_specs())
    moe = specs["group"]["b0_attn"]["moe"]
    attn = specs["group"]["b0_attn"]["attn"]
    assert moe["wi_gate"] == moe["wi_up"] == (None, "model", "data")
    assert moe["wo"] == (None, "model", None, "data")
    assert moe["router"] == (None, "data")
    assert moe["shared"]["wi_gate"] == (None, "data", "model")
    assert moe["shared"]["wo"] == (None, "model", "data")
    assert attn["wq"] == (None, "data", "model")
    assert attn["w_dkv"] == (None, "data")
    assert attn["w_uk"] == attn["w_uv"] == (None, None, "model")
    assert attn["wo"] == (None, "model", "data")
    grok = build_model(dataclasses.replace(get_config("grok-1-314b"),
                                           n_experts=6))
    moe = train_specs(grok.cfg, shape_mesh(1, 4),
                      grok.init_specs())["group"]["b0_attn"]["moe"]
    assert moe["wi_gate"] == (None, None, "data", "model")
    assert moe["wo"] == (None, None, "model", "data")
