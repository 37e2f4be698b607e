"""The port's mesh serve step on the MoE family (expert parallelism, MLA's
replicated latent) and on replicated KV heads, against the JAX package's
``make_serve_step`` on host meshes of the same shape, on the CPU.

The pattern of ``tests/test_torch_serve_step.py``: one JAX subprocess
writes the float32 SMOKE weights (``PRNGKey(0)``) and the inputs, then
one JAX subprocess a case (four host devices) runs both reference
variants on each of its meshes, beside the port's ranks (a gloo group
over a FileStore a mesh, every process with its own timeout) running
both port variants through ``make_serve_step``: a chunk of 8 with
``n_new`` [8, 3, 1, 5], then two decodes, on 4 slots of 32 tokens in
pages of 8.  The ranks' logits and caches are gathered
(``gather_params``, which takes one copy of a block several ranks hold
and requires the copies equal) and held within 1e-5 of the variant of
the same name (absolute, and relative to the leaf's largest magnitude
where that exceeds 1).

Cases:
  * grok-1-314b and deepseek-v2-lite-16b (MLA, a shared expert) at
    SMOKE width on (1, 2), (2, 1), (2, 2) and (1, 4): 4 experts at grok's
    SMOKE width (a rank holds 2 or 1), 8 at deepseek's (4 or 2); grok's
    2 KV heads copied at model=4, deepseek's latent whole on every rank;
  * qwen2-1.5b at (1, 4): 4 heads over 2 KV heads, each KV head copied
    onto the two ranks whose query heads read it;
  * "grok-e6": grok with 6 experts at (1, 4): "model" does not divide
    the experts, so every rank holds all 6 and a quarter of each one's
    FFN (``spec_for``'s fallback), its partial summed by the same one
    all_reduce;
  * "overflow": deepseek with router column 0 scaled by 16 at (2, 1) and
    (2, 2).  The chunk's 32 rows pick expert 0 past the whole batch's
    capacity (16) but not past a data shard's (32, exact): the
    reference's ``gspmd`` (one program over the batch) and ``shard_map``
    (each shard's own count) logits differ, and each port variant holds
    to its own.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist.sharding import gather_params
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.serve.step import make_serve_step

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300                        # seconds, each process
ALL = ((1, 2), (2, 1), (2, 2), (1, 4))
CASES = {                            # case -> (arch, meshes, overrides)
    "grok": ("grok-1-314b", ALL, {}),
    "deepseek": ("deepseek-v2-lite-16b", ALL, {}),
    "qwen2-1.5b": ("qwen2-1.5b", ((1, 4),), {}),
    "overflow": ("deepseek-v2-lite-16b", ((2, 1), (2, 2)), {}),
    # 6 experts at model=4: the experts stay whole on every rank and each
    # expert's FFN is split (spec_for's fallback)
    "grok-e6": ("grok-1-314b", ((1, 4),), {"n_experts": 6}),
}
OVERFLOW_SCALE = 16.0                # router column 0 of every layer
VARIANTS = ("gspmd", "shard_map")
B, MAX_SEQ, PAGE, C = 4, 32, 8, 8
N_NEW = (8, 3, 1, 5)
STEPS = 3                            # the chunk, then two decodes
TOL = 1e-5
MESHES = sorted({m for _, ms, _ in CASES.values() for m in ms})

_INPUTS_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.spec import init_params

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    save = {}
    for case, (arch, over) in cases.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32, **over)
        params = init_params(build_model(cfg).init_specs(),
                             jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            name = "/".join(k.key for k in path)
            leaf = np.array(leaf)
            if case == "overflow" and name.endswith("moe/router"):
                leaf[..., 0] *= %(SCALE)r
            save[case + "/params/" + name] = leaf
        rng = np.random.default_rng(len(arch))
        save[case + "/tokens0"] = rng.integers(
            1, cfg.vocab, (%(B)d, %(C)d)).astype(np.int32)
        for s in range(1, %(STEPS)d):
            save[case + f"/tokens{s}"] = rng.integers(
                1, cfg.vocab, (%(B)d, 1)).astype(np.int32)
    np.savez(out_dir + "/inputs.npz", **save)
""" % dict(B=B, C=C, STEPS=STEPS, SCALE=OVERFLOW_SCALE))

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.dist.sharding import fit_batch_axes
    from repro.models import build_model
    from repro.serve.step import make_serve_step

    out_dir, case, arch, meshes, over = sys.argv[1:6]
    assert len(jax.devices()) >= 4, jax.devices()
    ref = np.load(out_dir + "/inputs.npz")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=jnp.float32, **json.loads(over))
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
    save = {}
    for shape in meshes.split(","):
        d, m = (int(x) for x in shape.split("x"))
        devs = np.array(jax.devices()[:d * m]).reshape(d, m)
        mesh = jax.sharding.Mesh(devs, ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for variant in ("gspmd", "shard_map"):
            with jax.set_mesh(mesh):
                caches = api.init_caches(%(B)d, %(MAX_SEQ)d,
                                         page_tokens=%(PAGE)d)
                step, psh, csh = make_serve_step(api, mesh, caches,
                                                 variant=variant,
                                                 donate=False)
                ba = fit_batch_axes(mesh, %(B)d)
                bsh = NamedSharding(mesh, P(ba if ba else None))
                caches = jax.device_put(caches, csh)
                prm = jax.device_put(params, psh)
                tag = f"{shape}/{variant}"
                for s in range(%(STEPS)d):
                    tok = jax.device_put(
                        jnp.asarray(ref[case + f"/tokens{s}"]), bsh)
                    n = %(N_NEW)r if s == 0 else (1,) * %(B)d
                    n_new = jax.device_put(jnp.asarray(n, jnp.int32), bsh)
                    logits, caches = step(prm, tok, caches, n_new)
                    save[f"{tag}/logits{s}"] = np.asarray(logits)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        caches)[0]:
                    name = "/".join(
                        str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
                    save[f"{tag}/caches/{name}"] = np.asarray(leaf)
    np.savez(out_dir + f"/jax-{case}.npz", **save)
""" % dict(B=B, MAX_SEQ=MAX_SEQ, PAGE=PAGE, STEPS=STEPS, N_NEW=N_NEW))

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
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
    from repro_torch.dist.sharding import shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.step import make_serve_step

    mesh = make_mesh((d, m))
    ref = np.load(out_dir + "/inputs.npz")
    save = {}
    for case, (arch, over) in cases.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32, **over)
        api = build_model(cfg)
        tree = {}
        prefix = case + "/params/"
        for key in ref.files:
            if key.startswith(prefix):
                *path, last = key[len(prefix):].split("/")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = ref[key]
        for variant in ("gspmd", "shard_map"):
            tag = f"{case}/{variant}"
            params = convert.params_from_numpy(tree, device="cpu")
            caches = api.init_caches(%(B)d, %(MAX_SEQ)d, %(PAGE)d,
                                     device="cpu")
            step, pspecs, cspecs = make_serve_step(api, mesh, caches,
                                                   variant=variant)
            params = shard_params(params, pspecs, mesh)
            caches = shard_params(caches, cspecs, mesh)
            rows = cspecs["lengths"]              # the batch's spec
            for s in range(%(STEPS)d):
                tok = torch.from_numpy(ref[case + f"/tokens{s}"])
                n = %(N_NEW)r if s == 0 else (1,) * %(B)d
                n_new = torch.tensor(n, dtype=torch.int32)
                logits, caches = step(params, shard_params(tok, rows, mesh),
                                      caches, shard_params(n_new, rows,
                                                           mesh))
                save[f"{tag}/logits{s}"] = logits.numpy()
            for k in ("page_table", "lengths"):
                save[f"{tag}/caches/{k}"] = caches[k].numpy()
            for i, pool in enumerate(caches["group"]["b0_attn"]):
                save[f"{tag}/caches/group/b0_attn/{i}"] = pool.numpy()
    np.savez(f"{out_dir}/rank-{d}x{m}-{rank}.npz", **save)
    dist.destroy_process_group()
""" % dict(B=B, MAX_SEQ=MAX_SEQ, PAGE=PAGE, STEPS=STEPS, N_NEW=N_NEW))


def env(jax_devices: int = 0) -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + e["PYTHONPATH"] if e.get("PYTHONPATH") else "")
    if jax_devices:
        e["XLA_FLAGS"] = (e.get("XLA_FLAGS", "") + " --xla_force_host_"
                          f"platform_device_count={jax_devices}").strip()
    return e


def wait_all(procs: list) -> None:
    """Each process within TIMEOUT of its start; all killed on a failure."""
    start = time.monotonic()
    errs = []
    try:
        for p in procs:
            left = max(1.0, TIMEOUT - (time.monotonic() - start))
            _, err = p.communicate(timeout=left)
            errs.append((p.returncode, err[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs


def popen(args: list, e: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", *args],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, env=e)


def tag(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, then a JAX process a case beside the port's ranks (a
    gloo group a mesh, each rank running every case of its mesh)."""
    out = tmp_path_factory.mktemp("mesh_moe")
    wait_all([popen([_INPUTS_SCRIPT, str(out), json.dumps(
        {c: (a, over) for c, (a, _, over) in CASES.items()})], env())])
    procs = [popen([_JAX_SCRIPT, str(out), case, arch,
                    ",".join(map(tag, meshes)), json.dumps(over)], env(4))
             for case, (arch, meshes, over) in CASES.items()]
    for mesh in MESHES:
        d, m = mesh
        cases = json.dumps({c: (a, over) for c, (a, ms, over)
                            in CASES.items() if mesh in ms})
        store = out / f"store-{tag(mesh)}"
        procs += [popen([_RANK_SCRIPT, tag(mesh), str(r), str(store),
                         str(out), cases], env()) for r in range(d * m)]
    wait_all(procs)
    jax_out = {c: np.load(out / f"jax-{c}.npz") for c in CASES}
    ranks = {mesh: [np.load(out / f"rank-{tag(mesh)}-{r}.npz")
                    for r in range(mesh[0] * mesh[1])] for mesh in MESHES}
    return jax_out, ranks


def shape_mesh(d: int, m: int) -> Mesh:
    return Mesh(shape={"data": d, "model": m}, coords={"data": 0, "model": 0},
                groups={})


def close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def valid_gap(a: list, b: list, first: int = 0) -> float:
    """The largest |difference| of two runs' logits at valid positions;
    their rows are the batch's from row ``first`` on (a data shard's)."""
    gap = 0.0
    for s in range(STEPS):
        n = N_NEW if s == 0 else (1,) * B
        for row in range(a[s].shape[0]):
            k = n[first + row]
            x, y = a[s][row, :k], b[s][row, :k]
            gap = max(gap, float(np.abs(x - y).max()))
    return gap


@pytest.mark.parametrize("case,mesh", [(c, m) for c, (_, ms, _) in
                                       CASES.items() for m in ms],
                         ids=lambda x: x if isinstance(x, str) else tag(x))
def test_moe_mesh_step_matches_reference_variants(runs, case, mesh):
    """Each port variant's valid logits and every cache leaf, gathered
    from the ranks (copies of a replicated block equal bitwise), within
    1e-5 of the reference's variant of the same name."""
    jax_out, ranks = runs
    arch, _, over = CASES[case]
    d, m = mesh
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32, **over)
    api = build_model(cfg)
    caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
    mesh_ = shape_mesh(d, m)
    shards = ranks[mesh]
    ref = jax_out[case]
    n_pools = len(caches["group"]["b0_attn"])
    names = ["page_table", "lengths"] + [f"group/b0_attn/{i}"
                                         for i in range(n_pools)]
    for variant in VARIANTS:
        key = f"{case}/{variant}"
        _, _, cspecs = make_serve_step(api, mesh_, caches, variant=variant)
        spec_of = {"page_table": cspecs["page_table"],
                   "lengths": cspecs["lengths"],
                   **{f"group/b0_attn/{i}": cspecs["group"]["b0_attn"][i]
                      for i in range(n_pools)}}
        # every rank of a data shard holds the same gathered logits
        for r, a in enumerate(shards):
            twin = shards[(r // m) * m]
            for s in range(STEPS):
                np.testing.assert_array_equal(a[f"{key}/logits{s}"],
                                              twin[f"{key}/logits{s}"])
        got = {n: gather_params(
            [torch.from_numpy(a[f"{key}/caches/{n}"]) for a in shards],
            spec_of[n], mesh_).numpy() for n in names}
        logits = [gather_params([torch.from_numpy(a[f"{key}/logits{s}"])
                                 for a in shards], cspecs["lengths"],
                                mesh_).numpy() for s in range(STEPS)]
        local_pool = caches["group"]["b0_attn"][0].shape[1] // (
            d if "data" in cspecs["lengths"] else 1)
        tag_ = f"{tag(mesh)}/{variant}"
        for s in range(STEPS):
            want = ref[f"{tag_}/logits{s}"]
            n = N_NEW if s == 0 else (1,) * B
            for b in range(B):         # valid positions; pads are free
                close(logits[s][b, :n[b]], want[b, :n[b]],
                      f"{tag_} logits step {s} row {b}")
        for n in names:
            want = ref[f"{tag_}/caches/{n}"]
            if n == "page_table":      # page-local, as shard_map returns it
                np.testing.assert_array_equal(got[n], want % local_pool)
            elif n == "lengths":
                np.testing.assert_array_equal(got[n], want)
            else:
                close(got[n], want, f"{tag_} {n}")


@pytest.mark.parametrize("mesh", CASES["overflow"][1], ids=tag)
def test_overflow_parts_the_reference_variants(runs, mesh):
    """With expert 0 overflowing the whole batch's capacity, the
    reference's two variants give logits further apart than the
    tolerance, and so do the port's (each held to its own above) on the
    last data shard, whose picks come last in the whole batch's count;
    the seed weights' routing overflows neither (the variants agree)."""
    jax_out, ranks = runs

    def logits(out, fmt):
        return [out[fmt.format(s=s)] for s in range(STEPS)]

    ref = jax_out["overflow"]
    t = tag(mesh)
    assert valid_gap(logits(ref, t + "/gspmd/logits{s}"),
                     logits(ref, t + "/shard_map/logits{s}")) > 100 * TOL
    last = ranks[mesh][-1]
    assert valid_gap(logits(last, "overflow/gspmd/logits{s}"),
                     logits(last, "overflow/shard_map/logits{s}"),
                     first=B - B // mesh[0]) > 100 * TOL
    seed = jax_out["deepseek"]
    assert valid_gap(logits(seed, t + "/gspmd/logits{s}"),
                     logits(seed, t + "/shard_map/logits{s}")) <= TOL


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-lite-16b"])
def test_moe_expert_and_head_shards(arch):
    """What a rank holds at model=4 (the SMOKE configs): its block of
    whole experts (the expert FFN whole: the axis is consumed), its
    quarter of the shared experts' FFN and of the query heads; grok's two
    KV heads copied (one a rank); deepseek's latent whole."""
    from repro_torch.dist.sharding import Copies, shard_block

    cfg = get_config(arch, smoke=True)
    api = build_model(cfg)
    caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
    _, pspecs, cspecs = make_serve_step(api, shape_mesh(1, 4), caches)
    like = api.init_specs()
    mesh = Mesh(shape={"data": 1, "model": 4},
                coords={"data": 0, "model": 3}, groups={})
    moe = like["group"]["b0_attn"]["moe"]
    mspec = pspecs["group"]["b0_attn"]["moe"]
    L, E = cfg.n_layers, cfg.n_experts
    got, block = shard_block(moe["wi_gate"].shape, mspec["wi_gate"], mesh)
    assert got == (L, E // 4, cfg.d_model, cfg.moe_d_ff) and block == 3
    assert mspec["router"] == ()                        # replicated
    attn = pspecs["group"]["b0_attn"]["attn"]
    pool = caches["group"]["b0_attn"][0]
    if cfg.mla:
        Fs = cfg.n_shared_experts * cfg.moe_d_ff
        got, _ = shard_block(moe["shared"]["wo"].shape,
                             mspec["shared"]["wo"], mesh)
        assert got == (L, Fs // 4, cfg.d_model)
        assert attn["w_dkv"] == ()
        assert shard_block(pool.shape, cspecs["group"]["b0_attn"][0],
                           mesh)[0] == tuple(pool.shape)
    else:
        assert attn["wk"][-1] == Copies("model", cfg.n_kv_heads)
        got, block = shard_block(pool.shape, cspecs["group"]["b0_attn"][0],
                                 mesh)
        assert got[-2] == 1 and block == 1
