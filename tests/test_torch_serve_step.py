"""The port's mesh serve step (``repro_torch.serve.step.make_serve_step``)
against the JAX package's ``make_serve_step`` on host meshes of the same
shape, on the CPU.

The JAX side runs in subprocesses with four host devices
(``--xla_force_host_platform_device_count``): one writes the float32
SMOKE weights (``PRNGKey(0)``) of the four dense architectures and the
inputs, then one process an architecture runs both variants (``gspmd``,
``shard_map``) on meshes (1, 2), (2, 1) and (2, 2).  The port's ranks run
as processes of a gloo group over a FileStore (one group a mesh, every
process with its own timeout), carry the weights across with
``convert.params_from_numpy``, take their shards with
``dist.sharding.shard_params`` and run the same three steps: a chunk of 8
with ``n_new`` [8, 3, 1, 5], then two decodes, on 4 slots of 32 tokens in
pages of 8.  The test gathers the ranks' logits and caches
(``gather_params``) and holds the valid positions' logits and every
cache leaf within 1e-5 of each variant's (absolute, and relative to the
leaf's largest magnitude where that exceeds 1: float32, the same products
summed in another order).  The page table comes back page-local, as the
``shard_map`` variant returns it; the ``gspmd`` variant's global ids are
compared modulo the local pool.

qwen2-72b (QKV bias), qwen2-1.5b (tied embeddings), minitron-8b (relu2)
and starcoder2-7b (layernorm, biases, window 32) at SMOKE width: 4 heads
over 2 KV heads, so model=2 splits whole heads.  qwen2-1.5b also runs on
a ("pod", "data", "model") mesh of (2, 1, 2), where the reference takes
"pod" as the outer batch axis and the port serves on the (2, 2) view.
"""

import dataclasses
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
ARCHS = ("qwen2-72b", "qwen2-1.5b", "minitron-8b", "starcoder2-7b")
MESHES = ((1, 2), (2, 1), (2, 2))
POD_MESH, POD_ARCH = (2, 1, 2), "qwen2-1.5b"
B, MAX_SEQ, PAGE, C = 4, 32, 8, 8
N_NEW = (8, 3, 1, 5)
STEPS = 3                            # the chunk, then two decodes
TOL = 1e-5

_INPUTS_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.spec import init_params

    out_dir, archs = sys.argv[1], sys.argv[2].split(",")
    save = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=jnp.float32)
        params = init_params(build_model(cfg).init_specs(),
                             jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            save[arch + "/params/" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
        rng = np.random.default_rng(len(arch))
        save[arch + "/tokens0"] = rng.integers(
            1, cfg.vocab, (%(B)d, %(C)d)).astype(np.int32)
        for s in range(1, %(STEPS)d):
            save[arch + f"/tokens{s}"] = rng.integers(
                1, cfg.vocab, (%(B)d, 1)).astype(np.int32)
    np.savez(out_dir + "/inputs.npz", **save)
""" % dict(B=B, C=C, STEPS=STEPS))

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.dist.sharding import fit_batch_axes
    from repro.models import build_model
    from repro.serve.step import make_serve_step

    out_dir, arch, meshes = sys.argv[1], sys.argv[2], sys.argv[3]
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
    save = {}
    for shape in meshes.split(","):
        dims = tuple(int(x) for x in shape.split("x"))
        devs = np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims)
        mesh = jax.sharding.Mesh(
            devs, ("pod", "data", "model")[3 - len(dims):],
            axis_types=(jax.sharding.AxisType.Auto,) * len(dims))
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
                        jnp.asarray(ref[arch + f"/tokens{s}"]), bsh)
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
    np.savez(out_dir + f"/jax-{arch}.npz", **save)
""" % dict(B=B, MAX_SEQ=MAX_SEQ, PAGE=PAGE, STEPS=STEPS, N_NEW=N_NEW))

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    shape = tuple(int(x) for x in sys.argv[1].split("x"))
    rank, store_path, out_dir = int(sys.argv[2]), sys.argv[3], sys.argv[4]
    archs = sys.argv[5].split(",")
    world = int(np.prod(shape))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.step import make_serve_step

    mesh = make_mesh(shape)
    ref = np.load(out_dir + "/inputs.npz")
    save = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32)
        api = build_model(cfg)
        params = {}
        prefix = arch + "/params/"
        for key in ref.files:
            if key.startswith(prefix):
                *path, last = key[len(prefix):].split("/")
                node = params
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = np.array(ref[key])
        params = convert.params_from_numpy(params, device="cpu")
        caches = api.init_caches(%(B)d, %(MAX_SEQ)d, %(PAGE)d, device="cpu")
        step, pspecs, cspecs = make_serve_step(api, mesh, caches)
        view = mesh.merged or mesh            # a pod mesh serves on it
        params = shard_params(params, pspecs, view)
        caches = shard_params(caches, cspecs, view)
        rows = cspecs["lengths"]              # the batch's spec
        for s in range(%(STEPS)d):
            tok = torch.from_numpy(ref[arch + f"/tokens{s}"])
            n = %(N_NEW)r if s == 0 else (1,) * %(B)d
            n_new = torch.tensor(n, dtype=torch.int32)
            logits, caches = step(params, shard_params(tok, rows, view),
                                  caches, shard_params(n_new, rows, view))
            save[f"{arch}/logits{s}"] = logits.numpy()
        for k in ("page_table", "lengths"):
            save[f"{arch}/caches/{k}"] = caches[k].numpy()
        for i, pool in enumerate(caches["group"]["b0_attn"]):
            save[f"{arch}/caches/group/b0_attn/{i}"] = pool.numpy()
    np.savez(f"{out_dir}/rank-{sys.argv[1]}-{rank}.npz", **save)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, then the JAX meshes (a process an architecture) beside
    the port's ranks (a gloo group a mesh)."""
    out = tmp_path_factory.mktemp("mesh")
    wait_all([popen([_INPUTS_SCRIPT, str(out), ",".join(ARCHS)], env())])
    procs = [popen([_JAX_SCRIPT, str(out), arch, ",".join(
        tag(s) for s in MESHES + ((POD_MESH,) if arch == POD_ARCH else ()))],
        env(4)) for arch in ARCHS]
    runs_on = [(mesh, ARCHS) for mesh in MESHES] + [(POD_MESH, (POD_ARCH,))]
    for mesh, archs in runs_on:
        store = out / f"store-{tag(mesh)}"
        procs += [popen([_RANK_SCRIPT, tag(mesh), str(r), str(store),
                         str(out), ",".join(archs)], env())
                  for r in range(int(np.prod(mesh)))]
    wait_all(procs)
    jax_out = {a: np.load(out / f"jax-{a}.npz") for a in ARCHS}
    ranks = {mesh: [np.load(out / f"rank-{tag(mesh)}-{r}.npz")
                    for r in range(int(np.prod(mesh)))]
             for mesh, _ in runs_on}
    return jax_out, ranks


def tag(mesh) -> str:
    return "x".join(map(str, mesh))


def shape_mesh(d: int, m: int) -> Mesh:
    return Mesh(shape={"data": d, "model": m}, coords={"data": 0, "model": 0},
                groups={})


def close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference_variants(runs, arch, mesh):
    check_mesh_step(runs, arch, mesh)


def test_pod_mesh_serves_on_the_merged_view(runs):
    """A (2, 1, 2) mesh: "pod" is the outer batch axis, so the ranks
    serve as a (2, 2) mesh, pod-major, and match the reference's pod
    mesh within the same bound."""
    check_mesh_step(runs, POD_ARCH, POD_MESH)


def check_mesh_step(runs, arch: str, mesh) -> None:
    """The ranks' gathered logits and caches of ``arch`` on ``mesh``
    against both reference variants (module docstring)."""
    jax_out, ranks = runs
    *pods, d, m = mesh
    d *= pods[0] if pods else 1          # the (pod * data, model) view
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
    mesh_ = shape_mesh(d, m)
    _, _, cspecs = make_serve_step(api, mesh_, caches)
    shards = ranks[tuple(mesh)]
    # every rank of a data shard holds the same gathered logits, bitwise
    for r, a in enumerate(shards):
        twin = shards[(r // m) * m]
        for s in range(STEPS):
            np.testing.assert_array_equal(a[f"{arch}/logits{s}"],
                                          twin[f"{arch}/logits{s}"])
    names = ["page_table", "lengths", "group/b0_attn/0", "group/b0_attn/1"]
    spec_of = {"page_table": cspecs["page_table"],
               "lengths": cspecs["lengths"],
               "group/b0_attn/0": cspecs["group"]["b0_attn"][0],
               "group/b0_attn/1": cspecs["group"]["b0_attn"][1]}
    got = {n: gather_params(
        [torch.from_numpy(a[f"{arch}/caches/{n}"]) for a in shards],
        spec_of[n], mesh_).numpy() for n in names}
    logits = [gather_params([torch.from_numpy(a[f"{arch}/logits{s}"])
                             for a in shards], cspecs["lengths"],
                            mesh_).numpy() for s in range(STEPS)]
    local_pool = caches["group"]["b0_attn"][0].shape[1] // (
        d if "data" in cspecs["lengths"] else 1)
    ref = jax_out[arch]
    for variant in ("gspmd", "shard_map"):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_the_unsharded_step(arch, tmp_path):
    """model=1 and data=1: the step is ``api.serve_step`` itself, and its
    shards are the whole tree (bitwise the same logits)."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import shard_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        assert mesh.shape == {"data": 1, "model": 1} and not mesh.groups
        caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
        step, pspecs, cspecs = make_serve_step(api, mesh, caches)
        assert step is api.serve_step
        params = init_params(api.init_specs(),
                             torch.Generator().manual_seed(1), device="cpu")
        mine = shard_params(params, pspecs, mesh)
        c1 = shard_params(caches, cspecs, mesh)
        c2 = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
        tok = torch.arange(B * C, dtype=torch.int32).reshape(B, C) % cfg.vocab
        n_new = torch.tensor(N_NEW, dtype=torch.int32)
        a, c1 = step(mine, tok, c1, n_new)
        b, c2 = api.serve_step(params, tok, c2, n_new)
        assert torch.equal(a, b)
        for x, y in zip(c1["group"]["b0_attn"], c2["group"]["b0_attn"]):
            assert torch.equal(x, y)
    finally:
        dist.destroy_process_group()


SPLITS = {"embed": ("embed",), "attention": ("attn",), "mlp": ("mlp",),
          "lm_head": ("lm_head",)}


@pytest.mark.parametrize("split", list(SPLITS))
def test_sharded_tree_outside_the_model_group_raises(split):
    """A tree sharded for model=2 but served by ``api.serve_step`` itself
    (no model group installed) raises at its first split weight instead of
    giving partial sums, zero embeddings or one rank's vocab block.  Only
    the ``split`` leaves are sharded (for the attention, its pools too),
    so each call site of the model code is reached."""
    from repro_torch.dist.sharding import shard_params
    from repro_torch.models import init_params
    from repro_torch.tree import map_with_path

    cfg = dataclasses.replace(get_config("qwen2-72b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
    mesh = shape_mesh(1, 2)
    _, pspecs, cspecs = make_serve_step(api, mesh, caches)
    keys = SPLITS[split]

    def only(path, _, spec):
        return spec if any(k in path for k in keys) else ()

    params = init_params(api.init_specs(), torch.Generator().manual_seed(1),
                         device="cpu")
    params = shard_params(params, map_with_path(only, params, pspecs), mesh)
    if split == "attention":
        caches = shard_params(caches, cspecs, mesh)
    tok = torch.ones(B, C, dtype=torch.int32)
    n_new = torch.tensor(N_NEW, dtype=torch.int32)
    with pytest.raises(ValueError, match="no model group"):
        api.serve_step(params, tok, caches, n_new)


def test_model_not_dividing_the_kv_heads_raises():
    """The port splits or copies whole heads only (ROADMAP item 7.1):
    qwen2-1.5b's 12 heads over 2 KV heads at model=3 (3 divides the query
    heads but neither divides nor is divided by the KV heads), and its
    SMOKE config's 4 heads at model=3 (not the query heads either),
    raise.  (Its KV heads at model=4 are copied: tests/
    test_torch_serve_step_moe.py.)"""
    for smoke in (False, True):
        api = build_model(get_config("qwen2-1.5b", smoke=smoke))
        caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
        with pytest.raises(ValueError, match="item 7.1"):
            make_serve_step(api, shape_mesh(1, 3), caches)


def test_world_size_not_the_mesh_product_raises(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_mesh((2, 2))
    finally:
        dist.destroy_process_group()


def test_unknown_variant_raises():
    api = build_model(get_config("qwen2-72b", smoke=True))
    caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        make_serve_step(api, shape_mesh(1, 2), caches, variant="pjit")
