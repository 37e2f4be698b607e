"""The harness of ``tests/test_torch_serve_step_state.py`` and
``tests/test_torch_serve_step_encdec.py``: the port's mesh serve step
(``repro_torch.serve.step.make_serve_step``) against the JAX package's
``make_serve_step`` on host meshes of the same shape, on the CPU.

As ``tests/test_torch_serve_step_moe.py`` does: one JAX subprocess writes
the float32 SMOKE weights (``PRNGKey(0)``), the tokens and, for the
encoder-decoder, the encoder's frames; then one JAX subprocess a case
(four host devices) runs both reference variants on each of its meshes,
beside the port's ranks (a gloo group over a FileStore a mesh, every
process with its own timeout) running both port variants: a chunk of 8
with ``n_new`` [8, 3, 1, 5], then two decodes, on 4 slots of 32 tokens
in pages of 8.  The encoder-decoder's cross K/V are written into the
caches before the first step: on the JAX side by ``encode`` and
``encdec_prefill_cross`` over the whole tree; on each rank by the
unsharded ``encode`` of its data shard's frames and then
``encdec_prefill_cross`` over its own shards (its own KV heads).  Each
rank saves its logits, every leaf of its caches and the number of
collectives (``all_reduce``, ``all_gather``) of each step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.dist.sharding import gather_params
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.serve.step import make_serve_step
from repro_torch.tree import map_with_path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300                        # seconds, each process
VARIANTS = ("gspmd", "shard_map")
B, MAX_SEQ, PAGE, C = 4, 32, 8, 8
N_NEW = (8, 3, 1, 5)
STEPS = 3                            # the chunk, then two decodes
TOL = 1e-5

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
            save[case + "/params/" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
        rng = np.random.default_rng(len(case))
        save[case + "/tokens0"] = rng.integers(
            1, cfg.vocab, (%(B)d, %(C)d)).astype(np.int32)
        for s in range(1, %(STEPS)d):
            save[case + f"/tokens{s}"] = rng.integers(
                1, cfg.vocab, (%(B)d, 1)).astype(np.int32)
        if cfg.family == "encdec":
            save[case + "/frames"] = rng.standard_normal(
                (%(B)d, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    np.savez(out_dir + "/inputs.npz", **save)
""" % dict(B=B, C=C, STEPS=STEPS))

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.dist.sharding import fit_batch_axes
    from repro.models import build_model
    from repro.models import encdec as jed
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
    cross = None
    if cfg.family == "encdec":
        enc = jed.encode(params, cfg, jnp.asarray(ref[case + "/frames"]))
        cross = jed.encdec_prefill_cross(params, cfg, enc)
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
                if cross is not None:
                    caches = {**caches, "cross_k": cross[0],
                              "cross_v": cross[1]}
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
    from repro_torch.models import encdec as ed
    from repro_torch.serve.step import make_serve_step
    from repro_torch.tree import map_with_path

    calls = {"n": 0}

    def counted(fn):
        def inner(*a, **k):
            calls["n"] += 1
            return fn(*a, **k)
        return inner

    # every collective of the step goes through these two
    dist.all_reduce = counted(dist.all_reduce)
    dist.all_gather = counted(dist.all_gather)

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
            rows = cspecs["lengths"]              # the batch's spec
            enc = None
            if cfg.family == "encdec":            # the whole encoder
                frames = torch.from_numpy(ref[case + "/frames"])
                enc = ed.encode(params, cfg, shard_params(frames, rows,
                                                          mesh))
            params = shard_params(params, pspecs, mesh)
            caches = shard_params(caches, cspecs, mesh)
            if enc is not None:                   # this rank's KV heads
                ck, cv = ed.encdec_prefill_cross(params, cfg, enc)
                assert ck.shape == caches["cross_k"].shape, ck.shape
                caches["cross_k"], caches["cross_v"] = ck, cv
            for s in range(%(STEPS)d):
                tok = torch.from_numpy(ref[case + f"/tokens{s}"])
                n = %(N_NEW)r if s == 0 else (1,) * %(B)d
                n_new = torch.tensor(n, dtype=torch.int32)
                calls["n"] = 0
                logits, caches = step(params, shard_params(tok, rows, mesh),
                                      caches, shard_params(n_new, rows,
                                                           mesh))
                save[f"{tag}/collectives{s}"] = np.int64(calls["n"])
                save[f"{tag}/logits{s}"] = logits.numpy()

            def keep(path, leaf):
                save[f"{tag}/caches/" + "/".join(map(str, path))] = \\
                    leaf.numpy()

            map_with_path(keep, caches)
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


def run_cases(out: Path, cases: dict):
    """``cases``: case -> (arch, meshes, config overrides).  The inputs,
    then a JAX process a case beside the port's ranks (a gloo group a
    mesh, each rank running every case of its mesh).  Returns (the JAX
    outputs by case, the ranks' outputs by mesh)."""
    wait_all([popen([_INPUTS_SCRIPT, str(out), json.dumps(
        {c: (a, over) for c, (a, _, over) in cases.items()})], env())])
    procs = [popen([_JAX_SCRIPT, str(out), case, arch,
                    ",".join(map(tag, meshes)), json.dumps(over)], env(4))
             for case, (arch, meshes, over) in cases.items()]
    meshes = sorted({m for _, ms, _ in cases.values() for m in ms})
    for mesh in meshes:
        d, m = mesh
        mine = json.dumps({c: (a, over) for c, (a, ms, over)
                           in cases.items() if mesh in ms})
        store = out / f"store-{tag(mesh)}"
        procs += [popen([_RANK_SCRIPT, tag(mesh), str(r), str(store),
                         str(out), mine], env()) for r in range(d * m)]
    wait_all(procs)
    jax_out = {c: np.load(out / f"jax-{c}.npz") for c in cases}
    ranks = {mesh: [np.load(out / f"rank-{tag(mesh)}-{r}.npz")
                    for r in range(mesh[0] * mesh[1])] for mesh in meshes}
    return jax_out, ranks


def shape_mesh(d: int, m: int) -> Mesh:
    return Mesh(shape={"data": d, "model": m}, coords={"data": 0, "model": 0},
                groups={})


def close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def smoke_api(arch: str, over: dict):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32, **over)
    return build_model(cfg)


def check_case(runs, cases: dict, case: str, mesh, variant: str) -> None:
    """One port variant's valid logits and every cache leaf, gathered
    from the ranks (copies of a replicated block or of a whole segment
    equal bitwise), within 1e-5 of the reference's variant of the same
    name; every rank of a data shard with the same logits, bitwise."""
    jax_out, ranks = runs
    arch, _, over = cases[case]
    d, m = mesh
    api = smoke_api(arch, over)
    caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
    mesh_ = shape_mesh(d, m)
    shards = ranks[mesh]
    ref = jax_out[case]
    key = f"{case}/{variant}"
    _, _, cspecs = make_serve_step(api, mesh_, caches, variant=variant)
    spec_of = {}
    map_with_path(lambda path, _, spec: spec_of.__setitem__(
        "/".join(map(str, path)), spec), caches, cspecs)
    for r, a in enumerate(shards):
        twin = shards[(r // m) * m]
        for s in range(STEPS):
            np.testing.assert_array_equal(a[f"{key}/logits{s}"],
                                          twin[f"{key}/logits{s}"])
    logits = [gather_params([torch.from_numpy(a[f"{key}/logits{s}"])
                             for a in shards], cspecs["lengths"],
                            mesh_).numpy() for s in range(STEPS)]
    tag_ = f"{tag(mesh)}/{variant}"
    for s in range(STEPS):
        want = ref[f"{tag_}/logits{s}"]
        n = N_NEW if s == 0 else (1,) * B
        for b in range(B):             # valid positions; pads are free
            close(logits[s][b, :n[b]], want[b, :n[b]],
                  f"{tag_} logits step {s} row {b}")
    pools = [n for n in spec_of if "_attn" in n or n.startswith("pools")]
    local_pool = None
    if pools and "data" in cspecs["lengths"]:
        leaf = dict(_flat(caches))[pools[0]]
        local_pool = leaf.shape[leaf.ndim - 4] // d
    assert set(spec_of) == {k[len(f"{tag_}/caches/"):] for k in ref.files
                            if k.startswith(f"{tag_}/caches/")}
    for n, spec in spec_of.items():
        got = gather_params([torch.from_numpy(a[f"{key}/caches/{n}"])
                             for a in shards], spec, mesh_).numpy()
        want = ref[f"{tag_}/caches/{n}"]
        if n == "page_table":
            # page-local where the batch is split over a pool, as
            # shard_map returns it; Mamba2's (no pool) as it came in
            np.testing.assert_array_equal(
                got, want if local_pool is None else want % local_pool)
        elif n == "lengths":
            np.testing.assert_array_equal(got, want)
        else:
            close(got, want, f"{tag_} {n}")


def _flat(tree, path=()) -> list:
    """(name, leaf) of every leaf of a cache tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, path + (i,))]
    return [("/".join(map(str, path)), tree)]


def collectives(runs, case: str, mesh) -> list:
    """Each rank's collectives in each step of ``case`` (both variants)."""
    _, ranks = runs
    return [[int(a[f"{case}/{v}/collectives{s}"]) for s in range(STEPS)]
            for a in ranks[mesh] for v in VARIANTS]
