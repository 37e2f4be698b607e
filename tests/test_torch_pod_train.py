"""Two ranks of the port's compressed gradient reduction over gloo on the
CPU, against the JAX package's two-pod host mesh.

The JAX side runs ``tests/test_pod_compression.py``'s ``_MULTIPOD_SCRIPT``
scenarios in a subprocess with two host devices, in float32, and saves
its inputs, losses and per-pod residual rows; the port side runs each
rank in a process of its own (a gloo group over a FileStore in the test's
tmp_path), each with its own timeout, on the same inputs:

- the toy model (two tanh layers, 4 leaves in 2 buckets at
  ``bucket_elems=600``), 12 SGD steps through none, int8 and top-k (a
  quarter kept), each step's compressed mean held to the codec's bound
  around the plain mean, as the reference's script holds it;
- the real train step on SMOKE qwen2 (float32 activations) from the JAX
  package's ``PRNGKey(2)`` weights carried across with
  ``repro_torch.convert.params_from_numpy``, the ``rng(3)`` tokens
  ``(4, 17)`` split two rows a rank, ``bucket_elems=1<<14`` (5 buckets),
  4 AdamW steps of none, int8 and top-k;
- ``run_training`` with a checkpoint on rank 0: a crash after step 3 and
  a resume from step 2 reach the uninterrupted run's losses exactly on
  both ranks, and the saved ``err`` leaves have the reference's global
  ``[2 * n]`` shapes; a ``CheckpointManager`` on rank 1, a batch that
  does not split over the ranks and a ``FaultPolicy`` over the group
  raise ``ValueError``.

Tolerances (float32, the same products summed in another order by XLA
and torch): losses rtol 1e-5; residual rows atol 1e-5 but for near-.5
ties of ``x / scale`` that the grads' rounding moved across, each within
one quantization step (``assert_residuals_close`` of
``tests/test_torch_compression.py``): at most 0.1% of a bucket, and 1%
for the int8 train step, where AdamW turns a moved tie into a parameter
difference of up to ``lr`` that moves the later grads.  Measured on the
CPU: loss gaps <= 2.2e-7 relative; toy int8 and every top-k residual
within 4.8e-7 with no tie moved; the int8 train step's residuals moved
at 6-87 elements a bucket (at most 0.35%), each by at most 1.7 times the
bucket's largest residual.  Both ranks' parameters are bitwise equal
after every step.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from test_torch_compression import assert_residuals_close

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600                       # seconds, each process

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import repro  # noqa: F401
    from repro.dist.compression import (
        bucketed_compressed_psum, init_residuals, plan_buckets)

    out_dir = sys.argv[1]
    assert len(jax.devices()) >= 2, jax.devices()
    PODS = 2
    mesh = jax.make_mesh((PODS,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    save = {}

    # -- the toy model (tests/test_pod_compression.py:_MULTIPOD_SCRIPT) --
    rng = np.random.default_rng(0)
    shapes = [(16, 32), (32,), (32, 8), (8,)]
    params0 = [jnp.asarray(rng.standard_normal(s) * 0.3, jnp.float32)
               for s in shapes]
    xs = jnp.asarray(rng.standard_normal((PODS, 64, 16)), jnp.float32)
    ys = jnp.asarray(rng.standard_normal((PODS, 64, 8)), jnp.float32)
    for i, p in enumerate(params0):
        save[f"toy/params0/{i}"] = np.asarray(p)
    save["toy/xs"], save["toy/ys"] = np.asarray(xs), np.asarray(ys)

    def loss_fn(params, x, y):
        w1, b1, w2, b2 = params
        return jnp.mean((jnp.tanh(x @ w1 + b1) @ w2 + b2 - y) ** 2)

    plan = plan_buckets([int(np.prod(s)) for s in shapes], bucket_elems=600)
    LR, STEPS, FRAC = 0.05, 12, 0.25

    def make_step(codec):
        def stepfn(params, errs, x, y):
            g = jax.grad(loss_fn)(params, x, y)
            if codec == "none":
                g = jax.tree.map(lambda a: jax.lax.pmean(a, "pod"), g)
            else:
                g, errs = bucketed_compressed_psum(
                    g, errs, "pod", plan=plan, codec=codec, topk_frac=FRAC)
            params = jax.tree.map(lambda p, a: p - LR * a, params, g)
            return params, errs, jax.lax.pmean(loss_fn(params, x, y), "pod")
        return jax.jit(jax.shard_map(
            stepfn, mesh=mesh,
            in_specs=(P(), P("pod"), P("pod"), P("pod")),
            out_specs=(P(), P("pod"), P()),
            axis_names={"pod"}, check_vma=False))

    out = {"toy": {}, "train": {}}
    for codec in ("none", "int8", "topk"):
        fn = make_step(codec)
        params, errs = list(params0), init_residuals(plan, pod_size=PODS)
        losses = []
        for _ in range(STEPS):
            params, errs, loss = fn(params, errs, xs, ys)
            losses.append(float(loss))
        out["toy"][codec] = losses
        for b, e in enumerate(errs):
            save[f"toy/{codec}/err/{b}"] = np.asarray(e).reshape(PODS, -1)

    # -- the real train step on a (pod=2, data=1, model=1) mesh ----------
    from repro.configs import get_config
    from repro.models import build_model
    from repro.models.spec import init_params
    from repro.train.optimizer import AdamWConfig
    from repro.train.step import make_train_step

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=jnp.float32)
    api = build_model(cfg)
    tmesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 3)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
    save["train/tokens"] = np.asarray(toks, np.int32)
    params = init_params(api.init_specs(), jax.random.PRNGKey(2))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        save["train/params/" + "/".join(k.key for k in path)] = \\
            np.asarray(leaf)
    for codec in ("none", "int8", "topk"):
        step, _, bsh, init_state = make_train_step(
            api, tmesh, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5),
            compress_pod_grads=codec != "none",
            codec=codec if codec != "none" else "int8",
            bucket_elems=1 << 14)
        with jax.set_mesh(tmesh):
            state = init_state(init_params(api.init_specs(),
                                           jax.random.PRNGKey(2)))
            b = jax.device_put(batch, bsh)
            losses = []
            for _ in range(4):
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        out["train"][codec] = losses
        for i, e in enumerate(state.get("err", [])):
            save[f"train/{codec}/err/{i}"] = np.asarray(e).reshape(2, -1)
    np.savez(out_dir + "/jax.npz", **save)
    print("RESULT " + json.dumps(out))
""")

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store_path, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4])
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    group = dist.group.WORLD

    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import Mode, PMDevice, USplit, Volume, VolumeGeometry
    from repro_torch.data import TokenPipeline
    from repro_torch.dist import FaultPolicy, HeartbeatMonitor
    from repro_torch.dist.compression import (
        BLOCK, bucket_flat, bucketed_compressed_psum, init_residuals,
        plan_buckets)
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, LoopConfig, run_training
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.step import exact_mean, make_train_step

    ref = np.load(out_dir + "/jax.npz")
    out = {"toy": {}, "train": {}, "errors": {}}
    save = {}

    def same_on_every_rank(tensors):
        # bitwise: rank 0's copy broadcast and compared on every rank
        ok = torch.ones(1)
        for t in tensors:
            t0 = t.clone()
            dist.broadcast(t0, src=0, group=group)
            ok *= float(torch.equal(t0.view(torch.int32),
                                    t.view(torch.int32)))
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=group)
        return bool(ok.item())

    def mean(x):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x / world

    # -- the toy model -----------------------------------------------------
    params0 = [torch.from_numpy(ref[f"toy/params0/{i}"]) for i in range(4)]
    x = torch.from_numpy(ref["toy/xs"][rank:rank + 1])
    y = torch.from_numpy(ref["toy/ys"][rank:rank + 1])
    plan = plan_buckets([p.numel() for p in params0], bucket_elems=600)
    assert plan.num_buckets == 2
    LR, STEPS, FRAC = 0.05, 12, 0.25

    def loss_fn(params):
        w1, b1, w2, b2 = params
        return torch.mean((torch.tanh(x @ w1 + b1) @ w2 + b2 - y) ** 2)

    for codec in ("none", "int8", "topk"):
        params, errs = [p.clone() for p in params0], init_residuals(plan)
        losses, viol, same = [], 0.0, True
        for _ in range(STEPS):
            ps = [p.requires_grad_() for p in params]
            g = list(torch.autograd.grad(loss_fn(ps), ps))
            params = [p.detach() for p in ps]
            if codec == "none":
                g = exact_mean(g, group)
            else:
                red, new_errs = bucketed_compressed_psum(
                    g, errs, group, plan=plan, codec=codec, topk_frac=FRAC)
                # |compressed mean - plain mean| within the codec's bound
                for b in range(plan.num_buckets):
                    x_b = bucket_flat(g, plan, b) + errs[b]
                    red_b = bucket_flat(red, plan, b)
                    if codec == "int8":
                        scale = x_b.reshape(-1, BLOCK).abs().amax(1) / 127.0
                        bound = (scale / 2).repeat_interleave(BLOCK)
                    else:
                        k = max(1, int(round(FRAC * x_b.numel())))
                        bound = torch.topk(x_b.abs(), k).values[-1].expand(
                            x_b.shape)
                    bound = mean(bound) + 1e-6
                    viol = max(viol, float(((red_b - mean(x_b)).abs()
                                            - bound).max()))
                g, errs = red, new_errs
            with torch.no_grad():
                params = [p - LR * a for p, a in zip(params, g)]
                losses.append(float(mean(loss_fn(params).reshape(1))[0]))
            same = same and same_on_every_rank(params)
        out["toy"][codec] = {"losses": losses, "max_bound_violation": viol,
                             "params_equal": same}
        for b, e in enumerate(errs if codec != "none" else []):
            save[f"toy/{codec}/err/{b}"] = e.numpy()

    # -- the real train step on SMOKE qwen2 ------------------------------
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)

    def nest(prefix):
        tree = {}
        for key in ref.files:
            if key.startswith(prefix):
                *path, last = key[len(prefix):].split("/")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = ref[key]
        return tree

    toks = ref["train/tokens"][2 * rank:2 * rank + 2]
    batch = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
             "targets": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    for codec in ("none", "int8", "topk"):
        step, init_state, _ = make_train_step(
            api, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5),
            pod_group=group, codec=codec, bucket_elems=1 << 14)
        # fresh arrays: the step updates the params in place, and
        # params_from_numpy shares a writable array's memory
        state = init_state(convert.params_from_numpy(
            nest("train/params/"), device="cpu"), device="cpu")
        losses, same = [], True
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            same = same and same_on_every_rank(leaves(state["params"]))
        out["train"][codec] = {"losses": losses, "params_equal": same}
        for i, e in enumerate(state.get("err", [])):
            save[f"train/{codec}/err/{i}"] = e.numpy()

    # -- run_training: a crash on every rank, a resume from rank 0's
    # checkpoint with the residual rows in it --------------------------------
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)

    def store():
        geometry = VolumeGeometry(meta_blocks=256, journal_blocks=512,
                                  oplog_slots=1, oplog_blocks=64)
        vol = Volume.format(PMDevice(size=256 * 1024 * 1024), geometry)
        return USplit(vol, mode=Mode.SYNC, staging_file_bytes=8 << 20,
                      staging_prealloc=2, staging_background=False)

    def train(ckpt=None, crash_at=None, global_batch=4):
        pipe = TokenPipeline(cfg, global_batch=global_batch, seq_len=16,
                             seed=7)
        return run_training(api, pipe, LoopConfig(
            steps=6, ckpt_every=2, codec="int8", bucket_elems=1 << 14),
            opt, ckpt=ckpt, device="cpu", crash_at=crash_at,
            pod_group=group)

    whole = train()
    ckpt = CheckpointManager(store()) if rank == 0 else None
    try:
        train(ckpt, crash_at=3)
        raise AssertionError("no crash")
    except RuntimeError as e:
        assert "injected crash at step 3" in str(e), e
    resumed = train(ckpt)
    out["ckpt"] = {"whole": whole.losses, "resumed": resumed.losses,
                   "restored_from": resumed.restored_from,
                   "steps_run": resumed.steps_run}
    if rank == 0:
        _, init_state, _ = make_train_step(api, opt, pod_group=group,
                                        bucket_elems=1 << 14)
        like = init_state(convert.params_from_numpy(
            nest("train/params/"), device="cpu"), device="cpu")
        step, tree, extra = ckpt.restore(like)
        out["ckpt"]["saved_step"] = step
        out["ckpt"]["err_shapes"] = [list(e.shape) for e in tree["err"]]
        out["ckpt"]["pipeline_step"] = extra["pipeline_step"]
    # both raise before their first collective
    if rank == 1:
        try:
            train(CheckpointManager(store()))
        except ValueError as e:
            out["errors"]["ckpt_on_rank_1"] = str(e)
    try:
        train(global_batch=3)
    except ValueError as e:
        out["errors"]["batch_of_3"] = str(e)
    monitor = HeartbeatMonitor([0, 1])
    try:
        run_training(api, TokenPipeline(cfg, global_batch=4, seq_len=16,
                                        seed=7), LoopConfig(steps=6), opt,
                     device="cpu", pod_group=group, monitor=monitor,
                     policy=FaultPolicy(monitor, assignment={0: 0, 1: 1},
                                        chips_per_worker=1, model_axis=1))
    except ValueError as e:
        out["errors"]["fault_path"] = str(e)
    dist.barrier(group=group)
    np.savez(f"{out_dir}/rank{rank}.npz", **save)
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


def env() -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + e["PYTHONPATH"] if e.get("PYTHONPATH") else "")
    return e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX two-pod subprocess, then the port's two ranks."""
    out = tmp_path_factory.mktemp("pods")
    e = env()
    e["XLA_FLAGS"] = (e.get("XLA_FLAGS", "")
                      + " --xla_force_host_platform_device_count=2").strip()
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out)],
                          capture_output=True, text=True, env=e,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    jax_out = json.loads(line[len("RESULT "):])
    store = out / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), "2", str(store),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env()) for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            errs.append((p.returncode, err[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    arrays = [np.load(out / f"rank{r}.npz") for r in range(2)]
    return jax_out, np.load(out / "jax.npz"), ranks, arrays


@pytest.mark.parametrize("codec", ["none", "int8", "topk"])
@pytest.mark.parametrize("scenario", ["toy", "train"])
def test_two_ranks_match_the_two_pod_reference(runs, scenario, codec):
    jax_out, jax_arrays, ranks, arrays = runs
    want = jax_out[scenario][codec]
    for r in range(2):
        rec = ranks[r][scenario][codec]
        assert rec["params_equal"], "ranks' params must stay bitwise equal"
        np.testing.assert_allclose(rec["losses"], want, rtol=1e-5, atol=0)
        assert rec["losses"] == ranks[0][scenario][codec]["losses"]
        if scenario == "toy" and codec != "none":
            assert rec["max_bound_violation"] <= 0.0
    if codec == "none":
        return
    keys = sorted(k for k in jax_arrays.files
                  if k.startswith(f"{scenario}/{codec}/err/"))
    assert keys and keys == sorted(k for k in arrays[0].files
                                   if k.startswith(f"{scenario}/{codec}/"))
    differ = False
    for k in keys:
        rows = jax_arrays[k]
        for r in range(2):
            assert_residuals_close(arrays[r][k], rows[r], flip_share=(
                1e-2 if (scenario, codec) == ("train", "int8") else 1e-3))
        differ |= not np.array_equal(arrays[0][k], arrays[1][k])
    assert differ, "each rank carries its own residual row"


def test_toy_codecs_converge_as_the_reference_asserts(runs):
    _, _, ranks, _ = runs
    toy = ranks[0]["toy"]
    for codec in ("int8", "topk"):
        assert toy[codec]["losses"][-1] < toy[codec]["losses"][0]
    np.testing.assert_allclose(toy["int8"]["losses"], toy["none"]["losses"],
                               rtol=0.05)
    assert toy["topk"]["losses"][-1] < toy["none"]["losses"][0]
    train = ranks[0]["train"]
    np.testing.assert_allclose(train["int8"]["losses"],
                               train["none"]["losses"], rtol=0.05)
    assert train["topk"]["losses"][-1] < train["topk"]["losses"][0]


def test_crash_restart_resumes_with_residuals_in_the_checkpoint(runs):
    _, jax_arrays, ranks, _ = runs
    for r in range(2):
        ck = ranks[r]["ckpt"]
        assert ck["restored_from"] == 2 and ck["steps_run"] == 4
        assert ck["resumed"] == ck["whole"][2:], (r, ck)
        assert ck["whole"] == ranks[0]["ckpt"]["whole"]
    ck = ranks[0]["ckpt"]
    assert ck["saved_step"] == 6 and ck["pipeline_step"] == 6
    # the reference's global layout: one row a pod, rank-major
    sizes = [jax_arrays[f"train/int8/err/{i}"].shape[1]
             for i in range(len(ck["err_shapes"]))]
    assert ck["err_shapes"] == [[2 * n] for n in sizes]


def test_misuse_raises(runs):
    _, _, ranks, _ = runs
    assert "rank 0 alone" in ranks[1]["errors"]["ckpt_on_rank_1"]
    for r in range(2):
        assert "does not split" in ranks[r]["errors"]["batch_of_3"]
        # each rank would plan steal / remesh on its own: refused
        assert "does not run over a pod_group" in \
            ranks[r]["errors"]["fault_path"]
