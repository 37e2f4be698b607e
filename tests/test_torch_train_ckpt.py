"""The port's fault-aware training loop (``repro_torch.train.run_training``
with ``ckpt``, ``monitor``, ``worker`` and ``policy``) and its entry point
``repro_torch.launch.train`` on qwen2-1.5b SMOKE in float32 on the CPU.

Each scenario of tests/test_train_serve.py (crash and restart, the STRICT
round trip) and tests/test_elastic.py (rescale and resume, a steal in
band, a straggler that leaves, the remesh fallback) runs on the port and
on the JAX loop.  The port's parameters are its own draw, so losses are
held to the port's own uninterrupted run (rtol 1e-5, the reference
test's), and the structural records to the JAX loop's: steps run, the
step restored from, the plans, the policy's assignment, the pipeline's
position and the checkpoint files.
"""

import dataclasses
import itertools
import time
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.data import TokenPipeline as JaxPipeline
from repro.dist import fault as jax_fault
from repro.models import build_model as jax_build_model
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import LoopConfig as JaxLoopConfig
from repro.train import run_training as jax_run_training
import repro.train.loop as jax_loop
import repro_torch.core as port_core
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.dist import fault
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, init_params
from repro_torch.train import AdamWConfig, LoopConfig, run_training
import repro_torch.train.loop as port_loop
from repro_torch.train.optimizer import leaves

MB = 1024 * 1024


def host_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


class Side:
    """One package's loop, store and fault plane behind one signature."""

    def __init__(self, name: str) -> None:
        self.name = name
        jax_side = name == "jax"
        self.core = ref_core if jax_side else port_core
        self.fault = jax_fault if jax_side else fault
        self.Manager = JaxManager if jax_side else CheckpointManager
        self.Pipeline = JaxPipeline if jax_side else TokenPipeline
        self.Loop = JaxLoopConfig if jax_side else LoopConfig
        self.Adam = JaxAdamWConfig if jax_side else AdamWConfig
        cfg = (jax_get_config if jax_side else get_config)(
            "qwen2-1.5b", smoke=True)
        if not jax_side:
            cfg = dataclasses.replace(cfg, dtype=torch.float32)
        self.cfg = cfg
        self.api = (jax_build_model if jax_side else build_model)(cfg)

    def store(self, mode="SYNC", oplog_blocks=64):
        c = self.core
        geometry = c.VolumeGeometry(meta_blocks=256, journal_blocks=512,
                                    oplog_slots=1, oplog_blocks=oplog_blocks)
        device = c.PMDevice(size=256 * MB)
        vol = c.Volume.format(device, geometry)
        return c.USplit(vol, mode=c.Mode[mode],
                        staging_file_bytes=8 * MB, staging_prealloc=2,
                        staging_background=False)

    def pipe(self, **kw):
        return self.Pipeline(self.cfg, **kw)

    def run(self, pipe, steps, opt, **kw):
        loop_kw = {k: kw.pop(k) for k in ("ckpt_every",) if k in kw}
        loop = self.Loop(steps=steps, **loop_kw)
        if self.name == "jax":
            return jax_run_training(self.api, host_mesh(), pipe, loop, opt,
                                    **kw)
        return run_training(self.api, pipe, loop, opt, device="cpu", **kw)


SIDES = ("jax", "port")


def plan_record(plan):
    if plan is None:
        return None
    return type(plan).__name__, dataclasses.asdict(plan)


def files(store):
    return sorted(n for n in store.ksplit.namespace if not n.startswith("."))


# ---------------------------------------------------------------- crash


def crash_restart(side: Side) -> dict:
    opt = side.Adam(lr=1e-3, warmup_steps=2, total_steps=10)
    store = side.store()
    pipe = side.pipe(global_batch=4, seq_len=32, seed=7)
    with pytest.raises(RuntimeError, match="injected crash at step 6"):
        side.run(pipe, 10, opt, ckpt_every=4, ckpt=side.Manager(store),
                 crash_at=6)
    crashed_at = pipe.snapshot()
    pipe_c = side.pipe(global_batch=4, seq_len=32, seed=7)
    resumed = side.run(pipe_c, 10, opt, ckpt_every=4,
                       ckpt=side.Manager(store))
    return {"crashed_at": crashed_at, "restored_from": resumed.restored_from,
            "steps_run": resumed.steps_run, "pipeline": pipe_c.snapshot(),
            "files": files(store), "copied_bytes": store.stats.copied_bytes,
            "losses": resumed.losses}


def test_crash_restart_resumes_exactly():
    port = Side("port")
    got = crash_restart(port)
    base = port.run(port.pipe(global_batch=4, seq_len=32, seed=7), 10,
                    AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    assert got["restored_from"] == 4
    np.testing.assert_allclose(got["losses"], base.losses[4:], rtol=1e-5)
    ref = crash_restart(Side("jax"))
    for key in ("crashed_at", "restored_from", "steps_run", "pipeline",
                "files", "copied_bytes"):
        assert got[key] == ref[key], key
    assert got["copied_bytes"] == 0


def test_strict_checkpoint_round_trip_through_a_crash():
    """test_train_serve.py's STRICT round trip, then the same checkpoint
    read from a torn copy of the device mounted with oplog recovery."""
    side = Side("port")
    store = side.store("STRICT")
    mgr = CheckpointManager(store)
    params = init_params(side.api.init_specs(),
                         torch.Generator().manual_seed(0), device="cpu")
    tree = {"params": params}
    mgr.save(1, tree)
    step, restored, _ = mgr.restore(tree)
    assert step == 1
    for a, b in zip(leaves(params), leaves(restored["params"])):
        assert torch.equal(a, b)
    crashed = store.device.torn_copy(np.random.default_rng(0))
    vol = port_core.Volume.mount(crashed, store.volume.geometry)
    s2 = port_core.USplit(vol, mode=port_core.Mode.STRICT, oplog_slot=0,
                          recover=True, staging_file_bytes=8 * MB,
                          staging_prealloc=1, staging_background=False)
    step, restored, _ = CheckpointManager(s2).restore(tree)
    assert step == 1
    for a, b in zip(leaves(params), leaves(restored["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- elastic


def rescale(side: Side) -> dict:
    opt = side.Adam(lr=1e-3, warmup_steps=2, total_steps=12)
    store = side.store()
    ckpt = side.Manager(store)
    monitor = side.fault.HeartbeatMonitor(list(range(16)), timeout_s=5.0)
    pipe = side.pipe(global_batch=15, seq_len=32, seed=11, shard=0,
                     num_shards=1)
    r1 = side.run(pipe, 6, opt, ckpt_every=3, ckpt=ckpt, monitor=monitor,
                  worker=0)
    for w in range(16):
        if w != 5:
            monitor.beat(w, 6, 1.0, now=100.0)
    monitor.beat(5, 3, 1.0, now=90.0)
    dead = monitor.dead_workers(now=100.0)
    monitor.mark_dead(5)
    plan = side.fault.plan_remesh(monitor.alive_workers(),
                                  chips_per_worker=16, model_axis=16,
                                  restore_step=ckpt.latest_step())
    new_pipe = pipe.reshard(shard=plan.data_shard_of[0],
                            num_shards=len(plan.survivors))
    resharded_at = new_pipe.snapshot()
    r2 = side.run(new_pipe, 12, opt, ckpt_every=3, ckpt=ckpt,
                  monitor=monitor, worker=0)
    assert np.isfinite(r2.losses).all()
    assert np.mean(r2.losses[-3:]) < np.mean(r1.losses[:3])
    return {"r1_steps": r1.steps_run, "dead": dead,
            "plan": plan_record(plan), "resharded_at": resharded_at,
            "restored_from": r2.restored_from, "r2_steps": r2.steps_run,
            "pipeline": new_pipe.snapshot(), "files": files(store),
            "alive": monitor.alive_workers()}


def steal_in_band(side: Side) -> dict:
    opt = side.Adam(lr=1e-3, warmup_steps=2, total_steps=8)
    monitor = side.fault.HeartbeatMonitor([0, 1, 2, 3], patience=1)
    policy = side.fault.FaultPolicy(monitor, assignment={1: 0, 2: 1, 3: 2},
                                    spares=[0], chips_per_worker=16,
                                    model_axis=16)
    for w, rate in ((1, 1.0), (2, 8.0), (3, 1.0)):
        monitor.beat(w, 0, rate)
    pipe = side.pipe(global_batch=6, seq_len=32, seed=3, shard=0,
                     num_shards=3)
    r = side.run(pipe, 4, opt, monitor=monitor, worker=0, policy=policy)
    return {"steps_run": r.steps_run,
            "mitigations": [plan_record(p) for p in r.mitigations],
            "remesh_pending": plan_record(r.remesh_pending),
            "assignment": dict(policy.assignment),
            "spares": list(policy.spares), "pipeline": pipe.snapshot()}


def straggler_exits(side: Side) -> dict:
    opt = side.Adam(lr=1e-3, warmup_steps=2, total_steps=8)
    monitor = side.fault.HeartbeatMonitor([0, 1, 2, 9], patience=1)
    policy = side.fault.FaultPolicy(monitor, assignment={0: 0, 1: 1, 2: 2},
                                    spares=[9], chips_per_worker=16,
                                    model_axis=16)
    for w in (1, 2, 9):
        monitor.beat(w, 0, 1e-4)
    pipe = side.pipe(global_batch=6, seq_len=32, seed=3, shard=0,
                     num_shards=3)
    r = side.run(pipe, 6, opt, monitor=monitor, worker=0, policy=policy)
    return {"steps_run": r.steps_run,
            "mitigations": [plan_record(p) for p in r.mitigations],
            "remesh_pending": plan_record(r.remesh_pending),
            "assignment": dict(policy.assignment),
            "pipeline": pipe.snapshot()}


def remesh_fallback(side: Side) -> dict:
    opt = side.Adam(lr=1e-3, warmup_steps=2, total_steps=8)
    monitor = side.fault.HeartbeatMonitor([0, 1], timeout_s=0.5)
    policy = side.fault.FaultPolicy(monitor, assignment={0: 0, 1: 1},
                                    chips_per_worker=16, model_axis=16)
    monitor.beat(1, 0, 1.0, now=time.monotonic() - 100.0)
    pipe = side.pipe(global_batch=4, seq_len=32, seed=5, shard=0,
                     num_shards=1)
    r = side.run(pipe, 6, opt, monitor=monitor, worker=0, policy=policy)
    return {"steps_run": r.steps_run,
            "mitigations": [plan_record(p) for p in r.mitigations],
            "remesh_pending": plan_record(r.remesh_pending),
            "assignment": dict(policy.assignment),
            "pipeline": pipe.snapshot()}


@pytest.fixture
def steady_clock(monkeypatch):
    """Both loops time their steps on a clock that moves 10 ms a call, so
    worker 0's heartbeats, and the step at which the policy acts, do not
    depend on the host's load (the JAX loop's first step includes its
    compile).  The fault plane keeps the real clock."""
    for mod in (jax_loop, port_loop):
        ticks = itertools.count()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda ticks=ticks: next(ticks) * 0.01))


@pytest.mark.parametrize("scenario", [rescale, steal_in_band,
                                      straggler_exits, remesh_fallback],
                         ids=lambda f: f.__name__)
def test_loop_scenario_records_equal_the_jax_loop(scenario, steady_clock):
    got = {side: scenario(Side(side)) for side in SIDES}
    assert got["port"] == got["jax"]


def test_loop_scenarios_hold_the_reference_outcomes(steady_clock):
    """The outcomes tests/test_elastic.py asserts, on the port alone."""
    side = Side("port")
    r = rescale(side)
    assert r["dead"] == [5] and r["restored_from"] == 6
    assert r["resharded_at"] == 6 and r["pipeline"] == 12
    assert r["plan"][1]["mesh_shape"] == (15, 16)
    s = steal_in_band(side)
    assert s["steps_run"] == 4 and s["remesh_pending"] is None
    assert [m[1]["spare"] for m in s["mitigations"]] == [0]
    assert s["assignment"][0] == 1 and s["pipeline"] < 4
    x = straggler_exits(side)
    assert x["steps_run"] < 6 and x["assignment"] == {1: 1, 2: 2, 9: 0}
    m = remesh_fallback(side)
    assert m["remesh_pending"][0] == "RemeshPlan" and m["steps_run"] < 6
    assert m["remesh_pending"][1]["mesh_shape"] == (1, 16)


# ---------------------------------------------------------------- launch


def test_launch_train_on_the_cpu(capsys):
    launch_train.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "8",
                       "--ckpt-every", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    loss = next(line for line in out if " steps, loss " in line)
    first, _, last = loss.split("loss ")[1].split(" ")[:3]
    assert float(last) < float(first)
    store = next(line for line in out if line.startswith("[train] store:"))
    assert "copied_bytes=0," in store


def test_launch_train_mamba2_strict_with_spares_on_the_cpu(capsys):
    launch_train.main(["--arch", "mamba2-1.3b", "--steps", "6",
                       "--ckpt-every", "3", "--mode", "strict", "--spares",
                       "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ran 6 steps" in out and "copied_bytes=0," in out
    assert "log_entries=0" not in out


def test_launch_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--steps", "1"])


def test_checkpoint_volume_holds_the_kept_steps_and_one_more():
    """``checkpoint_volume`` sizes the device for keep + 1 checkpoints of
    the state: saves past ``keep`` never run out of space."""
    api = build_model(get_config("qwen2-1.5b", smoke=True))
    nbytes = launch_train.state_bytes(api)
    assert nbytes == 12 * sum(
        int(np.prod(s.shape)) for s in leaves(api.init_specs())) + 4
    store = launch_train.checkpoint_volume(nbytes,
                                           mode=port_core.Mode.SYNC, keep=1)
    mgr = CheckpointManager(store, keep=1)
    tree = {"x": torch.zeros(nbytes // 4, dtype=torch.int32)}
    for step in range(1, 5):
        tree["x"].fill_(step)
        mgr.save(step, tree)
    assert torch.equal(mgr.restore(tree)[1]["x"], tree["x"])
    assert mgr.latest_step() == 4 and store.stats.copied_bytes == 0


@pytest.mark.parametrize("nbytes", [1 << 20, 5_046_798_340, 18_520_000_000])
def test_checkpoint_volume_metadata_holds_every_data_block(nbytes):
    """The K-Split checkpoint (16 B a mapped block) fits the home region
    however many data blocks are mapped: with 2 GiB staging files a
    remount maps their preallocated blocks beside the committed
    checkpoint, which at a 5 GB state outnumbered the blocks of keep + 2
    checkpoints, the region's old size."""
    from repro_torch.core.volume import BLOCK_SIZE
    geometry, size = launch_train.checkpoint_geometry(
        nbytes, keep=1, staging_file_bytes=2 << 30, staging_prealloc=2)
    data_blocks = size // BLOCK_SIZE - geometry.data_base()
    assert geometry.meta_blocks * BLOCK_SIZE >= 16 * data_blocks + (1 << 20)
