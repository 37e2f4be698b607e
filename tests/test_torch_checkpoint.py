"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same train state saved by each on
identically formatted volumes gives the same shard bytes and manifest
records, and with the host chunk at least the largest leaf the same PM
bytes; each package restores the other's checkpoints exactly; bfloat16
travels as ``"bfloat16"``; a torn newest manifest falls back; ``keep``
collects the right files; and a POSIX ``save(blocking=False)`` holds the
values from before an in-place update that follows it.

The state is qwen2-1.5b SMOKE after one JAX AdamW step (so ``mu``, ``nu``
and ``step`` are real), converted with ``repro_torch.convert``.
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.staging as ref_staging
import repro.core.store as ref_store
import repro_torch.core as port_core
import repro_torch.core.staging as port_staging
import repro_torch.core.store as port_store
from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.train.optimizer import leaves

PACKAGES = {
    "ref": types.SimpleNamespace(core=ref_core, manager=RefManager,
                                 staging=ref_staging, store=ref_store),
    "port": types.SimpleNamespace(core=port_core, manager=CheckpointManager,
                                  staging=port_staging, store=port_store),
}
MB = 1024 * 1024


@pytest.fixture(scope="module")
def jax_state():
    cfg = jax_get_config("qwen2-1.5b", smoke=True)
    api = jax_build_model(cfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    step, _, _, init_state = jax_make_train_step(
        api, mesh, JaxAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2))
    batch = TokenPipeline(cfg, global_batch=4, seq_len=16, seed=5).batch_at(0)
    with jax.set_mesh(mesh):
        state = init_state(jax_init_params(api.init_specs(),
                                           jax.random.PRNGKey(0)))
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, state)


def torch_tree(np_tree):
    return convert.params_from_numpy(np_tree, device="cpu")


def np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.fixture
def fixed_staging_names(monkeypatch):
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg.store, "id", lambda obj: 0x5EED,
                            raising=False)
        monkeypatch.setattr(pkg.staging.StagingAllocator, "_counter", 0)


def make_store(pkg, mode="SYNC", staging=8 * MB):
    c = pkg.core
    geometry = c.VolumeGeometry(meta_blocks=256, journal_blocks=512,
                                oplog_slots=2, oplog_blocks=128)
    vol = c.Volume.format(c.PMDevice(size=96 * MB), geometry)
    return c.USplit(vol, mode=c.Mode[mode], staging_file_bytes=staging,
                    staging_prealloc=2, staging_background=False)


def manager(name, store, **kw):
    if name == "port":
        kw.setdefault("chunk_bytes", MB)   # >= every leaf of the state
    return PACKAGES[name].manager(store, **kw)


def tree_for(name, np_state):
    return np_state if name == "ref" else torch_tree(np_state)


# ---------------------------------------------------------------- same bytes


@pytest.mark.parametrize("mode", ["POSIX", "SYNC", "STRICT"])
def test_same_state_same_shard_manifest_and_pm_bytes(jax_state, mode,
                                                     fixed_staging_names):
    """With the host chunk at least the largest leaf and staging files that
    hold the checkpoint, the port writes each leaf in one append, as the
    reference does: every PM byte (the STRICT oplog included) and every
    store counter are the reference's."""
    out = {}
    for name in PACKAGES:
        store = make_store(PACKAGES[name], mode)
        manager(name, store).save(1, tree_for(name, jax_state),
                                  extra={"pipeline_step": 3})
        out[name] = {
            "shard": store.read_file("ckpt/1/shard-0.bin"),
            "manifest": store.read_file("ckpt/1/MANIFEST-0"),
            "latest": store.read_file("ckpt/LATEST"),
            "namespace": sorted(store.ksplit.namespace),
            "buf": store.device.buf.copy(), "stats": store.stats}
    ref, port = out["ref"], out["port"]
    for key in ("shard", "manifest", "latest", "namespace"):
        assert port[key] == ref[key], key
    assert vars(port["stats"]) == vars(ref["stats"])
    assert len(ref["shard"]) == sum(x.nbytes for x in np_leaves(jax_state))
    assert np.array_equal(port["buf"], ref["buf"])


def test_records_match_the_reference_walk(jax_state):
    """Leaf paths, dtypes, shapes, offsets, nbytes and crcs, read back from
    the port's manifest, against the reference's own flattening."""
    import json
    import zlib
    from repro.checkpoint.manager import _leaf_paths as ref_leaf_paths
    store = make_store(PACKAGES["port"])
    manager("port", store).save(7, torch_tree(jax_state))
    blob = store.read_file("ckpt/7/MANIFEST-0")
    records = json.loads(blob[4:])["records"]
    offset = 0
    for rec, (path, leaf) in zip(records, ref_leaf_paths(jax_state),
                                 strict=True):
        leaf = np.asarray(leaf)
        assert rec == {"path": path, "dtype": str(leaf.dtype),
                       "shape": list(leaf.shape), "offset": offset,
                       "nbytes": leaf.nbytes,
                       "crc": zlib.crc32(leaf.tobytes())}
        offset += leaf.nbytes
    assert len(records) == 43


def test_chunked_save_copies_nothing_where_the_reference_copies(
        jax_state, fixed_staging_names):
    """64 KB pieces over 128 KB staging files: the checkpoint crosses many
    staging files.  The shard bytes and manifest stay the reference's, and
    the port's relink copies nothing (each piece after a leaf's head starts
    on a block)."""
    out = {}
    for name in PACKAGES:
        store = make_store(PACKAGES[name], staging=128 * 1024)
        kw = {"chunk_bytes": 64 * 1024} if name == "port" else {}
        PACKAGES[name].manager(store, **kw).save(
            2, tree_for(name, jax_state))
        out[name] = (store.read_file("ckpt/2/shard-0.bin"),
                     store.read_file("ckpt/2/MANIFEST-0"),
                     store.stats.copied_bytes)
    assert out["port"][:2] == out["ref"][:2]
    assert out["port"][2] == 0
    assert out["ref"][2] > 0, out["ref"][2]


# ---------------------------------------------------------------- restore


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_restores_the_others_checkpoint(jax_state, writer,
                                                     reader):
    store = make_store(PACKAGES[writer])
    manager(writer, store).save(4, tree_for(writer, jax_state),
                                extra={"pipeline_step": 4})
    got = manager(reader, store).restore(tree_for(reader, jax_state))
    assert got is not None
    step, tree, extra = got
    assert (step, extra) == (4, {"pipeline_step": 4})
    restored = ([t.numpy() for t in leaves(tree)] if reader == "port"
                else np_leaves(tree))
    want = np_leaves(jax_state)
    assert len(restored) == len(want) == 43
    for a, b in zip(restored, want):
        assert same_bits(a, b)


def test_bfloat16_round_trips_between_packages():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"w": np.asarray(jnp.asarray(x, jnp.bfloat16)),
             "b": {"s": np.asarray(7, np.int32)}}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16),
             "b": {"s": torch.tensor(7, dtype=torch.int32)}}
    for writer, wtree in (("port", ttree), ("ref", jtree)):
        store = make_store(PACKAGES[writer])
        manager(writer, store).save(1, wtree)
        blob = store.read_file("ckpt/1/MANIFEST-0")
        assert b'"dtype": "bfloat16"' in blob
        port = manager("port", store).restore(ttree)[1]
        ref = manager("ref", store).restore(jtree)[1]
        assert port["w"].dtype == torch.bfloat16
        assert torch.equal(port["w"], ttree["w"])
        assert ref["w"].dtype == jtree["w"].dtype
        assert ref["w"].view(np.uint16).tobytes() == \
            ttree["w"].view(torch.int16).numpy().tobytes()
        assert int(port["b"]["s"]) == int(ref["b"]["s"]) == 7


@pytest.mark.parametrize("name", ["ref", "port"])
def test_torn_newest_manifest_falls_back(jax_state, name):
    store = make_store(PACKAGES[name])
    mgr = manager(name, store)
    tree = tree_for(name, jax_state)
    mgr.save(1, tree, extra={"pipeline_step": 1})
    bumped = jax.tree.map(lambda a: np.asarray(a) + 1, jax_state)
    mgr.save(2, tree_for(name, bumped), extra={"pipeline_step": 2})
    fd = store.open("ckpt/2/MANIFEST-0")
    store.pwrite(fd, b"\xff", 9)             # tear one byte of step 2's
    store.fsync(fd)
    # the candidates are LATEST and the steps this manager saved
    got = mgr.restore(tree)
    assert got[0] == 1 and got[2] == {"pipeline_step": 1}
    got_leaves = ([t.numpy() for t in leaves(got[1])] if name == "port"
                  else np_leaves(got[1]))
    assert all(same_bits(a, b)
               for a, b in zip(got_leaves, np_leaves(jax_state)))


def test_keep_collects_the_same_files(jax_state, fixed_staging_names):
    names = {}
    for name in PACKAGES:
        store = make_store(PACKAGES[name])
        mgr = manager(name, store, keep=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, tree_for(name, jax_state))
        names[name] = sorted(n for n in store.ksplit.namespace
                             if not n.startswith("."))
        assert mgr.saved_steps == [3, 4] and mgr.latest_step() == 4
    assert names["port"] == names["ref"] == [
        "ckpt/3/MANIFEST-0", "ckpt/3/shard-0.bin", "ckpt/4/MANIFEST-0",
        "ckpt/4/shard-0.bin", "ckpt/LATEST"]


# ---------------------------------------------------------------- in place


def test_posix_nonblocking_save_survives_an_in_place_update(jax_state):
    """The background save may only start writing after the caller has
    updated the tree in place (as AdamW does): it must still commit the
    values the tree held when ``save`` returned."""
    store = make_store(PACKAGES["port"], "POSIX")
    gate = threading.Event()
    real_open = store.open

    def gated_open(name, create=False):
        if name.startswith("ckpt/5/shard"):
            assert gate.wait(10)
        return real_open(name, create)

    store.open = gated_open
    mgr = manager("port", store)
    tree = torch_tree(jax_state)
    before = [t.clone() for t in leaves(tree)]
    mgr.save(5, tree, blocking=False)
    for t in leaves(tree):                   # the next step, in place
        t.add_(1)
    gate.set()
    mgr.wait()
    got = mgr.restore(tree)
    assert got[0] == 5
    for a, b in zip(leaves(got[1]), before):
        assert torch.equal(a, b)
    assert not torch.equal(leaves(tree)[0], before[0])


def test_blocking_is_the_only_path_outside_posix(jax_state):
    """SYNC and STRICT saves are durable on return even when asked not to
    block, as in the reference."""
    for mode in ("SYNC", "STRICT"):
        store = make_store(PACKAGES["port"], mode)
        mgr = manager("port", store)
        mgr.save(1, torch_tree(jax_state), blocking=False)
        assert mgr._flush_thread is None and mgr.latest_step() == 1
