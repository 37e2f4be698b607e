"""Shared by the port's engine tests (tests/test_torch_{prefix,tier,spec,
obs,cluster,arrival}.py): the JAX package's serving stack and the port's
side by side,
as two namespaces with the same names, so that each scenario is written
once and run on both engines from the same weights.

Weights are qwen2-1.5b SMOKE at fp32 from ``repro.models.init_params``,
carried across with ``convert.params_from_numpy`` (as
tests/test_torch_serve.py's ``pair`` fixture does); the port runs on the
CPU."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as jax_core
import repro.core.kvcache as jax_kvcache
import repro.core.oplog as jax_oplog
import repro.dist.fault as jax_fault
import repro.obs as jax_obs
import repro.serve as jax_serve
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch import core as port_core
from repro_torch import obs as port_obs
from repro_torch import serve as port_serve
from repro_torch.configs import get_config
from repro_torch.core import kvcache as port_kvcache
from repro_torch.core import oplog as port_oplog
from repro_torch.dist import fault as port_fault
from repro_torch.models import build_model

# the controller counters every scenario holds equal across the engines
COUNTERS = ("pages_adopted", "pages_copied", "pages_relinked", "pins_taken",
            "pages_allocated", "pages_freed")


def _lib(name, core, kvcache, oplog, obs, serve, fault, api, params, kw):
    return SimpleNamespace(
        name=name, api=api, params=params, kw=kw,
        Engine=serve.ServingEngine, Client=serve.ServeClient,
        SpecConfig=serve.SpecConfig, SamplingParams=serve.SamplingParams,
        Mode=core.Mode, PMDevice=core.PMDevice, OpLog=oplog.OpLog,
        OP_TRUNCATE=oplog.OP_TRUNCATE, OP_KV_COMMIT=oplog.OP_KV_COMMIT,
        replay=kvcache.replay_kv_commits,
        KVGeometry=kvcache.KVGeometry, PagedKVCache=kvcache.PagedKVCache,
        KVPoolFullError=kvcache.KVPoolFullError,
        Obs=obs.Obs, validate=obs.validate_chrome_trace,
        Cluster=serve.EngineCluster, PrefixRouter=serve.PrefixRouter,
        prefix_hash=serve.prefix_hash,
        snapshot_session=serve.snapshot_session,
        restore_session=serve.restore_session,
        MigrationError=serve.MigrationError,
        ByteTokenizer=serve.ByteTokenizer,
        OpenLoopDriver=serve.OpenLoopDriver, ArrivalSpec=serve.ArrivalSpec,
        poisson_schedule=serve.poisson_schedule,
        trace_schedule=serve.trace_schedule,
        HeartbeatMonitor=fault.HeartbeatMonitor,
        FaultPolicy=fault.FaultPolicy, StealPlan=fault.StealPlan,
        RemeshPlan=fault.RemeshPlan, plan_steal=fault.plan_steal)


def libs(arch: str = "qwen2-1.5b", params_fn=None):
    """(jax lib, port lib) at fp32 from one draw of the JAX package's
    weights (``params_fn(numpy params) -> numpy params`` may redraw
    leaves first)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32)
    japi = jax_build_model(jcfg)
    np_params = jax.tree.map(
        np.asarray, jax_init_params(japi.init_specs(),
                                    jax.random.PRNGKey(0)))
    if params_fn is not None:
        np_params = params_fn(np_params)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = convert.params_from_numpy(np_params, device="cpu")
    return (_lib("jax", jax_core, jax_kvcache, jax_oplog, jax_obs, jax_serve,
                 jax_fault, japi, jparams, {}),
            _lib("torch", port_core, port_kvcache, port_oplog, port_obs,
                 port_serve, port_fault, build_model(tcfg), tparams,
                 {"device": "cpu"}))


def engine(lib, **kw):
    return lib.Engine(lib.api, lib.params, **kw, **lib.kw)


def client(lib, **kw):
    return lib.Client(lib.api, lib.params, **kw, **lib.kw)


def cluster(lib, **kw):
    return lib.Cluster(lib.api, lib.params, **kw, **lib.kw)


def oplog(lib):
    return lib.OpLog(lib.PMDevice(size=4 * 1024 * 1024), base_block=1,
                     num_blocks=16)


def counters(eng) -> dict:
    ctrl = eng.controller
    return {k: getattr(ctrl, k) for k in COUNTERS}


def entries(log) -> list:
    """The oplog's entries as plain tuples (both packages' ``LogEntry``
    are the same dataclass)."""
    return [dataclasses.astuple(e) for e in log.scan()]


def _leaves(eng, page):
    views = eng._gather_page(page)
    if views and isinstance(views[0], torch.Tensor):
        return [v.contiguous() for v in views]
    return [np.asarray(v) for v in views]


def bits(v) -> np.ndarray:
    """An array's bits: float32 as uint32, bfloat16 as uint16 (JAX's
    ml_dtypes arrays and the port's tensors alike)."""
    if isinstance(v, torch.Tensor):
        as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        v = v.contiguous().view(as_int[v.dtype]).numpy()
    v = np.ascontiguousarray(v)
    return v.view(np.uint32 if v.itemsize == 4 else np.uint16)


def leaf_bits(eng, page) -> list:
    """One physical page's bits in every layer pool ([L, T, KV, D] each,
    the engine's own gather order)."""
    return [bits(v) for v in _leaves(eng, page)]


def page_bits(eng, page) -> np.ndarray:
    return np.concatenate([v.ravel() for v in leaf_bits(eng, page)])


def page_values(eng, page) -> np.ndarray:
    """One physical page's values as float32, for comparing the two
    engines' pages (their K/V agree to float32 rounding, not bits)."""
    return np.concatenate([
        (v.float().numpy() if isinstance(v, torch.Tensor)
         else v.astype(np.float32)).ravel() for v in _leaves(eng, page)])


# the two engines' K/V for one page: float32 products summed in another
# order through two SMOKE layers
KV_TOL = 1e-5


def assert_pages_close(jeng, jpage, teng, tpage) -> None:
    a, b = page_values(jeng, jpage), page_values(teng, tpage)
    assert np.abs(a - b).max() <= KV_TOL * max(1.0, np.abs(a).max())


def audit(eng) -> None:
    """Cross-check the metadata planes against each other (as
    tests/test_tier.py does): controller refcounts equal live-sequence
    links plus trie device pins, the trie's pin count its device-resident
    nodes, the tier's occupancy the trie's host-resident nodes."""
    ctrl = eng.controller
    expect = np.zeros_like(ctrl._refcount)
    for seq in ctrl._seqs.values():
        for p in seq.pages:
            expect[p] += 1
    pc = eng.prefix_cache
    if pc is not None:
        device_pins = 0
        for node in pc._iter_nodes():
            if node.on_host:
                continue
            expect[node.page] += 1
            device_pins += 1
        assert device_pins == pc.pinned_pages
        if eng.tier is not None:
            assert pc.host_nodes == eng.tier.host_pages
    assert list(expect[1:]) == list(ctrl._refcount[1:]), \
        "refcounts drifted from seq links + trie pins"


def drain(eng) -> None:
    """Cancel what is left, clear the trie, and check that the pool is
    whole again (tests/test_serve_api.py's teardown audit)."""
    for req in list(eng.waiting) + list(eng.active.values()):
        eng.cancel(req)
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    ctrl = eng.controller
    assert not eng.active and not eng.waiting
    assert ctrl.pages_in_use == 0, "leaked pool pages"
    assert ctrl.pages_in_use == ctrl.pages_allocated - ctrl.pages_freed
    assert ctrl.num_free_pages == ctrl.geom.num_pages - 1
