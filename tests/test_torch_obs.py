"""The port's observability plane (DESIGN.md §10) against the JAX
engine's, at fp32 on qwen2-1.5b SMOKE with the JAX package's weights:
tests/test_obs.py's engine scenarios run on both engines and assert the
reference test's expectations and that the engines agree on the counter
snapshot, the trace's span families and the ledger's step counts (times
are each engine's own).  The registry, tracer, profiler, ledger and pool
gauge tests run on the port's copies with the reference's expectations,
and ``attach_fault`` over a duck-typed fault plane."""

import json
from types import SimpleNamespace

import pytest
from torch_engine_pair import client, libs

from repro_torch.core.kvcache import KVGeometry, PagedKVCache
from repro_torch.obs import (Obs, OverheadLedger, Registry, SpanTracer,
                             WindowedProfiler, attach_fault,
                             validate_chrome_trace)
from repro_torch.serve import PrefixCache


@pytest.fixture(scope="module")
def pair():
    return libs()


def both(pair, scenario):
    jrec, trec = (scenario(lib) for lib in pair)
    assert trec == jrec
    return trec


def counts(snap: dict) -> dict:
    """The snapshot's event counts and levels (times are each engine's
    own and differ)."""
    return {k: v for k, v in snap.items()
            if not k.endswith("_ns") and k != "spec.draft_ns"}


# ---------------------------------------------------------------- registry


def test_counters_are_monotonic():
    reg = Registry()
    c = reg.counter("events")
    c.inc()
    c.inc(3)
    assert reg.snapshot()["events"] == 4
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("events") is c
    assert "events" in reg.monotonic_names()


def test_registry_kind_collisions_and_lazy():
    reg = Registry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.register("x", lambda: 0)
    g = reg.gauge("depth")
    g.set(5)
    g.add(-2)
    box = {"v": 7}
    reg.register("lazy", lambda: box["v"], monotonic=True)
    snap = reg.snapshot()
    assert snap["depth"] == 3 and snap["lazy"] == 7
    box["v"] = 9
    assert reg.snapshot()["lazy"] == 9
    reg.register("lazy", lambda: 42, monotonic=True)
    assert reg.snapshot()["lazy"] == 42


def test_pool_gauge_matches_alloc_minus_freed_across_interleavings():
    kv = PagedKVCache(KVGeometry(num_pages=32, page_tokens=4, max_seqs=8,
                                 pages_per_seq=8))

    def check():
        assert kv.pages_in_use == kv.pages_allocated - kv.pages_freed

    a = kv.create_seq()
    kv.append_tokens(a, 10)
    check()
    b = kv.fork(a)
    check()
    assert kv.prepare_append(b, 1) is not None
    check()
    kv.append_tokens(b, 3)
    check()
    pc = PrefixCache(kv)
    c = kv.create_seq()
    kv.append_tokens(c, 8)
    prompt = list(range(100, 108))
    pc.insert(prompt, kv.committed_extents(c))
    check()
    d = kv.create_seq()
    pages, n_tok = pc.match(prompt + [1], align=1)
    assert n_tok == 8
    kv.adopt_prefix(d, pages)
    check()
    for sid in (a, b, c):
        kv.free_seq(sid)
        check()
    pc.release(10)
    check()
    kv.free_seq(d)
    check()
    pc.clear()
    check()
    assert kv.pages_in_use == 0
    assert kv.num_free_pages == 31


# ---------------------------------------------------------------- engines


def test_trie_hits_match_adoption_events(pair):
    def scenario(lib):
        obs = lib.Obs()
        c = client(lib, max_batch=2, max_seq=64, page_tokens=8, obs=obs)
        sess = c.open_session()
        shared = list(range(1, 17))
        outs = []
        for tail in ([21, 22, 23], [31, 32, 33], [41, 42, 43]):
            outs.append(sess.submit(shared + tail, max_new_tokens=2))
            c.run_until_done()
        snap = obs.registry.snapshot()
        assert snap["trie.hits"] == 2
        assert snap["trie.misses"] >= 1
        assert snap["kv.pages_adopted"] == snap["trie.match_pages_sum"] == 4
        assert snap["trie.tokens_saved"] == 4 * 8
        assert snap["trie.deepest_match"] == 2
        assert snap["kv.pages_in_use"] == snap["trie.pinned_pages"]
        c.engine.prefix_cache.clear()
        assert c.engine.controller.pages_in_use == 0
        return [r.output for r in outs], counts(snap)

    both(pair, scenario)


def test_trace_is_valid_chrome_and_spans_nest(pair, tmp_path):
    def scenario(lib):
        obs = lib.Obs(trace=True)
        c = client(lib, max_batch=2, max_seq=64, page_tokens=8, obs=obs)
        sess = c.open_session()
        r1 = sess.submit(list(range(1, 20)), max_new_tokens=3)
        r2 = sess.submit(list(range(1, 12)), max_new_tokens=2)
        c.run_until_done()
        path = tmp_path / f"trace_{lib.name}.json"
        c.dump_trace(str(path))
        doc = json.loads(path.read_text())
        assert lib.validate(doc) == []
        names = {ev["name"] for ev in doc["traceEvents"]}
        for expected in ("step", "admit", "schedule", "serve_step",
                         "sample", "submit", f"req{r1.rid}"):
            assert expected in names, expected
        req_evs = [ev for ev in doc["traceEvents"] if ev.get("tid", 0) >= 100]
        assert req_evs and all(ev["args"]["steps"] > 0 for ev in req_evs)
        assert doc["otherData"]["dropped_events"] == 0
        lanes = sorted((ev["name"], ev.get("tid", 0))
                       for ev in doc["traceEvents"])
        return r1.output, r2.output, lanes

    both(pair, scenario)


def test_trace_disabled_adds_zero_entries(pair):
    def scenario(lib):
        obs = lib.Obs()
        c = client(lib, max_batch=1, max_seq=64, page_tokens=8, obs=obs)
        r = c.open_session().submit([1, 2, 3, 4], max_new_tokens=2)
        c.run_until_done()
        assert obs.tracer is None
        assert "trace_events" not in obs.stats()
        with pytest.raises(ValueError):
            obs.dump_trace("/dev/null")
        bare = client(lib, max_batch=1, max_seq=64, page_tokens=8)
        assert bare.engine.obs is None
        rb = bare.open_session().submit([1, 2, 3, 4], max_new_tokens=2)
        bare.run_until_done()
        assert "obs" not in bare.stats()
        assert rb.output == r.output
        return r.output

    both(pair, scenario)


def test_engine_ledger_sums_to_phase_totals(pair):
    """Per-request ledgers (even split across each step's participants)
    sum to the engine's phase totals, and client_ns covers submit->admit."""
    def scenario(lib):
        obs = lib.Obs()
        c = client(lib, max_batch=2, max_seq=64, page_tokens=8, obs=obs)
        sess = c.open_session()
        reqs = [sess.submit(list(range(1, 10 + i)), max_new_tokens=3)
                for i in range(2)]
        c.run_until_done()
        totals = {k: obs.ledger.phase_totals("prefill")[k]
                  + obs.ledger.phase_totals("decode")[k]
                  for k in ("scheduler", "device", "persistence")}
        for comp, key in (("scheduler", "scheduler_ns"),
                          ("device", "device_ns"),
                          ("persistence", "persistence_ns")):
            summed = sum(r.ledger[key] for r in reqs)
            assert 0 <= totals[comp] - summed <= 2 * sum(
                r.ledger["steps"] for r in reqs)
        assert all(r.ledger["client_ns"] >= 0 for r in reqs)
        assert all(r.ledger["steps"] > 0 for r in reqs)
        return ([r.output for r in reqs], [r.ledger["steps"] for r in reqs],
                obs.ledger.phase_totals("prefill")["steps"],
                obs.ledger.phase_totals("decode")["steps"])

    both(pair, scenario)


def test_obs_stats_payload_shape(pair):
    def scenario(lib):
        obs = lib.Obs(window_s=0.001)
        c = client(lib, max_batch=1, max_seq=64, page_tokens=8, obs=obs)
        sess = c.open_session()
        r = sess.submit(list(range(1, 18)), max_new_tokens=4)
        c.run_until_done()
        st = sess.stats()
        assert st["submitted"] == 1 and st["done"] == 1
        assert st["overhead_ns"]["steps"] > 0
        payload = st["engine"]
        assert set(payload) >= {"counters", "windows", "overhead"}
        assert payload["counters"]["engine.steps"] > 0
        assert payload["windows"]
        total_tok = sum(w["counters"]["engine.tokens"]
                        for w in payload["windows"])
        assert total_tok == payload["counters"]["engine.tokens"]
        assert payload["overhead"]["phases"]["decode"]["steps"] > 0
        cs = c.stats()
        return (r.output, counts(payload["counters"]),
                {k: v for k, v in cs.items() if k != "obs"},
                sorted(cs["obs"]))

    both(pair, scenario)


# ---------------------------------------------------------------- units


def test_tracer_cap_and_validator_catches_overlap():
    tr = SpanTracer(max_events=2)
    tr.complete("a", "t", 0, 10)
    tr.complete("b", "t", 2, 8)
    tr.complete("c", "t", 20, 30)
    assert len(tr) == 2 and tr.dropped == 1
    assert tr.to_chrome()["otherData"]["dropped_events"] == 1
    bad = {"traceEvents": [
        {"name": "a", "cat": "t", "ph": "X", "ts": 0.0, "dur": 10.0,
         "pid": 0, "tid": 0},
        {"name": "b", "cat": "t", "ph": "X", "ts": 5.0, "dur": 10.0,
         "pid": 0, "tid": 0},
    ]}
    assert any("overlaps" in p for p in validate_chrome_trace(bad))
    assert validate_chrome_trace({"traceEvents": []})


def test_profiler_windows_delta_counters_and_ring():
    reg = Registry()
    box = {"tok": 0, "occ": 0.0}
    reg.register("engine.tokens", lambda: box["tok"], monotonic=True)
    reg.register("occupancy", lambda: box["occ"])
    prof = WindowedProfiler(reg, window_s=1.0, capacity=2)
    prof.observe(now=0.0)
    box["tok"], box["occ"] = 10, 0.5
    prof.observe(now=0.4)
    assert prof.windows() == []
    box["tok"], box["occ"] = 30, 0.75
    prof.observe(now=1.2)
    (w,) = prof.windows()
    assert w.counters["engine.tokens"] == 30
    assert w.gauges["occupancy"] == 0.75
    assert w.t_start == 0.0 and w.t_end == 1.2
    assert w.tok_s == pytest.approx(30 / 1.2)
    box["tok"] = 40
    prof.observe(now=2.3)
    box["tok"] = 45
    prof.flush(now=2.5)
    wins = prof.windows()
    assert len(wins) == 2
    assert [w.index for w in wins] == [1, 2]
    assert wins[0].counters["engine.tokens"] == 10
    assert wins[1].counters["engine.tokens"] == 5
    assert wins[1].duration == pytest.approx(0.2)


def test_overhead_ledger_breakdown_shares():
    led = OverheadLedger()
    led.add("prefill", sched_ns=100, device_ns=800, persist_ns=100, steps=2)
    led.add("decode", sched_ns=50, device_ns=900, persist_ns=50, steps=5)
    led.add_client(1000)
    bd = led.breakdown()
    assert bd["phases"]["prefill"]["steps"] == 2
    pre = bd["phases"]["prefill"]["shares"]
    assert pre["device"] == pytest.approx(0.8)
    assert sum(pre.values()) == pytest.approx(1.0)
    total = bd["shares"]
    assert sum(total.values()) == pytest.approx(1.0)
    assert total["client"] == pytest.approx(1000 / 3000)
    assert bd["software_frac"] == pytest.approx(1.0 - total["device"])
    assert bd["total_s"] == pytest.approx(3000 / 1e9)
    led.reset()
    assert led.breakdown()["total_s"] == 0.0


def test_attach_fault_reads_a_duck_typed_fault_plane():
    """``attach_fault`` reads whatever carries the fault plane's counters
    (the cluster's ``FaultPolicy`` or a stand-in)."""
    mon = SimpleNamespace(beats=3, heartbeats_missed=1, deaths=1,
                          straggler_flags=1, alive_workers=lambda: [0, 1])
    pol = SimpleNamespace(monitor=mon, steals=1, remeshes=1, spares=[])
    obs = Obs()
    attach_fault(obs, pol)
    snap = obs.registry.snapshot()
    assert snap["fault.heartbeats"] == 3 and snap["fault.steals"] == 1
    assert snap["fault.alive"] == 2 and snap["fault.spares"] == 0
    mon.beats = 5
    assert obs.registry.snapshot()["fault.heartbeats"] == 5
    assert "fault.deaths" in obs.registry.monotonic_names()
