"""The port's engine cluster against the JAX package's, at fp32 on the
SMOKE configs with the JAX package's weights: every scenario of
tests/test_cluster.py (router, staged-then-flip snapshot, the fault
ladder, kill-one-engine for qwen2, mamba2 and the recurrentgemma
hybrid (its sessions carry pages and state), STRICT republish, straggler
steal, remesh, parked restores, routing affinity, the shared-oplog
refusal, the text front) runs on both packages with the same inputs; each
asserts the reference test's expectations and that the two records are
equal — output streams token for token, migration and fault counters,
router counters, each engine's controller counters and each STRICT
volume's oplog entries.  Every restored page equals the bytes its snapshot
captured, bit for bit on each package and within ``KV_TOL`` across them.
Port-only: a snapshot restored after its source reused the freed pages
still restores the captured bytes, every engine of a cluster shares one
copy of the weights, and token ids outside the vocabulary are refused at
submit.  Engine step times come from a deterministic clock
(``step_clock``) on both packages."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from torch_engine_pair import (KV_TOL, StepClock, bits, client, cluster,
                               counters, engine, entries, leaf_bits, libs,
                               oplog, page_values)

import repro.serve.cluster as jax_cluster
import repro_torch.serve.cluster as port_cluster
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params
from repro_torch.serve import EngineCluster
from repro_torch.train.optimizer import leaves


@pytest.fixture(scope="module")
def pair():
    return libs()


@pytest.fixture(scope="module")
def mamba_pair():
    return libs("mamba2-1.3b")


@pytest.fixture(scope="module")
def hybrid_pair():
    return libs("recurrentgemma-9b")


@pytest.fixture(autouse=True)
def step_clock(monkeypatch):
    """Every cluster here, on both packages, times its engines' steps with
    ``StepClock`` (1 ms a step; an injected slow factor multiplies it).
    With wall-clock times the straggler check (8x the median of the alive
    engines' last step times, 3 polls in a row) sees, e.g., a port's
    mamba2 engine whose prefill steps (a per-token recurrence over the
    chunk) take several times its peer's decode steps, while the idle
    spare re-beats the fastest time and a killed engine its last one
    until it is declared dead: host noise can hold that ratio past 8 for
    three ticks, and a flag or a second steal on one package only breaks
    the records' equality (test_kill_one_engine_token_identity[mamba2-1.3b]
    failed so under pytest with six xdist workers).  No scenario here
    depends on real step times."""
    for mod in (jax_cluster, port_cluster):
        monkeypatch.setattr(mod, "time", StepClock())


def both(pair, scenario):
    """Run ``scenario(lib)`` on both packages; the records must agree."""
    jrec, trec = (scenario(lib) for lib in pair)
    assert trec == jrec
    return trec


def family_prompts(vocab: int, n: int, *, families: int = 2,
                   prefix_len: int = 16, seed: int = 7):
    """tests/test_cluster.py's ``family_prompts``."""
    rng = np.random.default_rng(seed)
    heads = [list(rng.integers(1, vocab, prefix_len)) for _ in range(families)]
    return [heads[i % families] + list(rng.integers(1, vocab, 6 + i % 5))
            for i in range(n)]


def record(c) -> dict:
    """What the two clusters must agree on besides their output streams."""
    return {"ticks": c.ticks, "migrations": c.migrations,
            "sessions_migrated": c.sessions_migrated,
            "sessions_requeued": c.sessions_requeued,
            "restore_retries": c.restore_retries,
            "steals": c.policy.steals, "remeshes": c.policy.remeshes,
            "deaths": c.monitor.deaths,
            "straggler_flags": c.monitor.straggler_flags,
            "router": c.router.stats(),
            "counters": [counters(e) for e in c.engines]}


def outputs_by_prompt(reqs):
    return {tuple(int(t) for t in r.prompt): list(r.output) for r in reqs}


class Restores:
    """Wraps the cluster module's ``restore_session`` for one package: each
    restore that carried device state is checked at once against the
    bytes its snapshot captured (nothing has stepped the target since),
    and its pages' values and state are kept for the cross-package
    comparison."""

    def __init__(self, lib, monkeypatch):
        mod = sys.modules[lib.Cluster.__module__]
        self.real = mod.restore_session
        self.pages, self.states = [], []
        monkeypatch.setattr(mod, "restore_session", self)

    def __call__(self, eng, snap):
        req = self.real(eng, snap)
        if snap.seq is not None:
            pages = eng.controller.snapshot_seq(req.seq_id).pages
            assert len(pages) == len(snap.page_bytes)
            for page, views in zip(pages, snap.page_bytes):
                got = leaf_bits(eng, page)
                assert len(got) == len(views)
                for g, v in zip(got, views):
                    assert np.array_equal(g, bits(v)), "restored page torn"
                if views:                      # mamba2 has no KV pools
                    self.pages.append(page_values(eng, page))
            if snap.state is not None:
                now = eng._gather_slot_state(req.slot)
                for g, v in zip(now, snap.state):
                    assert np.array_equal(bits(g), bits(v)), "state torn"
                self.states.append(np.concatenate(
                    [np.asarray(x, np.float32).ravel() for x in
                     (v.numpy() if isinstance(v, torch.Tensor) else v
                      for v in snap.state)]))
        return req


def assert_restores_close(jr: Restores, tr: Restores) -> None:
    assert len(jr.pages) == len(tr.pages)
    assert len(jr.states) == len(tr.states)
    for a, b in zip(jr.pages + jr.states, tr.pages + tr.states):
        assert np.abs(a - b).max() <= KV_TOL * max(1.0, np.abs(a).max())


def both_restoring(pair, monkeypatch, scenario):
    """``both`` with every restore checked (``Restores``)."""
    jr, tr = (Restores(lib, monkeypatch) for lib in pair)
    rec = both(pair, scenario)
    assert_restores_close(jr, tr)
    return rec, tr


# ------------------------------------------------------------------ router


def test_prefix_hash_affinity_and_determinism(pair):
    def scenario(lib):
        h = lib.prefix_hash
        a = [3, 1, 4, 1, 5, 9, 2, 6] * 4
        assert h(a, 16) == h(list(a), 16)
        assert h(a[:16] + [7, 7], 16) == h(a[:16] + [8], 16)
        assert h([1] + a[1:], 16) != h(a, 16)
        return [h(a, 16), h(a, 4), h([1] + a[1:], 16)]

    both(pair, scenario)


def test_router_spillover_hysteresis(pair):
    def scenario(lib):
        r = lib.PrefixRouter(2, prefix_tokens=4, spill_margin=3)
        p = [1, 2, 3, 4]
        home = lib.prefix_hash(p, 4) % 2
        other = 1 - home
        shard, spilled = r.route(p, {home: 2, other: 0})
        assert shard == home and not spilled
        shard, spilled = r.route(p, {home: 3, other: 0})
        assert shard == other and spilled
        assert r.stats() == {"n_shards": 2, "routed_home": 1, "spills": 1}
        return home, r.stats()

    both(pair, scenario)


def test_router_survives_remesh_shrink(pair):
    def scenario(lib):
        r = lib.PrefixRouter(4, prefix_tokens=4, spill_margin=8)
        shard, _ = r.route([9, 9, 9, 9], {0: 1, 2: 0})
        assert shard in (0, 2)
        r.n_shards = 1
        assert r.route([5], {0: 0})[0] == 0
        return shard, r.stats()

    both(pair, scenario)


def test_router_validation(pair):
    for lib in pair:
        with pytest.raises(ValueError):
            lib.PrefixRouter(0)
        with pytest.raises(ValueError):
            lib.PrefixRouter(2, spill_margin=0)


# ------------------------------- controller snapshot / restore round trip


@pytest.mark.parametrize("mode", ["POSIX", "SYNC", "STRICT"])
def test_snapshot_restore_staged_then_flip(pair, mode):
    """The migration protocol at the controller: STAGE on the target
    (nothing published, no oplog entry), then FLIP (publish + STRICT
    oplog in the target's own volume)."""
    def scenario(lib):
        m = lib.Mode[mode]
        geom = lib.KVGeometry(num_pages=32, page_tokens=8, max_seqs=4,
                              pages_per_seq=8)
        src_log, tgt_log = oplog(lib), oplog(lib)
        src = lib.PagedKVCache(geom, oplog=src_log)
        tgt = lib.PagedKVCache(geom, oplog=tgt_log)
        sid = src.create_seq(m)
        src.append_tokens(sid, 20)
        snap = src.snapshot_seq(sid)
        assert snap.length == 20 and snap.committed_pages == 2
        assert len(snap.pages) == 3 and snap.mode is m
        keep = tgt.create_seq(lib.Mode.STRICT)
        tgt.append_tokens(keep, 8)
        replay_before = lib.replay(tgt_log.scan())
        assert sorted(replay_before[keep]) == [0]
        in_use_before = tgt.pages_in_use
        rsid, pages = tgt.restore_seq_staged(snap)
        assert len(pages) == 3 and tgt.seq_length(rsid) == 20
        assert tgt.committed_extents(rsid) == {}
        assert lib.replay(tgt_log.scan()) == replay_before
        assert tgt.restore_seq(rsid) == 2
        assert tgt.committed_extents(rsid) == {0: pages[0], 1: pages[1]}
        replay_after = lib.replay(tgt_log.scan())
        if m.logs_ops:
            assert replay_after[rsid] == {0: pages[0], 1: pages[1]}
        else:
            assert replay_after == replay_before
        assert tgt.restore_seq(rsid) == 0
        tgt.advance(rsid, 4)
        assert tgt.seq_length(rsid) == 24
        assert sorted(tgt.committed_extents(rsid)) == [0, 1, 2]
        assert tgt.pages_in_use == in_use_before + 3
        return (list(pages), entries(src_log), entries(tgt_log),
                {k: dict(v) for k, v in replay_after.items()})

    both(pair, scenario)


def test_staged_restore_capacity_failures_leak_nothing(pair):
    def scenario(lib):
        src = lib.PagedKVCache(lib.KVGeometry(num_pages=8, page_tokens=8,
                                              max_seqs=2, pages_per_seq=8))
        sid = src.create_seq()
        src.append_tokens(sid, 24)
        snap = src.snapshot_seq(sid)
        tgt = lib.PagedKVCache(lib.KVGeometry(num_pages=3, page_tokens=8,
                                              max_seqs=2, pages_per_seq=8))
        before = tgt.pages_in_use
        with pytest.raises(lib.KVPoolFullError):
            tgt.restore_seq_staged(snap)
        assert tgt.pages_in_use == before, "failed stage leaked pages"
        return before, tgt.num_free_pages

    both(pair, scenario)


# ------------------------------------------- fault-ladder steal-on-death


def dead_monitor(lib, workers, dead, *, timeout=5.0):
    mon = lib.HeartbeatMonitor(workers, timeout_s=timeout, patience=1,
                               straggler_factor=100.0)
    for w in workers:
        mon.beat(w, 0, 0.01, now=0.0)
    for w in workers:
        if w not in dead:
            mon.beat(w, 1, 0.01, now=timeout + 1.0)
    return mon


def plan_record(plan):
    return None if plan is None else (type(plan).__name__,
                                      dataclass_tuple(plan))


def dataclass_tuple(plan):
    return tuple(sorted((k, repr(v)) for k, v in
                        dataclasses.asdict(plan).items()))


def test_policy_steals_dead_shard_to_spare(pair):
    def scenario(lib):
        mon = dead_monitor(lib, [0, 1, 2], dead={1})
        pol = lib.FaultPolicy(mon, assignment={0: 0, 1: 1}, spares=[2],
                              chips_per_worker=1, model_axis=1,
                              steal_on_death=True)
        plan = pol.poll(now=6.1)
        assert isinstance(plan, lib.StealPlan)
        assert plan.straggler == 1 and plan.spare == 2 and plan.shard == 1
        assert pol.assignment == {0: 0, 2: 1} and pol.spares == []
        assert pol.steals == 1 and pol.remeshes == 0
        assert pol.poll(now=6.2) is None
        return plan_record(plan), pol.assignment

    both(pair, scenario)


def test_policy_death_without_spare_remeshes(pair):
    def scenario(lib):
        mon = dead_monitor(lib, [0, 1], dead={1})
        pol = lib.FaultPolicy(mon, assignment={0: 0, 1: 1}, spares=[],
                              chips_per_worker=1, model_axis=1,
                              steal_on_death=True)
        plan = pol.poll(now=6.1)
        assert isinstance(plan, lib.RemeshPlan)
        assert plan.survivors == (0,) and pol.assignment == {0: 0}
        assert pol.remeshes == 1 and pol.steals == 0
        return plan_record(plan)

    both(pair, scenario)


def test_policy_default_death_skips_steal_rung(pair):
    def scenario(lib):
        mon = dead_monitor(lib, [0, 1, 2], dead={1})
        pol = lib.FaultPolicy(mon, assignment={0: 0, 1: 1}, spares=[2],
                              chips_per_worker=1, model_axis=1)
        plan = pol.poll(now=6.1)
        assert isinstance(plan, lib.RemeshPlan) and pol.steals == 0
        return plan_record(plan)

    both(pair, scenario)


def test_policy_two_deaths_one_spare_escalates(pair):
    def scenario(lib):
        mon = dead_monitor(lib, [0, 1, 2, 3], dead={1, 2})
        pol = lib.FaultPolicy(mon, assignment={0: 0, 1: 1, 2: 2}, spares=[3],
                              chips_per_worker=1, model_axis=1,
                              steal_on_death=True)
        first = pol.poll(now=6.1)
        assert isinstance(first, lib.StealPlan) and first.spare == 3
        second = pol.poll(now=6.2)
        assert isinstance(second, lib.RemeshPlan)
        assert set(second.data_shard_of) == {0, 3}
        return plan_record(first), plan_record(second)

    both(pair, scenario)


def test_plan_steal_requires_a_free_spare(pair):
    """tests/test_elastic.py's scenario on both fault planes."""
    def scenario(lib):
        assignment = {0: 0, 1: 1}
        assert lib.plan_steal(assignment, 1, []) is None
        assert lib.plan_steal(assignment, 1, [0]) is None
        assert lib.plan_steal(assignment, 7, [5]) is None
        plan = lib.plan_steal(assignment, 1, [5, 6])
        assert plan.spare == 5 and plan.data_shard_of == {0: 0, 5: 1}
        assert assignment == {0: 0, 1: 1}, "input assignment is not mutated"
        return plan_record(plan)

    both(pair, scenario)


def test_steal_falls_back_to_remesh_on_confirmed_death(pair):
    """tests/test_elastic.py's escalation ladder on both fault planes."""
    def scenario(lib):
        monitor = lib.HeartbeatMonitor([0, 1, 2, 3, 9], patience=1,
                                       timeout_s=5.0)
        policy = lib.FaultPolicy(monitor,
                                 assignment={0: 0, 1: 1, 2: 2, 3: 3},
                                 spares=[9], chips_per_worker=16,
                                 model_axis=16)
        for w in (0, 1, 3, 9):
            monitor.beat(w, 0, 1.0, now=0.0)
        monitor.beat(2, 0, 8.0, now=0.0)
        steal = policy.poll(now=0.0)
        assert isinstance(steal, lib.StealPlan)
        for w in (0, 1, 3):
            monitor.beat(w, 2, 1.0, now=2.0)
        plan = policy.poll(now=6.0)
        assert isinstance(plan, lib.RemeshPlan)
        assert plan.mesh_shape == (3, 16)
        assert set(plan.data_shard_of) == {0, 1, 3}
        assert 2 not in plan.survivors and 9 not in plan.survivors
        assert policy.assignment == dict(plan.data_shard_of)
        return (plan_record(steal), plan_record(plan), monitor.deaths,
                monitor.straggler_flags)

    both(pair, scenario)


# -------------------------------------------------- cluster integration


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_kill_one_engine_token_identity(arch, request, monkeypatch):
    """Kill a busy engine mid-decode: its live sessions resume on the
    spare from their snapshots (KV pages for qwen2, recurrent state leaves
    for mamba2, both for the recurrentgemma hybrid) and every output
    equals the unkilled run's."""
    pair = request.getfixturevalue({"qwen2-1.5b": "pair",
                                    "mamba2-1.3b": "mamba_pair",
                                    "recurrentgemma-9b": "hybrid_pair"}[arch])

    def scenario(lib):
        prompts = family_prompts(lib.api.cfg.vocab, 6)

        def run(kill: bool):
            c = cluster(lib, n_engines=2, n_spares=1, max_batch=2,
                        max_seq=64, page_tokens=8, heartbeat_timeout=3.0)
            reqs = [c.submit(p, max_new_tokens=12) for p in prompts]
            if kill:
                for _ in range(3):
                    c.step()
                victim = max(range(2), key=lambda e: (
                    len(c.engines[e].active), len(c.engines[e].waiting)))
                assert c.engines[victim].active, "kill landed on idle"
                c.kill(victim)
            done = c.run_until_done(max_steps=600)
            assert len(done) == len(reqs) and all(r.done for r in reqs)
            assert len({r.rid for r in done}) == len(done), "duplicated rids"
            return c, done

        ref_c, ref = run(kill=False)
        c, done = run(kill=True)
        assert c.sessions_migrated >= 1, "no session resumed from snapshot"
        assert c.policy.steals == 1 and c.monitor.deaths == 1
        assert outputs_by_prompt(done) == outputs_by_prompt(ref)
        return outputs_by_prompt(done), record(ref_c), record(c)

    _, restores = both_restoring(pair, monkeypatch, scenario)
    if arch != "qwen2-1.5b":
        assert restores.states, "no recurrent state was migrated"
    if arch != "mamba2-1.3b":
        assert restores.pages, "no page was migrated"


def strict_logs(lib):
    logs = []

    def make_oplog():
        log = oplog(lib)
        logs.append(log)
        return log
    return logs, make_oplog


def test_strict_migration_republishes_in_target_volume(pair, monkeypatch):
    """A STRICT session that migrates off a dead engine re-logs its
    committed extent in the TARGET's oplog; the dead source's frozen log
    still replays the pre-kill extents."""
    def scenario(lib):
        logs, make_oplog = strict_logs(lib)
        c = cluster(lib, n_engines=2, n_spares=1, max_batch=2, max_seq=64,
                    page_tokens=8, heartbeat_timeout=3.0,
                    mode=lib.Mode.STRICT, make_oplog=make_oplog,
                    prefix_cache=False)
        prompts = family_prompts(lib.api.cfg.vocab, 4, prefix_len=16,
                                 seed=3)
        reqs = [c.submit(p, max_new_tokens=16) for p in prompts]
        for _ in range(4):
            c.step()
        victim = max(range(2), key=lambda e: len(c.engines[e].active))
        assert c.engines[victim].active
        c.kill(victim)
        done = c.run_until_done(max_steps=600)
        assert len(done) == len(reqs) and c.sessions_migrated >= 1
        spare_eid = c._engine_of_shard[victim]
        assert spare_eid == 2
        assert lib.replay(logs[victim].scan()), "frozen log lost extents"
        spare_entries = list(logs[spare_eid].scan())
        assert spare_entries, "migration published nothing in the target"
        assert lib.replay(spare_entries) == {}, "finished seqs not unlinked"
        return (outputs_by_prompt(done), record(c),
                [entries(log) for log in logs])

    both_restoring(pair, monkeypatch, scenario)


def test_straggler_steal_detaches_live_source(pair, monkeypatch):
    """A LIVE straggler is stolen from: its sessions detach (free_seq
    tombstones each in the straggler's own volume) and finish on the
    spare."""
    def scenario(lib):
        logs, make_oplog = strict_logs(lib)
        c = cluster(lib, n_engines=2, n_spares=1, max_batch=2, max_seq=64,
                    page_tokens=8, heartbeat_timeout=50.0, patience=2,
                    mode=lib.Mode.STRICT, make_oplog=make_oplog,
                    prefix_cache=False)
        rng = np.random.default_rng(0)
        reqs = []
        for eid in range(2):
            for _ in range(2):
                req = c.engines[eid].submit(
                    list(rng.integers(1, lib.api.cfg.vocab, 12)),
                    max_new_tokens=32, mode=lib.Mode.STRICT)
                req.engine_id = eid
                reqs.append(req)
        for _ in range(2):
            c.step()
        victim = 1
        c.slow(victim, 1000.0)
        for _ in range(100):
            c.step()
            if c.policy.steals:
                break
        assert c.policy.steals == 1 and c.monitor.deaths == 0
        assert not c.engines[victim].active, "straggler kept sessions"
        assert c.sessions_migrated >= 1
        done = c.run_until_done(max_steps=600)
        assert len(done) == len(reqs) and all(r.done for r in reqs)
        assert lib.replay(logs[victim].scan()) == {}
        return (outputs_by_prompt(done), record(c),
                [entries(log) for log in logs])

    both_restoring(pair, monkeypatch, scenario)


def test_remesh_rescues_onto_survivor_without_spares(pair, monkeypatch):
    def scenario(lib):
        c = cluster(lib, n_engines=2, n_spares=0, max_batch=4, max_seq=64,
                    page_tokens=8, heartbeat_timeout=3.0)
        prompts = family_prompts(lib.api.cfg.vocab, 6, seed=11)
        reqs = [c.submit(p, max_new_tokens=10) for p in prompts]
        for _ in range(3):
            c.step()
        victim = max(range(2), key=lambda e: (len(c.engines[e].active),
                                              len(c.engines[e].waiting)))
        assert c.engines[victim].active or c.engines[victim].waiting
        c.kill(victim)
        done = c.run_until_done(max_steps=600)
        assert len(done) == len(reqs) and all(r.done for r in reqs)
        assert c.policy.remeshes == 1
        assert c.router.n_shards == 1
        post = c.submit(list(range(1, 9)), max_new_tokens=2)
        assert post.engine_id == 1 - victim
        c.run_until_done(max_steps=100)
        assert post.done
        return outputs_by_prompt(done), post.output, record(c)

    both_restoring(pair, monkeypatch, scenario)


def test_parked_restore_drains_and_cancel_while_parked(pair, monkeypatch):
    """A snapshot whose target has no free slot PARKS, stays visible in
    ``waiting``, retries each tick and drains once the survivor frees a
    slot; cancelling a parked session resolves it without a restore."""
    def scenario(lib):
        c = cluster(lib, n_engines=2, n_spares=0, max_batch=2, max_seq=96,
                    page_tokens=8, heartbeat_timeout=2.0)
        rng = np.random.default_rng(1)

        def direct(eid, n_tokens):
            req = c.engines[eid].submit(
                list(rng.integers(1, lib.api.cfg.vocab, 10)),
                max_new_tokens=n_tokens)
            req.engine_id = eid
            return req

        survivors = [direct(0, 64), direct(0, 64)]
        victims = [direct(1, 24), direct(1, 24)]
        for _ in range(3):
            c.step()
        assert len(c.engines[1].active) == 2
        c.kill(1)
        for _ in range(60):
            c.step()
            if c.migrations:
                break
        assert c.migrations == 1
        assert c.stats()["pending_restores"] == 2
        assert {r.rid for r in c.waiting} == {r.rid for r in victims}
        c.cancel(victims[0])
        assert victims[0].done and victims[0].cancelled
        assert victims[0] in c.finished
        done = c.run_until_done(max_steps=800)
        assert len(done) == 4 and all(r.done for r in survivors + victims)
        assert c.sessions_migrated == 1
        assert c.restore_retries > 0
        assert c.stats()["pending_restores"] == 0
        assert len(victims[1].output) == 24
        return outputs_by_prompt(done), record(c)

    both_restoring(pair, monkeypatch, scenario)


def test_cluster_routing_affinity_end_to_end(pair):
    def scenario(lib):
        cl = client(lib, n_engines=2, max_batch=8, max_seq=64,
                    page_tokens=16)
        sess = cl.open_session()
        prompts = family_prompts(lib.api.cfg.vocab, 8, families=2,
                                 prefix_len=16, seed=5)
        reqs = [sess.submit(p, max_new_tokens=2) for p in prompts]
        for fam in (0, 1):
            eids = {r.engine_id for r in reqs[fam::2]}
            assert len(eids) == 1, f"family {fam} scattered across {eids}"
        assert cl.engine.router.spills == 0
        cl.run_until_done()
        assert all(r.done for r in reqs)
        st = cl.stats()
        assert st["cluster"]["router"]["routed_home"] == len(prompts)
        return ([r.engine_id for r in reqs], outputs_by_prompt(reqs),
                record(cl.engine), st["cluster"]["assignment"],
                st["sessions"])

    both(pair, scenario)


def test_client_rejects_shared_oplog_in_cluster_mode(pair):
    for lib in pair:
        with pytest.raises(ValueError, match="make_oplog"):
            client(lib, n_engines=2, oplog=oplog(lib))


def test_session_text_prompt_equals_token_path(pair):
    def scenario(lib):
        assert lib.api.cfg.vocab >= lib.ByteTokenizer.vocab_needed
        text = "split the file system"
        cl = client(lib, max_batch=2, max_seq=64, page_tokens=8)
        out_text = list(cl.open_session().generate(text, max_new_tokens=6))
        ids = cl.tokenizer.encode(text)
        solo = client(lib, max_batch=2, max_seq=64, page_tokens=8)
        out_ids = list(solo.open_session().generate(ids, max_new_tokens=6))
        assert out_text == out_ids and len(out_text) == 6
        return out_text

    both(pair, scenario)


# ------------------------------------------------------------ port only


def test_snapshot_restored_after_its_source_reused_the_pages(pair):
    """A snapshot parks (the target has no free slot) while its LIVE
    source detaches the session and reuses the freed pages for new
    requests; the restore then lands the bytes captured at snapshot time,
    bit for bit, and the session goes on to the tokens of an undisturbed
    run.  A snapshot of views would restore the new occupants' K/V."""
    _, lib = pair
    snapshot_session, restore_session = (lib.snapshot_session,
                                         lib.restore_session)
    rng = np.random.default_rng(4)
    vocab = lib.api.cfg.vocab
    prompt = list(rng.integers(1, vocab, 20))
    ref = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                 prefix_cache=False)
    want = ref.submit(prompt, max_new_tokens=12)
    ref.run_until_done()

    src = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                 prefix_cache=False)
    dst = engine(lib, max_batch=1, max_seq=64, page_tokens=8,
                 prefix_cache=False)
    req = src.submit(prompt, max_new_tokens=12)
    while len(req.output) < 4:
        src.step()
    snap = snapshot_session(src, req)
    captured = [[bits(v).copy() for v in views] for views in snap.page_bytes]
    blocker = dst.submit(list(rng.integers(1, vocab, 10)), max_new_tokens=6)
    dst.step()
    with pytest.raises(lib.MigrationError):
        restore_session(dst, snap)                # parked: no free slot
    src.detach(req)
    # the free list is FIFO: enough new pages to come round to the freed
    others = [src.submit(list(rng.integers(1, vocab, 40)), max_new_tokens=3)
              for _ in range(6)]
    src.run_until_done()
    assert all(r.done for r in others)
    reused = [p for p, c in zip(snap.seq.pages, captured)
              if any(not np.array_equal(a, b)
                     for a, b in zip(leaf_bits(src, p), c))]
    assert reused, "the source never rewrote the freed pages"
    for views, c in zip(snap.page_bytes, captured):
        assert all(np.array_equal(bits(v), b) for v, b in zip(views, c))
    dst.run_until_done()
    assert blocker.done
    restore_session(dst, snap)
    pages = dst.controller.snapshot_seq(req.seq_id).pages
    for page, c in zip(pages, captured):
        assert all(np.array_equal(a, b)
                   for a, b in zip(leaf_bits(dst, page), c))
    dst.run_until_done()
    assert req.done and req.output == want.output


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_engines_share_one_copy_of_the_weights(dtype):
    """The cluster moves and casts the params once: every engine's leaves
    share engine 0's storage, for float32 params served in float32 and in
    bfloat16 (where each engine's own cast would copy)."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=dtype)
    api = build_model(cfg)
    params = init_params(api.init_specs(),
                         torch.Generator().manual_seed(0), device="cpu")
    c = EngineCluster(api, params, n_engines=2, n_spares=1, max_batch=2,
                      max_seq=64, page_tokens=8, device="cpu")

    first = leaves(c.engines[0].params)
    assert any(x.dtype == dtype for x in first)
    for eng in c.engines[1:]:
        assert [x.data_ptr() for x in leaves(eng.params)] == \
            [x.data_ptr() for x in first]


def test_submit_refuses_token_ids_outside_the_vocabulary(pair):
    """An id outside [0, vocab) raises ValueError at submit, before
    admission, on an engine and on a cluster; the other requests finish
    and the pool is whole again (the reference's gather clamps the id)."""
    _, lib = pair
    vocab = lib.api.cfg.vocab
    eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8)
    c = cluster(lib, n_engines=2, max_batch=2, max_seq=64, page_tokens=8)
    for target in (eng, c):
        good = target.submit([5, 6, 7, 8, 9], max_new_tokens=3)
        for bad in ([1, 2, vocab], [-1, 3], [vocab + 7000]):
            with pytest.raises(ValueError, match="outside"):
                target.submit(bad, max_new_tokens=3)
        target.run_until_done()
        assert good.done and len(good.output) == 3
        assert not target.waiting and not target.active
    for e in [eng] + c.engines:
        if e.prefix_cache is not None:
            e.prefix_cache.clear()
        ctrl = e.controller
        assert ctrl.pages_in_use == 0
        assert ctrl.num_free_pages == ctrl.geom.num_pages - 1


def test_cluster_obs_counters_and_trace(pair):
    """``EngineCluster(obs=...)`` wires the cluster, router and fault
    counters into the registry (``attach_cluster``) and traces routes, the
    kill and a migrate span enclosing its snapshots; with
    ``per_engine_obs`` each engine keeps its own bundle.  Both packages
    read the same counters after the same kill."""
    def scenario(lib):
        obs = lib.Obs(trace=True)
        c = cluster(lib, n_engines=2, n_spares=1, max_batch=2, max_seq=64,
                    page_tokens=8, heartbeat_timeout=3.0, obs=obs,
                    per_engine_obs=True)
        reqs = [c.submit(p, max_new_tokens=8)
                for p in family_prompts(lib.api.cfg.vocab, 6)]
        for _ in range(3):
            c.step()
        c.kill(max(range(2), key=lambda e: len(c.engines[e].active)))
        c.run_until_done(max_steps=600)
        assert all(r.done for r in reqs)
        snap = obs.registry.snapshot()
        names = {e["name"] for e in obs.tracer.to_chrome()["traceEvents"]}
        assert {"route", "kill", "migrate", "snapshot"} <= names
        assert not lib.validate(obs.tracer.to_chrome())
        assert all("obs" in d for d in c.stats()["engines"])
        return {k: v for k, v in snap.items()
                if k.startswith(("cluster.", "router.", "fault."))}

    rec = both(pair, scenario)
    assert rec["cluster.sessions_migrated"] >= 1
    assert rec["fault.steals"] == 1 and rec["cluster.engines_live"] == 2
