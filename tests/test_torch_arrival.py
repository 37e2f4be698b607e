"""The port's open-loop driver (``repro_torch.serve.arrival``) against the
JAX package's, at fp32 on qwen2-1.5b SMOKE with the JAX package's weights:
tests/test_serve_api.py's schedule and open-loop scenarios run on both
clients (schedules equal bit for bit; each record's outputs equal), and
one open-loop run over a two-engine cluster with a spare and a scheduled
kill gives equal completions and migration counts on both packages.  That
run reads a clock that advances by the open-loop driver's naps and a time
per cluster tick, so the kill lands on the same tick in both."""

from types import SimpleNamespace
import sys

import numpy as np
import pytest

from torch_engine_pair import client, libs, oplog

PROMPT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]


@pytest.fixture(scope="module")
def pair():
    return libs()


def both(pair, scenario):
    jrec, trec = (scenario(lib) for lib in pair)
    assert trec == jrec
    return trec


def test_poisson_and_trace_schedules(pair):
    def scenario(lib):
        a = lib.poisson_schedule(16, rate_rps=100.0, seed=3)
        b = lib.poisson_schedule(16, rate_rps=100.0, seed=3)
        assert a == b and len(a) == 16
        assert all(x < y for x, y in zip(a, a[1:]))
        t = lib.trace_schedule([0.5, 0.25, 0.25])
        assert t == pytest.approx([0.5, 0.75, 1.0])
        return ([float(x).hex() for x in a], [float(x).hex() for x in t])

    both(pair, scenario)


def test_open_loop_driver_measures_ttft_tpot(pair):
    def scenario(lib):
        cl = client(lib, max_batch=2, max_seq=64, page_tokens=8)
        warm = cl.open_session()
        list(warm.generate([1, 2, 3], max_new_tokens=2))
        rng = np.random.default_rng(0)
        shared = list(rng.integers(1, lib.api.cfg.vocab, 8))
        workload = [lib.ArrivalSpec(
            t, shared + list(rng.integers(1, lib.api.cfg.vocab, 4)),
            max_new_tokens=4) for t in [0.0, 0.01, 0.02, 0.03]]
        result = lib.OpenLoopDriver(cl).run(workload)
        assert len(result.records) == 4
        for rec in result.records:
            assert rec.t_done is not None and rec.n_output == 4
            assert rec.t_submit >= rec.spec.t_arrival
            assert rec.ttft is not None and rec.ttft <= rec.latency
            assert rec.tpot is not None and rec.tpot >= 0
        pct = result.percentiles()
        assert set(pct) == {"ttft", "tpot", "latency"}
        assert pct["ttft"]["p50"] <= pct["ttft"]["p99"]
        assert result.total_tokens == 16 and result.throughput_tok_s > 0
        return ([r.n_output for r in result.records],
                [r.output for r in cl.engine.finished], result.total_tokens)

    both(pair, scenario)


def test_open_loop_time_scale_keeps_metrics_consistent(pair):
    def scenario(lib):
        cl = client(lib, max_batch=2, max_seq=64, page_tokens=8)
        warm = cl.open_session()
        list(warm.generate([1, 2, 3], max_new_tokens=2))
        workload = [lib.ArrivalSpec(0.5 * i, PROMPT[:6], max_new_tokens=3)
                    for i in range(3)]
        result = lib.OpenLoopDriver(cl, time_scale=0.02).run(workload)
        assert result.makespan < 5.0
        for rec in result.records:
            assert rec.t_submit >= rec.t_arrival
            assert rec.ttft is not None and rec.ttft >= 0
            assert rec.latency is not None and rec.latency >= rec.ttft
        return [r.t_arrival for r in result.records], \
            [r.output for r in cl.engine.finished]

    both(pair, scenario)


def test_open_loop_mixed_mode_sessions(pair):
    def scenario(lib):
        log = oplog(lib)
        cl = client(lib, max_batch=2, max_seq=64, page_tokens=8, oplog=log)
        posix = cl.open_session()
        strict = cl.open_session(mode=lib.Mode.STRICT)
        shared = list(range(1, 17))
        workload = [lib.ArrivalSpec(0.01 * i, shared + [100 + i],
                                    max_new_tokens=3,
                                    session=strict if i % 2 else posix)
                    for i in range(4)]
        result = lib.OpenLoopDriver(cl, session=posix).run(workload)
        assert all(r.t_done is not None for r in result.records)
        reqs = cl.engine.finished
        assert {r.mode for r in reqs} == {lib.Mode.POSIX, lib.Mode.STRICT}
        strict_sids = {r.seq_id for r in reqs if r.mode is lib.Mode.STRICT}
        commits = [e for e in log.scan() if e.op == lib.OP_KV_COMMIT]
        assert commits and {e.inode for e in commits} <= strict_sids
        return (sorted((r.prompt[-1], r.mode.name, r.output) for r in reqs),
                len(commits))

    both(pair, scenario)


class TickClock:
    """Stands in for the arrival module's ``time``: the clock moves by
    each nap and by ``dt`` seconds per tick of ``engine``."""

    def __init__(self, dt: float):
        self.dt, self.slept, self.engine = dt, 0.0, None

    def perf_counter(self) -> float:
        ticks = self.engine.steps if self.engine is not None else 0
        return self.slept + ticks * self.dt

    def sleep(self, s: float) -> None:
        self.slept += s


def test_open_loop_cluster_kill_migrates_on_both(pair, monkeypatch):
    """Poisson traffic into two engines and a spare; a fault kills the
    busiest engine mid-run.  Every request completes, with the same
    outputs and the same migration counts on both packages."""
    def scenario(lib):
        clock = TickClock(dt=0.01)
        monkeypatch.setattr(sys.modules[lib.OpenLoopDriver.__module__],
                            "time", SimpleNamespace(
                                perf_counter=clock.perf_counter,
                                sleep=clock.sleep))
        cl = client(lib, n_engines=2, n_spares=1, max_batch=2, max_seq=64,
                    page_tokens=8, heartbeat_timeout=3.0)
        c = cl.engine
        clock.engine = c
        rng = np.random.default_rng(3)
        vocab = lib.api.cfg.vocab
        sched = lib.poisson_schedule(10, rate_rps=40.0, seed=3)
        workload = [lib.ArrivalSpec(t, list(rng.integers(1, vocab, 12)),
                                    max_new_tokens=8) for t in sched]
        killed = []

        def kill_busiest():
            victim = max(range(2), key=lambda e: (
                len(c.engines[e].active), len(c.engines[e].waiting)))
            killed.append((victim, c.ticks))
            c.kill(victim)

        result = lib.OpenLoopDriver(cl).run(workload,
                                            faults=[(0.05, kill_busiest)])
        assert all(r.t_done is not None and r.n_output == 8
                   for r in result.records)
        assert len({r.rid for r in c.finished}) == len(workload)
        st = cl.stats()["cluster"]
        assert st["fault"] == {"steals": 1, "remeshes": 0, "deaths": 1}
        assert st["sessions_migrated"] >= 1
        return (killed, [r.n_output for r in result.records],
                sorted((tuple(r.prompt), r.output) for r in c.finished),
                {k: st[k] for k in ("ticks", "migrations",
                                    "sessions_migrated", "sessions_requeued",
                                    "restore_retries", "fault", "router")})

    both(pair, scenario)
