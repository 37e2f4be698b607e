"""Open-loop request-arrival front-end (the many-user traffic scenario);
a copy of ``repro.serve.arrival`` (numpy over ``.api``).

Requests arrive on a wall-clock schedule (Poisson or trace interarrivals)
INDEPENDENT of completions — the open-loop discipline, which is what a
service actually faces: a slow engine doesn't slow the users down, it
grows the queue.  The driver pumps one ``ServeClient`` (continuous
batching does the rest) and records per-request

  * TTFT    — time from ARRIVAL to the first generated token (includes
              queueing delay: the open-loop convention),
  * TPOT    — mean time per output token after the first,
  * latency — arrival to completion,

summarized as p50/p90/p99 (``ArrivalResult.percentiles``).

    sched  = poisson_schedule(n=64, rate_rps=20.0, seed=0)
    result = OpenLoopDriver(client).run(
        [ArrivalSpec(t, prompt, 16) for t, prompt in zip(sched, prompts)])

Timing is real wall-clock; ``time_scale`` compresses a trace for smoke
runs (interarrivals are multiplied by it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .api import ServeClient, Session


def poisson_schedule(n: int, rate_rps: float, seed: int = 0) -> List[float]:
    """Arrival times (seconds from start) of a Poisson process: i.i.d.
    exponential interarrivals at ``rate_rps`` requests/second."""
    rng = np.random.default_rng(seed)
    return list(np.cumsum(rng.exponential(1.0 / rate_rps, size=n)))


def trace_schedule(interarrivals: Sequence[float]) -> List[float]:
    """Arrival times from recorded interarrival gaps (trace replay)."""
    return list(np.cumsum(np.asarray(interarrivals, dtype=np.float64)))


@dataclass
class ArrivalSpec:
    t_arrival: float                     # seconds from driver start
    prompt: List[int]
    max_new_tokens: int = 16
    session: Optional[Session] = None    # submit via this session (mixed-
                                         # mode traffic); default: driver's


@dataclass
class RequestRecord:
    spec: ArrivalSpec
    t_arrival: float = 0.0               # EFFECTIVE (time_scale-adjusted)
                                         # arrival; all metrics use this
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    n_output: int = 0
    truncated: bool = False
    stalled: bool = False

    @property
    def ttft(self) -> Optional[float]:
        return None if self.t_first is None \
            else self.t_first - self.t_arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.t_done is None or self.t_first is None or self.n_output < 2:
            return None
        return (self.t_done - self.t_first) / (self.n_output - 1)

    @property
    def latency(self) -> Optional[float]:
        return None if self.t_done is None \
            else self.t_done - self.t_arrival


@dataclass
class ArrivalResult:
    records: List[RequestRecord]
    makespan: float                      # first arrival scheduled at t=0
    total_tokens: int
    engine_steps: int
    stats: Dict[str, object] = field(default_factory=dict)

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / max(self.makespan, 1e-9)

    def percentiles(self, qs: Sequence[float] = (50, 90, 99),
                    ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name in ("ttft", "tpot", "latency"):
            vals = [getattr(r, name) for r in self.records]
            vals = [v for v in vals if v is not None]
            out[name] = {f"p{int(q)}": float(np.percentile(vals, q))
                         for q in qs} if vals else {}
        return out


class OpenLoopDriver:
    """Pumps a ``ServeClient`` against a wall-clock arrival schedule.

    Each spec is submitted through ``session`` (a fresh default-mode
    session when omitted) the moment its arrival time passes — never
    earlier, and never gated on prior completions (open loop).  Between
    arrivals the driver steps the engine if there is work, else sleeps to
    the next arrival.
    """

    def __init__(self, client: ServeClient, *,
                 session: Optional[Session] = None,
                 time_scale: float = 1.0) -> None:
        self.client = client
        self.session = session or client.open_session()
        self.time_scale = time_scale

    def run(self, workload: Sequence[ArrivalSpec],
            max_steps: int = 1000000,
            faults: Sequence[Tuple[float, Callable[[], None]]] = (),
            ) -> ArrivalResult:
        """``faults`` is a schedule of ``(t, action)`` pairs on the same
        (time_scale-adjusted) clock as the arrivals: each ``action`` fires
        once, the first time the driver's clock passes ``t`` — e.g.
        ``(0.05, lambda: cluster.kill(0))`` for a kill-one-engine run."""
        specs = sorted(workload, key=lambda s: s.t_arrival)
        records = [RequestRecord(s, t_arrival=s.t_arrival * self.time_scale)
                   for s in specs]
        fq = sorted(faults, key=lambda f: f[0])
        fi = 0
        live: Dict[int, tuple] = {}              # rid -> (request, record)
        eng = self.client.engine
        obs = eng.obs
        if obs is not None:
            busy0 = sum(sum(obs.ledger.phase_totals(p)[c]
                            for c in ("scheduler", "device", "persistence"))
                        for p in ("prefill", "decode"))
        sleep_s = 0.0
        steps0 = eng.steps
        i = 0
        t0 = time.perf_counter()
        while i < len(specs) or eng.active or eng.waiting:
            now = time.perf_counter() - t0
            while fi < len(fq) and fq[fi][0] * self.time_scale <= now:
                fq[fi][1]()
                fi += 1
            while i < len(specs) and records[i].t_arrival <= now:
                rec = records[i]
                sess = specs[i].session or self.session
                req = sess.submit(specs[i].prompt, specs[i].max_new_tokens)
                rec.t_submit = now
                live[req.rid] = (req, rec)
                i += 1
            if eng.active or eng.waiting:
                eng.step()
                now = time.perf_counter() - t0
                self._observe(now, live)
                if eng.steps - steps0 >= max_steps:
                    # timeout: flag OUR outstanding requests and the
                    # not-yet-submitted specs, so every record
                    # distinguishes timeout from a clean run — but never
                    # other sessions' requests sharing the engine
                    for req, rec in live.values():
                        req.stalled = True
                        rec.stalled = True
                    for rec in records[i:]:
                        rec.stalled = True
                    break
            elif i < len(specs):
                gap = records[i].t_arrival - now
                if gap > 0:
                    nap = min(gap, 0.05)
                    time.sleep(nap)
                    sleep_s += nap
        makespan = time.perf_counter() - t0
        if obs is not None:
            # client/front-end attribution: the wall time this driver spent
            # OUTSIDE the engine and not asleep waiting for arrivals —
            # submission, record-keeping, scheduling overhead (the SplitFS
            # user-library bucket; the engine buckets the rest per step)
            busy = sum(sum(obs.ledger.phase_totals(p)[c]
                           for c in ("scheduler", "device", "persistence"))
                       for p in ("prefill", "decode"))
            obs.ledger.add_client(
                int(makespan * 1e9) - (busy - busy0) - int(sleep_s * 1e9))
            obs.profiler.flush()
        total = sum(r.n_output for r in records)
        return ArrivalResult(records=records, makespan=makespan,
                             total_tokens=total, engine_steps=eng.steps - steps0,
                             stats=self.client.stats())

    def _observe(self, now: float, live: Dict[int, tuple]) -> None:
        done = []
        for rid, (req, rec) in live.items():
            if req.output and rec.t_first is None:
                rec.t_first = now
            rec.n_output = len(req.output)
            if req.done:
                rec.t_done = now
                rec.truncated = req.truncated
                done.append(rid)
        for rid in done:
            live.pop(rid, None)
