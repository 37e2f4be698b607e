"""Sharded multi-engine serving: routing plane over N data planes
(DESIGN.md §12); port of ``repro.serve.cluster``.

``EngineCluster`` stands up ``n_engines`` shard owners plus ``n_spares``
idle engines behind one submit/step surface that quacks like a single
``ServingEngine`` (the ``ServeClient`` and ``OpenLoopDriver`` drive it
unchanged).  The split of responsibilities mirrors the repo's core
design: the cluster is a THIN metadata plane — routing (prefix-affinity
hash, ``router.PrefixRouter``), liveness (``dist.fault`` heartbeat
ladder), and migration orchestration — while every token touches only a
per-engine data plane.  All engines share ONE copy of the weights on
``device``: the cluster moves and casts the params once, so each engine's
own move and cast returns the same tensors.

Fault story, reusing the training fault plane verbatim:

  * each engine is a "worker"; the cluster beats for an engine after its
    step (an idle engine re-beats its last busy step time, so the
    straggler median reflects real rates, not zero-cost idling);
  * ``FaultPolicy(steal_on_death=True)`` escalates: a straggler or a
    DEAD engine with a free spare yields a ``StealPlan`` — its shard
    moves to the spare and every live session MIGRATES there via the
    failure-atomic snapshot path (serve.snapshot); no spare left yields
    a ``RemeshPlan`` — the shard ring shrinks onto the survivors and the
    dead engine's sessions are rescued onto them round-robin.

A ``kill`` is fail-stop: the engine stops stepping and beating, but its
pools and controller remain readable — the PM analogue where a process
dies but its persistent state survives for recovery.  Sessions whose
snapshot cannot restore yet (target slots/pages full) PARK and drain as
capacity frees; the driver sees them in ``waiting`` so open-loop runs
keep pumping until they land.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..convert import cast_params
from ..core.kvcache import KVPoolFullError
from ..core.modes import Mode
from ..dist.fault import FaultPolicy, HeartbeatMonitor, RemeshPlan, StealPlan
from ..kernels.common import resolve_device
from ..models.registry import ModelAPI
from ..obs import Obs
from .engine import (Request, SamplingParams, ServingEngine, SpecConfig,
                     _to_device)
from .router import PrefixRouter
from .snapshot import (MigrationError, SessionSnapshot, restore_session,
                       snapshot_session)

# rid-space stride per engine: OpenLoopDriver keys its live map by rid,
# so per-engine counters must not collide across engines
_RID_STRIDE = 10 ** 9


class EngineCluster:
    """N sharded ``ServingEngine``s + spares behind one engine-shaped API."""

    def __init__(self, api: ModelAPI, params, *, n_engines: int = 2,
                 n_spares: int = 0, router: Optional[PrefixRouter] = None,
                 spill_margin: Optional[int] = None,
                 heartbeat_timeout: float = 6.0,
                 straggler_factor: float = 8.0, patience: int = 3,
                 max_batch: int = 8, max_seq: int = 512,
                 page_tokens: int = 16, chunk_tokens: Optional[int] = None,
                 greedy: bool = True, seed: int = 0,
                 mode: Mode = Mode.POSIX,
                 make_oplog: Optional[Callable[[], object]] = None,
                 prefix_cache: bool = True,
                 spec: Optional[SpecConfig] = None,
                 host_cache_pages: int = 0,
                 pool_pages: Optional[int] = None,
                 obs: Optional[Obs] = None,
                 per_engine_obs: bool = False,
                 device="cuda") -> None:
        if n_engines < 1 or n_spares < 0:
            raise ValueError("need n_engines >= 1, n_spares >= 0")
        self.api = api
        self.default_mode = mode
        self.max_batch = max_batch
        total = n_engines + n_spares
        # one copy of the weights for the fleet
        device = resolve_device(device)
        params = cast_params(_to_device(params, device), api.cfg)
        self.engines: List[ServingEngine] = []
        for eid in range(total):
            eng = ServingEngine(
                api, params, max_batch=max_batch, max_seq=max_seq,
                page_tokens=page_tokens, chunk_tokens=chunk_tokens,
                greedy=greedy, seed=seed + eid, mode=mode,
                oplog=make_oplog() if make_oplog is not None else None,
                prefix_cache=prefix_cache, spec=spec,
                host_cache_pages=host_cache_pages, pool_pages=pool_pages,
                obs=Obs() if per_engine_obs else None,
                device=device)
            eng._rid = itertools.count(eid * _RID_STRIDE)
            self.engines.append(eng)
        self.router = router if router is not None else PrefixRouter(
            n_engines, prefix_tokens=page_tokens,
            spill_margin=max_batch if spill_margin is None else spill_margin)
        self.monitor = HeartbeatMonitor(
            range(total), timeout_s=heartbeat_timeout, patience=patience,
            straggler_factor=straggler_factor)
        self.policy = FaultPolicy(
            self.monitor, assignment={eid: eid for eid in range(n_engines)},
            spares=list(range(n_engines, total)), chips_per_worker=1,
            model_axis=1, steal_on_death=True)
        self._engine_of_shard: Dict[int, int] = {
            s: e for e, s in self.policy.assignment.items()}
        # fail-stop + mitigation state
        self._killed: Set[int] = set()
        self._drained: Set[int] = set()       # killed engines already rescued
        self._slow: Dict[int, float] = {}      # eid -> injected slow factor
        self._last_step_time: Dict[int, float] = {}
        # snapshots whose restore hit capacity; retried each tick
        self._pending: List[Tuple[int, SessionSnapshot]] = []
        self.finished_parked: List[Request] = []   # cancelled while parked
        # the cluster clock: one tick per step() call.  Heartbeats and the
        # policy run on this VIRTUAL clock — deterministic under test and
        # unaffected by wall-clock jitter between driver naps
        self.ticks = 0
        self.migrations = 0                    # migration EVENTS (per engine)
        self.sessions_migrated = 0             # restored from snapshot
        self.sessions_requeued = 0             # replayed from prompt
        self.restore_retries = 0               # parked-restore re-parks
        self.obs = obs
        if obs is not None:
            from ..obs.bundle import attach_cluster
            attach_cluster(obs, self)

    # ------------------------------------------------------------------ API

    def submit(self, prompt: List[int], max_new_tokens: int = 16, *,
               mode: Optional[Mode] = None,
               sampling: Optional[SamplingParams] = None,
               spec: Optional[SpecConfig] = None) -> Request:
        shard, spilled = self.router.route(prompt, self._shard_loads())
        eid = self._engine_of_shard[shard]
        eng = self.engines[eid]
        req = eng.submit(prompt, max_new_tokens,
                         mode=self.default_mode if mode is None else mode,
                         sampling=sampling, spec=spec)
        req.engine_id = eid
        if self.obs is not None and self.obs.tracer is not None:
            self.obs.tracer.instant(
                "route", "cluster",
                args={"rid": req.rid, "shard": shard, "engine": eid,
                      "spilled": spilled})
        return req

    def _shard_loads(self) -> Dict[int, int]:
        return {s: len(self.engines[e].active) + len(self.engines[e].waiting)
                for s, e in self._engine_of_shard.items()}

    def step(self) -> None:
        """One cluster tick: step every live engine that has work, beat
        for it, drain parked restores, then poll the fault ladder (at
        most one plan per tick — control-plane actions are serialized)."""
        self.ticks += 1
        now = float(self.ticks)
        for eid, eng in enumerate(self.engines):
            if eid in self._killed:
                continue                      # fail-stop: no step, no beat
            if eng.active or eng.waiting:
                t0 = time.perf_counter()
                eng.step()
                dt = (time.perf_counter() - t0) * self._slow.get(eid, 1.0)
                self._last_step_time[eid] = dt
            # an idle engine re-beats its LAST busy step time — or, before
            # it ever stepped, the fleet's fastest known rate: beating 0.0
            # would drag the straggler median toward zero and flag every
            # busy engine, while beating nothing would look like death
            fallback = min(self._last_step_time.values()) \
                if self._last_step_time else 0.0
            self.monitor.beat(eid, eng.steps,
                              self._last_step_time.get(eid, fallback),
                              now=now)
        self._drain_pending()
        if len(self._killed) < len(self.engines):
            plan = self.policy.poll(now=now)
            if plan is not None:
                self._apply(plan)

    # ------------------------------------------------------------------ fault handling

    def _apply(self, plan) -> None:
        if isinstance(plan, StealPlan):
            # the spare took the shard; its sessions follow by snapshot
            self._engine_of_shard[plan.shard] = plan.spare
            self._migrate(plan.straggler, [plan.spare])
        elif isinstance(plan, RemeshPlan):
            # shard ring shrank onto the survivors; rescue every killed,
            # not-yet-drained engine's sessions onto them round-robin
            self._engine_of_shard = {
                s: e for e, s in plan.data_shard_of.items()}
            self.router.n_shards = max(len(self._engine_of_shard), 1)
            targets = sorted(plan.data_shard_of)
            for eid in sorted(self._killed - self._drained):
                self._migrate(eid, targets)

    def _migrate(self, src_eid: int, targets: List[int]) -> None:
        """Move every session off ``src_eid`` onto ``targets``
        (round-robin).  A live source (straggler steal) is detached —
        free_seq tombstones each sequence in ITS volume; a dead source is
        frozen, so only the cluster's own bookkeeping is cleared and its
        persistent state is merely read."""
        src = self.engines[src_eid]
        alive = src_eid not in self._killed
        tracer = self.obs.tracer if self.obs is not None else None
        t0 = tracer.now_ns() if tracer is not None else 0
        snaps: List[SessionSnapshot] = []
        for slot, req in sorted(src.active.items()):
            if tracer is not None:
                s0 = tracer.now_ns()
            snap = snapshot_session(src, req)
            if tracer is not None:
                tracer.complete(
                    "snapshot", "cluster", s0, tracer.now_ns(),
                    args={"rid": req.rid, "src": src_eid,
                          "pages": len(snap.page_bytes),
                          "from_prompt": snap.seq is None})
            snaps.append(snap)
        for snap in snaps:
            req = snap.request
            if alive:
                src.detach(req)
            else:
                # dead volume is frozen — don't free_seq into it; just
                # drop the cluster's handle so the slot is not double-read
                src.active.pop(req.slot, None)
                req.slot = None
                req.seq_id = None
        rr = itertools.cycle(targets)
        for snap in snaps:
            self._restore_or_park(next(rr), snap)
        # queued sessions never touched the device: plain re-queue
        queued = list(src.waiting)
        for req in queued:
            if alive:
                src.waiting.remove(req)
            req.slot = None
            req.seq_id = None
            req.prompt_pos = 0
            req.prefix_tokens = 0
            req.promoting = False
            dst = next(rr)
            req.engine_id = dst
            self.engines[dst].waiting.append(req)
            self.sessions_requeued += 1
        if not alive:
            src.waiting.clear()
        self._drained.add(src_eid)
        self.migrations += 1
        if tracer is not None:
            # the migrate span ENCLOSES its snapshot spans on tid 0 — the
            # validator's nesting invariant documents the protocol shape
            tracer.complete(
                "migrate", "cluster", t0, tracer.now_ns(),
                args={"src": src_eid, "targets": list(targets),
                      "sessions": len(snaps) + len(queued),
                      "alive_source": alive})

    def _restore_or_park(self, dst_eid: int, snap: SessionSnapshot) -> None:
        try:
            restore_session(self.engines[dst_eid], snap)
        except (KVPoolFullError, MigrationError):
            self._pending.append((dst_eid, snap))
            return
        snap.request.engine_id = dst_eid
        if snap.seq is None:
            self.sessions_requeued += 1
        else:
            self.sessions_migrated += 1

    def _drain_pending(self) -> None:
        """Retry parked restores; a parked snapshot whose target died
        retargets to the least-loaded live engine."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for dst_eid, snap in pending:
            if dst_eid in self._killed:
                live = [e for e in range(len(self.engines))
                        if e not in self._killed]
                if not live:
                    self._pending.append((dst_eid, snap))
                    continue
                dst_eid = min(live, key=lambda e: (
                    len(self.engines[e].active) +
                    len(self.engines[e].waiting), e))
            before = len(self._pending)
            self._restore_or_park(dst_eid, snap)
            if len(self._pending) > before:
                self.restore_retries += 1

    # ------------------------------------------------------------------ fault injection

    def kill(self, eid: int) -> None:
        """Fail-stop ``eid``: it stops stepping and beating (the monitor
        times it out after ``heartbeat_timeout`` ticks and the ladder
        steals/remeshes).  Its pools and controller stay readable — the
        PM-survives-process-death analogue the snapshot rescue relies
        on."""
        self._killed.add(eid)
        if self.obs is not None and self.obs.tracer is not None:
            self.obs.tracer.instant("kill", "cluster", args={"engine": eid})

    def slow(self, eid: int, factor: Optional[float]) -> None:
        """Inject (or clear, with None) a straggle: the engine's reported
        step time is multiplied by ``factor``; the data plane itself is
        untouched."""
        if factor is None:
            self._slow.pop(eid, None)
        else:
            self._slow[eid] = float(factor)

    # ---------------------------------------------------- engine-shaped surface

    @property
    def steps(self) -> int:
        return self.ticks

    @property
    def active(self) -> Dict[Tuple[int, int], Request]:
        return {(eid, slot): req
                for eid, eng in enumerate(self.engines)
                for slot, req in eng.active.items()}

    @property
    def waiting(self) -> List[Request]:
        out: List[Request] = []
        for eng in self.engines:
            out.extend(eng.waiting)
        out.extend(snap.request for _, snap in self._pending)
        return out

    @property
    def finished(self) -> List[Request]:
        out: List[Request] = []
        for eng in self.engines:
            out.extend(eng.finished)
        out.extend(self.finished_parked)
        return out

    def run_until_done(self, max_steps: int = 10000) -> List[Request]:
        for req in list(self.active.values()) + self.waiting:
            req.stalled = False
        steps0 = self.ticks
        while (self.waiting or self.active) and \
                self.ticks - steps0 < max_steps:
            self.step()
        for req in list(self.active.values()) + self.waiting:
            req.stalled = True
        return self.finished

    def cancel(self, req: Request) -> None:
        if req.done:
            return
        for i, (dst, snap) in enumerate(self._pending):
            if snap.request is req:
                self._pending.pop(i)
                req.cancelled = True
                req.done = True
                self.finished_parked.append(req)
                return
        for eng in self.engines:
            if req in eng.waiting or (
                    req.slot is not None and
                    eng.active.get(req.slot) is req):
                eng.cancel(req)
                return

    def stats(self) -> dict:
        per_engine = []
        for eid, eng in enumerate(self.engines):
            d = {"steps": eng.steps, "active": len(eng.active),
                 "waiting": len(eng.waiting), "finished": len(eng.finished),
                 "killed": eid in self._killed}
            if eng.obs is not None:
                d["obs"] = eng.obs.stats()
            per_engine.append(d)
        return {
            "ticks": self.ticks,
            "engines": per_engine,
            "router": self.router.stats(),
            "assignment": dict(self.policy.assignment),
            "spares": list(self.policy.spares),
            "migrations": self.migrations,
            "sessions_migrated": self.sessions_migrated,
            "sessions_requeued": self.sessions_requeued,
            "restore_retries": self.restore_retries,
            "pending_restores": len(self._pending),
            "fault": {"steals": self.policy.steals,
                      "remeshes": self.policy.remeshes,
                      "deaths": self.monitor.deaths},
        }
