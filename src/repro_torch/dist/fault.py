"""Fault tolerance control plane: heartbeats, stragglers, work stealing,
remesh planning (a copy of ``repro.dist.fault``; standard library only).

The monitor is deliberately passive (pure bookkeeping, explicit ``now=``
injection for tests); *policy* lives in ``FaultPolicy``, which the
training loop polls once per step.  Mitigation is an escalation ladder:

  * **straggler** -> ``plan_steal``: its data shard moves to an idle spare
    worker.  The mesh shape is untouched — no restore, no recompile, no
    lockstep barrier; the spare steps into the straggler's shard index and
    the (deterministic) TokenPipeline replays that shard from the current
    step.  This is the SplitFS move: fix the slow participant off the
    critical path with a metadata-only reassignment (a relink of the
    shard->worker mapping) instead of a stop-the-world rebuild.
  * **confirmed death** (heartbeat timeout) -> ``plan_remesh``: shrink the
    data axis onto the survivors, checkpoint restore through the SplitFS
    staging+relink path, pipeline reshard, deterministic resumption
    (tests/test_elastic.py).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class _WorkerState:
    last_beat: float
    step: int = -1
    step_time: float = 0.0
    slow_polls: int = 0


class HeartbeatMonitor:
    """Tracks per-worker liveness and step rate.

    * a worker is **dead** when its last heartbeat is older than
      ``timeout_s``;
    * a worker is a **straggler** when its step time exceeds
      ``straggler_factor`` x the alive-set median for ``patience``
      consecutive polls (one poll per training step); it stays flagged
      while it remains slow.
    """

    def __init__(self, workers: Sequence[int], *, timeout_s: float = 60.0,
                 patience: int = 3, straggler_factor: float = 2.0) -> None:
        now = time.monotonic()
        self.timeout_s = timeout_s
        self.patience = patience
        self.straggler_factor = straggler_factor
        self._state: Dict[int, _WorkerState] = {
            w: _WorkerState(last_beat=now) for w in workers}
        self._alive = set(workers)
        self._flagged: set = set()
        # plain-int stats, read lazily by the obs registry (DESIGN.md §10)
        self.beats = 0
        self.heartbeats_missed = 0           # timeout detections
        self.deaths = 0
        self.straggler_flags = 0             # workers newly flagged slow

    # ------------------------------------------------------------ heartbeats

    def beat(self, worker: int, step: int, step_time: float,
             *, now: Optional[float] = None) -> None:
        if worker not in self._state:
            raise KeyError(f"unknown worker {worker}")
        st = self._state[worker]
        st.last_beat = time.monotonic() if now is None else now
        st.step = step
        st.step_time = step_time
        self.beats += 1

    def dead_workers(self, *, now: Optional[float] = None) -> List[int]:
        """Alive workers whose heartbeat has timed out."""
        t = time.monotonic() if now is None else now
        return sorted(w for w in self._alive
                      if t - self._state[w].last_beat > self.timeout_s)

    def mark_dead(self, worker: int) -> None:
        if worker in self._alive:
            self.heartbeats_missed += 1
            self.deaths += 1
        self._alive.discard(worker)
        self._flagged.discard(worker)

    def alive_workers(self) -> List[int]:
        return sorted(self._alive)

    # ------------------------------------------------------------ stragglers

    def stragglers(self) -> List[int]:
        """Poll once per step: workers ``patience`` consecutive slow polls
        behind the alive-set median step time."""
        rates = [self._state[w].step_time for w in self._alive
                 if self._state[w].step >= 0]
        if len(rates) < 2:
            return []
        median = statistics.median(rates)
        for w in sorted(self._alive):
            st = self._state[w]
            if st.step >= 0 and st.step_time > self.straggler_factor * median:
                st.slow_polls += 1
                if st.slow_polls >= self.patience:
                    if w not in self._flagged:
                        self.straggler_flags += 1
                    self._flagged.add(w)
            else:
                st.slow_polls = 0
                self._flagged.discard(w)
        return sorted(self._flagged)


# ---------------------------------------------------------------- stealing


@dataclasses.dataclass(frozen=True)
class StealPlan:
    """Metadata-only mitigation: ``spare`` takes over ``straggler``'s data
    shard; mesh shape and every other worker's assignment are unchanged."""
    straggler: int
    spare: int
    shard: int                               # the data-shard index that moved
    data_shard_of: Dict[int, int]            # post-steal assignment


def plan_steal(assignment: Dict[int, int], straggler: int,
               spares: Sequence[int]) -> Optional[StealPlan]:
    """Move ``straggler``'s data shard to the first idle spare.

    Unlike ``plan_remesh`` this never changes the mesh shape — the spare
    simply steps into the straggler's shard index, so survivors keep their
    compiled step and their pipeline position; only the spare has to replay
    the stolen shard (exact, because TokenPipeline batches are pure
    functions of (seed, shard, step)).  Returns ``None`` when the
    straggler owns no shard or no spare is free — the caller keeps the
    straggler flagged and escalates to ``plan_remesh`` only on confirmed
    death.
    """
    if straggler not in assignment:
        return None
    free = sorted(s for s in spares
                  if s not in assignment and s != straggler)
    if not free:
        return None
    spare = free[0]
    shard = assignment[straggler]
    new_assignment = {w: s for w, s in assignment.items() if w != straggler}
    new_assignment[spare] = shard
    return StealPlan(straggler=straggler, spare=spare, shard=shard,
                     data_shard_of=new_assignment)


class FaultPolicy:
    """The escalation ladder, polled once per training step.

    Owns the mutable control-plane state the passive ``HeartbeatMonitor``
    deliberately does not: the shard->worker ``assignment``, the idle
    ``spares`` pool, and the mesh geometry needed for the remesh fallback.
    ``poll`` returns at most one plan per call (control-plane actions are
    serialized, like oplog entries):

      * ``StealPlan``  — a flagged straggler had a shard and a spare was
        free; the assignment has already been updated.
      * ``RemeshPlan`` — a shard-owning worker is confirmed dead (or a
        straggler could not be mitigated and then died); survivors must
        restore + reshard.
      * ``None``       — nothing to do.
    """

    def __init__(self, monitor: HeartbeatMonitor, *,
                 assignment: Dict[int, int], spares: Sequence[int] = (),
                 chips_per_worker: int, model_axis: int,
                 pod_axis: int = 1, steal_on_death: bool = False) -> None:
        self.monitor = monitor
        self.assignment = dict(assignment)
        self.spares = sorted(spares)
        self.chips_per_worker = chips_per_worker
        self.model_axis = model_axis
        self.pod_axis = pod_axis
        # steal_on_death: a dead shard owner is first STOLEN from (its
        # shard moves to a free spare, one plan per poll) and the remesh
        # fallback fires only when no spare is left.  The serving plane
        # wants this rung — a spare engine restores the dead engine's
        # sessions from their snapshots without disturbing the survivors —
        # while training keeps the default (death => restore + reshard).
        self.steal_on_death = steal_on_death
        self._dead_pending: List[int] = []    # dead shard owners not yet
                                              # mitigated (steal_on_death)
        self._mitigated: set = set()          # stragglers already stolen from
        self.steals = 0                       # mitigation counters (obs)
        self.remeshes = 0

    def poll(self, *, now: Optional[float] = None,
             restore_step: Optional[int] = None):
        # confirmed deaths first: they invalidate any pending steal
        dead = self.monitor.dead_workers(now=now)
        for w in dead:
            self.monitor.mark_dead(w)
            self.spares = [s for s in self.spares if s != w]
            self._mitigated.discard(w)
            if w in self.assignment:
                self._dead_pending.append(w)
        if self._dead_pending:
            if self.steal_on_death:
                w = self._dead_pending[0]
                steal = plan_steal(self.assignment, w, self.spares)
                if steal is not None:
                    self._dead_pending.pop(0)
                    self.assignment = dict(steal.data_shard_of)
                    self.spares = [s for s in self.spares
                                   if s != steal.spare]
                    self.steals += 1
                    return steal
            # no steal rung (or no spare free): drop every pending dead
            # shard onto the survivors in one remesh
            for w in self._dead_pending:
                self.assignment.pop(w, None)
            self._dead_pending.clear()
            plan = plan_remesh(sorted(self.assignment),
                               chips_per_worker=self.chips_per_worker,
                               model_axis=self.model_axis,
                               pod_axis=self.pod_axis,
                               restore_step=restore_step)
            self.assignment = dict(plan.data_shard_of)
            self.remeshes += 1
            return plan
        if dead:
            return None                       # only shard-less workers died
        stragglers = self.monitor.stragglers()
        # a stolen-from straggler that recovered (no longer flagged) is idle
        # and healthy: return it to the spare pool so it can absorb the
        # next steal instead of shrinking mitigation capacity forever
        for w in sorted(self._mitigated):
            if w not in stragglers:
                self._mitigated.discard(w)
                if w not in self.assignment and w not in self.spares:
                    self.spares = sorted(self.spares + [w])
        for w in stragglers:
            if w in self._mitigated:
                continue                      # already shard-less; tolerate
            steal = plan_steal(self.assignment, w, self.spares)
            if steal is None:
                continue                      # no spare: wait for death
            self.assignment = dict(steal.data_shard_of)
            self.spares = [s for s in self.spares if s != steal.spare]
            self._mitigated.add(w)
            self.steals += 1
            return steal
        return None


# ---------------------------------------------------------------- remesh


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    """The control-plane output the survivors execute in lockstep."""
    mesh_shape: Tuple[int, ...]              # (data, model) or (pod, data, model)
    survivors: Tuple[int, ...]
    data_shard_of: Dict[int, int]            # worker id -> data-shard index
    restore_step: Optional[int] = None


def plan_remesh(alive: Sequence[int], *, chips_per_worker: int,
                model_axis: int, pod_axis: int = 1,
                restore_step: Optional[int] = None) -> RemeshPlan:
    """Shrink the data axis onto the surviving workers.

    The model (and pod) axes are load-bearing — parameters are laid out
    over them — so elasticity happens on the data axis only: total chips
    must factor as ``pod_axis * data * model_axis`` with ``data >= 1``,
    else the geometry is infeasible and we raise instead of guessing.
    """
    survivors = tuple(sorted(set(alive)))
    total = len(survivors) * chips_per_worker
    denom = model_axis * pod_axis
    if model_axis < 1 or pod_axis < 1 or chips_per_worker < 1:
        raise ValueError("axes and chips_per_worker must be positive")
    if total < denom or total % denom != 0:
        raise ValueError(
            f"{len(survivors)} workers x {chips_per_worker} chips = {total} "
            f"chips cannot form a (pod={pod_axis}, data, model={model_axis}) "
            "mesh")
    data = total // denom
    mesh_shape = (pod_axis, data, model_axis) if pod_axis > 1 \
        else (data, model_axis)
    return RemeshPlan(
        mesh_shape=mesh_shape, survivors=survivors,
        data_shard_of={w: i for i, w in enumerate(survivors)},
        restore_step=restore_step)
