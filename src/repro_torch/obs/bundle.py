"""The ``Obs`` bundle: registry + overhead ledger + windowed profiler +
optional span tracer, handed to the serving stack as ONE optional object.

``obs=None`` (the default everywhere) is the instrumentation-off mode:
the hot path pays only ``if obs is not None`` branches — no clock reads,
no allocations, no trace entries (the <2% bound of DESIGN.md §10 holds
by construction; the CI smoke cell measures even the *enabled* cost
against it).

The overhead ledger is the SplitFS software-overhead decomposition
applied to serving: each engine step's wall time is split into

    scheduler   host control-plane time (admission, staging metadata,
                backpressure, sampling, device-mirror sync)
    device      the ``serve_step`` call to its end on the device (the
                engine synchronizes a CUDA device when obs is on)
    persistence oplog publish time (64 B entry + fence, STRICT only)

keyed by phase (``prefill`` while any batched request is still
ingesting its prompt, else ``decode`` — the same predicate that picks
the step width C).  ``client`` is front-end time OUTSIDE the engine
(session API, arrival bookkeeping), reported by the harness that owns
the wall clock.  Where the paper splits a syscall into user-library /
kernel / device ns, we split a token's serving cost into client /
scheduler / device / persistence."""

from __future__ import annotations

from typing import Dict, Optional

from .profiler import WindowedProfiler
from .registry import Registry
from .trace import SpanTracer

COMPONENTS = ("scheduler", "device", "persistence")


class OverheadLedger:
    def __init__(self) -> None:
        self._phases: Dict[str, Dict[str, int]] = {}
        self.client_ns = 0

    def add(self, phase: str, *, sched_ns: int = 0, device_ns: int = 0,
            persist_ns: int = 0, steps: int = 0) -> None:
        d = self._phases.get(phase)
        if d is None:
            d = self._phases[phase] = {"scheduler": 0, "device": 0,
                                       "persistence": 0, "steps": 0}
        d["scheduler"] += sched_ns
        d["device"] += device_ns
        d["persistence"] += persist_ns
        d["steps"] += steps

    def add_client(self, ns: int) -> None:
        self.client_ns += max(int(ns), 0)

    def reset(self) -> None:
        """Drop accumulated time (after warmup, so one-time kernel builds
        never pollute the device bucket)."""
        self._phases.clear()
        self.client_ns = 0

    def phase_totals(self, phase: str) -> Dict[str, int]:
        return dict(self._phases.get(phase,
                                     {c: 0 for c in COMPONENTS + ("steps",)}))

    def breakdown(self) -> dict:
        """Per-phase seconds + shares, plus the overall client/scheduler/
        device/persistence split (the BENCH_serve software_overhead
        shape).  ``software_frac`` is everything that is NOT device
        compute — the paper's 'software overhead' ratio."""
        out: Dict[str, object] = {"phases": {}}
        tot = {c: 0 for c in COMPONENTS}
        for phase, d in sorted(self._phases.items()):
            psum = sum(d[c] for c in COMPONENTS)
            out["phases"][phase] = {
                "steps": d["steps"],
                **{f"{c}_s": d[c] / 1e9 for c in COMPONENTS},
                "shares": {c: d[c] / psum if psum else 0.0
                           for c in COMPONENTS},
            }
            for c in COMPONENTS:
                tot[c] += d[c]
        total = sum(tot.values()) + self.client_ns
        out["client_s"] = self.client_ns / 1e9
        out["total_s"] = total / 1e9
        shares = {c: tot[c] / total if total else 0.0 for c in COMPONENTS}
        shares["client"] = self.client_ns / total if total else 0.0
        out["shares"] = shares
        out["software_frac"] = 1.0 - shares["device"]
        return out


class Obs:
    """One observability context, shared by everything serving one
    engine (client, engine, controller, caches, arrival driver)."""

    def __init__(self, *, trace: bool = False, window_s: float = 1.0,
                 windows: int = 64, max_trace_events: int = 200_000) -> None:
        self.registry = Registry()
        self.ledger = OverheadLedger()
        self.profiler = WindowedProfiler(self.registry, window_s=window_s,
                                         capacity=windows)
        self.tracer: Optional[SpanTracer] = (
            SpanTracer(max_events=max_trace_events) if trace else None)

    def stats(self) -> dict:
        """The ``Session.stats()`` / ``ServeClient.stats()`` payload:
        a counter snapshot, the windowed-profiler ring, and the overhead
        breakdown."""
        self.profiler.flush()
        out = {"counters": self.registry.snapshot(),
               "windows": self.profiler.as_dicts(),
               "overhead": self.ledger.breakdown()}
        if self.tracer is not None:
            out["trace_events"] = len(self.tracer)
        return out

    def dump_trace(self, path: str) -> None:
        if self.tracer is None:
            raise ValueError("tracing disabled: construct Obs(trace=True)")
        self.tracer.dump(path)


# ---------------------------------------------------------------- wiring
#
# Lazy registration over the plain int stats the components already keep:
# attaching costs the hot path nothing (readers run at snapshot time).


def attach_serving(obs: Obs, engine) -> None:
    """Wire an engine (+ its controller, prefix cache, oplog) into the
    registry.  Called by ``ServingEngine.__init__`` when obs is given."""
    reg = obs.registry
    ctrl = engine.controller

    reg.register("engine.steps", lambda: engine.steps, monotonic=True)
    reg.register("engine.tokens", lambda: engine.tokens_processed,
                 monotonic=True)
    reg.register("engine.truncations", lambda: engine.truncations,
                 monotonic=True)
    reg.register("engine.cancels", lambda: engine.cancels, monotonic=True)
    reg.register("engine.backpressure_stalls",
                 lambda: engine.backpressure_stalls, monotonic=True)
    reg.register("engine.slots_active", lambda: len(engine.active))
    reg.register("engine.waiting", lambda: len(engine.waiting))
    reg.register("engine.slot_occupancy",
                 lambda: len(engine.active) / engine.max_batch)

    # speculative decoding: accept rate = accepted / drafted; draft_ns is
    # the host drafting time the ledger charges to the CLIENT bucket
    reg.register("spec.steps", lambda: engine.spec_steps, monotonic=True)
    reg.register("spec.drafted_tokens", lambda: engine.spec_drafted_tokens,
                 monotonic=True)
    reg.register("spec.accepted_tokens", lambda: engine.spec_accepted_tokens,
                 monotonic=True)
    reg.register("spec.rejected_tokens", lambda: engine.spec_rejected_tokens,
                 monotonic=True)
    reg.register("spec.rollbacks", lambda: engine.spec_rollbacks,
                 monotonic=True)
    reg.register("spec.draft_ns", lambda: engine.draft_ns, monotonic=True)
    reg.register("spec.accept_rate",
                 lambda: (engine.spec_accepted_tokens
                          / engine.spec_drafted_tokens
                          if engine.spec_drafted_tokens else 0.0))

    reg.register("kv.pages_allocated", lambda: ctrl.pages_allocated,
                 monotonic=True)
    reg.register("kv.pages_freed", lambda: ctrl.pages_freed, monotonic=True)
    reg.register("kv.pages_relinked", lambda: ctrl.pages_relinked,
                 monotonic=True)
    reg.register("kv.pages_copied", lambda: ctrl.pages_copied,
                 monotonic=True)
    reg.register("kv.pages_adopted", lambda: ctrl.pages_adopted,
                 monotonic=True)
    reg.register("kv.pins_taken", lambda: ctrl.pins_taken, monotonic=True)
    reg.register("kv.pad_fallbacks", lambda: ctrl.pad_fallbacks,
                 monotonic=True)
    reg.register("kv.alloc_failures", lambda: ctrl.alloc_failures,
                 monotonic=True)
    reg.register("kv.pages_in_use", lambda: ctrl.pages_in_use)
    reg.register("kv.utilization", ctrl.utilization)
    reg.register("kv.persist_ns", lambda: ctrl.persist_ns, monotonic=True)

    pc = engine.prefix_cache
    if pc is not None:
        reg.register("trie.hits", lambda: pc.hits, monotonic=True)
        reg.register("trie.misses", lambda: pc.misses, monotonic=True)
        reg.register("trie.tokens_saved", lambda: pc.tokens_saved,
                     monotonic=True)
        reg.register("trie.match_pages_sum", lambda: pc.match_pages_sum,
                     monotonic=True)
        reg.register("trie.pages_evicted", lambda: pc.pages_evicted,
                     monotonic=True)
        reg.register("trie.pinned_pages", lambda: pc.pinned_pages)
        reg.register("trie.pinned_tokens",
                     lambda: pc.pinned_pages * pc.page_tokens)
        reg.register("trie.deepest_match", lambda: pc.deepest_match)
        reg.register("trie.demotions", lambda: pc.demotions, monotonic=True)
        reg.register("trie.promotions", lambda: pc.promotions,
                     monotonic=True)
        reg.register("trie.upgrades", lambda: pc.upgrades, monotonic=True)

    tier = getattr(engine, "tier", None)
    if tier is not None:
        # host cold tier (DESIGN.md §8a): demote/promote traffic plus the
        # promotion-lag pair the windowed profiler derives promote_lag_ms
        # from (lag = H2D enqueue -> page-table flip, engine-side)
        reg.register("tier.pages_demoted", lambda: tier.pages_demoted,
                     monotonic=True)
        reg.register("tier.pages_promoted", lambda: tier.pages_promoted,
                     monotonic=True)
        reg.register("tier.demote_failures", lambda: tier.demote_failures,
                     monotonic=True)
        reg.register("tier.host_drops", lambda: tier.host_drops,
                     monotonic=True)
        reg.register("tier.demote_ns", lambda: tier.demote_ns,
                     monotonic=True)
        reg.register("tier.promote_ns", lambda: tier.promote_ns,
                     monotonic=True)
        reg.register("tier.promotes", lambda: engine.promote_events,
                     monotonic=True)
        reg.register("tier.promote_lag_ns", lambda: engine.promote_lag_ns,
                     monotonic=True)
        reg.register("kv.host_pages", lambda: tier.host_pages)
        reg.register("kv.host_capacity", lambda: tier.capacity_pages)

    log = ctrl.oplog
    if log is not None:
        reg.register("oplog.appends", lambda: log.appends, monotonic=True)
        reg.register("oplog.entries_scanned", lambda: log.entries_scanned,
                     monotonic=True)
        for m in (0, 1, 2):                  # Mode values; avoids an import
            reg.register(f"oplog.appends.mode{m}",
                         lambda m=m: log.appends_by_mode.get(m, 0),
                         monotonic=True)


def attach_fault(obs: Obs, policy) -> None:
    """Wire the dist fault plane (``dist.fault.FaultPolicy``; duck-typed,
    the plane itself is not ported yet: ROADMAP queue 1, item 1.7) into
    the registry: liveness and mitigation counters.  The reference's
    ``attach_cluster`` comes with the cluster."""
    reg = obs.registry
    mon = policy.monitor
    reg.register("fault.heartbeats", lambda: mon.beats, monotonic=True)
    reg.register("fault.heartbeats_missed", lambda: mon.heartbeats_missed,
                 monotonic=True)
    reg.register("fault.deaths", lambda: mon.deaths, monotonic=True)
    reg.register("fault.straggler_flags", lambda: mon.straggler_flags,
                 monotonic=True)
    reg.register("fault.steals", lambda: policy.steals, monotonic=True)
    reg.register("fault.remeshes", lambda: policy.remeshes, monotonic=True)
    reg.register("fault.alive", lambda: len(mon.alive_workers()))
    reg.register("fault.spares", lambda: len(policy.spares))
