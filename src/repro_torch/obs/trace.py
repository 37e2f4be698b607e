"""Span tracing: monotonic-clock spans exported as Chrome trace-event
JSON (the ``chrome://tracing`` / Perfetto format).

A span is one complete event (``"ph": "X"``) with microsecond ``ts`` /
``dur`` relative to tracer start; spans on the same ``tid`` nest by
interval containment, which is how the viewers draw the flame.  The
serving taxonomy (DESIGN.md §10):

    tid 0          engine timeline: step{admit, schedule, serve_step,
                   sample} per engine step, publish sub-spans when a
                   chunk commits pages
    tid 2          host-tier demotions (D2H page spills, DESIGN.md §8a)
    tid 100+slot   request lifetimes: one span from admission to
                   finish, args carry the per-request overhead ledger
    tid 200+slot   host-tier promotions: one [enqueue -> page-table
                   flip] span per staged adoption — it OVERLAPS the
                   engine lane's serve_step on purpose (the proof the
                   H2D copy ran concurrent with compute), which is why
                   it lives on its own lane (spans nest per tid)
    instants       submit (arrival at the front door), cancel

Storage is allocation-light: one tuple per event in a flat list,
rendered to dicts only at ``dump()``.  ``max_events`` bounds memory;
overflow increments ``dropped`` instead of growing without bound."""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

# event tuple: (name, cat, ph, ts_ns, dur_ns, tid, args-or-None)
_Event = Tuple[str, str, str, int, int, int, Optional[dict]]


class SpanTracer:
    def __init__(self, *, max_events: int = 200_000) -> None:
        self._t0 = time.perf_counter_ns()
        self._events: List[_Event] = []
        self.max_events = max_events
        self.dropped = 0

    # ------------------------------------------------------------- clock

    def now_ns(self) -> int:
        """Monotonic ns since tracer start (span begin/end timestamps)."""
        return time.perf_counter_ns() - self._t0

    def rel(self, raw_ns: int) -> int:
        """Convert a raw ``time.perf_counter_ns()`` stamp to tracer-relative
        ns — lets callers take ONE stamp and reuse it for both ledger
        arithmetic (raw deltas) and span timestamps."""
        return raw_ns - self._t0

    # ------------------------------------------------------------- record

    def _push(self, ev: _Event) -> None:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    def complete(self, name: str, cat: str, t0_ns: int, t1_ns: int, *,
                 tid: int = 0, args: Optional[dict] = None) -> None:
        """One finished span [t0_ns, t1_ns] (from ``now_ns`` readings)."""
        self._push((name, cat, "X", t0_ns, max(t1_ns - t0_ns, 0), tid, args))

    def instant(self, name: str, cat: str, *, tid: int = 0,
                args: Optional[dict] = None) -> None:
        self._push((name, cat, "i", self.now_ns(), 0, tid, args))

    @contextmanager
    def span(self, name: str, cat: str, *, tid: int = 0,
             args: Optional[dict] = None) -> Iterator[None]:
        t0 = self.now_ns()
        try:
            yield
        finally:
            self.complete(name, cat, t0, self.now_ns(), tid=tid, args=args)

    # ------------------------------------------------------------- export

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[dict]:
        """Chrome trace-event dicts (``ts``/``dur`` in microseconds, the
        format's unit)."""
        out = []
        for name, cat, ph, ts, dur, tid, args in self._events:
            ev: Dict[str, object] = {
                "name": name, "cat": cat, "ph": ph,
                "ts": ts / 1e3, "pid": 0, "tid": tid,
            }
            if ph == "X":
                ev["dur"] = dur / 1e3
            if ph == "i":
                ev["s"] = "t"                  # thread-scoped instant
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def validate_chrome_trace(doc: dict) -> List[str]:
    """Structural checks for an exported trace (used by tests and the CI
    smoke cell).  Returns a list of problems (empty == valid):

      * ``traceEvents`` is a non-empty list of well-formed events;
      * complete events carry non-negative ``ts``/``dur``;
      * per ``(pid, tid)``, complete spans NEST — any two either are
        disjoint or one contains the other (the viewer's flame-graph
        precondition)."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    lanes: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            problems.append(f"event {i}: not a trace event")
            continue
        if "ts" not in ev:
            problems.append(f"event {i} ({ev['name']}): missing ts")
            continue
        if ev["ph"] == "X":
            if ev.get("dur", -1) < 0 or ev["ts"] < 0:
                problems.append(f"event {i} ({ev['name']}): bad ts/dur")
                continue
            lanes.setdefault((ev.get("pid", 0), ev.get("tid", 0)), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 str(ev["name"])))
    eps = 1e-3                                   # 1 ns at us granularity
    for lane, spans in lanes.items():
        # parents before children at equal start times (longest first)
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, float, str]] = []
        for t0, t1, name in spans:
            while stack and stack[-1][1] <= t0 + eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                problems.append(
                    f"tid {lane[1]}: span {name!r} [{t0},{t1}] overlaps "
                    f"{stack[-1][2]!r} ending {stack[-1][1]}")
            stack.append((t0, t1, name))
    return problems
