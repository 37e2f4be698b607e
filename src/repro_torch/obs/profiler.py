"""SPFS-style windowed profiler (``1SEC_PROFILER``): periodic ring-buffer
snapshots of the counter registry.

``observe()`` is called from the serving hot loop (once per engine step);
it is a clock read + one comparison until a window boundary passes, at
which point the open window closes: monotonic metrics are stored as
DELTAS over the window, gauges as their closing level, and tok/s is
derived from the ``engine.tokens`` counter.  The ring keeps the last
``capacity`` windows (old ones fall off — bounded memory for arbitrarily
long serving runs, like SPFS's fixed profiler region)."""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from .registry import Registry


@dataclass
class Window:
    index: int
    t_start: float                       # seconds since profiler start
    t_end: float
    counters: Dict[str, float] = field(default_factory=dict)  # deltas
    gauges: Dict[str, float] = field(default_factory=dict)    # last values

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def tok_s(self) -> float:
        return self.counters.get("engine.tokens", 0.0) / max(self.duration,
                                                             1e-9)

    @property
    def promote_lag_ms(self) -> float:
        """Mean host-tier promotion lag over the window (H2D enqueue ->
        page-table flip, DESIGN.md §8a) — the stall-visibility metric for
        the tiered KV store.  0.0 in windows without promotions (or on
        engines without a host tier)."""
        n = self.counters.get("tier.promotes", 0.0)
        if not n:
            return 0.0
        return self.counters.get("tier.promote_lag_ns", 0.0) / n / 1e6

    def as_dict(self) -> dict:
        return {"index": self.index, "t_start": round(self.t_start, 4),
                "t_end": round(self.t_end, 4), "tok_s": round(self.tok_s, 1),
                "promote_lag_ms": round(self.promote_lag_ms, 3),
                "counters": self.counters, "gauges": self.gauges}


class WindowedProfiler:
    def __init__(self, registry: Registry, *, window_s: float = 1.0,
                 capacity: int = 64) -> None:
        self.registry = registry
        self.window_s = window_s
        self._ring: Deque[Window] = deque(maxlen=capacity)
        self._t0 = time.perf_counter()
        self._open_start: Optional[float] = None
        self._open_snap: Dict[str, float] = {}
        self._index = 0

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def observe(self, *, now: Optional[float] = None) -> None:
        """Hot-loop tick.  Cheap until a window boundary: one clock read
        and one comparison.  ``now`` (seconds since profiler start) is
        injectable for tests."""
        t = self._now() if now is None else now
        if self._open_start is None:
            # EMPTY baseline: the first window's deltas count everything
            # since registry start, so no tick's work escapes the ring
            # (the first observe runs AFTER the first engine step)
            self._open_start = t
            self._open_snap = {}
            return
        if t - self._open_start >= self.window_s:
            self._close(t)
            self._open_start = t

    def flush(self, *, now: Optional[float] = None) -> None:
        """Close the partial window (end of run / stats dump)."""
        t = self._now() if now is None else now
        if self._open_start is not None and t > self._open_start:
            self._close(t)
            self._open_start = None

    def _close(self, t: float) -> None:
        snap = self.registry.snapshot()
        mono = self.registry.monotonic_names()
        w = Window(index=self._index, t_start=self._open_start, t_end=t)
        for name, v in snap.items():
            if name in mono:
                w.counters[name] = v - self._open_snap.get(name, 0.0)
            else:
                w.gauges[name] = v
        self._ring.append(w)
        self._index += 1
        self._open_snap = snap

    # ------------------------------------------------------------- reading

    def windows(self) -> List[Window]:
        return list(self._ring)

    def as_dicts(self) -> List[dict]:
        return [w.as_dict() for w in self._ring]
