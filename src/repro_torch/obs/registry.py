"""Counter/gauge registry — the SPFS ``CONFIG_SPFS_STATS`` analogue.

Two kinds of metric, chosen for hot-path cost:

  * **imperative** ``Counter`` / ``Gauge`` objects: a plain attribute
    update (one int add under the GIL), for call sites that have no
    existing stat to read — allocation-free after creation;
  * **lazy** metrics (``register``): a callable evaluated only at
    ``snapshot()`` time.  Most of the serving stack already keeps plain
    int stats (``PagedKVCache.pages_allocated``, ``PrefixCache.hits``,
    ...); registering a reader costs the hot path NOTHING — the SplitFS
    discipline of keeping the data plane untouched applied to metrics.

``snapshot()`` returns one flat ``{name: number}`` dict; names marked
``monotonic`` are counters (the windowed profiler differences them),
the rest are gauges (levels — the profiler keeps the last value).
"""

from __future__ import annotations

from typing import Callable, Dict, Set


class Counter:
    """Monotonic event count.  ``inc`` rejects negative deltas — a
    counter that can go down is a gauge, and windowed deltas over it
    would silently under-report."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Instantaneous level (occupancy, queue depth)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def add(self, d: float) -> None:
        self.value += d


class Registry:
    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._lazy: Dict[str, Callable[[], float]] = {}
        self._monotonic: Set[str] = set()

    # ------------------------------------------------------------- creation

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            if name in self._gauges or name in self._lazy:
                raise ValueError(f"metric {name!r} already registered")
            c = self._counters[name] = Counter(name)
            self._monotonic.add(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            if name in self._counters or name in self._lazy:
                raise ValueError(f"metric {name!r} already registered")
            g = self._gauges[name] = Gauge(name)
        return g

    def register(self, name: str, fn: Callable[[], float], *,
                 monotonic: bool = False) -> None:
        """Lazy metric: ``fn`` is called at snapshot time only.  Re-
        registering a name replaces the reader (an engine rebuilt over
        the same Obs keeps one metric, not a stale duplicate)."""
        if name in self._counters or name in self._gauges:
            raise ValueError(f"metric {name!r} already registered")
        self._lazy[name] = fn
        if monotonic:
            self._monotonic.add(name)
        else:
            self._monotonic.discard(name)

    # ------------------------------------------------------------- reading

    def monotonic_names(self) -> Set[str]:
        return set(self._monotonic)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, fn in self._lazy.items():
            out[name] = fn()
        return out
