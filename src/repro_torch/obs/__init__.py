"""repro_torch.obs — a copy of ``repro.obs`` (plain Python, no jax):
low-overhead observability for the serving path (DESIGN.md §10): span
tracing to Chrome trace-event JSON, a counter/gauge registry over the
stack's existing plain-int stats, an SPFS-style windowed profiler, and
the SplitFS software-overhead ledger (client / scheduler / device /
persistence attribution).

Everything hangs off one optional ``Obs`` bundle; ``obs=None`` keeps
the hot path untouched."""

from .bundle import Obs, OverheadLedger, attach_fault, attach_serving
from .profiler import Window, WindowedProfiler
from .registry import Counter, Gauge, Registry
from .trace import SpanTracer, validate_chrome_trace

__all__ = [
    "Obs", "OverheadLedger", "attach_fault", "attach_serving",
    "Window", "WindowedProfiler", "Counter", "Gauge", "Registry",
    "SpanTracer", "validate_chrome_trace",
]
