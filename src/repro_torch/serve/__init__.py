"""Serving stack of the port: session client API over the
continuous-batching engine.

``ServeClient`` / ``Session`` (serve.api) is the front door — per-session
consistency modes and sampling over ONE engine or an ``EngineCluster`` of
N (serve.cluster, DESIGN.md §12); ``ServingEngine`` remains the raw
control plane underneath; ``PrefixCache`` dedups shared prompt prefixes
at admission; ``arrival`` drives open-loop traffic; ``tokenizer`` is the
byte-level text front; ``router``/``snapshot`` are the cluster's routing
and failure-atomic migration planes.
"""
from .api import ServeClient, Session
from .arrival import (ArrivalResult, ArrivalSpec, OpenLoopDriver,
                      poisson_schedule, trace_schedule)
from .cluster import EngineCluster
from .engine import Request, SamplingParams, ServingEngine, SpecConfig
from .prefix_cache import PrefixCache
from .router import PrefixRouter, prefix_hash
from .snapshot import (MigrationError, SessionSnapshot, restore_session,
                       snapshot_session)
from .tokenizer import ByteTokenizer
from ..obs import Obs
