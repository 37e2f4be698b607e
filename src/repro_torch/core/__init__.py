"""The port's host control plane: copies of the numpy-only modules of
``repro.core`` that the serving path needs (consistency modes, the
simulated PM device, the 64 B operation log, the paged-KV controller,
the free list) and the port of the host tier under the page pool."""

from .kvcache import (KVGeometry, KVPoolFullError, PagedKVCache,
                      replay_kv_commits)
from .modes import Mode
from .oplog import OP_KV_COMMIT, LogEntry, OpLog
from .pagepool import FreeList
from .pmem import BLOCK_SIZE, CACHELINE, PMDevice
from .tier import HostArena, HostTier

__all__ = ["BLOCK_SIZE", "CACHELINE", "FreeList", "HostArena", "HostTier",
           "KVGeometry", "KVPoolFullError", "LogEntry", "Mode",
           "OP_KV_COMMIT", "OpLog", "PMDevice", "PagedKVCache",
           "replay_kv_commits"]
