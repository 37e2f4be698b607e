"""The port's host control plane: copies of the numpy-only modules of
``repro.core`` that the serving path needs (consistency modes, the
simulated PM device, the 64 B operation log, the paged-KV controller)."""

from .kvcache import (KVGeometry, KVPoolFullError, PagedKVCache,
                      replay_kv_commits)
from .modes import Mode
from .oplog import OP_KV_COMMIT, LogEntry, OpLog
from .pmem import BLOCK_SIZE, CACHELINE, PMDevice

__all__ = ["BLOCK_SIZE", "CACHELINE", "KVGeometry", "KVPoolFullError",
           "LogEntry", "Mode", "OP_KV_COMMIT", "OpLog", "PMDevice",
           "PagedKVCache", "replay_kv_commits"]
