"""The port's host control plane: copies of the numpy-only modules of
``repro.core`` (the SplitFS split-architecture store: U-Split/K-Split,
staging + relink, the optimized oplog, three consistency modes, the
journal and the volume layout; the simulated PM device; the paged-KV
controller) and the port of the host tier under the page pool.  The
reference's ``baselines`` (the paper's other file systems, for the FS
benchmarks) is not here (ROADMAP queue 1, item 6)."""

from .extents import ExtentMap, Segment, move_extents
from .journal import Journal, Txn
from .ksplit import FSError, Inode, KSplit, NoEntError
from .kvcache import (KVGeometry, KVPoolFullError, PagedKVCache,
                      replay_kv_commits)
from .mmap_cache import MmapCache
from .modes import Mode
from .oplog import OP_KV_COMMIT, LogEntry, OpLog
from .pagepool import FreeList, OutOfSpaceError, PagePool
from .pmem import BLOCK_SIZE, CACHELINE, MMAP_CHUNK, Meter, NS, PMDevice
from .staging import StagedRange, StagingAllocator
from .store import FileState, StagedExtent, StoreStats, USplit
from .tier import HostArena, HostTier
from .volume import Volume, VolumeGeometry

__all__ = [
    "BLOCK_SIZE", "CACHELINE", "MMAP_CHUNK", "ExtentMap", "FSError",
    "FileState", "FreeList", "HostArena", "HostTier", "Inode", "Journal",
    "KSplit", "KVGeometry", "KVPoolFullError", "LogEntry", "Meter",
    "MmapCache", "Mode", "NS", "NoEntError", "OP_KV_COMMIT", "OpLog",
    "OutOfSpaceError", "PMDevice", "PagePool", "PagedKVCache", "Segment",
    "StagedExtent", "StagedRange", "StagingAllocator", "StoreStats", "Txn",
    "USplit", "Volume", "VolumeGeometry", "move_extents",
    "replay_kv_commits",
]
