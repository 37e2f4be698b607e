"""Simulated persistent-memory device + calibrated cost model.

The paper's subject is *software overhead*: the gap between what an operation
costs end-to-end and what the raw device transfer costs.  On this CPU-only
container we reproduce that accounting with a two-channel meter:

  * **mechanism counters** — every engine (SplitFS and the five baselines)
    executes its real algorithm against a real byte buffer and emits low-level
    events (kernel traps, block allocations, journal commits, cacheline
    persists, fences, data writes, page faults, ...).  These counts are facts
    about the executed code path, not tuned numbers.
  * **a calibrated ns model** — each event kind is priced once, from the
    paper's own measurements (Table 2: store+flush+fence = 91 ns; 4 KB PM
    write = 671 ns) and from published Linux costs for traps/journaling.
    Engine latency = sum(price(event) * count(event)).

The same constants price *every* engine, so relative overheads (Table 1,
Table 6, Figs 3-5) are predictions of the mechanism, not fits.

A copy of ``repro.core.pmem`` without the accelerator roofline constants:
the port's serving plane needs only ``PMDevice`` (the STRICT oplog's
backing store) and ``CACHELINE``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

# ---------------------------------------------------------------------------
# Device geometry
# ---------------------------------------------------------------------------

BLOCK_SIZE = 4096          # PM file-system block (paper uses 4 KB ops/blocks)
CACHELINE = 64             # persist granularity
MMAP_CHUNK = 2 * 1024 * 1024   # default mmap granularity (huge page, paper §3.6)

# ---------------------------------------------------------------------------
# Calibrated event prices (ns).  Sources:
#   pm_store_line      — Table 2 "Store + flush + fence": 91 ns / cacheline.
#   pm_data_per_byte   — §1: "671 ns to write a 4 KB to PM"  => 0.1638 ns/B
#                        (movnt streaming; bandwidth-limited term).
#   pm_read_latency    — Table 2 sequential read latency: 169 ns first touch.
#   pm_read_per_byte   — Table 2 read BW 39.4 GB/s => 0.0254 ns/B.
#   trap               — syscall entry/exit + VFS dispatch on a post-KPTI
#                        kernel (~450 ns round trip).
#   ext4_alloc         — ext4 mballoc + extent-tree insert per new extent.
#   ext4_journal_txn   — jbd2 handle start/stop + descriptor/commit blocks.
#   ext4_write_path    — dax_iomap path: locking, iomap lookup per write call.
#   nova_alloc         — NOVA per-CPU free-list allocation (much cheaper).
#   nova_log_line      — NOVA persists >= 2 cachelines + 2 fences per op;
#                        we charge per line so strict/relaxed differ by count.
#   dram_per_byte      — DRAM copy at ~80 GB/s (Table 2 DRAM write BW).
#   page_fault         — minor fault with PTE setup.
#   mmap_syscall       — mmap()/munmap() call overhead excluding faults.
#   index_op           — in-DRAM metadata structure update (hash/tree op).
#   cas                — compare-and-swap on the DRAM log tail.
#   checksum_per_byte  — crc32 at ~10 GB/s.
# ---------------------------------------------------------------------------

NS = {
    "trap": 450.0,
    "pm_store_line": 91.0,
    "pm_data_per_byte": 671.0 / 4096.0,
    "pm_read_latency": 169.0,
    "pm_read_per_byte": 1.0 / 39.4,
    "dram_per_byte": 1.0 / 80.0,
    "fence": 25.0,
    "ext4_alloc": 1450.0,
    "ext4_free": 400.0,   # extent removal inside a running jbd2 handle
    "ext4_journal_txn": 2900.0,
    "ext4_write_path": 1800.0,
    "ext4_read_path": 650.0,
    "pmfs_alloc": 520.0,
    "pmfs_write_path": 700.0,
    "nova_alloc": 300.0,
    "nova_log_line": 91.0,
    "nova_write_path": 450.0,
    "page_fault": 950.0,
    "mmap_syscall": 1100.0,
    "index_op": 90.0,
    "cas": 20.0,
    "checksum_per_byte": 0.1,
    "open_path": 900.0,     # path resolution + dentry/inode lookup
    "strata_digest_per_byte": 671.0 / 4096.0,  # digest copies data again
}

class Meter:
    """Accumulates mechanism events; prices them with the calibrated model.

    ``ns()`` returns total modeled nanoseconds;  ``device_ns()`` returns the
    subset that is *raw device transfer* (the paper's denominator), so
    ``software_ns = ns() - device_ns()`` is the paper's "software overhead".

    ``offpath()`` redirects events to a separate channel: work done by
    background threads (staging-file pre-allocation) is real device work but
    NOT application-visible latency — exactly the distinction the paper's
    "avoid work in the critical path" design makes (§4).
    """

    DEVICE_KEYS = ("pm_data_bytes", "pm_read_bytes")

    def __init__(self) -> None:
        self.counts: Dict[str, float] = {}
        self.off_counts: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def offpath(self):
        import contextlib

        meter = self

        @contextlib.contextmanager
        def ctx():
            prev = getattr(meter._local, "off", False)
            meter._local.off = True
            try:
                yield
            finally:
                meter._local.off = prev

        return ctx()

    def add(self, key: str, n: float = 1.0) -> None:
        with self._lock:
            if getattr(self._local, "off", False):
                self.off_counts[key] = self.off_counts.get(key, 0.0) + n
            else:
                self.counts[key] = self.counts.get(key, 0.0) + n

    def merge(self, other: "Meter") -> None:
        with self._lock:
            for k, v in other.counts.items():
                self.counts[k] = self.counts.get(k, 0.0) + v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counts)

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()
            self.off_counts.clear()

    # -- pricing ------------------------------------------------------------

    def ns(self) -> float:
        c = self.snapshot()
        t = 0.0
        t += c.get("trap", 0) * NS["trap"]
        t += c.get("pm_store_line", 0) * NS["pm_store_line"]
        t += c.get("pm_data_bytes", 0) * NS["pm_data_per_byte"]
        t += c.get("pm_read_ops", 0) * NS["pm_read_latency"]
        t += c.get("pm_read_bytes", 0) * NS["pm_read_per_byte"]
        t += c.get("dram_bytes", 0) * NS["dram_per_byte"]
        t += c.get("fence", 0) * NS["fence"]
        t += c.get("ext4_alloc", 0) * NS["ext4_alloc"]
        t += c.get("ext4_free", 0) * NS["ext4_free"]
        t += c.get("ext4_journal_txn", 0) * NS["ext4_journal_txn"]
        t += c.get("ext4_write_path", 0) * NS["ext4_write_path"]
        t += c.get("ext4_read_path", 0) * NS["ext4_read_path"]
        t += c.get("pmfs_alloc", 0) * NS["pmfs_alloc"]
        t += c.get("pmfs_write_path", 0) * NS["pmfs_write_path"]
        t += c.get("nova_alloc", 0) * NS["nova_alloc"]
        t += c.get("nova_log_line", 0) * NS["nova_log_line"]
        t += c.get("nova_write_path", 0) * NS["nova_write_path"]
        t += c.get("page_fault", 0) * NS["page_fault"]
        t += c.get("mmap_syscall", 0) * NS["mmap_syscall"]
        t += c.get("index_op", 0) * NS["index_op"]
        t += c.get("cas", 0) * NS["cas"]
        t += c.get("checksum_bytes", 0) * NS["checksum_per_byte"]
        t += c.get("open_path", 0) * NS["open_path"]
        t += c.get("strata_digest_bytes", 0) * NS["strata_digest_per_byte"]
        return t

    def device_ns(self) -> float:
        c = self.snapshot()
        return (
            c.get("pm_data_bytes", 0) * NS["pm_data_per_byte"]
            + c.get("pm_read_ops", 0) * NS["pm_read_latency"]
            + c.get("pm_read_bytes", 0) * NS["pm_read_per_byte"]
            + c.get("strata_digest_bytes", 0) * NS["strata_digest_per_byte"]
        )

    def software_ns(self) -> float:
        return self.ns() - self.device_ns()

    # -- write-IO accounting (Table 7) ---------------------------------------

    def pm_bytes_written(self) -> float:
        c = self.snapshot()
        return (
            c.get("pm_data_bytes", 0)
            + c.get("pm_store_line", 0) * CACHELINE
            + c.get("strata_digest_bytes", 0)
        )


@dataclass
class PMDevice:
    """The simulated byte-addressable PM device: one flat buffer + a meter.

    ``write_data``   — streaming (movnt-style) bulk write, priced by bandwidth.
    ``persist_line`` — one cacheline store+flush (91 ns), for logs/journals.
    ``fence``        — ordering point (sfence).
    ``read``         — load path, priced by latency + bandwidth.

    The buffer is real: every engine's bytes genuinely land here, so crash
    tests can tear the device mid-operation and recovery must read back what
    was actually persisted.
    """

    size: int = 512 * 1024 * 1024
    buf: np.ndarray = field(default=None, repr=False)  # type: ignore[assignment]
    meter: Meter = field(default_factory=Meter)

    def __post_init__(self) -> None:
        if self.buf is None:
            self.buf = np.zeros(self.size, dtype=np.uint8)

    @property
    def num_blocks(self) -> int:
        return self.size // BLOCK_SIZE

    # -- data path ------------------------------------------------------------

    def write_data(self, addr: int, data: bytes | np.ndarray) -> None:
        n = len(data)
        assert 0 <= addr and addr + n <= self.size, "PM write out of range"
        self.buf[addr : addr + n] = np.frombuffer(memoryview(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        self.meter.add("pm_data_bytes", n)

    def persist_line(self, addr: int, data: bytes) -> None:
        n = len(data)
        assert n <= CACHELINE, "persist_line writes at most one cacheline"
        assert 0 <= addr and addr + n <= self.size
        self.buf[addr : addr + n] = np.frombuffer(data, dtype=np.uint8)
        self.meter.add("pm_store_line", 1)

    def fence(self) -> None:
        self.meter.add("fence", 1)

    def read(self, addr: int, n: int) -> memoryview:
        assert 0 <= addr and addr + n <= self.size, "PM read out of range"
        self.meter.add("pm_read_ops", 1)
        self.meter.add("pm_read_bytes", n)
        return memoryview(self.buf[addr : addr + n])

    def read_silent(self, addr: int, n: int) -> memoryview:
        """Read without metering (used by recovery scans & tests)."""
        return memoryview(self.buf[addr : addr + n])

    def zero(self, addr: int, n: int, metered: bool = True) -> None:
        self.buf[addr : addr + n] = 0
        if metered:
            self.meter.add("pm_data_bytes", n)

    # -- crash injection --------------------------------------------------------

    def torn_copy(self, rng: np.random.Generator, torn_tail_bytes: int = 0) -> "PMDevice":
        """Clone the device as-if power was lost *now*; optionally tear the
        last ``torn_tail_bytes`` (simulating a partial cacheline flush)."""
        clone = PMDevice(size=self.size, buf=self.buf.copy())
        if torn_tail_bytes:
            lo = rng.integers(0, self.size - torn_tail_bytes)
            clone.buf[lo : lo + torn_tail_bytes] = rng.integers(
                0, 256, size=torn_tail_bytes, dtype=np.uint8
            )
        return clone
