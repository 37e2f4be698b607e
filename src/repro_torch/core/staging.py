"""Staging files: pre-allocated append/overwrite landing zones (paper §3.3;
a copy of ``repro.core.staging``).

SplitFS pre-allocates staging files at startup (default 10 x 160 MB) and a
background thread replenishes the queue whenever one is consumed, so the
data path never allocates in the critical path — the paper's "avoid work in
the critical path" principle.

``take(nbytes)`` reserves a staged byte range and returns it; the caller
writes with non-temporal stores and later relinks it into the target file.
Reservation never blocks on the kernel unless the queue underruns (which the
benchmarks count, as the paper counts staging-file misses).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

from .ksplit import KSplit
from .pmem import BLOCK_SIZE


@dataclass
class StagedRange:
    ino: int            # staging file inode
    offset: int         # byte offset within the staging file
    length: int
    phys_addr: int      # physical PM address of the first byte (contiguous)


class _StagingFile:
    def __init__(self, ino: int, capacity: int) -> None:
        self.ino = ino
        self.capacity = capacity
        self.used = 0

    def remaining(self) -> int:
        return self.capacity - self.used


class StagingAllocator:
    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(
        self,
        ksplit: KSplit,
        file_bytes: int = 160 * 1024 * 1024,
        prealloc_files: int = 10,
        background: bool = True,
        name_prefix: str = ".staging",
    ) -> None:
        assert file_bytes % BLOCK_SIZE == 0
        self.ksplit = ksplit
        self.file_bytes = file_bytes
        self.background = background
        self.name_prefix = name_prefix
        self._queue: "queue.SimpleQueue[_StagingFile]" = queue.SimpleQueue()
        self._current: Optional[_StagingFile] = None
        self._lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self._refill_pending = 0
        self.n_underruns = 0
        self.created: List[int] = []
        for _ in range(prealloc_files):
            self._queue.put(self._create_file())

    # -- creation (runs at startup or on the background thread) ----------------

    def _create_file(self) -> _StagingFile:
        with StagingAllocator._counter_lock:
            StagingAllocator._counter += 1
            n = StagingAllocator._counter
        name = f"{self.name_prefix}.{n}"
        # pre-allocation is the background thread's job: its (real) device
        # work is metered off the critical path (paper §4)
        with self.ksplit.device.meter.offpath():
            ino = self.ksplit.create(name, staging=True)
            # pre-allocate all blocks, preferring physical contiguity (this
            # is what preserves locality through relink, paper §3.3)
            self.ksplit.allocate(ino, 0, self.file_bytes, contiguous=True)
            self.ksplit.set_size(ino, self.file_bytes, charge_trap=False)
        self.created.append(ino)
        return _StagingFile(ino, self.file_bytes)

    def _refill_async(self) -> None:
        def work() -> None:
            self._queue.put(self._create_file())
            with self._pending_lock:
                self._refill_pending -= 1

        with self._pending_lock:
            self._refill_pending += 1
        if self.background:
            threading.Thread(target=work, name="staging-refill", daemon=True).start()
        else:
            work()

    # -- the hot path ------------------------------------------------------------

    def take(self, nbytes: int, phase: Optional[int] = None) -> StagedRange:
        """Reserve ``nbytes`` of staging space (contiguous within one file).

        ``phase`` forces the reservation to start at a byte offset congruent
        to ``phase`` mod 4 KB. Staging an extent *in phase with its target
        file offset* is what lets relink stay metadata-only: fully-covered
        blocks line up block-for-block (paper §3.3 partial-block rule)."""
        assert 0 < nbytes <= self.file_bytes, "callers chunk writes larger than a staging file"

        def _phase_skip(used: int) -> int:
            if phase is None:
                return 0
            return (phase - used) % BLOCK_SIZE

        with self._lock:
            cur = self._current
            if cur is None:
                cur = self._current = self._next_file_locked()
            while True:
                cur.used += _phase_skip(cur.used)
                if cur.remaining() < nbytes:
                    cur = self._current = self._next_file_locked()
                    continue
                # A prior relink may have stolen the block under the cursor
                # (publishing a partial tail block moves the whole block);
                # skip to the next block boundary until we sit on owned space.
                inode = self.ksplit.inodes[cur.ino]
                lblk = cur.used // BLOCK_SIZE
                if inode.extents.lookup_block(lblk) is None:
                    cur.used = (lblk + 1) * BLOCK_SIZE
                    continue
                break
            offset = cur.used
            cur.used += nbytes
        seg = inode.extents.segments(offset, 1)[0]
        return StagedRange(cur.ino, offset, nbytes, seg.phys_addr)

    def _next_file_locked(self) -> _StagingFile:
        try:
            f = self._queue.get_nowait()
        except queue.Empty:
            # underrun: must create synchronously in the critical path —
            # exactly the cost the background thread exists to avoid.
            self.n_underruns += 1
            f = self._create_file()
        self._refill_async()
        return f

    def segments_of(self, rng: StagedRange):
        """Physically-contiguous segments of a staged range (for copy paths)."""
        inode = self.ksplit.inodes[rng.ino]
        return inode.extents.segments(rng.offset, rng.length)

    def drain(self) -> None:
        """Wait for pending background refills (tests/shutdown)."""
        import time

        while True:
            with self._pending_lock:
                if self._refill_pending == 0:
                    return
            time.sleep(0.001)
