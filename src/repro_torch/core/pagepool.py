"""Block allocator over the PM device (a copy of ``repro.core.pagepool``;
``FreeList`` backs the host tier's arena).

Files own 4 KB blocks; allocators differ per engine (ext4's mballoc vs NOVA's
per-CPU lists vs SplitFS's pre-allocated staging) only in the *cost events*
they emit — the free-list mechanics are shared here.

The pool hands out *physical block ids*; ``addr = block_id * BLOCK_SIZE``.
Block 0 is reserved (so 0 can mean "null" in on-PM structures).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterable, List

from .pmem import BLOCK_SIZE, PMDevice


class OutOfSpaceError(Exception):
    pass


class FreeList:
    """Bounded id recycler: ids in ``[0, capacity)`` are bump-allocated on
    first use and recycled FIFO after ``free``.  The shared allocation
    discipline of the pools — ``PagePool`` adds PM-device cost accounting
    on top; the host tier's arena (``core.tier.HostArena``) uses this
    directly, where a slot id names a fixed region offset so host buffers
    are written in place on reuse rather than reallocated."""

    def __init__(self, capacity: int) -> None:
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self._next = 0
        self._free: deque[int] = deque()
        self._allocated: set[int] = set()

    def alloc(self) -> int | None:
        """Next free id, or None when all ``capacity`` ids are in use."""
        if self._free:
            i = self._free.popleft()
        elif self._next < self.capacity:
            i = self._next
            self._next += 1
        else:
            return None
        self._allocated.add(i)
        return i

    def free(self, i: int) -> None:
        if i not in self._allocated:
            raise ValueError(f"double free of id {i}")
        self._allocated.remove(i)
        self._free.append(i)

    @property
    def in_use(self) -> int:
        return len(self._allocated)

    @property
    def full(self) -> bool:
        return len(self._allocated) >= self.capacity


class PagePool:
    def __init__(self, device: PMDevice, base_block: int = 1,
                 num_blocks: int | None = None) -> None:
        self.device = device
        self._lock = threading.Lock()
        if num_blocks is None:
            num_blocks = device.num_blocks - base_block
        self.base_block = base_block
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(base_block, base_block + num_blocks))
        self._allocated: set[int] = set()

    # -- queries ---------------------------------------------------------------

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def num_allocated(self) -> int:
        with self._lock:
            return len(self._allocated)

    def is_allocated(self, block: int) -> bool:
        with self._lock:
            return block in self._allocated

    # -- alloc/free --------------------------------------------------------------

    def alloc(self, n: int, cost_event: str | None = None, contiguous: bool = False) -> List[int]:
        """Allocate ``n`` blocks.  ``cost_event`` names the allocator being
        modeled (e.g. ``ext4_alloc``) and is charged once per extent, matching
        extent-based allocators."""
        with self._lock:
            if len(self._free) < n:
                raise OutOfSpaceError(f"need {n} blocks, {len(self._free)} free")
            if contiguous:
                blocks = self._alloc_contiguous_locked(n)
            else:
                blocks = [self._free.popleft() for _ in range(n)]
            self._allocated.update(blocks)
        if cost_event:
            self.device.meter.add(cost_event, self._extent_count(blocks))
        return blocks

    def _alloc_contiguous_locked(self, n: int) -> List[int]:
        # Best-effort: scan the free deque for a run of n consecutive ids.
        free_sorted = sorted(self._free)
        run_start = 0
        for i in range(1, len(free_sorted) + 1):
            if i == len(free_sorted) or free_sorted[i] != free_sorted[i - 1] + 1:
                if i - run_start >= n:
                    blocks = free_sorted[run_start : run_start + n]
                    chosen = set(blocks)
                    self._free = deque(b for b in self._free if b not in chosen)
                    return blocks
                run_start = i
        # Fragmented: fall back to arbitrary blocks (the paper's huge-page
        # fragility observation — contiguity cannot be guaranteed).
        return [self._free.popleft() for _ in range(n)]

    def free(self, blocks: Iterable[int], cost_event: str | None = None) -> None:
        blocks = list(blocks)
        with self._lock:
            for b in blocks:
                if b not in self._allocated:
                    raise ValueError(f"double free of block {b}")
                self._allocated.remove(b)
                self._free.append(b)
        if cost_event:
            self.device.meter.add(cost_event, self._extent_count(blocks))

    def adopt(self, blocks: Iterable[int]) -> None:
        """Mark blocks allocated without going through alloc (recovery path)."""
        blocks = list(blocks)
        with self._lock:
            free_set = set(self._free)
            for b in blocks:
                if b in self._allocated:
                    continue
                if b not in free_set:
                    raise ValueError(f"block {b} neither free nor allocated")
                free_set.remove(b)
                self._allocated.add(b)
            self._free = deque(sorted(free_set))

    @staticmethod
    def _extent_count(blocks: List[int]) -> int:
        if not blocks:
            return 0
        runs = 1
        for a, b in zip(blocks, blocks[1:]):
            if b != a + 1:
                runs += 1
        return runs

    @staticmethod
    def addr(block: int, offset: int = 0) -> int:
        assert 0 <= offset < BLOCK_SIZE
        return block * BLOCK_SIZE + offset
