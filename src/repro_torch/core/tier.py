"""Host-memory cold tier under the device KV page pool (DESIGN.md §8a);
the port of ``repro.core.tier``.

The SplitFS/SPFS stacking argument applied to the serving plane: the
device pool is the fast tier whose capacity binds first, so published
prefix chains that backpressure (or trie capacity) would otherwise
DISCARD are spilled to host memory instead.  Two operations:

  demote(page)        D2H: snapshot one physical page's bytes across every
                      layer pool into an arena slot.  Synchronous: the
                      copy has landed when ``demote`` returns, so the
                      caller may unpin the page at once.
  promote(slot, dst)  H2D: write a demoted page's bytes into a freshly
                      reserved device page.  The engine enqueues it
                      asynchronously (a side CUDA stream) so the copy
                      overlaps the in-flight serve step; the page-table
                      flip — the relink-style publish — happens only
                      after the copy is enqueued, and the engine makes
                      the next step wait on the copy's event.

The arena borrows ``core.mmap_cache``'s translation-cache discipline:
backing buffers are allocated once per ``chunk_pages``-page REGION on
first touch and never discarded — slot reuse rewrites bytes in place, so
the expensive part (allocation, and page-locking with ``pin_memory``) is
paid per region, not per demotion.  Regions are torch tensors of each
leaf's own dtype, so a bfloat16 page round-trips bit for bit.

An asynchronous H2D copy reads its pinned source when the device runs
it, not when it is enqueued, so a slot freed at flip time may still be
read by a copy in flight.  ``HostArena.mark_read`` records the event
after the last copy that read a slot, and ``put`` into that slot waits
on it before rewriting the bytes.

The host tier is a LOSS-TOLERANT cache, never a durability participant:
pages move tiers without changing bytes or chain identity, nothing here
is logged, and dropping the whole arena at any point costs only future
prefill recompute (DESIGN.md §8a).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .pagepool import FreeList

# one page's bytes, as a list of per-pool-leaf tensors (the engine's
# deterministic cache walk fixes the leaf order)
PageViews = List[torch.Tensor]


class HostArena:
    """Chunked host page store: ``capacity_pages`` slots backed by
    per-region tensors of ``chunk_pages`` pages each, allocated lazily on
    first touch (page-locked with ``pin_memory``) and reused in place
    forever after."""

    def __init__(self, capacity_pages: int, chunk_pages: int = 8, *,
                 pin_memory: bool = False) -> None:
        if capacity_pages < 1:
            raise ValueError("host arena needs >= 1 page")
        self.capacity_pages = capacity_pages
        self.chunk_pages = max(1, min(chunk_pages, capacity_pages))
        self.pin_memory = pin_memory
        self._slots = FreeList(capacity_pages)
        # region index -> one buffer per pool leaf, [chunk_pages, *leaf]
        self._regions: Dict[int, List[torch.Tensor]] = {}
        # slot -> event after the last asynchronous copy that read it
        self._reads: Dict[int, torch.cuda.Event] = {}
        self.regions_created = 0
        self.region_reuses = 0      # puts landing in an already-built region
        self.read_waits = 0         # puts that waited on a copy in flight

    def put(self, views: Sequence[torch.Tensor]) -> Optional[int]:
        """Store one page's leaf views (on any device; the copy has
        landed on return); returns the slot or None when every slot is
        taken (the caller's backpressure signal)."""
        slot = self._slots.alloc()
        if slot is None:
            return None
        ev = self._reads.pop(slot, None)
        if ev is not None and not ev.query():
            ev.synchronize()
            self.read_waits += 1
        region_idx, off = divmod(slot, self.chunk_pages)
        region = self._regions.get(region_idx)
        if region is None:
            region = [torch.empty((self.chunk_pages,) + tuple(v.shape),
                                  dtype=v.dtype, pin_memory=self.pin_memory)
                      for v in views]
            self._regions[region_idx] = region
            self.regions_created += 1
        else:
            self.region_reuses += 1
        for buf, v in zip(region, views):
            buf[off].copy_(v)
        return slot

    def get(self, slot: int) -> PageViews:
        """Zero-copy views of a stored page's leaves."""
        region_idx, off = divmod(slot, self.chunk_pages)
        return [buf[off] for buf in self._regions[region_idx]]

    def mark_read(self, slot: int, event: torch.cuda.Event) -> None:
        """An asynchronous copy reading ``slot`` was enqueued before
        ``event``: the next ``put`` into the slot waits on it."""
        self._reads[slot] = event

    def free(self, slot: int) -> None:
        """Release a slot for reuse.  The region (and its bytes) stays:
        an in-flight promote that still reads the old bytes keeps reading
        valid memory, and the next ``put`` into the slot waits for it."""
        self._slots.free(slot)

    @property
    def in_use(self) -> int:
        return self._slots.in_use

    @property
    def full(self) -> bool:
        return self._slots.full


class HostTier:
    """The demote/promote protocol over one engine's pool tensors.

    ``read_page(page) -> PageViews`` and ``write_page(views, page) ->
    event or None`` are the engine's D2H/H2D callbacks (its deterministic
    cache walk; ``write_page`` returns the event after an asynchronous
    copy, None when the copy has landed on return); the tier itself never
    touches device state, mirroring the controller's metadata-only
    stance.  ``tracer`` (optional) emits "demote" spans on tid 2; promote
    spans belong to the ENGINE because their interval is enqueue ->
    page-table flip, which spans a serve step."""

    def __init__(self, capacity_pages: int, *,
                 read_page: Callable[[int], PageViews],
                 write_page: Callable[[PageViews, int],
                                      Optional[torch.cuda.Event]],
                 chunk_pages: int = 8, pin_memory: bool = False) -> None:
        self.arena = HostArena(capacity_pages, chunk_pages,
                               pin_memory=pin_memory)
        self._read_page = read_page
        self._write_page = write_page
        self.tracer = None
        # plain-int stats, read lazily by the obs registry
        self.pages_demoted = 0
        self.pages_promoted = 0
        self.demote_failures = 0    # arena full: the chain is dropped instead
        self.host_drops = 0         # demoted pages forgotten without promote
        self.demote_ns = 0
        self.promote_ns = 0

    @property
    def capacity_pages(self) -> int:
        return self.arena.capacity_pages

    @property
    def host_pages(self) -> int:
        """Occupancy gauge (kv.host_pages)."""
        return self.arena.in_use

    def demote(self, page: int) -> Optional[int]:
        """D2H: spill ``page`` into the arena.  Returns the slot, or None
        when the arena is full (caller falls back to dropping the chain).
        Must run while the device page is still allocated — the caller
        unpins only after the snapshot returns."""
        if self.arena.full:
            self.demote_failures += 1
            return None
        t0 = time.perf_counter_ns()
        slot = self.arena.put(self._read_page(page))
        t1 = time.perf_counter_ns()
        self.demote_ns += t1 - t0
        if slot is None:            # unreachable given the full-check, belt
            self.demote_failures += 1
            return None
        self.pages_demoted += 1
        if self.tracer is not None:
            self.tracer.complete("demote", "tier", self.tracer.rel(t0),
                                 self.tracer.rel(t1), tid=2,
                                 args={"page": page, "slot": slot})
        return slot

    def promote(self, slot: int, dst_page: int) -> None:
        """H2D: enqueue the copy of slot's bytes into device page
        ``dst_page``.  Asynchronous on a CUDA engine — the wall time
        measured here is enqueue cost, not transfer; the slot is freed by
        the caller at flip time, and the copy's event guards its bytes
        until the copy has read them."""
        t0 = time.perf_counter_ns()
        ev = self._write_page(self.arena.get(slot), dst_page)
        if ev is not None:
            self.arena.mark_read(slot, ev)
        self.promote_ns += time.perf_counter_ns() - t0
        self.pages_promoted += 1

    def free(self, slot: int, *, promoted: bool = True) -> None:
        """Release an arena slot; un-promoted frees are chain drops
        (LRU pressure on the host tier itself) and counted as such."""
        self.arena.free(slot)
        if not promoted:
            self.host_drops += 1

    def read(self, slot: int) -> PageViews:
        return self.arena.get(slot)

    def stats(self) -> Dict[str, int]:
        return {"pages_demoted": self.pages_demoted,
                "pages_promoted": self.pages_promoted,
                "demote_failures": self.demote_failures,
                "host_drops": self.host_drops,
                "host_pages": self.host_pages,
                "capacity_pages": self.capacity_pages,
                "regions_created": self.arena.regions_created}
