"""PagedKVCache: sequences-as-files over a device page pool (DESIGN.md §3.4).

A copy of ``repro.core.kvcache`` (numpy only), kept in the port so that
``repro_torch`` imports nothing of ``repro``; both packages run the same
crash-consistency protocol.  In the port the data-path operations below
are the hand-written CUDA kernels of ``repro_torch.kernels``.

The SplitFS mechanism mapped onto the serving plane:

  PM device            -> pre-allocated HBM page pool  [num_pages, page_tokens, kv_heads, hd]
  file                 -> a sequence's KV stream
  staging file         -> the sequence's current (not yet full) pool page
  append + nt store    -> in-graph scatter of one token's K/V into its page
  relink on fsync      -> page-table row update when a page fills / on commit
                          (metadata-only publish; zero data movement)
  collection of mmaps  -> the device page table  [max_seqs, pages_per_seq] int32
  hard links           -> refcounted page sharing (prefix cache / beam forks)
  partial-block copy   -> copy-on-write of the *last, partially-filled* page
                          when a forked sequence appends

The host controller below owns metadata only (free lists, refcounts, extent
maps); every data-path operation is a compiled JAX function over the pool
arrays (kernels/kv_append, kernels/paged_attention).  The host never touches
KV bytes — the same "data plane never traps" split as the file system.

Chunked prefill (DESIGN.md §8) appends whole pages at a time through
``append_tokens``; newly-FULL pages are *committed* (published) as they
fill, and in STRICT mode every commit appends one 64 B ``OP_KV_COMMIT``
operation-log entry (1 cacheline + 1 fence) so a crash mid-prefill recovers
exactly the committed pages by idempotent replay (``replay_kv_commits``).

Physical page 0 is RESERVED as the null page (never allocated): a zero
page-table entry therefore always denotes "unallocated -> null", so the
fixed-shape data plane may route pad-token writes through stale table rows
without ever touching published data — the superblock-style reservation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .modes import Mode
from .oplog import OP_KV_COMMIT, OP_TRUNCATE, OP_UNLINK, LogEntry, OpLog


class KVPoolFullError(Exception):
    pass


@dataclass(frozen=True)
class KVGeometry:
    """Pool geometry. page_tokens defaults to 128 = VREG lane width so a
    page is one hardware tile deep (DESIGN.md §7)."""

    num_pages: int
    page_tokens: int = 128
    max_seqs: int = 64
    pages_per_seq: int = 256  # page-table row width (max 32k tokens @128)

    @property
    def max_tokens_per_seq(self) -> int:
        return self.page_tokens * self.pages_per_seq


@dataclass
class _Seq:
    sid: int
    length: int = 0                      # tokens
    pages: List[int] = field(default_factory=list)  # physical page ids, in order
    committed_pages: int = 0             # pages published (relinkled) so far
    mode: Mode = Mode.POSIX              # per-sequence consistency mode


@dataclass(frozen=True)
class SeqSnapshot:
    """A sequence's metadata at snapshot time (DESIGN.md §12): enough to
    rebuild the extent map on ANOTHER controller once the page BYTES have
    been carried over.  ``pages`` are physical ids on the SOURCE pool —
    the restore allocates fresh pages on the target and the engine copies
    bytes between them; the snapshot itself is metadata-only."""
    length: int                          # tokens at capture
    committed_pages: int                 # published pages at capture
    mode: Mode                           # the sequence's consistency mode
    pages: Tuple[int, ...]               # live source pages (ceil(len/pt))


class PagedKVCache:
    """Host-side metadata controller for one layer-group's KV pool.

    Thread-safe; all methods are metadata-only and O(pages touched).
    Device mirrors: ``page_table()`` and ``seq_lens()`` return int32 numpy
    arrays to be shipped (or donated) to the compiled step function.
    """

    def __init__(self, geom: KVGeometry, *, mode: Mode = Mode.POSIX,
                 oplog: Optional[OpLog] = None) -> None:
        self.geom = geom
        # ``mode`` is the DEFAULT for new sequences; each sequence carries
        # its own mode (paper §3.2: concurrent U-Split instances in
        # different modes over one volume, never interfering).  A STRICT
        # sequence's commits are logged; POSIX/SYNC neighbors on the same
        # pool pay nothing for them.
        self.mode = mode
        self.oplog = oplog
        # page 0 is the reserved null page: zero table entries mean
        # "unallocated", and pad-token writes routed there touch nothing live
        self._free: deque[int] = deque(range(1, geom.num_pages))
        self._refcount = np.zeros(geom.num_pages, dtype=np.int32)
        self._seqs: Dict[int, _Seq] = {}
        self._free_sids: deque[int] = deque(range(geom.max_seqs))
        self._lock = threading.Lock()
        # device mirrors (kept hot; shipped as-is to jitted steps)
        self._page_table = np.zeros((geom.max_seqs, geom.pages_per_seq),
                                    dtype=np.int32)
        self._seq_lens = np.zeros(geom.max_seqs, dtype=np.int32)
        # stats (the serving-plane analogues of StoreStats); all plain int
        # attributes so the obs registry can read them lazily at snapshot
        # time (repro.obs.attach_serving) — zero hot-path cost
        self.pages_relinked = 0     # metadata-only publishes
        self.pages_copied = 0       # CoW copies (partial-page forks)
        self.pages_allocated = 0    # fresh allocations (prefix hits avoid these)
        self.pages_adopted = 0      # shared via prefix-cache attach
        self.pages_freed = 0        # returned to the free list (in_use =
                                    # allocated - freed, the pool gauge)
        self.pins_taken = 0         # cache-owned refcount pins (pin_page)
        self.pad_fallbacks = 0      # over-reserve shortfalls: pad tokens
                                    # routed to the null page instead
        self.alloc_failures = 0
        self.persist_ns = 0         # wall ns inside oplog publishes (the
                                    # ledger's persistence component)

    # ------------------------------------------------------------- allocation

    def _alloc_page(self) -> int:
        if not self._free:
            self.alloc_failures += 1
            raise KVPoolFullError("KV page pool exhausted")
        p = self._free.popleft()
        self._refcount[p] = 1
        self.pages_allocated += 1
        return p

    def _release_page(self, p: int) -> None:
        self._refcount[p] -= 1
        if self._refcount[p] == 0:
            self._free.append(p)
            self.pages_freed += 1

    @property
    def num_free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pool occupancy gauge; equals pages_allocated - pages_freed by
        construction (tests/test_obs.py holds this across interleavings)."""
        with self._lock:
            return self.geom.num_pages - 1 - len(self._free)

    # ------------------------------------------------------------- sequence ops

    def create_seq(self, mode: Optional[Mode] = None) -> int:
        """New sequence in consistency mode ``mode`` (default: the
        controller default).  Sequences in different modes coexist on one
        pool — mode is consulted per-sequence at every publish, so a
        STRICT neighbor's oplog traffic never taxes a POSIX one."""
        with self._lock:
            if not self._free_sids:
                raise KVPoolFullError("no free sequence slots")
            sid = self._free_sids.popleft()
            self._seqs[sid] = _Seq(sid, mode=self.mode if mode is None
                                   else mode)
            self._seq_lens[sid] = 0
            return sid

    def free_seq(self, sid: int) -> None:
        with self._lock:
            seq = self._seqs.pop(sid)
            # tombstone BEFORE releasing: sids and pages are both reused,
            # so without it replay would resurrect this sequence's extents
            # over pages since handed to live sequences
            self._log_ctl(seq, OP_UNLINK, 0)
            for p in seq.pages:
                self._release_page(p)
            self._page_table[sid, :] = 0
            self._seq_lens[sid] = 0
            self._free_sids.append(sid)

    def ensure_capacity(self, sid: int, new_len: int) -> List[int]:
        """Reserve staging pages so the sequence can grow to ``new_len``
        tokens.  Returns newly-allocated page ids.  This is the metadata
        operation; it happens once per page_tokens tokens, not per token —
        the serving-plane version of 'metadata ops are rare'."""
        with self._lock:
            return self._reserve_locked(self._seqs[sid], new_len)

    def _reserve_locked(self, seq: _Seq, new_len: int) -> List[int]:
        g = self.geom
        if new_len > g.max_tokens_per_seq:
            raise KVPoolFullError(f"sequence exceeds {g.max_tokens_per_seq} tokens")
        need = -(-new_len // g.page_tokens)  # ceil
        added: List[int] = []
        while len(seq.pages) < need:
            p = self._alloc_page()
            self._page_table[seq.sid, len(seq.pages)] = p
            seq.pages.append(p)
            added.append(p)
        return added

    def pages_needed(self, sid: int, new_len: int) -> int:
        """Staging pages a growth to ``new_len`` would have to allocate
        (the engine's admission/backpressure check)."""
        with self._lock:
            seq = self._seqs[sid]
            return max(0, -(-new_len // self.geom.page_tokens) - len(seq.pages))

    def append_tokens(self, sid: int, n_tokens: int,
                      *, reserve: Optional[int] = None,
                      publish: bool = True) -> Tuple[List[int], int]:
        """Bulk chunk append: reserve staging pages for the ``n_tokens``
        appended (hard — raises on exhaustion) and BEST-EFFORT up to
        ``reserve`` tokens so a fixed-shape chunk's pad positions land in
        allocated staging slots; when the pool can't spare the extra page,
        pads simply route through zero table entries to the null page, so
        the over-reserve is an optimization, never a safety requirement.
        Advances the length by ``n_tokens`` and (with ``publish=True``)
        COMMITs every newly-full page — one metadata publish (+ one 64 B
        oplog entry in STRICT mode) per page.  With chunk == page_tokens a
        full prefill chunk is exactly one publish (the chunk/page
        invariant, DESIGN.md §3.4).

        ``publish=False`` STAGES the tokens without committing — the
        speculative-decode lane: provisional tokens live in staging pages
        only (the SPFS fast-tier absorb), and the caller publishes the
        verified prefix afterwards via ``commit(sid, upto_len=...)``, so a
        crash mid-speculation can never replay an unverified extent.
        Returns (newly-allocated page ids, pages published)."""
        g = self.geom
        with self._lock:
            seq = self._seqs[sid]
            new_len = seq.length + n_tokens
            added = self._reserve_locked(seq, new_len)
            cap = min(max(new_len, seq.length + (reserve or n_tokens)),
                      g.max_tokens_per_seq)
            desired = -(-cap // g.page_tokens)
            while len(seq.pages) < desired and self._free:
                p = self._alloc_page()
                self._page_table[sid, len(seq.pages)] = p
                seq.pages.append(p)
                added.append(p)
            # over-reserve shortfall: the chunk's pad positions will route
            # through zero table entries to the null page (harmless by
            # construction, but worth counting — it flags pool pressure)
            self.pad_fallbacks += desired - len(seq.pages)
            seq.length = new_len
            self._seq_lens[sid] = new_len
            return added, (self._commit_locked(seq) if publish else 0)

    def advance(self, sid: int, n_tokens: int = 1) -> None:
        """Record that n tokens were appended (the device scatter happened
        inside the compiled step).  Publishes filled pages (relink)."""
        with self._lock:
            seq = self._seqs[sid]
            seq.length += n_tokens
            self._seq_lens[sid] = seq.length
            self._commit_locked(seq)

    def commit(self, sid: int, *, upto_len: Optional[int] = None) -> int:
        """Publish every newly-full page of ``sid`` (relink: metadata-only;
        no data moves).  ``upto_len`` bounds the publish to pages wholly
        inside the first ``upto_len`` tokens — the speculative-decode
        verify step publishes exactly the ACCEPTED extent this way, before
        rolling the rejected tail back.  Returns pages published."""
        with self._lock:
            return self._commit_locked(self._seqs[sid], upto_len)

    def _commit_locked(self, seq: _Seq, upto_len: Optional[int] = None,
                       ) -> int:
        n_tok = seq.length if upto_len is None else min(seq.length, upto_len)
        full = n_tok // self.geom.page_tokens
        n = full - seq.committed_pages
        if n <= 0:
            return 0
        for idx in range(seq.committed_pages, full):
            self._log_commit(seq, idx)
        self.pages_relinked += n
        seq.committed_pages = full
        return n

    def _log_commit(self, seq: _Seq, page_idx: int) -> None:
        """STRICT sequences: one pre-allocated 64 B log entry per published
        page (1 cacheline store + 1 fence) — crash recovery replays these to
        reconstruct exactly the committed extent map.  Per-SEQUENCE mode:
        a POSIX/SYNC sequence publishes for free."""
        if self.oplog is None or not seq.mode.logs_ops:
            return
        t0 = time.perf_counter_ns()
        self.oplog.append(LogEntry(
            op=OP_KV_COMMIT, mode=int(seq.mode),
            seqno=self.oplog.next_seqno(), inode=seq.sid, offset=page_idx,
            length=self.geom.page_tokens, staging_addr=seq.pages[page_idx],
            aux1=seq.length))
        self.persist_ns += time.perf_counter_ns() - t0

    def _log_ctl(self, seq: _Seq, op: int, keep_pages: int) -> None:
        """Unlink/truncate tombstones: replay must not resurrect extents of
        freed (or rolled-back) sequences whose sid/pages were reused."""
        if self.oplog is None or not seq.mode.logs_ops:
            return
        t0 = time.perf_counter_ns()
        self.oplog.append(LogEntry(
            op=op, mode=int(seq.mode), seqno=self.oplog.next_seqno(),
            inode=seq.sid, offset=keep_pages, length=0, staging_addr=0))
        self.persist_ns += time.perf_counter_ns() - t0

    def seq_mode(self, sid: int) -> Mode:
        with self._lock:
            return self._seqs[sid].mode

    def committed_extents(self, sid: int) -> Dict[int, int]:
        """The published extent map: logical page index -> physical page."""
        with self._lock:
            seq = self._seqs[sid]
            return {i: seq.pages[i] for i in range(seq.committed_pages)}

    def seq_length(self, sid: int) -> int:
        with self._lock:
            return self._seqs[sid].length

    # ------------------------------------------------------------- zero-copy fork

    def fork(self, parent_sid: int) -> int:
        """Beam/speculative fork: share the pages holding DATA by refcount
        (the hard-link analogue).  The last, partially-filled page is
        copied on the NEXT append by whichever branch appends first (CoW) —
        that copy is the partial-block-copy analogue and the only data
        movement.  Over-reserved staging pages BEYOND the tail hold no
        data and stay parent-private: sharing them would let both branches
        scatter into one physical page with no CoW ever privatizing it."""
        with self._lock:
            if not self._free_sids:
                raise KVPoolFullError("no free sequence slots")
            parent = self._seqs[parent_sid]
            sid = self._free_sids.popleft()
            n_live = -(-parent.length // self.geom.page_tokens)
            child = _Seq(sid, length=parent.length,
                         pages=list(parent.pages[:n_live]),
                         committed_pages=parent.committed_pages,
                         mode=parent.mode)
            for p in child.pages:
                self._refcount[p] += 1
            self._seqs[sid] = child
            self._page_table[sid, : len(child.pages)] = child.pages
            self._page_table[sid, len(child.pages):] = 0
            self._seq_lens[sid] = child.length
            # the hard-link publish is itself logged: replay after a crash
            # reconstructs the child's shared extents too
            for idx in range(child.committed_pages):
                self._log_commit(child, idx)
            return sid

    def adopt_prefix(self, sid: int, pages: List[int]) -> int:
        """Prefix-cache attach: start an EMPTY sequence on a chain of
        already-published full pages (refcounted hard links — the same
        sharing ``fork`` uses, minus the CoW tail: adopted pages are all
        FULL, so the adopter's first append opens a fresh page and can
        never scribble on shared bytes).  The adopted extents are logged
        under the ADOPTER's mode, so a STRICT session's crash replay
        reconstructs its shared prefix too.  Returns tokens adopted.

        The all-device special case of the staged protocol below: with no
        host-resident links there is nothing in flight, so the publish
        happens immediately."""
        n_tok, fresh = self.adopt_prefix_staged(sid, list(pages))
        assert not fresh
        self.finish_adopt(sid)
        return n_tok

    def adopt_prefix_staged(self, sid: int,
                            pages: List[Optional[int]],
                            ) -> Tuple[int, List[Tuple[int, int]]]:
        """Tiered attach (DESIGN.md §8a): adopt a chain whose pages may be
        HOST-resident.  ``pages[i] is None`` marks a host link — a fresh
        device page is reserved for it here, to be filled by an async H2D
        promotion the engine dispatches later.  Device links hard-link as
        in ``adopt_prefix``.

        Publish ordering: only the LEADING all-device run is committed
        (and, for STRICT adopters, logged) now; everything at or past the
        first reserved page stays unpublished until ``finish_adopt`` —
        the page-table flip — runs after the copies are enqueued.  A
        crash between stage and flip therefore replays to a committed
        PREFIX of the chain, never to an extent whose bytes were still in
        flight.  Returns (tokens adopted, [(logical idx, reserved page)]).
        """
        g = self.geom
        with self._lock:
            seq = self._seqs[sid]
            if seq.length or seq.pages:
                raise ValueError("adopt_prefix requires a fresh sequence")
            if len(pages) > g.pages_per_seq:
                raise KVPoolFullError("prefix longer than a page-table row")
            n_fresh = sum(1 for p in pages if p is None)
            if n_fresh > len(self._free):
                self.alloc_failures += 1
                raise KVPoolFullError(
                    f"need {n_fresh} pages for promotion, "
                    f"{len(self._free)} free")
            for p in pages:
                if p is not None and self._refcount[p] <= 0:
                    raise ValueError(f"page {p} is free; stale prefix chain")
            # validated: no failure past this point may leave partial state
            fresh: List[Tuple[int, int]] = []
            phys: List[int] = []
            for idx, p in enumerate(pages):
                if p is None:
                    p = self._alloc_page()
                    fresh.append((idx, p))
                else:
                    self._refcount[p] += 1
                    self.pages_adopted += 1
                phys.append(p)
            seq.pages = phys
            seq.length = len(phys) * g.page_tokens
            self._page_table[sid, :len(phys)] = phys
            self._seq_lens[sid] = seq.length
            # commit (and log) only the leading hard-linked run; the rest
            # publishes at the flip
            lead = fresh[0][0] if fresh else len(phys)
            seq.committed_pages = lead
            for idx in range(lead):
                self._log_commit(seq, idx)
            return seq.length, fresh

    def finish_adopt(self, sid: int) -> int:
        """The staged adoption's page-table flip: publish (commit + oplog
        under the adopter's mode) every page past the leading run, once
        the engine has enqueued the H2D copies that fill the reserved
        pages.  Idempotent; returns pages published."""
        with self._lock:
            return self._commit_locked(self._seqs[sid])

    # ------------------------------------------------------------- session snapshot / restore

    def snapshot_seq(self, sid: int) -> SeqSnapshot:
        """Capture a sequence's metadata for failure-atomic migration
        (DESIGN.md §12).  Read-only and O(pages): the caller pairs it with
        a D2H copy of the live pages' bytes.  Taken between engine steps,
        so staged-but-unverified speculative extents are never present
        (verify + commit happen within the step)."""
        with self._lock:
            seq = self._seqs[sid]
            n_live = -(-seq.length // self.geom.page_tokens)
            return SeqSnapshot(length=seq.length,
                               committed_pages=min(seq.committed_pages,
                                                   n_live),
                               mode=seq.mode,
                               pages=tuple(seq.pages[:n_live]))

    def restore_seq_staged(self, snap: SeqSnapshot) -> Tuple[int, List[int]]:
        """STAGE a snapshot restore on this controller: allocate a fresh
        sid + fresh pages and wire them into the extent map and device
        mirrors — but publish NOTHING (committed_pages stays 0, no oplog
        entries).  The caller copies the snapshot's page bytes into the
        returned pages, then flips via ``restore_seq``.  The msync/relink
        discipline of ``adopt_prefix_staged``: a crash between stage and
        flip replays to the PRE-restore committed state — never to a torn
        session whose bytes were still in flight.  Returns (sid, pages)."""
        g = self.geom
        with self._lock:
            n = -(-snap.length // g.page_tokens)
            if not self._free_sids:
                raise KVPoolFullError("no free sequence slots")
            if n > g.pages_per_seq:
                raise KVPoolFullError("snapshot longer than a page-table row")
            if n > len(self._free):
                self.alloc_failures += 1
                raise KVPoolFullError(
                    f"need {n} pages to restore, {len(self._free)} free")
            sid = self._free_sids.popleft()
            seq = _Seq(sid, length=snap.length, mode=snap.mode)
            for i in range(n):
                p = self._alloc_page()
                seq.pages.append(p)
                self._page_table[sid, i] = p
            self._seqs[sid] = seq
            self._seq_lens[sid] = snap.length
            return sid, list(seq.pages)

    def restore_seq(self, sid: int) -> int:
        """The staged restore's FLIP: publish every full page of the
        restored sequence in one critical section — commits plus, for a
        STRICT sequence, one OP_KV_COMMIT entry per page under its own
        mode.  Idempotent (mirrors ``finish_adopt``).  The partial tail
        page stays staging, exactly as it was on the source.  Returns
        pages published."""
        with self._lock:
            return self._commit_locked(self._seqs[sid])

    # ------------------------------------------------------------- page pins

    def pin_page(self, p: int) -> None:
        """Take a refcount on a published page so it outlives the sequence
        that wrote it (the prefix cache's hold — a hard link owned by the
        cache itself)."""
        with self._lock:
            if self._refcount[p] <= 0:
                raise ValueError(f"cannot pin free page {p}")
            self._refcount[p] += 1
            self.pins_taken += 1

    def page_refcount(self, p: int) -> int:
        """Current reference count (live sequences + cache pins) — lets
        the prefix cache tell an idle pin (count 1: eviction frees the
        page) from a shared one (eviction frees nothing)."""
        with self._lock:
            return int(self._refcount[p])

    def unpin_page(self, p: int) -> None:
        """Drop a pin; the page returns to the free list once no sequence
        (and no pin) references it.  Unpinning an already-free page is a
        caller bookkeeping bug and raises — decrementing past zero would
        silently free a page a live sequence still maps."""
        with self._lock:
            if self._refcount[p] <= 0:
                raise ValueError(f"cannot unpin free page {p}")
            self._release_page(p)

    def prepare_append(self, sid: int, n_tokens: int = 1) -> Optional[tuple[int, int]]:
        """Called before appending to a sequence whose tail page may be
        shared: if so, allocate a private copy and return (src_page,
        dst_page) so the engine can schedule the device-side page copy.
        Returns None when no copy is needed (the common case)."""
        with self._lock:
            return self._cow_tail_locked(self._seqs[sid])

    def _cow_tail_locked(self, seq: _Seq) -> Optional[tuple[int, int]]:
        """CoW the tail page when it is PARTIAL and SHARED (refcount > 1:
        fork-shared, trie-adopted, or cache-pinned): the next append would
        otherwise scatter through the shared physical page.  Returns the
        (src, dst) pair for the device-side copy, or None."""
        g = self.geom
        tail_idx = seq.length // g.page_tokens
        if seq.length % g.page_tokens == 0:
            return None  # next token starts a fresh page
        if tail_idx >= len(seq.pages):
            return None
        tail = seq.pages[tail_idx]
        if self._refcount[tail] == 1:
            return None
        new = self._alloc_page()
        self._release_page(tail)
        seq.pages[tail_idx] = new
        self._page_table[seq.sid, tail_idx] = new
        self.pages_copied += 1
        return (tail, new)

    # ------------------------------------------------------------- rollback (spec. decode)

    def rollback(self, sid: int, new_len: int) -> Optional[tuple[int, int]]:
        """Speculative-decode rejection: shrink to new_len. Metadata-only —
        pages past the new tail are released, no data moves (the truncate-
        via-relink analogue).

        Two extra duties beyond the shrink:
          * STRICT sequences log an ``OP_TRUNCATE`` tombstone on ANY
            shrink, so crash replay reconstructs exactly the accepted
            extent even when sids/pages are later reused;
          * a kept-but-partial tail page that is SHARED (trie-adopted,
            pinned, or fork-shared) is CoW'd here — the re-append after a
            rollback must never write through a shared page.  Returns the
            (src, dst) page pair for the device-side copy (None when no
            copy was needed)."""
        g = self.geom
        with self._lock:
            seq = self._seqs[sid]
            assert new_len <= seq.length
            shrank = new_len < seq.length
            keep = -(-new_len // g.page_tokens) if new_len else 0
            for p in seq.pages[keep:]:
                self._release_page(p)
            self._page_table[sid, keep:] = 0
            seq.pages = seq.pages[:keep]
            seq.length = new_len
            # committed == published FULL pages: a kept-but-now-partial tail
            # page drops back to staging and is recommitted when it refills
            full = new_len // g.page_tokens
            if shrank:
                self._log_ctl(seq, OP_TRUNCATE, full)
            seq.committed_pages = min(seq.committed_pages, full)
            self._seq_lens[sid] = new_len
            return self._cow_tail_locked(seq)

    # ------------------------------------------------------------- device mirrors

    def page_table(self) -> np.ndarray:
        return self._page_table.copy()

    def seq_lens(self) -> np.ndarray:
        return self._seq_lens.copy()

    def live_tokens(self) -> int:
        with self._lock:
            return int(sum(s.length for s in self._seqs.values()))

    def utilization(self) -> float:
        g = self.geom
        with self._lock:
            used = g.num_pages - len(self._free)
        return used / g.num_pages


# ---------------------------------------------------------------- recovery


def replay_kv_commits(entries: Iterable[LogEntry]) -> Dict[int, Dict[int, int]]:
    """Idempotent recovery replay (paper §5.3 applied to the serving plane):
    rebuild each LIVE sequence's COMMITTED extent map {logical page index ->
    physical page} from the operation log.

    ``OP_KV_COMMIT`` publishes an extent; ``OP_UNLINK`` tombstones a freed
    sequence (its sid/pages may have been reused by later entries);
    ``OP_TRUNCATE`` keeps only the first ``offset`` committed pages
    (speculative-decode rollback).  Replay is idempotent by construction —
    re-applying the full log (repeated crashes during recovery) converges
    to the same map; within one pass a later entry for the same (sid, page
    index) wins, which is exactly the CoW-recommit case after a fork's
    partial-tail copy."""
    out: Dict[int, Dict[int, int]] = {}
    for e in entries:
        if e.op == OP_KV_COMMIT:
            out.setdefault(e.inode, {})[e.offset] = e.staging_addr
        elif e.op == OP_UNLINK:
            out.pop(e.inode, None)
        elif e.op == OP_TRUNCATE and e.inode in out:
            out[e.inode] = {i: p for i, p in out[e.inode].items()
                            if i < e.offset}
    return out
