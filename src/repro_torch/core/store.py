"""U-Split: the user-space library file system (paper §3.3-§3.5; a copy
of ``repro.core.store``).

The POSIX-shaped facade applications link against.  Data operations never
trap: reads and overwrites go through the collection-of-mmaps translations,
appends go to pre-allocated staging space, and only metadata operations
(open/close/unlink/rename/fsync's relink) reach K-Split.

Per-mode behaviour (see modes.py):
  POSIX   overwrites in-place (nt stores); appends staged -> relink on fsync.
  SYNC    + fence after every data op; metadata journal commits are fenced.
  STRICT  + overwrites staged too; every data op appends ONE 64 B oplog
          entry + ONE fence; crash recovery replays the oplog.

Staged state is tracked per-inode so two fds over one file see the same
bytes; `dup` shares the offset (paper §3.5 "Handling dup").
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .ksplit import FSError, Inode, KSplit, NoEntError
from .mmap_cache import MmapCache
from .modes import Mode
from .oplog import (OP_APPEND, OP_OVERWRITE, LogEntry, OpLog)
from .pmem import BLOCK_SIZE, PMDevice
from .staging import StagedRange, StagingAllocator
from .volume import Volume


@dataclass
class StagedExtent:
    """Bytes living in a staging file, logically part of target file."""

    file_off: int
    length: int
    ino: int          # staging inode
    staging_off: int
    is_append: bool

    @property
    def file_end(self) -> int:
        return self.file_off + self.length


@dataclass
class FileState:
    ino: int
    name: str
    size: int                   # K-Split (published) size
    logical_size: int           # size including staged appends
    staged: List[StagedExtent] = field(default_factory=list)  # sorted by file_off
    refcount: int = 0


class _FD:
    __slots__ = ("state", "offset", "refs")

    def __init__(self, state: FileState) -> None:
        self.state = state
        self.offset = 0
        self.refs = 1


@dataclass
class StoreStats:
    user_data_ops: int = 0      # served without trapping
    kernel_ops: int = 0
    staged_bytes: int = 0
    relinked_blocks: int = 0
    copied_bytes: int = 0       # partial-block copies during relink
    fsyncs: int = 0
    log_entries: int = 0


class USplit:
    """One application's library file system instance."""

    def __init__(
        self,
        volume: Volume,
        mode: Mode = Mode.POSIX,
        staging_file_bytes: int = 160 * 1024 * 1024,
        staging_prealloc: int = 10,
        staging_background: bool = True,
        map_chunk: int = 2 * 1024 * 1024,
        hugepages: bool = True,
        oplog_slot: Optional[int] = None,
        recover: bool = False,
        stage_appends: bool = True,
        publish_mode: str = "relink",
    ) -> None:
        """``stage_appends=False`` routes appends through the kernel (the
        paper's Fig 3 'split architecture only' ablation); ``publish_mode=
        'copy'`` makes fsync copy staged bytes instead of relinking (the
        '+staging' ablation).  Defaults are full SplitFS."""
        self.volume = volume
        self.device: PMDevice = volume.device
        self.ksplit: KSplit = volume.ksplit
        self.mode = mode
        self.mmaps = MmapCache(self.device, self.ksplit, map_chunk=map_chunk,
                               hugepages=hugepages)
        assert publish_mode in ("relink", "copy")
        self.stage_appends = stage_appends
        self.publish_mode = publish_mode
        self.stats = StoreStats()
        self._lock = threading.RLock()
        self._files: Dict[int, FileState] = {}       # ino -> state
        self._name_cache: Dict[str, int] = {}        # stat()-attribute cache
        self._fds: Dict[int, _FD] = {}
        self._next_fd = 3
        self.oplog: Optional[OpLog] = None
        if mode.logs_ops:
            slot, base, nblk = volume.take_oplog_slot(oplog_slot)
            self.oplog_slot = slot
            self.oplog = volume.oplog_for_slot(slot, on_full=self._on_log_full,
                                               fresh=not recover)
            if recover:
                self._replay_oplog()
        self.staging = StagingAllocator(
            self.ksplit,
            file_bytes=staging_file_bytes,
            prealloc_files=staging_prealloc,
            background=staging_background,
            name_prefix=f".staging.u{id(self) & 0xFFFF}",
        )

    # ===================================================================== open/close

    def open(self, name: str, create: bool = False) -> int:
        with self._lock:
            self.stats.kernel_ops += 1
            try:
                ino = self.ksplit.lookup(name)
            except NoEntError:
                if not create:
                    raise
                ino = self.ksplit.create(name)
            state = self._files.get(ino)
            if state is None:
                # stat() once and cache attributes in user space (paper §3.5)
                inode = self.ksplit.stat(name)
                state = FileState(ino=ino, name=name, size=inode.size,
                                  logical_size=inode.size)
                self._files[ino] = state
                self._name_cache[name] = ino
            state.refcount += 1
            fd = self._next_fd
            self._next_fd += 1
            self._fds[fd] = _FD(state)
            self.device.meter.add("index_op", 2)
            return fd

    def close(self, fd: int) -> None:
        with self._lock:
            f = self._pop_fd(fd)
            f.state.refcount -= 1
            # cached metadata is retained after close (paper §3.5)
            self.device.meter.add("index_op", 1)

    def dup(self, fd: int) -> int:
        with self._lock:
            f = self._fd(fd)
            f.refs += 1
            nfd = self._next_fd
            self._next_fd += 1
            self._fds[nfd] = f  # same object => shared offset (paper §3.5)
            return nfd

    def _fd(self, fd: int) -> _FD:
        try:
            return self._fds[fd]
        except KeyError:
            raise FSError(f"bad fd {fd}") from None

    def _pop_fd(self, fd: int) -> _FD:
        f = self._fd(fd)
        f.refs -= 1
        del self._fds[fd]
        return f

    def lseek(self, fd: int, offset: int, whence: int = 0) -> int:
        with self._lock:
            f = self._fd(fd)
            if whence == 0:
                f.offset = offset
            elif whence == 1:
                f.offset += offset
            elif whence == 2:
                f.offset = f.state.logical_size + offset
            else:
                raise FSError("bad whence")
            return f.offset

    # ===================================================================== reads

    def read(self, fd: int, n: int) -> bytes:
        with self._lock:
            f = self._fd(fd)
            data = self._pread_locked(f.state, f.offset, n)
            f.offset += len(data)
            return data

    def pread(self, fd: int, n: int, offset: int) -> bytes:
        with self._lock:
            f = self._fd(fd)
            return self._pread_locked(f.state, offset, n)

    def _pread_locked(self, st: FileState, offset: int, n: int) -> bytes:
        n = max(0, min(n, st.logical_size - offset))
        if n == 0:
            return b""
        self.stats.user_data_ops += 1
        out = bytearray(n)
        for piece_off, piece_len, ext in self._route(st, offset, n):
            rel = piece_off - offset
            if ext is None:
                self._read_base(st, piece_off, piece_len, out, rel)
            else:
                s_off = ext.staging_off + (piece_off - ext.file_off)
                self._read_via_mmap(ext.ino, s_off, piece_len, out, rel)
        return bytes(out)

    def _read_base(self, st: FileState, offset: int, n: int,
                   out: bytearray, out_off: int) -> None:
        pos = 0
        while pos < n:
            lblk, boff = divmod(offset + pos, BLOCK_SIZE)
            take = min(BLOCK_SIZE - boff, n - pos)
            pblk = self.mmaps.translate(st.ino, lblk)
            if pblk is not None:
                out[out_off + pos : out_off + pos + take] = self.device.read(
                    pblk * BLOCK_SIZE + boff, take
                )
            # holes read as zeros (bytearray is pre-zeroed)
            pos += take

    def _read_via_mmap(self, ino: int, offset: int, n: int,
                       out: bytearray, out_off: int) -> None:
        pos = 0
        while pos < n:
            lblk, boff = divmod(offset + pos, BLOCK_SIZE)
            take = min(BLOCK_SIZE - boff, n - pos)
            pblk = self.mmaps.translate(ino, lblk)
            assert pblk is not None, "staged extent must be mapped"
            out[out_off + pos : out_off + pos + take] = self.device.read(
                pblk * BLOCK_SIZE + boff, take
            )
            pos += take

    def _route(self, st: FileState, offset: int, n: int):
        """Split [offset, offset+n) into (off, len, staged_extent|None) pieces
        by consulting the staged interval list (the collection-of-mmaps
        routing step, paper §3.4 'Reads')."""
        pieces: List[Tuple[int, int, Optional[StagedExtent]]] = []
        pos = offset
        end = offset + n
        idx = bisect.bisect_right([e.file_off for e in st.staged], pos) - 1
        while pos < end:
            ext = None
            nxt = end
            for j in range(max(idx, 0), len(st.staged)):
                e = st.staged[j]
                if e.file_end <= pos:
                    continue
                if e.file_off <= pos:
                    ext = e
                    nxt = min(end, e.file_end)
                else:
                    nxt = min(end, e.file_off)
                break
            pieces.append((pos, nxt - pos, ext))
            pos = nxt
        return pieces

    # ===================================================================== writes

    def write(self, fd: int, data: bytes) -> int:
        with self._lock:
            f = self._fd(fd)
            n = self._pwrite_locked(f.state, data, f.offset)
            f.offset += n
            return n

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        with self._lock:
            f = self._fd(fd)
            return self._pwrite_locked(f.state, data, offset)

    def _pwrite_locked(self, st: FileState, data: bytes, offset: int) -> int:
        n = len(data)
        if n == 0:
            return 0
        self.stats.user_data_ops += 1
        eof = st.logical_size
        if offset >= eof:
            # pure append (holes between eof and offset read back as zeros
            # via staging of the gap — rare; we stage from offset directly)
            self._stage_append(st, data, offset)
        elif offset + n <= eof:
            self._overwrite(st, data, offset)
        else:
            cut = eof - offset
            self._overwrite(st, data[:cut], offset)
            self._stage_append(st, data[cut:], eof)
        if self.mode.syncs_data:
            self.device.fence()
        return n

    # ---- overwrite path ------------------------------------------------------------

    def _overwrite(self, st: FileState, data: bytes, offset: int) -> None:
        """POSIX/SYNC: in-place nt stores through mmap translations.
        STRICT: staged + logged, relinked on fsync (paper §3.4).
        Pieces overlapping existing staged extents are updated in the staging
        file directly in all modes (pre-publish state stays pre-publish)."""
        for piece_off, piece_len, ext in self._route(st, offset, len(data)):
            rel = piece_off - offset
            chunk = data[rel : rel + piece_len]
            if ext is not None:
                s_off = ext.staging_off + (piece_off - ext.file_off)
                self._write_via_mmap(ext.ino, s_off, chunk)
            elif self.mode.atomic_data:
                self._stage_overwrite(st, chunk, piece_off)
            else:
                self._write_in_place(st, chunk, piece_off)

    def _write_in_place(self, st: FileState, data: bytes, offset: int) -> None:
        self._write_via_mmap(st.ino, offset, data)

    def _write_via_mmap(self, ino: int, offset: int, data: bytes) -> None:
        pos = 0
        n = len(data)
        while pos < n:
            lblk, boff = divmod(offset + pos, BLOCK_SIZE)
            take = min(BLOCK_SIZE - boff, n - pos)
            pblk = self.mmaps.translate(ino, lblk)
            if pblk is None:
                # store into a hole: the MMU faults, the kernel allocates
                # (the one data-path case that must trap)
                self.stats.kernel_ops += 1
                self.ksplit.allocate(ino, lblk * BLOCK_SIZE, BLOCK_SIZE)
                pblk = self.mmaps.translate(ino, lblk)
                assert pblk is not None
            self.device.write_data(pblk * BLOCK_SIZE + boff, data[pos : pos + take])
            pos += take

    def _stage_overwrite(self, st: FileState, data: bytes, offset: int) -> None:
        rng = self.staging.take(len(data), phase=offset % BLOCK_SIZE)
        self._write_staged_bytes(rng, data)
        self._insert_staged(st, StagedExtent(offset, len(data), rng.ino,
                                             rng.offset, is_append=False))
        self.stats.staged_bytes += len(data)
        self._log_data_op(OP_OVERWRITE, st, offset, len(data), rng)

    # ---- append path ------------------------------------------------------------------

    def _stage_append(self, st: FileState, data: bytes, offset: int) -> None:
        if not self.stage_appends:
            # Fig 3 ablation: split architecture without staging — appends
            # are metadata ops and go straight to the kernel.
            self.stats.kernel_ops += 1
            self.ksplit.write(st.ino, offset, data)
            st.size = st.logical_size = max(st.logical_size, offset + len(data))
            return
        max_chunk = self.staging.file_bytes
        pos = 0
        while pos < len(data):
            chunk = data[pos : pos + max_chunk]
            off = offset + pos
            rng = self.staging.take(len(chunk), phase=off % BLOCK_SIZE)
            self._write_staged_bytes(rng, chunk)
            self._insert_staged(st, StagedExtent(off, len(chunk), rng.ino,
                                                 rng.offset, is_append=True))
            self.stats.staged_bytes += len(chunk)
            self._log_data_op(OP_APPEND, st, off, len(chunk), rng)
            pos += len(chunk)
        st.logical_size = max(st.logical_size, offset + len(data))

    def _write_staged_bytes(self, rng: StagedRange, data: bytes) -> None:
        pos = 0
        for seg in self.staging.segments_of(rng):
            self.device.write_data(seg.phys_addr, data[pos : pos + seg.length])
            pos += seg.length

    def _insert_staged(self, st: FileState, ext: StagedExtent) -> None:
        """Insert keeping the list sorted & disjoint; coalesce with the
        previous extent when logically AND physically contiguous (so one
        fsync of k sequential appends costs one relink)."""
        keys = [e.file_off for e in st.staged]
        i = bisect.bisect_left(keys, ext.file_off)
        if i > 0:
            prev = st.staged[i - 1]
            if (prev.file_end == ext.file_off and prev.ino == ext.ino
                    and prev.staging_off + prev.length == ext.staging_off
                    and prev.is_append == ext.is_append):
                st.staged[i - 1] = StagedExtent(prev.file_off,
                                                prev.length + ext.length,
                                                prev.ino, prev.staging_off,
                                                prev.is_append)
                return
        st.staged.insert(i, ext)

    def _log_data_op(self, op: int, st: FileState, offset: int, length: int,
                     rng: StagedRange) -> None:
        if self.oplog is None:
            return
        entry = LogEntry(op=op, mode=int(self.mode),
                         seqno=self.oplog.next_seqno(), inode=st.ino,
                         offset=offset, length=length,
                         staging_addr=rng.phys_addr, aux1=rng.ino,
                         aux2=rng.offset)
        self.oplog.append(entry)
        self.stats.log_entries += 1

    # ===================================================================== fsync/relink

    def fsync(self, fd: int) -> None:
        with self._lock:
            f = self._fd(fd)
            self._fsync_state(f.state)

    def _fsync_state(self, st: FileState) -> None:
        self.stats.fsyncs += 1
        self.stats.kernel_ops += 1
        if not st.staged:
            self.ksplit.fsync(st.ino)
            return
        staged, st.staged = st.staged, []
        new_size = max(st.logical_size, st.size)
        if self.publish_mode == "copy":
            for k, ext in enumerate(staged):
                last = k == len(staged) - 1
                self._publish_extent(st, ext, new_size if last else None)
        else:
            # ALL of this fsync's relinks commit in ONE jbd2 transaction
            # (one ioctl, one commit — how ext4 batches a handle's updates);
            # partial-block copies run after the swaps so append chains that
            # split a block publish correctly.
            swap_ops = []
            copy_ops = []
            # staging blocks referenced by each extent: a tail-block swap
            # must not carry away bytes another pending extent still needs
            blocks_of = []
            for ext in staged:
                lo = ext.staging_off // BLOCK_SIZE
                hi = (ext.staging_off + ext.length - 1) // BLOCK_SIZE
                blocks_of.append({(ext.ino, l) for l in range(lo, hi + 1)})
            for i, ext in enumerate(staged):
                others = set().union(*(b for j, b in enumerate(blocks_of)
                                       if j != i)) if len(staged) > 1 else set()
                self._plan_publish(st, ext, swap_ops, copy_ops, others)
            if swap_ops or new_size > self.ksplit.inodes[st.ino].size:
                self.ksplit.relink_many(swap_ops, new_dst_size=new_size,
                                        dst_ino=st.ino)
            for (src_ino, src_lblk, _, dst_lblk, n) in swap_ops:
                self.mmaps.transfer(src_ino, src_lblk, st.ino, dst_lblk, n)
                self.stats.relinked_blocks += n
            for ext, file_off, n in copy_ops:
                self._copy_staged_to_base(st, ext, file_off, n)
        st.size = new_size
        st.logical_size = max(st.logical_size, new_size)

    def _plan_publish(self, st: FileState, ext: StagedExtent,
                      swap_ops: list, copy_ops: list,
                      other_blocks: Optional[set] = None) -> None:
        """Split one staged extent into block swaps + partial-block copies
        (paper §3.3 relink rule); execution is batched by _fsync_state.

        ``other_blocks``: staging (ino, lblk) pairs referenced by OTHER
        pending extents — a partial tail block shared with one of them must
        be copied, not swapped (swapping would carry their bytes away)."""
        other_blocks = other_blocks or set()
        if ext.staging_off % BLOCK_SIZE != ext.file_off % BLOCK_SIZE:
            pos = ext.file_off
            while pos < ext.file_end:
                take = min(BLOCK_SIZE - pos % BLOCK_SIZE, ext.file_end - pos)
                copy_ops.append((ext, pos, take))
                pos += take
            return
        pos = ext.file_off
        end = ext.file_end
        if pos % BLOCK_SIZE:
            head = min(end - pos, BLOCK_SIZE - pos % BLOCK_SIZE)
            copy_ops.append((ext, pos, head))
            pos += head
        if pos >= end:
            return
        body_blocks = (end - pos) // BLOCK_SIZE
        tail = (end - pos) % BLOCK_SIZE
        tail_lblk = (pos + body_blocks * BLOCK_SIZE) // BLOCK_SIZE
        tail_exists = (self.ksplit.inodes[st.ino].extents.lookup_block(tail_lblk)
                       is not None)
        src_lblk = (ext.staging_off + (pos - ext.file_off)) // BLOCK_SIZE
        tail_src_blk = (ext.ino, src_lblk + body_blocks)
        tail_shared = tail_src_blk in other_blocks
        swap_blocks = body_blocks + (
            1 if tail and not tail_exists and not tail_shared else 0)
        if swap_blocks:
            swap_ops.append((ext.ino, src_lblk, st.ino, pos // BLOCK_SIZE,
                             swap_blocks))
        if tail and (tail_exists or tail_shared):
            copy_ops.append((ext, pos + body_blocks * BLOCK_SIZE, tail))

    def _publish_extent(self, st: FileState, ext: StagedExtent,
                        new_size: Optional[int]) -> None:
        """Relink one staged extent into the target file: metadata-only for
        block-aligned coverage, byte copies for partial head/tail (paper
        §3.3 'Relink')."""
        if self.publish_mode == "copy":
            # Fig 3 ablation: staging without relink — fsync copies data.
            self.stats.kernel_ops += 1
            self.device.meter.add("trap", 1)
            self._publish_by_copy(st, ext, new_size)
            return
        if ext.staging_off % BLOCK_SIZE != ext.file_off % BLOCK_SIZE:
            # phase mismatch (shouldn't happen on our paths): full copy
            self._publish_by_copy(st, ext, new_size)
            return
        pos = ext.file_off
        end = ext.file_end
        # head partial block: copy into the target's existing block
        if pos % BLOCK_SIZE:
            head = min(end - pos, BLOCK_SIZE - pos % BLOCK_SIZE)
            self._copy_staged_to_base(st, ext, pos, head)
            pos += head
        if pos >= end:
            if new_size is not None:
                self.ksplit.set_size(st.ino, new_size)
            return
        # aligned body: full blocks are swapped; the final partial block is
        # swapped too when the target block doesn't exist yet (pure append
        # tail — bytes past EOF are garbage but unreadable), else copied.
        body_blocks = (end - pos) // BLOCK_SIZE
        tail = (end - pos) % BLOCK_SIZE
        tail_lblk = (pos + body_blocks * BLOCK_SIZE) // BLOCK_SIZE
        tail_exists = (self.ksplit.inodes[st.ino].extents.lookup_block(tail_lblk)
                       is not None)
        swap_blocks = body_blocks + (1 if tail and not tail_exists else 0)
        if swap_blocks:
            src_lblk = (ext.staging_off + (pos - ext.file_off)) // BLOCK_SIZE
            self.ksplit.relink_blocks(ext.ino, src_lblk, st.ino,
                                      pos // BLOCK_SIZE, swap_blocks,
                                      new_dst_size=new_size)
            self.mmaps.transfer(ext.ino, src_lblk, st.ino, pos // BLOCK_SIZE,
                                swap_blocks)
            self.stats.relinked_blocks += swap_blocks
        elif new_size is not None:
            self.ksplit.set_size(st.ino, new_size)
        if tail and tail_exists:
            self._copy_staged_to_base(st, ext, pos + body_blocks * BLOCK_SIZE, tail)

    def _publish_by_copy(self, st: FileState, ext: StagedExtent,
                         new_size: Optional[int]) -> None:
        # allocate the whole destination range in ONE journal transaction
        # (jbd2 batches a single write's metadata), then copy bytes
        self.ksplit.allocate(st.ino, ext.file_off, ext.length)
        pos = ext.file_off
        while pos < ext.file_end:
            take = min(BLOCK_SIZE - pos % BLOCK_SIZE, ext.file_end - pos)
            self._copy_staged_to_base(st, ext, pos, take)
            pos += take
        if new_size is not None:
            self.ksplit.set_size(st.ino, new_size)

    def _copy_staged_to_base(self, st: FileState, ext: StagedExtent,
                             file_off: int, n: int) -> None:
        """Byte copy staging->target for partial blocks. Allocates the target
        block if missing (append into a shared partial block)."""
        s_off = ext.staging_off + (file_off - ext.file_off)
        inode = self.ksplit.inodes[st.ino]
        lblk = file_off // BLOCK_SIZE
        if inode.extents.lookup_block(lblk) is None:
            self.ksplit.allocate(st.ino, lblk * BLOCK_SIZE, BLOCK_SIZE,
                                 charge_trap=False)
        data = bytes(self._read_staging_raw(ext.ino, s_off, n))
        self._write_via_mmap(st.ino, file_off, data)
        self.stats.copied_bytes += n

    def _read_staging_raw(self, ino: int, offset: int, n: int) -> bytes:
        out = bytearray(n)
        self._read_via_mmap(ino, offset, n, out, 0)
        return bytes(out)

    # ===================================================================== metadata ops

    def unlink(self, name: str) -> None:
        with self._lock:
            self.stats.kernel_ops += 1
            ino = self._name_cache.get(name)
            if ino is None:
                ino = self.ksplit.lookup(name)
            # drop mmaps + cached metadata (paper §3.5: this is why unlink
            # is the most expensive call in Table 6)
            self.mmaps.drop_file(ino)
            st = self._files.pop(ino, None)
            if st is not None:
                st.staged.clear()
            self._name_cache.pop(name, None)
            self.ksplit.unlink(name)

    def rename(self, src: str, dst: str) -> None:
        with self._lock:
            self.stats.kernel_ops += 1
            self.ksplit.rename(src, dst)
            ino = self._name_cache.pop(src, None)
            if ino is not None:
                self._name_cache[dst] = ino
                if ino in self._files:
                    self._files[ino].name = dst

    def ftruncate(self, fd: int, size: int) -> None:
        with self._lock:
            f = self._fd(fd)
            st = f.state
            self.stats.kernel_ops += 1
            # publish staged state first, then truncate in the kernel
            self._fsync_state(st)
            self.ksplit.truncate(st.ino, size)
            st.size = st.logical_size = size

    def stat_size(self, name: str) -> int:
        with self._lock:
            ino = self._name_cache.get(name)
            if ino is not None and ino in self._files:
                self.device.meter.add("index_op", 1)  # served from user space
                return self._files[ino].logical_size
            self.stats.kernel_ops += 1
            return self.ksplit.stat(name).size

    # ===================================================================== recovery

    def _on_log_full(self) -> None:
        """Log full => checkpoint: relink all open files' staged state, then
        the caller zeroes the log (paper §3.3)."""
        for st in list(self._files.values()):
            if st.staged:
                self._fsync_state(st)

    def _replay_oplog(self) -> int:
        """Strict-mode crash recovery: replay valid 64 B entries on top of
        K-Split recovery.  Idempotent: a staged source that already moved is
        skipped (paper §5.3)."""
        assert self.oplog is not None
        n = 0
        for e in self.oplog.scan():
            if e.op not in (OP_APPEND, OP_OVERWRITE):
                continue
            target = self.ksplit.inodes.get(e.inode)
            staging = self.ksplit.inodes.get(e.aux1)
            if target is None or staging is None:
                continue
            if not (staging.flags & Inode.IS_STAGING):
                continue
            # staged source must still own its blocks (else already published)
            first_lblk = e.aux2 // BLOCK_SIZE
            if staging.extents.lookup_block(first_lblk) is None:
                # an earlier entry's whole-block relink may have carried this
                # entry's bytes with it: if the target now owns the full
                # range, only the i_size record is missing — repair it
                lo = e.offset // BLOCK_SIZE
                hi = (e.offset + e.length - 1) // BLOCK_SIZE
                covered = all(target.extents.lookup_block(l) is not None
                              for l in range(lo, hi + 1))
                if covered and e.offset + e.length > target.size:
                    self.ksplit.set_size(e.inode, e.offset + e.length)
                continue
            st = FileState(ino=e.inode, name=f"<ino{e.inode}>",
                           size=target.size, logical_size=target.size)
            ext = StagedExtent(e.offset, e.length, e.aux1, e.aux2,
                               is_append=(e.op == OP_APPEND))
            new_size = max(target.size, e.offset + e.length)
            self._publish_extent(st, ext, new_size)
            n += 1
        self.oplog.clear()
        return n

    # ===================================================================== convenience

    def write_file(self, name: str, data: bytes) -> None:
        fd = self.open(name, create=True)
        self.write(fd, data)
        self.fsync(fd)
        self.close(fd)

    def read_file(self, name: str) -> bytes:
        fd = self.open(name)
        size = self._fds[fd].state.logical_size
        data = self.pread(fd, size, 0)
        self.close(fd)
        return data
