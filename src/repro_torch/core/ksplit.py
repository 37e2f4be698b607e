"""K-Split: the kernel file-system analogue (the paper's ext4 DAX role;
a copy of ``repro.core.ksplit``).

K-Split owns *all metadata*: the inode table, the namespace, block
allocation, and the journal that makes every metadata mutation atomic.
U-Split (store.py) routes metadata operations here and pays the full
"kernel" cost for them — that asymmetry (cheap data plane, journaled
metadata plane) is the paper's central design bet.

Durability model (a real log+checkpoint FS design):
  * every mutation is journaled as a logical redo record;
  * a metadata *checkpoint* serializes the whole inode table + namespace to
    a reserved home region (with CRC), after which the journal resets;
  * recovery = load last checkpoint, replay journal, rebuild the free list
    from the union of live extents (free state is derived, never logged).

Costs: each public entry point charges a kernel ``trap`` plus the relevant
ext4 path constants; the journal's own PM writes/fences are emitted by
journal.py. This is what makes metadata ops *measurably* slower than the
user-space data path, as in the paper's Table 6.
"""

from __future__ import annotations

import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .extents import ExtentMap, move_extents
from .journal import Journal
from .pagepool import PagePool
from .pmem import BLOCK_SIZE, PMDevice


class FSError(Exception):
    pass


class NoEntError(FSError):
    pass


class ExistsError(FSError):
    pass


# ---------------------------------------------------------------------------
# Journal record encoding (logical redo records)
# ---------------------------------------------------------------------------

R_CREATE, R_UNLINK, R_RENAME, R_SIZE, R_MAP, R_UNMAP, R_SWAP, R_LINKCNT = range(1, 9)


def _rec_create(ino: int, name: str, flags: int) -> bytes:
    nb = name.encode()
    return struct.pack("<BQIH", R_CREATE, ino, flags, len(nb)) + nb


def _rec_unlink(ino: int, name: str) -> bytes:
    nb = name.encode()
    return struct.pack("<BQH", R_UNLINK, ino, len(nb)) + nb


def _rec_rename(src: str, dst: str) -> bytes:
    sb, db = src.encode(), dst.encode()
    return struct.pack("<BHH", R_RENAME, len(sb), len(db)) + sb + db


def _rec_size(ino: int, size: int) -> bytes:
    return struct.pack("<BQQ", R_SIZE, ino, size)


def _rec_map(ino: int, lblk: int, pblk: int) -> bytes:
    return struct.pack("<BQQQ", R_MAP, ino, lblk, pblk)


def _rec_unmap(ino: int, lblk: int) -> bytes:
    return struct.pack("<BQQ", R_UNMAP, ino, lblk)


def _rec_swap(src_ino: int, src_lblk: int, dst_ino: int, dst_lblk: int, n: int) -> bytes:
    return struct.pack("<BQQQQQ", R_SWAP, src_ino, src_lblk, dst_ino, dst_lblk, n)


# ---------------------------------------------------------------------------


@dataclass
class Inode:
    ino: int
    size: int = 0
    nlink: int = 1
    flags: int = 0            # bit0: staging file
    extents: ExtentMap = field(default_factory=ExtentMap)

    IS_STAGING = 1


class KSplit:
    def __init__(self, device: PMDevice, pool: PagePool, journal: Journal,
                 meta_base_block: int, meta_num_blocks: int) -> None:
        self.device = device
        self.pool = pool
        self.journal = journal
        self.meta_base = meta_base_block * BLOCK_SIZE
        self.meta_capacity = meta_num_blocks * BLOCK_SIZE
        self.inodes: Dict[int, Inode] = {}
        self.namespace: Dict[str, int] = {}
        self._next_ino = 2  # 1 could be a root dir; keep conventional
        self._lock = threading.RLock()
        journal.on_checkpoint = self.checkpoint_metadata

    # ------------------------------------------------------------------ helpers

    def _trap(self) -> None:
        self.device.meter.add("trap", 1)

    def _ino(self, ino: int) -> Inode:
        try:
            return self.inodes[ino]
        except KeyError:
            raise NoEntError(f"inode {ino}") from None

    # ------------------------------------------------------------------ namespace

    def create(self, name: str, staging: bool = False) -> int:
        self._trap()
        self.device.meter.add("open_path", 1)
        with self._lock:
            if name in self.namespace:
                raise ExistsError(name)
            ino = self._next_ino
            self._next_ino += 1
            flags = Inode.IS_STAGING if staging else 0
            with self.journal.begin() as txn:
                txn.log(_rec_create(ino, name, flags))
            self.inodes[ino] = Inode(ino=ino, flags=flags)
            self.namespace[name] = ino
            self.device.meter.add("index_op", 2)
            return ino

    def lookup(self, name: str) -> int:
        self._trap()
        self.device.meter.add("open_path", 1)
        with self._lock:
            if name not in self.namespace:
                raise NoEntError(name)
            return self.namespace[name]

    def unlink(self, name: str) -> None:
        self._trap()
        self.device.meter.add("open_path", 1)
        with self._lock:
            ino_num = self.namespace.get(name)
            if ino_num is None:
                raise NoEntError(name)
            inode = self._ino(ino_num)
            with self.journal.begin() as txn:
                txn.log(_rec_unlink(ino_num, name))
            del self.namespace[name]
            inode.nlink -= 1
            if inode.nlink == 0:
                blocks = inode.extents.all_blocks()
                if blocks:
                    self.pool.free(blocks, cost_event="ext4_alloc")
                del self.inodes[ino_num]
            self.device.meter.add("index_op", 2)

    def rename(self, src: str, dst: str) -> None:
        self._trap()
        self.device.meter.add("open_path", 2)
        with self._lock:
            if src not in self.namespace:
                raise NoEntError(src)
            with self.journal.begin() as txn:
                txn.log(_rec_rename(src, dst))
            ino = self.namespace.pop(src)
            replaced = self.namespace.get(dst)
            self.namespace[dst] = ino
            if replaced is not None:
                victim = self._ino(replaced)
                victim.nlink -= 1
                if victim.nlink == 0:
                    blocks = victim.extents.all_blocks()
                    if blocks:
                        self.pool.free(blocks, cost_event="ext4_alloc")
                    del self.inodes[replaced]
            self.device.meter.add("index_op", 2)

    def stat(self, name: str) -> Inode:
        self._trap()
        self.device.meter.add("open_path", 1)
        with self._lock:
            ino = self.namespace.get(name)
            if ino is None:
                raise NoEntError(name)
            return self._ino(ino)

    # ------------------------------------------------------------------ space

    def allocate(self, ino_num: int, offset: int, nbytes: int,
                 contiguous: bool = False, charge_trap: bool = True) -> List[int]:
        """Ensure blocks exist covering [offset, offset+nbytes); journaled.
        Returns the newly-allocated physical blocks."""
        if charge_trap:
            self._trap()
        if nbytes <= 0:
            return []
        with self._lock:
            inode = self._ino(ino_num)
            first = offset // BLOCK_SIZE
            last = (offset + nbytes - 1) // BLOCK_SIZE
            missing = [l for l in range(first, last + 1)
                       if inode.extents.lookup_block(l) is None]
            if not missing:
                return []
            blocks = self.pool.alloc(len(missing), cost_event="ext4_alloc",
                                     contiguous=contiguous)
            with self.journal.begin() as txn:
                for lblk, pblk in zip(missing, blocks):
                    txn.log(_rec_map(ino_num, lblk, pblk))
            for lblk, pblk in zip(missing, blocks):
                inode.extents.set_block(lblk, pblk)
            self.device.meter.add("index_op", len(missing))
            return blocks

    def truncate(self, ino_num: int, size: int) -> None:
        self._trap()
        with self._lock:
            inode = self._ino(ino_num)
            keep_last = (size + BLOCK_SIZE - 1) // BLOCK_SIZE  # blocks to keep
            drop = [l for l in list(inode.extents.blocks) if l >= keep_last]
            with self.journal.begin() as txn:
                txn.log(_rec_size(ino_num, size))
                for l in drop:
                    txn.log(_rec_unmap(ino_num, l))
            freed = [inode.extents.remove_block(l) for l in drop]
            freed = [p for p in freed if p is not None]
            if freed:
                self.pool.free(freed, cost_event="ext4_alloc")
            inode.size = size

    def set_size(self, ino_num: int, size: int, charge_trap: bool = True) -> None:
        """Journaled i_size update (appends grow the file => metadata op)."""
        if charge_trap:
            self._trap()
        with self._lock:
            inode = self._ino(ino_num)
            with self.journal.begin() as txn:
                txn.log(_rec_size(ino_num, size))
            inode.size = size

    # ------------------------------------------------------------------ the ioctl

    def swap_extents(self, src_ino: int, src_off: int, dst_ino: int, dst_off: int,
                     size: int, dealloc_src: bool = True) -> int:
        """The modified EXT4_IOC_MOVE_EXT behind relink (paper §3.5):
        metadata-only, journaled, atomic transfer of block ownership from
        src[src_off:+size] to dst[dst_off:+size]. Replaced dst blocks are
        freed. With ``dealloc_src`` the source mapping simply disappears
        (the staging file shrinks); no data is copied, moved, or flushed.

        Offsets and size must be block-aligned — the partial-block head/tail
        copy path lives in relink.py, exactly as the paper splits it.
        Returns the number of blocks moved."""
        self._trap()
        if size <= 0:
            return 0
        if src_off % BLOCK_SIZE or dst_off % BLOCK_SIZE or size % BLOCK_SIZE:
            raise FSError("swap_extents requires block alignment")
        with self._lock:
            src = self._ino(src_ino)
            dst = self._ino(dst_ino)
            n = size // BLOCK_SIZE
            src_lblk = src_off // BLOCK_SIZE
            dst_lblk = dst_off // BLOCK_SIZE
            # validate source fully mapped before mutating anything
            for i in range(n):
                if src.extents.lookup_block(src_lblk + i) is None:
                    raise FSError(f"swap source hole at block {src_lblk + i}")
            with self.journal.begin() as txn:
                txn.log(_rec_swap(src_ino, src_lblk, dst_ino, dst_lblk, n))
            replaced = move_extents(src.extents, src_lblk, dst.extents, dst_lblk, n)
            if replaced:
                self.pool.free(replaced, cost_event="ext4_alloc")
            self.device.meter.add("index_op", n)
            if not dealloc_src:
                # true swap: give dst's replaced blocks back to src
                for i, pblk in enumerate(replaced):
                    src.extents.set_block(src_lblk + i, pblk)
                if replaced:
                    self.pool.adopt(replaced)
            return n

    def relink_blocks(self, src_ino: int, src_lblk: int, dst_ino: int,
                      dst_lblk: int, nblocks: int,
                      new_dst_size: Optional[int] = None) -> int:
        """Single-journal-transaction, metadata-only relink (paper §3.3/§3.5).

        Faithful to the modified EXT4_IOC_MOVE_EXT sequence: temporary blocks
        are allocated at destination holes (the ioctl requires both sides
        mapped), the swap transfers staging blocks in, and the temporaries are
        deallocated as the "replaced" set — so the costs of the paper's
        allocate/swap/dealloc dance are charged, but no data byte moves.

        The swap and the i_size update commit in ONE journal transaction,
        which is what makes an fsync-published append atomic."""
        self._trap()
        with self._lock:
            if nblocks > 0:
                src = self._ino(src_ino)
                dst = self._ino(dst_ino)
                for i in range(nblocks):
                    if src.extents.lookup_block(src_lblk + i) is None:
                        raise FSError(f"relink source hole at {src_lblk + i}")
                holes = [i for i in range(nblocks)
                         if dst.extents.lookup_block(dst_lblk + i) is None]
                temp = self.pool.alloc(len(holes), cost_event="ext4_alloc") if holes else []
            with self.journal.begin() as txn:
                if nblocks > 0:
                    txn.log(_rec_swap(src_ino, src_lblk, dst_ino, dst_lblk, nblocks))
                if new_dst_size is not None:
                    txn.log(_rec_size(dst_ino, new_dst_size))
            if nblocks > 0:
                for i, pblk in zip(holes, temp):
                    dst.extents.set_block(dst_lblk + i, pblk)
                replaced = move_extents(src.extents, src_lblk, dst.extents,
                                        dst_lblk, nblocks)
                if replaced:
                    self.pool.free(replaced, cost_event="ext4_free")
                self.device.meter.add("index_op", nblocks)
            if new_dst_size is not None:
                self._ino(dst_ino).size = new_dst_size
            return max(nblocks, 0)

    def relink_many(self, ops, new_dst_size=None, dst_ino=None) -> int:
        """Batch form of relink_blocks: ALL the staged extents an fsync
        publishes commit in ONE jbd2 transaction (jbd2 batches a handle's
        updates into a single commit; one ioctl + one txn per fsync).

        ``ops``: [(src_ino, src_lblk, dst_ino, dst_lblk, nblocks)].
        Returns total blocks moved."""
        self._trap()
        total = 0
        with self._lock:
            allocs = []
            for src_ino, src_lblk, d_ino, dst_lblk, n in ops:
                src = self._ino(src_ino)
                dst = self._ino(d_ino)
                for i in range(n):
                    if src.extents.lookup_block(src_lblk + i) is None:
                        raise FSError(f"relink source hole at {src_lblk + i}")
                holes = [i for i in range(n)
                         if dst.extents.lookup_block(dst_lblk + i) is None]
                temp = self.pool.alloc(len(holes), cost_event="ext4_alloc") \
                    if holes else []
                allocs.append((holes, temp))
            with self.journal.begin() as txn:
                for src_ino, src_lblk, d_ino, dst_lblk, n in ops:
                    txn.log(_rec_swap(src_ino, src_lblk, d_ino, dst_lblk, n))
                if new_dst_size is not None and dst_ino is not None:
                    txn.log(_rec_size(dst_ino, new_dst_size))
            for (src_ino, src_lblk, d_ino, dst_lblk, n), (holes, temp) in zip(
                    ops, allocs):
                src = self._ino(src_ino)
                dst = self._ino(d_ino)
                for i, pblk in zip(holes, temp):
                    dst.extents.set_block(dst_lblk + i, pblk)
                replaced = move_extents(src.extents, src_lblk, dst.extents,
                                        dst_lblk, n)
                if replaced:
                    self.pool.free(replaced, cost_event="ext4_free")
                self.device.meter.add("index_op", n)
                total += n
            if new_dst_size is not None and dst_ino is not None:
                self._ino(dst_ino).size = new_dst_size
        return total

    # ------------------------------------------------------------------ kernel IO
    # (the path baseline engines and non-mmap fallbacks take: full syscall cost)

    def write(self, ino_num: int, offset: int, data: bytes,
              write_path_event: str = "ext4_write_path") -> int:
        self._trap()
        self.device.meter.add(write_path_event, 1)
        with self._lock:
            inode = self._ino(ino_num)
            first = offset // BLOCK_SIZE
            last = (offset + len(data) - 1) // BLOCK_SIZE
            missing = [l for l in range(first, last + 1)
                       if inode.extents.lookup_block(l) is None]
            grew = offset + len(data) > inode.size
            if missing or grew:
                # one jbd2 transaction covers allocation + i_size (as ext4
                # folds a write's metadata into a single running handle)
                blocks = self.pool.alloc(len(missing), cost_event="ext4_alloc") \
                    if missing else []
                with self.journal.begin() as txn:
                    for lblk, pblk in zip(missing, blocks):
                        txn.log(_rec_map(ino_num, lblk, pblk))
                    if grew:
                        txn.log(_rec_size(ino_num, offset + len(data)))
                for lblk, pblk in zip(missing, blocks):
                    inode.extents.set_block(lblk, pblk)
                if grew:
                    inode.size = offset + len(data)
                self.device.meter.add("index_op", len(missing))
            pos = 0
            for seg in inode.extents.segments(offset, len(data)):
                self.device.write_data(seg.phys_addr, data[pos : pos + seg.length])
                pos += seg.length
            return len(data)

    def read(self, ino_num: int, offset: int, n: int,
             read_path_event: str = "ext4_read_path") -> bytes:
        self._trap()
        self.device.meter.add(read_path_event, 1)
        with self._lock:
            inode = self._ino(ino_num)
            n = max(0, min(n, inode.size - offset))
            if n == 0:
                return b""
            out = bytearray(n)
            pos = 0
            for lblk, pblk in inode.extents.mapped_blocks(offset, n):
                boff = offset + pos - lblk * BLOCK_SIZE if pos == 0 else 0
                take = min(BLOCK_SIZE - boff, n - pos)
                if pblk is not None:
                    out[pos : pos + take] = self.device.read(
                        pblk * BLOCK_SIZE + boff, take
                    )
                pos += take
            return bytes(out)

    def fsync(self, ino_num: int) -> None:
        """Kernel fsync: force the journal's committed state durable."""
        self._trap()
        self.device.fence()

    # ------------------------------------------------------------------ checkpoint

    _CKPT_HDR = struct.Struct("<IIQQQ")  # magic, version, next_ino, n_inodes, payload_len
    _CKPT_MAGIC = 0x4B53504C  # 'KSPL'

    def checkpoint_metadata(self) -> None:
        """Serialize the full metadata state to the home region (then the
        journal may reset). CRC-protected; double-buffered would be the real
        design — we write a fresh image then the header last, so a torn
        checkpoint is detected and the previous journal replay still applies."""
        with self._lock:
            parts: List[bytes] = []
            for ino in sorted(self.inodes):
                inode = self.inodes[ino]
                ext = sorted(inode.extents.blocks.items())
                parts.append(struct.pack("<QQIIQ", ino, inode.size, inode.nlink,
                                         inode.flags, len(ext)))
                for lblk, pblk in ext:
                    parts.append(struct.pack("<QQ", lblk, pblk))
            parts.append(struct.pack("<Q", len(self.namespace)))
            for name in sorted(self.namespace):
                nb = name.encode()
                parts.append(struct.pack("<QH", self.namespace[name], len(nb)) + nb)
            payload = b"".join(parts)
            hdr = self._CKPT_HDR.pack(self._CKPT_MAGIC, 1, self._next_ino,
                                      len(self.inodes), len(payload))
            total = len(hdr) + len(payload) + 4
            if total > self.meta_capacity:
                raise FSError("metadata checkpoint exceeds home region")
            crc = struct.pack("<I", zlib.crc32(payload))
            self.device.write_data(self.meta_base + self._CKPT_HDR.size, payload)
            self.device.write_data(self.meta_base + self._CKPT_HDR.size + len(payload), crc)
            self.device.fence()
            self.device.persist_line(self.meta_base, hdr)  # header last = commit point
            self.device.fence()

    def load_checkpoint(self) -> bool:
        hdr = bytes(self.device.read_silent(self.meta_base, self._CKPT_HDR.size))
        magic, version, next_ino, n_inodes, plen = self._CKPT_HDR.unpack(hdr)
        if magic != self._CKPT_MAGIC:
            return False
        payload = bytes(self.device.read_silent(self.meta_base + self._CKPT_HDR.size, plen))
        (crc,) = struct.unpack(
            "<I", bytes(self.device.read_silent(
                self.meta_base + self._CKPT_HDR.size + plen, 4))
        )
        if zlib.crc32(payload) != crc:
            return False
        self.inodes.clear()
        self.namespace.clear()
        p = 0
        for _ in range(n_inodes):
            ino, size, nlink, flags, next_n = struct.unpack_from("<QQIIQ", payload, p)
            p += 32
            em = ExtentMap()
            for _ in range(next_n):
                lblk, pblk = struct.unpack_from("<QQ", payload, p)
                p += 16
                em.set_block(lblk, pblk)
            self.inodes[ino] = Inode(ino=ino, size=size, nlink=nlink, flags=flags, extents=em)
        (n_names,) = struct.unpack_from("<Q", payload, p)
        p += 8
        for _ in range(n_names):
            ino, nlen = struct.unpack_from("<QH", payload, p)
            p += 10
            name = payload[p : p + nlen].decode()
            p += nlen
            self.namespace[name] = ino
        self._next_ino = next_ino
        return True

    # ------------------------------------------------------------------ recovery

    def replay_journal(self) -> int:
        """Apply valid journal transactions on top of current state.
        Replay is idempotent: records are logical (set/remove), and SWAP
        records re-applied after being applied are detected via source-hole
        checks and skipped."""
        n_applied = 0
        for _txid, records in self.journal.replay():
            for rec in records:
                self._apply_record(rec)
            n_applied += 1
        self._rebuild_free_list()
        return n_applied

    def _apply_record(self, rec: bytes) -> None:
        kind = rec[0]
        if kind == R_CREATE:
            _, ino, flags, nlen = struct.unpack_from("<BQIH", rec)
            name = rec[struct.calcsize("<BQIH"):].decode()
            if ino not in self.inodes:
                self.inodes[ino] = Inode(ino=ino, flags=flags)
            self.namespace[name] = ino
            self._next_ino = max(self._next_ino, ino + 1)
        elif kind == R_UNLINK:
            _, ino, nlen = struct.unpack_from("<BQH", rec)
            name = rec[struct.calcsize("<BQH"):].decode()
            self.namespace.pop(name, None)
            inode = self.inodes.get(ino)
            if inode is not None:
                inode.nlink -= 1
                if inode.nlink <= 0:
                    self.inodes.pop(ino, None)
        elif kind == R_RENAME:
            _, slen, dlen = struct.unpack_from("<BHH", rec)
            base = struct.calcsize("<BHH")
            src = rec[base : base + slen].decode()
            dst = rec[base + slen : base + slen + dlen].decode()
            if src in self.namespace:
                self.namespace[dst] = self.namespace.pop(src)
        elif kind == R_SIZE:
            _, ino, size = struct.unpack_from("<BQQ", rec)
            if ino in self.inodes:
                self.inodes[ino].size = size
        elif kind == R_MAP:
            _, ino, lblk, pblk = struct.unpack_from("<BQQQ", rec)
            if ino in self.inodes:
                self.inodes[ino].extents.set_block(lblk, pblk)
        elif kind == R_UNMAP:
            _, ino, lblk = struct.unpack_from("<BQQ", rec)
            if ino in self.inodes:
                self.inodes[ino].extents.remove_block(lblk)
        elif kind == R_SWAP:
            _, s_ino, s_lblk, d_ino, d_lblk, n = struct.unpack_from("<BQQQQQ", rec)
            src = self.inodes.get(s_ino)
            dst = self.inodes.get(d_ino)
            if src is None or dst is None:
                return
            # idempotence: if the source range is already unmapped, this swap
            # already happened (possibly via checkpoint) — skip.
            if any(src.extents.lookup_block(s_lblk + i) is None for i in range(n)):
                return
            move_extents(src.extents, s_lblk, dst.extents, d_lblk, n)
        else:
            raise FSError(f"unknown journal record kind {kind}")

    def _rebuild_free_list(self) -> None:
        """Free state is derived, never logged: free = pool range - live."""
        import collections

        live: List[int] = []
        for inode in self.inodes.values():
            live.extend(inode.extents.all_blocks())
        pool = self.pool
        with pool._lock:
            pool._allocated = set(live)
            all_blocks = set(range(pool.base_block, pool.base_block + pool.num_blocks))
            pool._free = collections.deque(sorted(all_blocks - set(live)))
