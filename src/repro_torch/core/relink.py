"""The relink primitive (a copy of ``repro.core.relink``), paper
signature (§3.3):

    relink(file1, offset1, file2, offset2, size)

Atomically and logically moves ``size`` bytes from ``file1@offset1`` to
``file2@offset2`` with zero data copies when block-aligned, partial-block
copies otherwise.  This module exposes the standalone, file-to-file form
used by benchmarks and by the checkpoint manager; U-Split's fsync path uses
the same K-Split machinery directly (store._publish_extent).
"""

from __future__ import annotations

from .ksplit import FSError, KSplit
from .pmem import BLOCK_SIZE


def relink(ksplit: KSplit, src_name: str, src_off: int, dst_name: str,
           dst_off: int, size: int) -> dict:
    """Returns {'moved_blocks': n, 'copied_bytes': m} for accounting."""
    src_ino = ksplit.lookup(src_name)
    dst_ino = ksplit.lookup(dst_name)
    return relink_ino(ksplit, src_ino, src_off, dst_ino, dst_off, size)


def relink_ino(ksplit: KSplit, src_ino: int, src_off: int, dst_ino: int,
               dst_off: int, size: int) -> dict:
    if size <= 0:
        return {"moved_blocks": 0, "copied_bytes": 0}
    moved = 0
    copied = 0
    dst_end = dst_off + size

    if src_off % BLOCK_SIZE != dst_off % BLOCK_SIZE:
        # phases disagree: nothing can ever align; pure copy (documented
        # degenerate case — the paper's callers always stage in phase)
        copied += _copy_range(ksplit, src_ino, src_off, dst_ino, dst_off, size)
        _grow(ksplit, dst_ino, dst_end)
        return {"moved_blocks": 0, "copied_bytes": copied}

    pos_src, pos_dst, remaining = src_off, dst_off, size
    # head partial block
    if pos_dst % BLOCK_SIZE:
        head = min(remaining, BLOCK_SIZE - pos_dst % BLOCK_SIZE)
        copied += _copy_range(ksplit, src_ino, pos_src, dst_ino, pos_dst, head)
        pos_src += head
        pos_dst += head
        remaining -= head
    nblocks = remaining // BLOCK_SIZE
    tail = remaining % BLOCK_SIZE
    new_size = max(ksplit.inodes[dst_ino].size, dst_end)
    if nblocks:
        ksplit.relink_blocks(src_ino, pos_src // BLOCK_SIZE, dst_ino,
                             pos_dst // BLOCK_SIZE, nblocks,
                             new_dst_size=new_size)
        moved += nblocks
        pos_src += nblocks * BLOCK_SIZE
        pos_dst += nblocks * BLOCK_SIZE
    elif new_size > ksplit.inodes[dst_ino].size:
        ksplit.set_size(dst_ino, new_size, charge_trap=False)
    if tail:
        copied += _copy_range(ksplit, src_ino, pos_src, dst_ino, pos_dst, tail)
    return {"moved_blocks": moved, "copied_bytes": copied}


def _copy_range(ksplit: KSplit, src_ino: int, src_off: int, dst_ino: int,
                dst_off: int, n: int) -> int:
    src = ksplit.inodes[src_ino]
    ksplit.allocate(dst_ino, dst_off, n, charge_trap=False)
    dst = ksplit.inodes[dst_ino]
    pos = 0
    for seg in src.extents.segments(src_off, n):
        data = bytes(ksplit.device.read(seg.phys_addr, seg.length))
        dpos = 0
        for dseg in dst.extents.segments(dst_off + pos, seg.length):
            ksplit.device.write_data(dseg.phys_addr, data[dpos : dpos + dseg.length])
            dpos += dseg.length
        pos += seg.length
    return n


def _grow(ksplit: KSplit, ino: int, size: int) -> None:
    if size > ksplit.inodes[ino].size:
        ksplit.set_size(ino, size, charge_trap=False)
