"""Extent maps: logical file offset -> physical PM block routing
(a copy of ``repro.core.extents``).

This is the metadata structure behind both the paper's "collection of
memory-mappings" (U-Split side: where do reads/overwrites go) and the
kernel-side block mapping that ``relink``/``swap_extents`` mutates.

A file's bytes may be scattered across non-contiguous physical blocks
(original extents + relinked staging extents), exactly the situation the
paper's per-file mmap collection exists to route around.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .pmem import BLOCK_SIZE


@dataclass(frozen=True)
class Segment:
    """One physically-contiguous piece of a logical range."""

    logical_off: int
    phys_block: int
    block_off: int
    length: int

    @property
    def phys_addr(self) -> int:
        return self.phys_block * BLOCK_SIZE + self.block_off


@dataclass
class ExtentMap:
    """Block-granular logical->physical mapping for one file."""

    blocks: Dict[int, int] = field(default_factory=dict)  # lblk -> pblk

    def lookup_block(self, lblk: int) -> Optional[int]:
        return self.blocks.get(lblk)

    def set_block(self, lblk: int, pblk: int) -> Optional[int]:
        """Map ``lblk`` to ``pblk``; returns the replaced physical block."""
        old = self.blocks.get(lblk)
        self.blocks[lblk] = pblk
        return old

    def remove_block(self, lblk: int) -> Optional[int]:
        return self.blocks.pop(lblk, None)

    def segments(self, offset: int, length: int) -> List[Segment]:
        """Split [offset, offset+length) into physically-contiguous segments,
        coalescing physically-adjacent blocks.

        Raises ``KeyError`` on a hole — callers decide hole semantics
        (reads of holes return zeros at the store layer).
        """
        out: List[Segment] = []
        pos = offset
        end = offset + length
        while pos < end:
            lblk, boff = divmod(pos, BLOCK_SIZE)
            if lblk not in self.blocks:
                raise KeyError(lblk)
            n = min(BLOCK_SIZE - boff, end - pos)
            out.append(Segment(pos, self.blocks[lblk], boff, n))
            pos += n
        merged: List[Segment] = []
        for s in out:
            if (
                merged
                and merged[-1].phys_addr + merged[-1].length == s.phys_addr
                and merged[-1].logical_off + merged[-1].length == s.logical_off
            ):
                prev = merged.pop()
                merged.append(
                    Segment(prev.logical_off, prev.phys_block, prev.block_off, prev.length + s.length)
                )
            else:
                merged.append(s)
        return merged

    def mapped_blocks(self, offset: int, length: int) -> List[Tuple[int, Optional[int]]]:
        """[(lblk, pblk-or-None)] covering the range (None = hole)."""
        if length <= 0:
            return []
        first = offset // BLOCK_SIZE
        last = (offset + length - 1) // BLOCK_SIZE
        return [(l, self.blocks.get(l)) for l in range(first, last + 1)]

    def all_blocks(self) -> List[int]:
        return list(self.blocks.values())

    def num_blocks(self) -> int:
        return len(self.blocks)

    def copy(self) -> "ExtentMap":
        return ExtentMap(dict(self.blocks))


def move_extents(
    src: ExtentMap, src_lblk: int, dst: ExtentMap, dst_lblk: int, nblocks: int
) -> List[int]:
    """Transfer ownership of ``nblocks`` mapped blocks from src to dst.

    Returns physical blocks *replaced* in dst (to be freed by the caller).
    This is the in-memory half of relink/swap_extents; journaling and
    device-metadata persistence live in ksplit.
    """
    replaced: List[int] = []
    for i in range(nblocks):
        pblk = src.remove_block(src_lblk + i)
        if pblk is None:
            raise KeyError(f"relink source hole at lblk {src_lblk + i}")
        old = dst.set_block(dst_lblk + i, pblk)
        if old is not None:
            replaced.append(old)
    return replaced
