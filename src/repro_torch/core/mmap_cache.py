"""Collection of memory-mappings (paper §3.3/§3.4 + §4 'huge pages are fragile';
a copy of ``repro.core.mmap_cache``).

U-Split serves reads/overwrites through cached mmap translations:

  * mappings are created in ``map_chunk``-sized pieces (default 2 MB, the
    huge-page size), MAP_POPULATE-prefaulted, and **never discarded until
    unlink** — setting up translations once and reusing them is the paper's
    answer to page-fault cost and huge-page fragility;
  * a *translation* is (logical 4 KB block -> physical block) — looking one
    up costs nothing at runtime (it is the MMU's job); only creating it does
    (mmap syscall + faults);
  * after relink, physical pages move between files without changing their
    contents, so U-Split *transfers* the staging file's cached translations
    to the target file — the paper's "existing memory mappings of both
    source and destination files are valid".

Cost model: one ``mmap_syscall`` per region created; MAP_POPULATE faults are
charged per huge page when the region could use huge pages, else per 4 KB
page (the 50% read-throughput cliff the paper §4 measures comes from
exactly this difference).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .ksplit import KSplit
from .pmem import BLOCK_SIZE, MMAP_CHUNK, PMDevice


@dataclass
class MmapStats:
    regions_created: int = 0
    region_hits: int = 0
    translations: int = 0
    faults: int = 0


class MmapCache:
    def __init__(
        self,
        device: PMDevice,
        ksplit: KSplit,
        map_chunk: int = MMAP_CHUNK,
        hugepages: bool = True,
        populate: bool = True,
    ) -> None:
        assert map_chunk % BLOCK_SIZE == 0
        self.device = device
        self.ksplit = ksplit
        self.map_chunk = map_chunk
        self.hugepages = hugepages
        self.populate = populate
        # (ino, chunk_index) -> {lblk: pblk}
        self._regions: Dict[Tuple[int, int], Dict[int, int]] = {}
        self.stats = MmapStats()

    # -- region management ---------------------------------------------------------

    def _chunk_of(self, offset: int) -> int:
        return offset // self.map_chunk

    def ensure_mapped(self, ino: int, offset: int, length: int) -> None:
        """Make sure translations exist for [offset, offset+length)."""
        if length <= 0:
            return
        first = self._chunk_of(offset)
        last = self._chunk_of(offset + length - 1)
        for c in range(first, last + 1):
            self._map_region(ino, c)

    def _map_region(self, ino: int, chunk: int) -> Dict[int, int]:
        key = (ino, chunk)
        region = self._regions.get(key)
        if region is not None:
            self.stats.region_hits += 1
            return region
        # mmap() the surrounding map_chunk of the file (paper §3.4)
        self.device.meter.add("mmap_syscall", 1)
        self.stats.regions_created += 1
        region = {}
        inode = self.ksplit.inodes.get(ino)
        if inode is not None:
            lo = chunk * self.map_chunk // BLOCK_SIZE
            hi = lo + self.map_chunk // BLOCK_SIZE
            for lblk in range(lo, hi):
                pblk = inode.extents.lookup_block(lblk)
                if pblk is not None:
                    region[lblk] = pblk
        if self.populate and region:
            # MAP_POPULATE pre-faults the whole region now, not on first touch
            if self.hugepages and self._huge_eligible(region):
                n_faults = 1
            else:
                n_faults = len(region)
            self.device.meter.add("page_fault", n_faults)
            self.stats.faults += n_faults
        self._regions[key] = region
        return region

    @staticmethod
    def _huge_eligible(region: Dict[int, int]) -> bool:
        """A huge page needs physically-contiguous, aligned backing (paper §4:
        fragmentation makes this fail, halving read throughput)."""
        if not region:
            return False
        items = sorted(region.items())
        base_l, base_p = items[0]
        return all(p - base_p == l - base_l for l, p in items) and (
            items[0][1] % (MMAP_CHUNK // BLOCK_SIZE) == items[0][0] % (MMAP_CHUNK // BLOCK_SIZE)
        )

    # -- translation (the data-path hot loop) ----------------------------------------

    def translate(self, ino: int, lblk: int) -> Optional[int]:
        """logical block -> current physical block.

        Semantics follow file-backed shared mappings: the MMU translates to
        wherever the FILE's block lives NOW (relink's modified ioctl remaps
        PTEs without faulting, paper §3.5).  The region cache therefore only
        does COST accounting — a block faults once when first touched in a
        mapped region; later accesses (including after relink moved the
        underlying physical page) are free."""
        chunk = lblk * BLOCK_SIZE // self.map_chunk
        region = self._regions.get((ino, chunk))
        if region is None:
            region = self._map_region(ino, chunk)
        inode = self.ksplit.inodes.get(ino)
        live = inode.extents.lookup_block(lblk) if inode is not None else None
        if live is None:
            return None
        if lblk not in region:
            # first touch of this block in the mapping: minor fault
            self.device.meter.add("page_fault", 1)
            self.stats.faults += 1
        region[lblk] = live
        self.stats.translations += 1
        return live

    # -- relink integration -----------------------------------------------------------

    def transfer(self, src_ino: int, src_lblk: int, dst_ino: int, dst_lblk: int,
                 nblocks: int) -> None:
        """After relink moved physical blocks src->dst: mark the destination
        blocks as already-faulted (the ioctl remapped the PTEs — paper §3.5
        "existing memory mappings ... remain valid", i.e. no post-relink
        fault storm).  This is pure cost accounting; translate() always
        resolves the live block."""
        for i in range(nblocks):
            s_chunk = (src_lblk + i) * BLOCK_SIZE // self.map_chunk
            src_region = self._regions.get((src_ino, s_chunk))
            paid = bool(src_region) and src_region.pop(src_lblk + i, None) is not None
            if not paid:
                continue
            d_chunk = (dst_lblk + i) * BLOCK_SIZE // self.map_chunk
            dst_region = self._regions.setdefault((dst_ino, d_chunk), {})
            inode = self.ksplit.inodes.get(dst_ino)
            live = inode.extents.lookup_block(dst_lblk + i) if inode else None
            if live is not None:
                dst_region[dst_lblk + i] = live

    def drop_file(self, ino: int) -> int:
        """munmap all regions of a file (on unlink — paper Table 6 notes this
        is what makes unlink expensive). Returns regions dropped."""
        keys = [k for k in self._regions if k[0] == ino]
        for k in keys:
            del self._regions[k]
            self.device.meter.add("mmap_syscall", 1)  # munmap
        return len(keys)
