"""Volume: carves one PM device into the SplitFS on-device layout (a copy
of ``repro.core.volume``).

    block 0          reserved (so physical block 0 is never valid)
    metadata home    K-Split checkpoint region
    journal          K-Split (ext4-jbd2 analogue) journal
    oplog slots      one per concurrent U-Split instance (paper: per-process
                     operation logs, 128 MB each by default)
    data pool        everything else

``Volume.format`` builds a fresh file system; ``Volume.mount`` recovers an
existing device image: load the metadata checkpoint, replay the journal,
rebuild the free list. Strict-mode oplog replay is driven by U-Split
(store.recover_strict) because logs are per-instance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .journal import Journal
from .ksplit import KSplit
from .oplog import OpLog
from .pagepool import PagePool
from .pmem import BLOCK_SIZE, PMDevice


@dataclass(frozen=True)
class VolumeGeometry:
    meta_blocks: int = 1024          # 4 MB metadata home region
    journal_blocks: int = 2048       # 8 MB journal
    oplog_slots: int = 4
    oplog_blocks: int = 512          # 2 MB per slot default (paper: 128 MB max)

    def data_base(self) -> int:
        return 1 + self.meta_blocks + self.journal_blocks + self.oplog_slots * self.oplog_blocks


class Volume:
    def __init__(self, device: PMDevice, geometry: VolumeGeometry,
                 recovered: bool) -> None:
        self.device = device
        self.geometry = geometry
        g = geometry
        data_base = g.data_base()
        if data_base >= device.num_blocks:
            raise ValueError("device too small for volume geometry")
        self.pool = PagePool(device, base_block=data_base,
                             num_blocks=device.num_blocks - data_base)
        self.journal = Journal(device, base_block=1 + g.meta_blocks,
                               num_blocks=g.journal_blocks)
        self.ksplit = KSplit(device, self.pool, self.journal,
                             meta_base_block=1, meta_num_blocks=g.meta_blocks)
        self._oplog_taken: List[bool] = [False] * g.oplog_slots
        if recovered:
            self._recover()

    # -- lifecycle -----------------------------------------------------------------

    @classmethod
    def format(cls, device: PMDevice, geometry: VolumeGeometry = VolumeGeometry()) -> "Volume":
        device.zero(0, device.size, metered=False)
        return cls(device, geometry, recovered=False)

    @classmethod
    def mount(cls, device: PMDevice, geometry: VolumeGeometry = VolumeGeometry()) -> "Volume":
        return cls(device, geometry, recovered=True)

    def _recover(self) -> None:
        self.ksplit.load_checkpoint()
        self.ksplit.replay_journal()
        # after a successful replay, checkpoint + reset so records never
        # replay twice across mounts
        self.ksplit.checkpoint_metadata()
        self.journal.reset()

    # -- oplog slots ------------------------------------------------------------------

    def take_oplog_slot(self, slot: Optional[int] = None) -> tuple[int, int, int]:
        """Reserve an oplog slot; returns (slot, base_block, num_blocks)."""
        g = self.geometry
        if slot is None:
            try:
                slot = self._oplog_taken.index(False)
            except ValueError:
                raise RuntimeError("no free oplog slots") from None
        self._oplog_taken[slot] = True
        base = 1 + g.meta_blocks + g.journal_blocks + slot * g.oplog_blocks
        return slot, base, g.oplog_blocks

    def oplog_for_slot(self, slot: int, on_full=None, fresh: bool = True) -> OpLog:
        g = self.geometry
        base = 1 + g.meta_blocks + g.journal_blocks + slot * g.oplog_blocks
        return OpLog(self.device, base_block=base, num_blocks=g.oplog_blocks,
                     on_full=on_full, fresh=fresh)
