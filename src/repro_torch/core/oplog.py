"""The paper's optimized operation log (§3.3 "Optimized logging").

Per-U-Split, pre-allocated, pre-zeroed PM region of 64 B entries:

    entry := op u8 | mode u8 | seqno u16 | inode u32 |
             offset u64 | length u64 | staging_addr u64 |
             aux1 u64 | aux2 u64 | pad 12B | crc32 u32      == 64 B

Design points reproduced exactly from the paper:
  * common-case cost = ONE cacheline store + ONE fence (the 4 B transactional
    checksum removes the need for a second "entry valid" fence);
  * the tail lives only in DRAM; concurrent threads CAS it forward and write
    their slots independently;
  * the log file is zeroed at init, so recovery = scan non-zero 64 B slots,
    checksum-validate (drops torn entries), replay valid ones — replay is
    idempotent so repeated crashes during recovery are safe;
  * log full => checkpoint (relink all open staged files), zero, reuse.
"""

from __future__ import annotations

import itertools
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional

from .pmem import CACHELINE, PMDevice

_ENTRY = struct.Struct("<BBHIQQQQQ12x")  # 48 B fields + 12 pad = 60; crc appended
assert _ENTRY.size == 60


# op codes (paper: "all common case operations ... logged using a single 64B
# log entry while some uncommon operations, like rename(), require multiple")
OP_APPEND = 1
OP_OVERWRITE = 2
OP_CREATE = 3
OP_UNLINK = 4
OP_TRUNCATE = 5
OP_RELINK = 6
OP_RENAME_SRC = 7   # uncommon: two entries
OP_RENAME_DST = 8
OP_CHECKPOINT = 9   # manifest/step commit marker (checkpoint manager)
OP_KV_COMMIT = 10   # KV page published (serving plane)


@dataclass(frozen=True)
class LogEntry:
    op: int
    mode: int
    seqno: int
    inode: int
    offset: int
    length: int
    staging_addr: int
    aux1: int = 0
    aux2: int = 0

    def pack(self) -> bytes:
        body = _ENTRY.pack(
            self.op, self.mode, self.seqno & 0xFFFF, self.inode,
            self.offset, self.length, self.staging_addr, self.aux1, self.aux2,
        )
        return body + struct.pack("<I", zlib.crc32(body))

    @staticmethod
    def unpack(raw: bytes) -> Optional["LogEntry"]:
        if len(raw) != CACHELINE:
            return None
        body, (crc,) = raw[:60], struct.unpack("<I", raw[60:])
        if zlib.crc32(body) != crc:
            return None  # torn entry
        op, mode, seqno, inode, off, length, staging, a1, a2 = _ENTRY.unpack(body)
        return LogEntry(op, mode, seqno, inode, off, length, staging, a1, a2)


class OpLog:
    def __init__(
        self,
        device: PMDevice,
        base_block: int,
        num_blocks: int,
        on_full: Optional[Callable[[], None]] = None,
        fresh: bool = True,
    ) -> None:
        from .pmem import BLOCK_SIZE

        self.device = device
        self.base = base_block * BLOCK_SIZE
        self.capacity = num_blocks * BLOCK_SIZE
        self.num_slots = self.capacity // CACHELINE
        self.on_full = on_full
        # zero at init (paper: zeroed so recovery can detect valid entries);
        # fresh=False preserves a crashed instance's entries for recovery scans
        if fresh:
            device.zero(self.base, self.capacity, metered=False)
        # DRAM-only tail; CAS-advanced by concurrent threads
        self._tail_lock = threading.Lock()
        self._tail_value = 0
        self._seq = itertools.count(1)
        # plain-int stats, read lazily by the obs registry (DESIGN.md §10)
        self.appends = 0
        self.appends_by_mode: dict = {}      # Mode int -> publishes
        self.entries_scanned = 0             # valid entries seen by recovery

    # -- append (the hot path: 1 line + 1 fence) ---------------------------------

    def append(self, entry: LogEntry) -> int:
        slot = self._advance_tail()
        addr = self.base + slot * CACHELINE
        self.appends += 1
        self.appends_by_mode[entry.mode] = \
            self.appends_by_mode.get(entry.mode, 0) + 1
        dev = self.device
        dev.meter.add("cas", 1)          # DRAM tail CAS
        dev.meter.add("checksum_bytes", 60)
        dev.persist_line(addr, entry.pack())   # one cacheline, non-temporal
        dev.fence()                             # ONE fence (checksum trick)
        return slot

    def _advance_tail(self) -> int:
        with self._tail_lock:
            slot = self._tail_value
            if slot >= self.num_slots:
                if self.on_full is None:
                    raise RuntimeError("operation log full")
                # checkpoint: relink all staged state, then zero + reuse
                self.on_full()
                self.clear()
                slot = 0
            self._tail_value = slot + 1
            return slot

    def next_seqno(self) -> int:
        return next(self._seq)

    def clear(self) -> None:
        """Zero the log region and rewind the DRAM tail.

        Callers must already hold ``_tail_lock`` or be single-threaded at the
        point of clearing (``_advance_tail`` calls this under the lock)."""
        self.device.zero(self.base, self.capacity)
        self._tail_value = 0

    # -- recovery ---------------------------------------------------------------

    def scan(self) -> List[LogEntry]:
        """Crash recovery: every non-zero 64 B slot is potentially valid; the
        checksum separates torn from valid entries.  Returns valid entries in
        slot order (replay is idempotent, §5.3)."""
        out: List[LogEntry] = []
        buf = self.device.read_silent(self.base, self.capacity)
        for slot in range(self.num_slots):
            raw = bytes(buf[slot * CACHELINE : (slot + 1) * CACHELINE])
            if raw == b"\x00" * CACHELINE:
                continue
            entry = LogEntry.unpack(raw)
            if entry is not None:
                out.append(entry)
        self.entries_scanned += len(out)
        return out
