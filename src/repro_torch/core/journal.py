"""Write-ahead metadata journal (the ext4-jbd2 analogue behind K-Split;
a copy of ``repro.core.journal``).

``relink``/``swap_extents`` and all other metadata mutations are wrapped in
journal transactions so they are atomic across crashes (paper §3.3: "Atomicity
is ensured by wrapping the changes in a ext4 journal transaction").

On-PM layout (sequential, then wraps after an explicit checkpoint):

    txn   := header | record* | commit
    header:= MAGIC_H u32 | txid u64 | nrec u32 | payload_len u32
    record:= len u32 | bytes
    commit:= MAGIC_C u32 | txid u64 | crc32(payload) u32

The commit record fits one cacheline and is persisted with a single
store+flush; a fence orders payload-before-commit, one more orders
commit-before-return — matching jbd2's two-barrier commit.

Replay: scan from the journal base, parse transactions, keep only those whose
commit record matches (txid, crc); stop at the first hole/corruption.  Torn
transactions are discarded wholesale — this is what crash tests exercise.
"""

from __future__ import annotations

import struct
import threading
import zlib
from typing import Callable, List, Optional, Tuple

from .pmem import BLOCK_SIZE, PMDevice

MAGIC_H = 0x4A524E4C  # 'JRNL'
MAGIC_C = 0x434D4954  # 'CMIT'
_H = struct.Struct("<IQII")
_C = struct.Struct("<IQI")


class JournalFullError(Exception):
    pass


class Txn:
    def __init__(self, journal: "Journal", txid: int) -> None:
        self.journal = journal
        self.txid = txid
        self.records: List[bytes] = []
        self.committed = False

    def log(self, record: bytes) -> None:
        assert not self.committed
        self.records.append(record)

    def commit(self) -> None:
        self.journal._commit(self)
        self.committed = True

    # context-manager sugar: commit on clean exit, drop on exception
    def __enter__(self) -> "Txn":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.commit()


class Journal:
    def __init__(
        self,
        device: PMDevice,
        base_block: int,
        num_blocks: int,
        on_checkpoint: Optional[Callable[[], None]] = None,
    ) -> None:
        self.device = device
        self.base = base_block * BLOCK_SIZE
        self.capacity = num_blocks * BLOCK_SIZE
        self.head = 0  # DRAM-only write cursor (like jbd2's in-memory state)
        self._next_txid = 1
        self._lock = threading.Lock()
        self.on_checkpoint = on_checkpoint
        self.n_commits = 0

    # -- write side -------------------------------------------------------------

    def begin(self) -> Txn:
        with self._lock:
            txid = self._next_txid
            self._next_txid += 1
        return Txn(self, txid)

    def _commit(self, txn: Txn) -> None:
        payload = b"".join(
            struct.pack("<I", len(r)) + r for r in txn.records
        )
        need = _H.size + len(payload) + _C.size
        with self._lock:
            if self.head + need > self.capacity:
                # Journal full: caller-provided checkpoint flushes all live
                # metadata to its home location, after which the journal can
                # be reset (paper: same policy for the 128 MB oplog).
                if self.on_checkpoint is None:
                    raise JournalFullError
                self.on_checkpoint()
                self.reset()
                if self.head + need > self.capacity:
                    raise JournalFullError("txn larger than journal")
            pos = self.base + self.head
            dev = self.device
            dev.meter.add("ext4_journal_txn", 1)  # jbd2 handle/commit CPU cost
            dev.write_data(pos, _H.pack(MAGIC_H, txn.txid, len(txn.records), len(payload)))
            if payload:
                dev.write_data(pos + _H.size, payload)
            dev.fence()  # payload before commit record
            crc = zlib.crc32(payload)
            dev.meter.add("checksum_bytes", len(payload))
            dev.persist_line(pos + _H.size + len(payload), _C.pack(MAGIC_C, txn.txid, crc))
            dev.fence()  # commit durable before returning
            self.head += need
            self.n_commits += 1

    def reset(self) -> None:
        """Zero the journal region after a checkpoint (metadata is home)."""
        self.device.zero(self.base, self.capacity)
        self.head = 0

    # -- recovery side -------------------------------------------------------------

    def replay(self) -> List[Tuple[int, List[bytes]]]:
        """Scan the journal, returning [(txid, records)] for each transaction
        with a valid commit record, in order.  Stops at the first torn or
        absent transaction."""
        out: List[Tuple[int, List[bytes]]] = []
        pos = 0
        dev = self.device
        while pos + _H.size <= self.capacity:
            hdr = bytes(dev.read_silent(self.base + pos, _H.size))
            magic, txid, nrec, plen = _H.unpack(hdr)
            if magic != MAGIC_H:
                break
            if pos + _H.size + plen + _C.size > self.capacity:
                break
            payload = bytes(dev.read_silent(self.base + pos + _H.size, plen))
            cm = bytes(dev.read_silent(self.base + pos + _H.size + plen, _C.size))
            cmagic, ctxid, crc = _C.unpack(cm)
            if cmagic != MAGIC_C or ctxid != txid or zlib.crc32(payload) != crc:
                break  # torn txn: discard it and everything after
            records: List[bytes] = []
            p = 0
            ok = True
            for _ in range(nrec):
                if p + 4 > plen:
                    ok = False
                    break
                (rlen,) = struct.unpack_from("<I", payload, p)
                p += 4
                if p + rlen > plen:
                    ok = False
                    break
                records.append(payload[p : p + rlen])
                p += rlen
            if not ok:
                break
            out.append((txid, records))
            pos += _H.size + plen + _C.size
        return out
