"""SplitFS consistency modes (paper §3.2, Table 3).

Concurrent U-Split instances may run in different modes over the same
volume; modes never interfere (per-instance operation logs).

Interpretation notes (documented deviations are in DESIGN.md §2):
  * POSIX  — metadata consistency (= ext4-DAX); overwrites in-place &
             synchronous; appends staged, atomic, persisted on fsync.
  * SYNC   — + synchronous metadata operations (journal commit fenced
             before return) and an explicit fence after every data op.
             No data atomicity: a crash can tear an in-place overwrite.
  * STRICT — + atomic data operations: overwrites are also staged and
             relinked on fsync; every operation appends one 64 B oplog
             entry (1 cacheline + 1 fence), so staged-but-unsynced state
             is recovered by idempotent log replay.
"""

from __future__ import annotations

import enum


class Mode(enum.IntEnum):
    POSIX = 0
    SYNC = 1
    STRICT = 2

    @property
    def syncs_data(self) -> bool:
        return self in (Mode.SYNC, Mode.STRICT)

    @property
    def atomic_data(self) -> bool:
        return self is Mode.STRICT

    @property
    def logs_ops(self) -> bool:
        return self is Mode.STRICT
