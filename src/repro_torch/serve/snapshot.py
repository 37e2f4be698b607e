"""Failure-atomic session snapshot + restore (DESIGN.md §12); port of
``repro.serve.snapshot`` onto torch tensors.

A session's migratable state is the pair (metadata, bytes):

  * metadata — the controller-side ``SeqSnapshot`` (length, committed
    page count, consistency mode, live page ids) plus the request's own
    cursors (prompt_pos, output, sampler/spec config), which travel on
    the ``Request`` object itself;
  * bytes — a device copy of every live KV page across the layer pools,
    and for recurrent archs the slot's conv/h/ssd state leaves, taken at
    capture: the source may reuse its pages before the restore (a
    detached live source frees them; a parked snapshot waits while the
    source or the survivors go on).  Both engines share the card, so the
    copy stays on it.

Restore follows the msync/relink discipline end to end: STAGE (allocate
a fresh sid + pages on the target, scatter the bytes — nothing
published, no oplog entries), then FLIP (``restore_seq``: one critical
section that commits every full page and, for a STRICT session, logs
its OP_KV_COMMIT entries in the TARGET's volume).  A crash between
stage and flip replays the target to its pre-restore committed state —
never to a torn session — and the source's tombstone (``detach`` ->
``free_seq`` -> OP_UNLINK) keeps the SOURCE volume's replay clean when
the source was alive to write it.

A queued (never-admitted) session has no device state: its snapshot is
just the request, and restore re-queues it for ordinary admission —
exact, because it produced no output yet.  The same fallback covers a
mid-promotion session (its device extent is not yet published, so the
prompt replay IS its committed state).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..core.kvcache import KVPoolFullError, SeqSnapshot
from .engine import Request, ServingEngine


class MigrationError(RuntimeError):
    """Restore could not stage on the target (no free slot); the caller
    parks the snapshot and retries when capacity frees up."""


@dataclass
class SessionSnapshot:
    """Everything needed to resume a session on another engine without
    replaying its prompt.  ``seq is None`` marks the requeue-from-prompt
    fallback (queued or mid-promotion at capture — no published device
    state to carry)."""
    request: Request
    seq: Optional[SeqSnapshot]
    page_bytes: List[List[torch.Tensor]] = field(default_factory=list)
    state: Optional[List[torch.Tensor]] = None  # recurrent conv/h/ssd leaves


def snapshot_session(engine: ServingEngine, req: Request) -> SessionSnapshot:
    """Capture a live session between engine steps.

    Safe on a DEAD engine too: the engine object froze at its last
    completed step (fail-stop — the PM-survives-process-death analogue),
    so its pools and controller are merely read.  Between steps the
    committed extent equals the full-page extent (speculative staging is
    verified and committed within the step), so the restore flip
    reproduces the source's committed set exactly."""
    if req.slot is None or req.seq_id is None or req.promoting:
        return SessionSnapshot(request=req, seq=None)
    snap = engine.controller.snapshot_seq(req.seq_id)
    page_bytes = engine._capture_pages(snap.pages)
    state = engine._gather_slot_state(req.slot) if engine._recurrent else None
    return SessionSnapshot(request=req, seq=snap,
                           page_bytes=page_bytes, state=state)


def restore_session(engine: ServingEngine, snap: SessionSnapshot) -> Request:
    """Install a snapshot on ``engine``: stage, copy bytes, flip.

    Raises ``MigrationError`` (no free slot) or ``KVPoolFullError`` (no
    free sid/pages) BEFORE any engine state changes; after a staging
    failure mid-copy the staged sequence is freed, so the target is
    never left holding a half-restored extent."""
    req = snap.request
    if snap.seq is None:
        # no device state captured: plain re-admission from the prompt
        req.slot = None
        req.seq_id = None
        req.prompt_pos = 0
        req.prefix_tokens = 0
        req.promoting = False
        engine.waiting.append(req)
        return req
    free = [s for s in range(engine.max_batch) if s not in engine.active]
    if not free:
        raise MigrationError("no free slot on target engine")
    slot = free[0]
    sid, pages = engine.controller.restore_seq_staged(snap.seq)
    try:
        # STAGE: bytes land in allocated-but-unpublished pages (on the
        # compute stream, after the target's promotions; never through
        # the tier's side stream); a crash here replays the target to its
        # pre-restore committed state
        for views, page in zip(snap.page_bytes, pages):
            engine._write_page(views, page)
        if snap.state is not None:
            engine._scatter_slot_state(slot, snap.state)
        else:
            engine._zero_slot_state(slot)
    except Exception:
        engine.controller.free_seq(sid)
        raise
    # FLIP: publish the restored extent (+ STRICT oplog) in one critical
    # section, then wire the engine-side mirrors
    engine.controller.restore_seq(sid)
    req.slot = slot
    req.seq_id = sid
    req.promoting = False
    engine.active[slot] = req
    engine._set_device_length(slot, snap.seq.length)
    engine._sync_page_table()
    return req
