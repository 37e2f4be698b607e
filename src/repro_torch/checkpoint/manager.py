"""Checkpoint manager on trees of torch tensors (port of
``repro/checkpoint/manager.py``): the paper's technique applied to
training state.

Mechanism mapping (DESIGN.md §3.5), as in the reference:
  * every parameter/optimizer leaf is APPENDED to the SplitFS store —
    appends land in pre-allocated staging files via nt-stores, so the
    training loop's critical path never allocates or journals;
  * ``commit`` = fsync: the staged shard extents are RELINKED into the
    checkpoint file (metadata-only publish, zero copies) and the manifest
    is journaled — a crash mid-save can never expose a half-written step;
  * three modes: POSIX (``save(blocking=False)`` commits on a background
    thread), SYNC (durable on return), STRICT (durable + atomic per shard
    via the 64 B oplog);
  * restore picks the newest manifest with a valid checksum and falls back
    past one that fails it.

File layout (all inside one PM volume), byte for byte the reference's:
  ckpt/<step>/shard-<host>.bin    packed leaf bytes (appended then relinked)
  ckpt/<step>/MANIFEST-<host>     crc32 + JSON header + per-leaf (path,
                                  dtype, shape, offset, nbytes, crc32)
  ckpt/LATEST                     step pointer (atomic rename publish)

Leaves are named by their ``"/"``-joined dict keys in sorted-key order, as
``jax.tree_util.tree_flatten_with_path`` names them; dtypes by numpy's
names, with ``"bfloat16"`` as ml_dtypes names it.  A leaf's bytes are its
contiguous storage read through a ``torch.uint8`` view, so bfloat16 needs
no numpy type.

Where the port differs, and why:
  * A leaf larger than ``chunk_bytes``, or one the staging file being
    filled cannot hold, is written in pieces, where the reference writes
    it whole: when it starts inside a block, first the bytes to the
    block's end, then chunks of ``chunk_bytes`` (``_cuts``).  The
    reference's one write can land in a fresh staging file at an offset
    inside a block, and the relink then copies that partial head block;
    here a write that opens a staging file starts on a block, so the
    commit copies nothing.  A leaf of one piece that the current staging
    file holds is one write, as in the reference.  The crc runs over the
    pieces (``zlib.crc32(chunk, crc)``), so the records equal those of one
    write per leaf, and with ``chunk_bytes`` at least the largest leaf the
    PM bytes, oplog included, are the reference's unless a staging file
    fills mid-leaf.
  * On a card each piece passes a ring of ``chunk_bytes`` page-locked
    host slots, reused across saves: D2H of one piece on a side stream
    overlaps ``store.write`` of the one before.
  * The port's AdamW updates the state in place, where the reference's
    arrays are immutable.  ``save(blocking=False)`` therefore snapshots the
    tree before it returns: a clone of every leaf on the side stream, which
    the caller's stream waits for before its next kernel.  The background
    thread streams from the clone (one more copy of the state on the
    tree's device until the commit lands).
  * ``save`` waits for a background save still in flight, and ``wait``
    re-raises what that save raised.

``last_save`` and ``last_restore`` hold the host seconds of the last save
and restore by part (``d2h`` / ``h2d``: waits on the ring's copies;
``write`` / ``read``: the store's data path, staging included; ``fsync``:
the shard's relink commit; ``manifest``: the manifest and ``LATEST``
publishes or reads, and the GC; ``crc``), with ``bytes`` and ``seconds``.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.ksplit import NoEntError
from ..core.modes import Mode
from ..core.pmem import BLOCK_SIZE
from ..core.store import USplit

# torch dtype <-> the numpy name the reference writes into the manifest
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}

CHUNK_BYTES = 16 * 1024 * 1024      # one slot of the host ring
RING_SLOTS = 2                      # slots in flight: copy one, write one


def _leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, Any]]:
    """(name, leaf) in the reference's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(like: Any, it) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """The leaf's storage as a flat ``uint8`` tensor (no copy when it is
    contiguous)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _parts(*names: str) -> Dict[str, float]:
    return dict.fromkeys(names, 0.0)


class _HostRing:
    """``RING_SLOTS`` page-locked host chunks, each with the event of the
    last copy that touched it, reused across calls."""

    def __init__(self, chunk_bytes: int, device: torch.device) -> None:
        self.stream = torch.cuda.Stream(device)
        self.bufs = [torch.empty(chunk_bytes, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(RING_SLOTS)]
        self.events = [torch.cuda.Event() for _ in range(RING_SLOTS)]


class CheckpointManager:
    def __init__(self, store: USplit, *, host: int = 0, keep: int = 3,
                 chunk_bytes: int = CHUNK_BYTES) -> None:
        if chunk_bytes <= 0 or chunk_bytes % BLOCK_SIZE:
            raise ValueError(f"chunk_bytes={chunk_bytes}: a positive "
                             f"multiple of {BLOCK_SIZE}")
        self.store = store
        self.host = host
        self.keep = keep
        self.chunk_bytes = chunk_bytes
        self._flush_thread: Optional[threading.Thread] = None
        self._flush_error: Optional[Exception] = None
        self._rings: Dict[Tuple[str, torch.device], _HostRing] = {}
        self.saved_steps: List[int] = []
        self.last_save: Dict[str, float] = {}
        self.last_restore: Dict[str, float] = {}

    def _ring(self, role: str, device: torch.device) -> _HostRing:
        key = (role, device)
        if key not in self._rings:
            self._rings[key] = _HostRing(self.chunk_bytes, device)
        return self._rings[key]

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Write one checkpoint.  ``blocking=False`` (POSIX mode) returns
        once the tree is snapshotted; staging and the commit happen on a
        background thread — the relink makes it atomic whenever it
        lands."""
        self.wait()
        if not blocking and self.store.mode is Mode.POSIX:
            snap = self._snapshot(tree)
            t = threading.Thread(target=self._flush, args=(step, snap, extra),
                                 daemon=True)
            self._flush_thread = t
            t.start()
            return
        self._save_impl(step, tree, extra)

    def wait(self) -> None:
        if self._flush_thread is not None:
            self._flush_thread.join()
            self._flush_thread = None
        if self._flush_error is not None:
            err, self._flush_error = self._flush_error, None
            raise err

    def _flush(self, step: int, tree: Any, extra: Optional[Dict]) -> None:
        try:
            self._save_impl(step, tree, extra, on_caller_stream=False)
        except Exception as e:              # surfaced by wait()
            self._flush_error = e

    def _snapshot(self, tree: Any) -> Any:
        """A copy of every leaf, taken on the side stream of the leaf's card
        after the work already queued on the caller's stream; the caller's
        stream waits for the copies before its next kernel, so an in-place
        update that follows cannot reach them."""
        named = _leaf_paths(tree)
        copies = []
        for _, leaf in named:
            if not leaf.is_cuda:
                copies.append(leaf.detach().clone())
                continue
            ring = self._ring("save", leaf.device)
            caller = torch.cuda.current_stream(leaf.device)
            ring.stream.wait_stream(caller)
            with torch.cuda.stream(ring.stream):
                copies.append(leaf.detach().clone(
                    memory_format=torch.contiguous_format))
            caller.wait_stream(ring.stream)
        return _rebuild(tree, iter(copies))

    def _cuts(self, offset: int, n: int) -> List[Tuple[int, int]]:
        """(start, length) of each write of a leaf of ``n`` bytes at file
        offset ``offset``: one write when the leaf is one piece and the
        staging file being filled holds it; otherwise, for a leaf that
        starts inside a block, the bytes up to the block's end first, then
        chunks of ``chunk_bytes``.  Each later write then starts on a block
        boundary, so a staging-file switch between two writes leaves no
        partial head block for the relink to copy."""
        phase = offset % BLOCK_SIZE
        if n <= self.chunk_bytes and (not phase
                                      or self._fits_staging_file(n, phase)):
            return [(0, n)]
        head = min(n, -offset % BLOCK_SIZE)
        cuts = [(0, head)] if head else []
        return cuts + [(a, min(self.chunk_bytes, n - a))
                       for a in range(head, n, self.chunk_bytes)]

    def _fits_staging_file(self, n: int, phase: int) -> bool:
        """Whether ``staging.take(n, phase)`` would land in the staging file
        the store is filling now: the allocator's own walk (skip to the
        phase, skip blocks a relink took), read only."""
        staging = self.store.staging
        cur = staging._current
        if cur is None:
            return False
        extents = staging.ksplit.inodes[cur.ino].extents
        used = cur.used
        while True:
            used += (phase - used) % BLOCK_SIZE
            if cur.capacity - used < n:
                return False
            if extents.lookup_block(used // BLOCK_SIZE) is not None:
                return True
            used = (used // BLOCK_SIZE + 1) * BLOCK_SIZE

    def _leaf_chunks(self, leaf: torch.Tensor, offset: int,
                     on_caller_stream: bool, times: Dict[str, float]):
        """The bytes of ``leaf`` (at file offset ``offset``) in order, as
        numpy ``uint8`` chunks cut by ``_cuts``: views of the storage for a
        host tensor; for a card tensor, slots of the host ring, each copied
        D2H one slot ahead of its consumer (after the caller stream's
        queued work when ``on_caller_stream``; a snapshot is ordered
        already)."""
        flat = _byte_view(leaf)
        cuts = self._cuts(offset, flat.numel())
        if not flat.is_cuda:
            arr = flat.numpy()
            for a, m in cuts:
                yield arr[a:a + m]
            return
        ring = self._ring("save", flat.device)
        if on_caller_stream:
            ring.stream.wait_stream(torch.cuda.current_stream(flat.device))
        pending = []
        for i, (a, m) in enumerate(cuts):
            slot = i % RING_SLOTS
            with torch.cuda.stream(ring.stream):
                ring.bufs[slot][:m].copy_(flat[a:a + m], non_blocking=True)
                ring.events[slot].record(ring.stream)
            pending.append((slot, m))
            if len(pending) == RING_SLOTS:
                yield self._landed(ring, *pending.pop(0), times)
        for slot, m in pending:
            yield self._landed(ring, slot, m, times)

    @staticmethod
    def _landed(ring: _HostRing, slot: int, m: int,
                times: Dict[str, float]) -> np.ndarray:
        t0 = time.perf_counter()
        ring.events[slot].synchronize()
        times["d2h"] += time.perf_counter() - t0
        return ring.bufs[slot][:m].numpy()

    def _save_impl(self, step: int, tree: Any, extra: Optional[Dict],
                   on_caller_stream: bool = True) -> None:
        store = self.store
        times = _parts("d2h", "crc", "write", "fsync", "manifest")
        t_start = time.perf_counter()
        shard_name = f"ckpt/{step}/shard-{self.host}.bin"
        manifest_name = f"ckpt/{step}/MANIFEST-{self.host}"
        fd = store.open(shard_name, create=True)
        records = []
        offset = 0
        for name, leaf in _leaf_paths(tree):
            crc, nbytes = 0, 0
            for chunk in self._leaf_chunks(leaf, offset, on_caller_stream,
                                           times):
                t0 = time.perf_counter()
                crc = zlib.crc32(chunk, crc)
                t1 = time.perf_counter()
                store.write(fd, chunk)     # append -> staging (nt stores)
                times["crc"] += t1 - t0
                times["write"] += time.perf_counter() - t1
                nbytes += len(chunk)
            records.append({
                "path": name, "dtype": _DTYPE_NAMES[leaf.dtype],
                "shape": list(leaf.shape), "offset": offset,
                "nbytes": nbytes, "crc": crc,
            })
            offset += nbytes
        t0 = time.perf_counter()
        store.fsync(fd)                    # relink: metadata-only commit
        store.close(fd)
        t1 = time.perf_counter()
        times["fsync"] = t1 - t0

        manifest = {
            "step": step, "host": self.host,
            "records": records, "extra": extra or {},
        }
        blob = json.dumps(manifest).encode()
        blob = struct.pack("<I", zlib.crc32(blob)) + blob
        # atomic publish: write tmp, fsync, rename over the final name
        tmp = manifest_name + ".tmp"
        mfd = store.open(tmp, create=True)
        store.write(mfd, blob)
        store.fsync(mfd)
        store.close(mfd)
        store.rename(tmp, manifest_name)

        latest_tmp = f"ckpt/LATEST.tmp.{step}"
        lfd = store.open(latest_tmp, create=True)
        store.write(lfd, struct.pack("<Q", step))
        store.fsync(lfd)
        store.close(lfd)
        store.rename(latest_tmp, "ckpt/LATEST")
        self.saved_steps.append(step)
        self._gc()
        t2 = time.perf_counter()
        times["manifest"] = t2 - t1
        self.last_save = {**times, "bytes": offset, "seconds": t2 - t_start}

    def _gc(self) -> None:
        while len(self.saved_steps) > self.keep:
            victim = self.saved_steps.pop(0)
            for name in (f"ckpt/{victim}/shard-{self.host}.bin",
                         f"ckpt/{victim}/MANIFEST-{self.host}"):
                try:
                    self.store.unlink(name)
                except NoEntError:
                    pass

    # ------------------------------------------------------------------ restore

    def latest_step(self) -> Optional[int]:
        try:
            data = self.store.read_file("ckpt/LATEST")
        except NoEntError:
            return None
        if len(data) < 8:
            return None
        return struct.unpack("<Q", data[:8])[0]

    def _load_manifest(self, step: int) -> Optional[Dict]:
        try:
            blob = self.store.read_file(f"ckpt/{step}/MANIFEST-{self.host}")
        except NoEntError:
            return None
        if len(blob) < 4:
            return None
        crc, payload = struct.unpack("<I", blob[:4])[0], blob[4:]
        if zlib.crc32(payload) != crc:
            return None
        return json.loads(payload)

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Optional[Tuple[int, Any, Dict]]:
        """Restore into the structure of ``like``: new tensors on each
        ``like`` leaf's device, with the manifest's dtype and shape.  Falls
        back step-by-step past manifests that fail their checksum chain
        (torn by a crash).  Returns (step, tree, extra) or None."""
        self.last_restore = times = _parts("h2d", "crc", "read", "manifest")
        t_start = time.perf_counter()
        candidates: List[int] = []
        if step is not None:
            candidates = [step]
        else:
            latest = self.latest_step()
            if latest is None:
                return None
            candidates = sorted({latest, *self.saved_steps}, reverse=True)
        for s in candidates:
            t0 = time.perf_counter()
            manifest = self._load_manifest(s)
            times["manifest"] += time.perf_counter() - t0
            if manifest is None:
                continue
            tree = self._materialize(like, s, manifest, times)
            if tree is not None:
                times["bytes"] = sum(r["nbytes"] for r in manifest["records"])
                times["seconds"] = time.perf_counter() - t_start
                return s, tree, manifest.get("extra", {})
        return None

    def _read_leaf(self, fd: int, rec: Dict, device: torch.device,
                   times: Dict[str, float]) -> Optional[torch.Tensor]:
        """One record's bytes into a new tensor on ``device``, read in
        chunks of ``chunk_bytes`` (H2D from the host ring on a card), or
        None if they fail their crc."""
        out = torch.empty(rec["shape"], dtype=_DTYPES[rec["dtype"]],
                          device=device)
        flat = _byte_view(out)
        n, step, crc = rec["nbytes"], self.chunk_bytes, 0
        if flat.numel() != n:
            raise ValueError(f"{rec['path']}: {n} B recorded for "
                             f"{rec['dtype']} {rec['shape']}")
        ring = self._ring("restore", device) if out.is_cuda else None
        if ring is not None:
            ring.stream.wait_stream(torch.cuda.current_stream(device))
        for i, a in enumerate(range(0, n, step)):
            t0 = time.perf_counter()
            raw = self.store.pread(fd, min(step, n - a), rec["offset"] + a)
            t1 = time.perf_counter()
            crc = zlib.crc32(raw, crc)
            t2 = time.perf_counter()
            times["read"] += t1 - t0
            times["crc"] += t2 - t1
            src = np.frombuffer(raw, dtype=np.uint8)
            if ring is None:
                flat.numpy()[a:a + len(src)] = src
            else:
                slot = i % RING_SLOTS
                ring.events[slot].synchronize()   # its last H2D has read it
                ring.bufs[slot][:len(src)].numpy()[:] = src
                with torch.cuda.stream(ring.stream):
                    flat[a:a + len(src)].copy_(ring.bufs[slot][:len(src)],
                                               non_blocking=True)
                    ring.events[slot].record(ring.stream)
            times["h2d"] += time.perf_counter() - t2
        if ring is not None:
            torch.cuda.current_stream(device).wait_stream(ring.stream)
        return out if crc == rec["crc"] else None

    def _materialize(self, like: Any, step: int, manifest: Dict,
                     times: Dict[str, float]) -> Optional[Any]:
        shard = f"ckpt/{step}/shard-{self.host}.bin"
        try:
            fd = self.store.open(shard)
        except NoEntError:
            return None
        by_path = {r["path"]: r for r in manifest["records"]}
        leaves = []
        ok = True
        for name, leaf in _leaf_paths(like):
            rec = by_path.get(name)
            if rec is None:
                ok = False
                break
            got = self._read_leaf(fd, rec, leaf.device, times)
            if got is None:
                ok = False
                break
            leaves.append(got)
        self.store.close(fd)
        if not ok:
            return None
        return _rebuild(like, iter(leaves))
