"""The port's copies of the SplitFS store (``repro_torch.core``: extents,
journal, K-Split, relink, the mmap cache, staging, the volume and U-Split)
against the reference's ``repro.core``, byte for byte.

Each scenario of tests/test_store.py, test_core_primitives.py and
test_crash_recovery.py runs the same seeded operations on a volume of each
package, in each of POSIX, SYNC and STRICT, and must leave equal PM bytes,
equal namespaces, equal ``StoreStats`` and ``Meter`` counts and equal
reads; then a ``torn_copy`` of each device with the same rng (a torn tail
included) is mounted, STRICT replays its oplog, and the recovered files
must be equal too.

Staging files are named from ``id(store)`` and a class-wide counter, so
both packages' store modules see one fixed ``id`` and both counters start
from 0 in every case.
"""

import hashlib
import subprocess
import sys
import types
from dataclasses import asdict

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.relink as ref_relink
import repro.core.staging as ref_staging
import repro.core.store as ref_store
import repro_torch.core as port_core
import repro_torch.core.relink as port_relink
import repro_torch.core.staging as port_staging
import repro_torch.core.store as port_store

B = ref_core.BLOCK_SIZE
PACKAGES = {
    "ref": types.SimpleNamespace(core=ref_core, relink=ref_relink.relink,
                                 staging=ref_staging, store=ref_store),
    "port": types.SimpleNamespace(core=port_core, relink=port_relink.relink,
                                  staging=port_staging, store=port_store),
}
MODES = ["POSIX", "SYNC", "STRICT"]
DEVICE_BYTES = 16 * 1024 * 1024


def blk(n=1, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n * B, dtype=np.uint8).tobytes()


def data(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


class Run:
    """One package's volume and stores for one scenario."""

    def __init__(self, pkg, mode: str) -> None:
        self.pkg = pkg
        c = pkg.core
        self.mode = c.Mode[mode]
        self.geometry = c.VolumeGeometry(meta_blocks=64, journal_blocks=128,
                                         oplog_slots=2, oplog_blocks=64)
        self.device = c.PMDevice(size=DEVICE_BYTES)
        self.volume = c.Volume.format(self.device, self.geometry)
        self.stores = []
        self.reads = []

    def store(self, mode=None, **kw):
        c = self.pkg.core
        mode = self.mode if mode is None else c.Mode[mode]
        kw.setdefault("staging_file_bytes", 1024 * 1024)
        kw.setdefault("staging_prealloc", 2)
        kw.setdefault("staging_background", False)
        if mode is c.Mode.STRICT:
            kw.setdefault("oplog_slot", len(self.stores))
        s = c.USplit(self.volume, mode=mode, **kw)
        self.stores.append(s)
        return s

    def read(self, value) -> None:
        self.reads.append(value)

    def record(self) -> dict:
        return {
            "buf": hashlib.sha256(self.device.buf).hexdigest(),
            "namespace": dict(self.volume.ksplit.namespace),
            "stats": [asdict(s.stats) for s in self.stores],
            "meter": dict(self.device.meter.counts),
            "off_meter": dict(self.device.meter.off_counts),
            "reads": self.reads,
        }

    def recover(self, seed: int, torn_bytes: int) -> dict:
        """Tear a copy of the device, mount it, recover the first store's
        oplog in STRICT, and read every file back."""
        c = self.pkg.core
        crashed = self.device.torn_copy(np.random.default_rng(seed),
                                        torn_bytes)
        vol = c.Volume.mount(crashed, self.geometry)
        kw = dict(staging_file_bytes=1024 * 1024, staging_prealloc=1,
                  staging_background=False)
        if self.mode is c.Mode.STRICT:
            kw.update(oplog_slot=0, recover=True)
        try:
            s = c.USplit(vol, mode=self.mode, **kw)
        except (c.FSError, AssertionError) as e:   # the replay's own faults
            return {"replay_error": f"{type(e).__name__}: {e}",
                    "namespace": sorted(vol.ksplit.namespace)}
        files = {}
        for name in sorted(vol.ksplit.namespace):
            if name.startswith("."):
                continue
            try:
                files[name] = s.read_file(name)
            except c.FSError as e:
                files[name] = type(e).__name__
        return {"files": files, "namespace": sorted(vol.ksplit.namespace),
                "buf": hashlib.sha256(crashed.buf).hexdigest()}


# ---------------------------------------------------------------- scenarios
# each takes a Run and drives its stores; reads go into run.reads


def sc_basics(r):
    s = r.store()
    fd = s.open("f", create=True)
    s.write(fd, b"0123456789")
    fd2 = s.dup(fd)
    s.lseek(fd, 2)
    r.read(s.read(fd2, 3))
    fd3 = s.open("f")
    r.read(s.read(fd3, 3))
    r.read(s.pread(fd, 100, 0))
    r.read(s.pread(fd, 10, 50))
    s.write_file("g", b"data")
    s.unlink("g")
    s.write_file("a", b"payload")
    s.rename("a", "b")
    r.read(s.read_file("b"))
    s.write_file("t", blk(4, 1))
    ft = s.open("t")
    s.ftruncate(ft, B + 10)
    r.read(s.read_file("t"))
    r.read(s.ksplit.pool.num_free)


def sc_aligned_appends(r):
    s = r.store()
    fd = s.open("f", create=True)
    for i in range(8):
        s.write(fd, blk(seed=i))
    r.read(len(s._fds[fd].state.staged))
    s.fsync(fd)
    s.fsync(fd)                              # idempotent
    r.read(s.read_file("f"))


def sc_unaligned_appends(r):
    s = r.store()
    fd = s.open("f", create=True)
    s.write(fd, b"x" * 100)
    s.fsync(fd)
    s.write(fd, b"y" * (2 * B))
    r.read(s.pread(fd, 12, 98))
    r.read(s.ksplit.stat("f").size)
    s.fsync(fd)
    r.read(s.read_file("f"))


def sc_overwrites(r):
    s = r.store()
    fd = s.open("f", create=True)
    s.write(fd, blk(2, seed=1))
    s.fsync(fd)
    s.pwrite(fd, b"NEW", 100)
    r.read(s.pread(fd, 3, 100))
    s.pwrite(fd, blk(1, seed=2), 0)          # full-block overwrite
    s.pwrite(fd, b"Z" * 16, B - 8)           # straddles two blocks
    s.fsync(fd)
    r.read(s.read_file("f"))


def sc_two_stores(r):
    a = r.store()
    b = r.store("POSIX")
    fa = a.open("shared", create=True)
    a.write(fa, blk(2, seed=3))
    r.read(b.stat_size("shared"))
    a.fsync(fa)
    fb = b.open("shared")
    r.read(b.read_file("shared"))
    a.pwrite(fa, b"LIVE", 10)
    r.read(b.pread(fb, 4, 10))
    f2 = b.open("p", create=True)
    b.write(f2, blk(1, seed=5))
    b.fsync(f2)
    r.read(a.read_file("p"))


def sc_ablations(r):
    split_only = r.store(stage_appends=False)
    fd = split_only.open("k", create=True)
    split_only.write(fd, blk(2, seed=6))
    r.read(split_only.read_file("k"))
    copy = r.store("POSIX", publish_mode="copy")
    fc = copy.open("c", create=True)
    for i in range(4):
        copy.write(fc, blk(1, seed=i))
    copy.fsync(fc)
    r.read(copy.read_file("c"))


def sc_relink(r):
    s = r.store()
    s.write_file("src", blk(4, seed=9))
    s.write_file("dst", blk(2, seed=10))
    r.read(r.pkg.relink(s.ksplit, "src", B, "dst", 0, 2 * B))
    s.write_file("s2", blk(2, seed=11))
    s.write_file("d2", blk(2, seed=12))
    r.read(r.pkg.relink(s.ksplit, "s2", 100, "d2", 100, B))
    r.read(s.read_file("dst"))
    r.read(s.read_file("d2"))


def sc_oracle_ops(r):
    """A seeded draw of tests/test_store.py's oracle operations."""
    rng = np.random.default_rng(2024)
    s = r.store()
    fd = s.open("f", create=True)
    size = 0
    for _ in range(40):
        kind = rng.choice(["append", "overwrite", "read", "fsync",
                           "truncate"])
        n = int(rng.integers(1, 3 * B))
        off = int(rng.integers(0, 4 * B))
        payload = data(n, int(rng.integers(0, 2**16)))
        if kind == "append":
            s.pwrite(fd, payload, size)
            size += n
        elif kind == "overwrite":
            off = min(off, size)
            s.pwrite(fd, payload, off)
            size = max(size, off + n)
        elif kind == "read":
            r.read(s.pread(fd, n, min(off, size)))
        elif kind == "fsync":
            s.fsync(fd)
        else:
            size = min(off, size)
            s.ftruncate(fd, size)
    s.fsync(fd)
    r.read(s.read_file("f"))


def sc_shared_tail_block(r):
    """tests/test_store.py's regression: a partial tail block shared by two
    staged extents."""
    s = r.store()
    fd = s.open("f", create=True)
    size = [0]

    def append(n, seed):
        s.pwrite(fd, data(n, seed), size[0])
        size[0] += n

    for _ in range(5):
        append(1, 0)
    append(2319, 1)
    s.fsync(fd)
    append(1773, 2)
    s.pwrite(fd, b"Z", 1)
    append(1, 3)
    append(1, 4)
    s.fsync(fd)
    r.read(s.read_file("f"))


def sc_unsynced_tail(r):
    """test_crash_recovery.py: synced files, then appends and an overwrite
    never fsynced before the crash."""
    s = r.store()
    s.write_file("a", blk(2, seed=1))
    s.write_file("b", blk(1, seed=2))
    s.rename("b", "c")
    fd = s.open("a")
    s.lseek(fd, 0, 2)
    s.write(fd, blk(1, seed=4))
    s.write(fd, b"tail")
    s.pwrite(fd, blk(1, seed=7), 0)
    r.read(s.pread(fd, 8, 0))


def sc_fsync_every(r):
    """test_crash_recovery.py's crash after periodic fsyncs (25 appends,
    fsync every 7)."""
    s = r.store()
    fd = s.open("f", create=True)
    for i in range(25):
        s.write(fd, blk(1, seed=100 + i))
        if (i + 1) % 7 == 0:
            s.fsync(fd)


def sc_torn_log_entry(r):
    """test_crash_recovery.py: bytes torn inside the second oplog entry (in
    STRICT; the other modes keep no oplog and tear nothing)."""
    s = r.store()
    fd = s.open("f", create=True)
    s.write(fd, blk(1, seed=9))
    s.write(fd, blk(1, seed=10))
    if s.oplog is not None:
        r.device.buf[s.oplog.base + 64 + 20] ^= 0xAA


def sc_oplog_wrap(r):
    """More data ops than a STRICT oplog of 64 blocks holds (4096 slots):
    the log-full checkpoint relinks the open staged file and the log
    wraps."""
    s = r.store()
    fd = s.open("f", create=True)
    for i in range(4200):
        s.write(fd, data(60 + i % 50, i))
    r.read(s.pread(fd, 300, 250000))


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_basics, sc_aligned_appends, sc_unaligned_appends, sc_overwrites,
    sc_two_stores, sc_ablations, sc_relink, sc_oracle_ops,
    sc_shared_tail_block, sc_unsynced_tail, sc_fsync_every,
    sc_torn_log_entry, sc_oplog_wrap)}


@pytest.fixture
def fixed_staging_names(monkeypatch):
    """Both store modules name staging files from the same ``id``; both
    staging counters restart at 0."""
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg.store, "id", lambda obj: 0x5EED,
                            raising=False)
        monkeypatch.setattr(pkg.staging.StagingAllocator, "_counter", 0)


def run_both(scenario, mode):
    runs = {}
    for name, pkg in PACKAGES.items():
        r = Run(pkg, mode)
        scenario(r)
        runs[name] = r
    return runs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_store_copy_is_byte_identical(scenario, mode, fixed_staging_names):
    runs = run_both(SCENARIOS[scenario], mode)
    ref, port = runs["ref"].record(), runs["port"].record()
    for key in ref:
        assert port[key] == ref[key], f"{scenario}/{mode}: {key} differs"
    for seed, torn in ((0, 0), (1, 4096)):
        a = runs["ref"].recover(seed, torn)
        b = runs["port"].recover(seed, torn)
        assert b == a, f"{scenario}/{mode}: recovery (seed {seed}) differs"


# ---------------------------------------------------------------- primitives


def test_primitives_write_identical_bytes():
    """Journal commits (one torn), oplog appends and a wrap, pool
    allocation and extent moves on a bare device of each package."""
    out = {}
    for name, pkg in PACKAGES.items():
        c = pkg.core
        dev = c.PMDevice(size=4 * 1024 * 1024)
        j = c.Journal(dev, base_block=1, num_blocks=8)
        with j.begin() as t:
            t.log(b"alpha")
            t.log(b"beta")
        head = j.head
        with j.begin() as t:
            t.log(b"torn")
        dev.buf[j.base + head + 30] ^= 0xFF
        replayed = j.replay()
        calls = []
        log = c.OpLog(dev, base_block=16, num_blocks=1,
                      on_full=lambda: calls.append(1))
        for i in range(80):
            log.append(c.LogEntry(op=1, mode=2, seqno=i, inode=i, offset=i,
                                  length=i + 1, staging_addr=i * 64))
        pool = c.PagePool(dev, base_block=32, num_blocks=128)
        blocks = pool.alloc(16, contiguous=True)
        pool.free(blocks[:5])
        src, dst = c.ExtentMap(), c.ExtentMap()
        for i in range(6):
            src.set_block(10 + i, 1000 + i)
        dst.set_block(12, 7)
        replaced = c.move_extents(src, 10, dst, 11, 6)
        out[name] = (dev.buf.tobytes(), replayed, calls,
                     [asdict(e) for e in log.scan()],
                     blocks, pool.num_free, replaced, dst.blocks,
                     dict(dev.meter.counts),
                     [(s.logical_off, s.phys_block, s.block_off, s.length)
                      for s in dst.segments(11 * B + 5, 3 * B)])
    ref, port = out["ref"], out["port"]
    assert port[0] == ref[0]
    assert port[1:] == ref[1:]


# ---------------------------------------------------------------- imports


def test_port_modules_import_no_jax_or_reference():
    code = ("import sys, repro_torch.core, repro_torch.checkpoint, "
            "repro_torch.train, repro_torch.launch.train; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax', 'jaxlib')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
