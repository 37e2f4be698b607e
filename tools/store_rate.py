#!/usr/bin/env python3
"""Host rates of the port's copied SplitFS store on one file, no card.

    python3 tools/store_rate.py [GB]

Formats a numpy PM device of four times ``GB`` (default 0.5) plus 256 MB,
opens a SYNC ``USplit`` with 256 MB staging files, and prints the zlib
crc32 rate over ``GB`` of random bytes, the staged-append rate of 64 MB
writes, the seconds a GB of the relink fsync and of one ``pread`` of the
whole file (and whether it read back the bytes written), and the store's
stats.  Every figure is the host's, on whatever machine runs it.
"""

from __future__ import annotations

import sys
import time
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (Mode, PMDevice, USplit, Volume,  # noqa: E402
                              VolumeGeometry)


def main() -> int:
    gb = float(sys.argv[1]) if len(sys.argv) > 1 else 0.5
    nbytes = int(gb * 2**30)
    t = time.perf_counter()
    dev = PMDevice(size=nbytes * 4 + 256 * 2**20)
    vol = Volume.format(dev, VolumeGeometry(meta_blocks=16384,
                                            journal_blocks=16384,
                                            oplog_slots=1, oplog_blocks=512))
    print("format s", time.perf_counter() - t)
    store = USplit(vol, mode=Mode.SYNC, staging_file_bytes=256 * 2**20,
                   staging_prealloc=2, staging_background=False)
    data = np.random.default_rng(0).integers(0, 256, nbytes,
                                             dtype=np.uint8).tobytes()
    t = time.perf_counter()
    zlib.crc32(data)
    print("crc GB/s", gb / (time.perf_counter() - t))
    fd = store.open("x", create=True)
    t = time.perf_counter()
    chunk = 64 * 2**20
    for i in range(0, nbytes, chunk):
        store.write(fd, data[i:i + chunk])
    print("write GB/s", gb / (time.perf_counter() - t))
    t = time.perf_counter()
    store.fsync(fd)
    print("fsync s/GB", (time.perf_counter() - t) / gb)
    t = time.perf_counter()
    got = store.pread(fd, nbytes, 0)
    print("pread s/GB", (time.perf_counter() - t) / gb, got == data)
    print(store.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
