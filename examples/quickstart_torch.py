"""Quickstart on the port: the SplitFS storage plane in 40 lines, with the
appended blocks coming from and going back to tensors on ``--device``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device`` defaults to ``cuda`` and raises without a card.
"""

import argparse

import torch

from repro_torch.core import Mode, PMDevice, USplit, Volume
from repro_torch.kernels.common import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

# 1. a PM device + a formatted volume (metadata home, journal, oplog, pool)
device = PMDevice(size=256 * 1024 * 1024)
volume = Volume.format(device)

# 2. a U-Split instance in strict mode: synchronous + atomic data ops
fs = USplit(volume, mode=Mode.STRICT, staging_file_bytes=16 * 1024 * 1024,
            staging_prealloc=2, staging_background=False)

# 3. appends land in pre-allocated staging via nt-stores — no kernel trap;
#    each 4 KiB block is a tensor on the device, copied to the host
blocks = torch.arange(64, dtype=torch.uint8, device=dev)[:, None].expand(
    64, 4096).contiguous()
fd = fs.open("demo.log", create=True)
for i in range(64):
    fs.write(fd, blocks[i].cpu().numpy().tobytes())

# 4. reads see staged data immediately (collection-of-mmaps routing)
back = torch.frombuffer(bytearray(fs.pread(fd, 4096, 63 * 4096)),
                        dtype=torch.uint8).to(dev)
assert torch.equal(back, blocks[63])

# 5. fsync publishes with RELINK: metadata-only, zero data copies
fs.fsync(fd)
print(f"relinked blocks : {fs.stats.relinked_blocks}")
print(f"copied bytes    : {fs.stats.copied_bytes}   <- the zero-copy claim")
print(f"log entries     : {fs.stats.log_entries} (one 64B line + 1 fence each)")

# 6. software overhead accounting (the paper's headline metric)
m = device.meter
print(f"modeled total   : {m.ns()/64/1000:.2f} us/append")
print(f"device transfer : {m.device_ns()/64/1000:.2f} us/append")
print(f"software        : {m.software_ns()/64/1000:.2f} us/append")

# 7. the same primitives drive the serving plane
from repro_torch.core.kvcache import KVGeometry, PagedKVCache  # noqa: E402

kv = PagedKVCache(KVGeometry(num_pages=64, page_tokens=16, max_seqs=4))
seq = kv.create_seq()
kv.ensure_capacity(seq, 40)
kv.advance(seq, 40)
fork = kv.fork(seq)                      # zero-copy: shared pages, refcounted
print(f"fork shares pages; CoW copies so far: {kv.pages_copied}")
kv.prepare_append(fork)                  # partial tail page -> CoW (1 copy)
print(f"after first divergent append:  {kv.pages_copied}")
