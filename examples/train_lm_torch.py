"""Train a small LM end-to-end on the port with SplitFS checkpointing +
crash restart, on ``--device``.

Default is a quick smoke run; ``--full`` trains a ~100M-parameter model for
a few hundred steps.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 30] [--full]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --crash-at 12

``--device`` defaults to ``cuda`` and raises without a card.
"""

import argparse
import dataclasses
import math

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import Mode, PMDevice, USplit, Volume, VolumeGeometry
from repro_torch.data import TokenPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, LoopConfig, run_training
from repro_torch.train.optimizer import leaves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps, batch 4 x seq 256")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a crash after this step to demo restart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    if args.full:
        cfg = dataclasses.replace(
            get_config("qwen2-1.5b"),
            n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab=32768, tie_embeddings=True,
            name="demo-100m")
        steps, gb, seq = max(args.steps, 300), 4, 256
    else:
        cfg = get_config("qwen2-1.5b", smoke=True)
        steps, gb, seq = args.steps, 8, 64

    api = build_model(cfg)
    n = sum(math.prod(s.shape) for s in leaves(api.init_specs()))
    print(f"model={cfg.name}  params={n/1e6:.1f}M  steps={steps}  "
          f"device={dev}")

    pipeline = TokenPipeline(cfg, global_batch=gb, seq_len=seq, seed=0)
    device = PMDevice(size=1024 * 1024 * 1024)
    volume = Volume.format(device, VolumeGeometry(
        meta_blocks=4096, journal_blocks=2048, oplog_slots=2,
        oplog_blocks=512))
    store = USplit(volume, mode=Mode.SYNC,
                   staging_file_bytes=64 * 1024 * 1024, staging_prealloc=4)
    ckpt = CheckpointManager(store)

    loop = LoopConfig(steps=steps, ckpt_every=max(5, steps // 5), log_every=5)
    opt = AdamWConfig(lr=1e-3, warmup_steps=max(2, steps // 10),
                      total_steps=steps)
    try:
        result = run_training(api, pipeline, loop, opt, ckpt=ckpt,
                              crash_at=args.crash_at, device=dev)
    except RuntimeError as e:
        print(f"[crash injected] {e}; restarting from checkpoint...")
        pipeline = TokenPipeline(cfg, global_batch=gb, seq_len=seq, seed=0)
        result = run_training(api, pipeline, loop, opt, ckpt=ckpt,
                              device=dev)
        print(f"resumed from step {result.restored_from}")

    print(f"loss: {result.losses[0]:.3f} -> {result.losses[-1]:.3f} "
          f"over {result.steps_run} steps")
    print(f"checkpoint store: relinked={store.stats.relinked_blocks} blocks, "
          f"copied={store.stats.copied_bytes}B "
          f"(zero-copy commits), fsyncs={store.stats.fsyncs}")


if __name__ == "__main__":
    main()
