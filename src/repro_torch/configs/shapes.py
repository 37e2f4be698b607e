"""Assigned input shapes (4 per architecture, 40 cells in all), copied
from ``repro/configs/shapes.py`` with its imports pointed at the port.

  train_4k     train_step   seq 4,096   global_batch 256
  prefill_32k  prefill      seq 32,768  global_batch 32
  decode_32k   serve_step   1 new token, 32,768-token KV, global_batch 128
  long_500k    serve_step   1 new token, 524,288-token state, global_batch 1
               (sub-quadratic only: SSM + hybrid; skipped for pure
               full-attention archs, see DESIGN.md §6)

The port's training runs on one card read ``TRAIN_4K``'s sequence length
at a batch cut to 4 (``chip_smoke.py`` phases 4, 6 and 15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..models.config import ModelConfig


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCfg("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeCfg("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeCfg("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeCfg("long_500k", "decode", 524288, 1)

ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]


def shapes_for(cfg: ModelConfig) -> List[ShapeCfg]:
    """The assignment defines 4 shapes per arch = 40 cells.  ``long_500k``
    is only *runnable* sub-quadratically; for pure full-attention archs the
    cell is recorded as a documented skip (DESIGN.md §6), so the runnable
    set is smaller than 40 but every cell has a disposition."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return out
