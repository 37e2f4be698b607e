"""Deterministic, sharded, resumable synthetic token pipeline.

Every batch is a pure function of (seed, shard, step): restart/elastic
rescale replays exactly, and the pipeline state that must be checkpointed
is a single integer.  Modality extras (whisper frames, VLM patches) are
derived the same way so every arch family gets batches from one API.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..models.config import ModelConfig


@dataclass
class PipelineState:
    step: int = 0


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, *, global_batch: int, seq_len: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1,
                 state: Optional[PipelineState] = None) -> None:
        assert global_batch % num_shards == 0
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seq_len = seq_len
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.state = state or PipelineState()

    # -- deterministic generation -------------------------------------------------

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.shard, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for an absolute step (pure; used by replay tests)."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S = self.local_batch, self.seq_len
        # Zipf-ish marginals make the loss curve non-trivial
        tokens = (rng.zipf(1.3, size=(B, S + 1)) - 1) % cfg.vocab
        tokens = tokens.astype(np.int32)
        batch: Dict[str, np.ndarray] = {
            "tokens": tokens[:, :-1],
            "targets": tokens[:, 1:],
        }
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_patch_tokens, cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # -- checkpoint integration -----------------------------------------------------

    def snapshot(self) -> int:
        return self.state.step

    def restore(self, step: int) -> None:
        self.state.step = step

    def reshard(self, shard: int, num_shards: int) -> "TokenPipeline":
        """Elastic rescale: same seed/step, new shard layout — batches stay
        deterministic functions of (seed, shard, step)."""
        return TokenPipeline(self.cfg, global_batch=self.global_batch,
                             seq_len=self.seq_len, seed=self.seed,
                             shard=shard, num_shards=num_shards,
                             state=PipelineState(self.state.step))
