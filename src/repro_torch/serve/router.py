"""Prefix-affinity routing for the cluster plane (DESIGN.md §12); a copy
of ``repro.serve.router`` (zlib + numpy).

New sessions hash their first ``prefix_tokens`` prompt tokens and land on
the shard that hash names — prompts sharing a prefix (few-shot headers,
system prompts) keep hitting the SAME engine, so that engine's prefix
trie stays hot and adoption keeps skipping their prefill chunks.  This is
deliberately the directory-hash half of a split design: routing is a pure
metadata decision over token ids, touching no engine state.

Affinity loses to overload: when the home shard is ``spill_margin``
sessions deeper than the least-loaded shard, the session spills there —
it pays cold prefill once but does not queue behind a hot spot.  The
margin is the hysteresis that keeps routing sticky under jitter (a margin
of 0 would degenerate to pure least-loaded and shred every trie).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np


def prefix_hash(prompt: List[int], k: int) -> int:
    """Stable hash of the first ``k`` prompt tokens (crc32 over the
    int32 bytes — deterministic across processes, unlike ``hash``)."""
    return zlib.crc32(np.asarray(prompt[:k], dtype=np.int32).tobytes())


class PrefixRouter:
    """Maps a new session's prompt to a data shard index.

    ``n_shards`` is mutable on purpose: a remesh that drops an engine
    shrinks the shard space and the router just mods into the smaller
    ring (sessions already placed are unaffected — placement is decided
    once, at submit).
    """

    def __init__(self, n_shards: int, *, prefix_tokens: int = 16,
                 spill_margin: int = 8) -> None:
        if n_shards < 1:
            raise ValueError("need at least one shard")
        if spill_margin < 1:
            raise ValueError("spill_margin must be >= 1 (0 is least-loaded)")
        self.n_shards = n_shards
        self.prefix_tokens = prefix_tokens
        self.spill_margin = spill_margin
        # plain-int stats, read lazily by the obs registry
        self.routed_home = 0
        self.spills = 0

    def route(self, prompt: List[int],
              loads: Dict[int, int]) -> Tuple[int, bool]:
        """Pick a shard for ``prompt`` given per-shard session counts.

        Returns ``(shard, spilled)``.  ``loads`` must cover every live
        shard; the home shard is ``prefix_hash % n_shards`` and the
        session spills to the least-loaded shard (lowest index on ties)
        only when home is ``spill_margin`` sessions deeper."""
        home = prefix_hash(prompt, self.prefix_tokens) % self.n_shards
        if home not in loads:
            # home shard has no live engine (mid-remesh window): fall
            # through to least-loaded among the shards that do
            home = min(loads)
        least = min(loads, key=lambda s: (loads[s], s))
        if loads[home] - loads[least] >= self.spill_margin:
            self.spills += 1
            return least, True
        self.routed_home += 1
        return home, False

    def stats(self) -> Dict[str, int]:
        return {"n_shards": self.n_shards,
                "routed_home": self.routed_home,
                "spills": self.spills}
