"""Continuous-batching serving engine over the paged KV store (port of
``repro/serve/engine.py``).

The split architecture at serving time (DESIGN.md §3.4):
  * data plane: ONE fixed-shape ``serve_step(tokens[B, C], n_new[B])``
    over the pool tensors, allocated once.  Each step processes up to C new
    tokens per slot: prefill consumes the prompt chunk by chunk, decode
    runs the width-1 slice, mixed prefill/decode batches are one call.  C
    defaults to ``page_tokens``, so a full prefill chunk fills exactly one
    KV page and costs exactly ONE metadata publish.  On a CUDA device every
    step goes through the hand-written kernels; the step runs eagerly (no
    ``jit``) and updates the pools in place.
  * control plane: this engine + ``core.kvcache.PagedKVCache`` do metadata
    only — slot admission, per-slot chunk cursors, page allocation,
    publish-on-page-fill via ``PagedKVCache.commit`` (one 64 B
    ``OP_KV_COMMIT`` oplog entry per page for STRICT sequences).

Consistency modes and sampling parameters are per request.  The
controller is AUTHORITATIVE for the device page table: the engine mirrors
controller rows into the device tensor before every step.

Recurrent (SSM) state is reset for a slot when a request is admitted to
it, as in the reference.  This slice leaves out the reference engine's
prefix cache, host tier, speculative decoding, forks (with the slot-state
gather/scatter/copy they need), obs instrumentation and cluster hooks;
they are absent from the signature (ROADMAP queue 1).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..convert import cast_params
from ..core.kvcache import KVPoolFullError, PagedKVCache
from ..core.modes import Mode
from ..core.oplog import OpLog
from ..kernels.common import resolve_device
from ..models.registry import ModelAPI


# cache sub-dict keys that hold recurrent/SSM state (vs paged KV pools):
# the slot-state walk consults this set
RECURRENT_STATE_KEYS = frozenset({"conv", "h", "ssd"})


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: temperature <= 0 means greedy (argmax);
    top_k == 0 means the full vocabulary.  The host sampler itself stays
    in one place (``ServingEngine._sample``)."""
    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self) -> None:
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")

GREEDY = SamplingParams()


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    mode: Mode = Mode.POSIX              # per-request consistency mode
    sampling: SamplingParams = GREEDY
    output: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    seq_id: Optional[int] = None
    prompt_pos: int = 0                  # per-slot chunk cursor
    done: bool = False
    truncated: bool = False              # finished early (pool backpressure)
    stalled: bool = False                # run_until_done hit max_steps first
    cancelled: bool = False              # aborted by the caller

    @property
    def in_prefill(self) -> bool:
        return self.prompt_pos < len(self.prompt)


class ServingEngine:
    """One engine: one pool, one fixed-shape step, on ``device``.

    ``params`` is the model's parameter tree (tensors); the engine moves
    it to ``device`` and casts it to ``cfg.dtype`` once, but for the
    leaves the model reads in float32 (``convert.cast_params``: the same
    bits as the model's per-use cast)."""

    def __init__(self, api: ModelAPI, params, *, max_batch: int = 8,
                 max_seq: int = 512, page_tokens: int = 16,
                 chunk_tokens: Optional[int] = None, seed: int = 0,
                 mode: Mode = Mode.POSIX, oplog: Optional[OpLog] = None,
                 device="cuda") -> None:
        self.api = api
        self.device = resolve_device(device)
        self.params = cast_params(
            _to_device(params, self.device), api.cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        # C == page_tokens by default: one full chunk == one page == one
        # publish; chunk_tokens=1 recovers the token-at-a-time baseline
        self.chunk = int(chunk_tokens) if chunk_tokens else page_tokens
        self.rng = np.random.default_rng(seed)
        self.caches = api.init_caches(max_batch, max_seq, page_tokens,
                                      device=self.device)
        geom = api.kv_geometry(max_batch, max_seq, page_tokens)
        assert tuple(self.caches["page_table"].shape) == \
            (max_batch, geom.pages_per_seq), "geometry/pool mismatch"
        self.controller = PagedKVCache(geom, mode=mode, oplog=oplog)
        # hard per-slot token cap: the fixed-shape step addresses positions
        # up to lengths + C - 1, which must stay inside the page-table row
        # (this is what makes the page-index clamp of paged_chunk_ids safe)
        self._cap = min(max_seq - 1, geom.max_tokens_per_seq - self.chunk)
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}     # slot -> request
        self.finished: List[Request] = []
        self._rid = itertools.count()
        self.steps = 0
        self.tokens_processed = 0
        self.cancels = 0

    # ------------------------------------------------------------------ API

    def submit(self, prompt: List[int], max_new_tokens: int = 16, *,
               mode: Optional[Mode] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        if not prompt:
            raise ValueError("empty prompt")
        # statically infeasible prompts are rejected here; prompts that fit
        # but contend for pages at runtime go through backpressure and come
        # back flagged ``truncated``.  Bounds: every prefill chunk starts at
        # a multiple of C and addresses pad positions up to start + C - 1,
        # and a lone sequence can allocate at most the usable pool
        # (num_pages minus the reserved null page).
        g = self.controller.geom
        limit = min(self.max_seq - 1,
                    (g.max_tokens_per_seq // self.chunk) * self.chunk,
                    min(g.pages_per_seq, g.num_pages - 1) * g.page_tokens)
        if len(prompt) > limit:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the per-slot "
                f"capacity of {limit} (pool geometry / window bound)")
        req = Request(next(self._rid), list(prompt), max_new_tokens,
                      mode=self.controller.mode if mode is None else mode,
                      sampling=GREEDY if sampling is None else sampling)
        self.waiting.append(req)
        return req

    def run_until_done(self, max_steps: int = 10000) -> List[Request]:
        for req in list(self.active.values()) + self.waiting:
            req.stalled = False          # a fresh drive gets a fresh verdict
        steps0 = self.steps              # budget is per-call, not lifetime
        while (self.waiting or self.active) and \
                self.steps - steps0 < max_steps:
            self.step()
        # hitting max_steps with work outstanding is a TIMEOUT, not
        # completion: flag the survivors so callers can tell the two apart
        for req in list(self.active.values()) + self.waiting:
            req.stalled = True
        return self.finished

    # ------------------------------------------------------------------ engine step

    def _admit(self) -> None:
        free_slots = [s for s in range(self.max_batch) if s not in self.active]
        while self.waiting and free_slots:
            slot = free_slots.pop(0)
            req = self.waiting.pop(0)
            req.slot = slot
            req.seq_id = self.controller.create_seq(mode=req.mode)
            self._set_device_length(slot, 0)
            self._zero_slot_state(slot)
            self.active[slot] = req

    def step(self) -> None:
        self._admit()
        if not self.active:
            return
        B = self.max_batch
        # decode-only batches run the WIDTH-1 slice of the same step, so
        # steady-state decode never pays the C-wide compute for 1 token
        prefill_any = any(r.in_prefill for r in self.active.values())
        C = self.chunk if prefill_any else 1
        tokens = np.zeros((B, C), np.int32)
        n_new = np.zeros((B,), np.int32)
        feeds: Dict[int, int] = {}
        for slot, req in list(self.active.items()):
            total = self.controller.seq_length(req.seq_id)
            if req.in_prefill:
                # prompts are bounded at submit; prefill may stage up to
                # that limit regardless of the decode cap below
                take = min(C, len(req.prompt) - req.prompt_pos)
                feed = req.prompt[req.prompt_pos:req.prompt_pos + take]
            else:
                # width-aware overflow guard: a decode append of ``take``
                # tokens must keep total + take <= _cap
                if self._cap - total <= 0:
                    req.truncated = True    # capacity-bound, not completed
                    self._finish(slot, req)
                    continue
                take = 1
                feed = [req.output[-1]]
            # backpressure: only the VALID tokens need pages (pad positions
            # fall back to the null page when the over-reserve can't be
            # had); a chunk that cannot stage its valid tokens finishes the
            # request, flagged truncated, instead of stalling the batch
            need = self.controller.pages_needed(req.seq_id, total + take)
            if need > self.controller.num_free_pages:
                req.truncated = True
                self._finish(slot, req)
                continue
            tokens[slot, :take] = feed
            n_new[slot] = take
            feeds[slot] = take
            # CoW guard: an append must never write through a shared tail
            # page (O(1) metadata; no sharing arises in this slice)
            try:
                cow = self.controller.prepare_append(req.seq_id, take)
            except KVPoolFullError:
                req.truncated = True
                self._finish(slot, req)
                del feeds[slot]
                n_new[slot] = 0
                tokens[slot, :] = 0
                continue
            if cow is not None:
                self._copy_page_on_device(*cow)
            # metadata: reserve the FULL chunk's staging slots (pad tokens
            # land in allocated-but-unpublished slots), advance by the valid
            # count, publish (commit + oplog) every page the chunk filled
            self.controller.append_tokens(req.seq_id, take, reserve=C)
        if not feeds:
            return

        self._sync_page_table()
        dev = self.device
        logits, self.caches = self.api.serve_step(
            self.params, torch.from_numpy(tokens).to(dev), self.caches,
            torch.from_numpy(n_new).to(dev))
        logits = self._logits_to_host(logits)
        self.steps += 1
        self.tokens_processed += int(sum(feeds.values()))

        for slot, take in feeds.items():
            req = self.active[slot]
            if req.in_prefill:
                req.prompt_pos += take
                if req.in_prefill:
                    continue              # more prompt chunks to go
            # the chunk's last valid position predicts the next token: the
            # final prefill chunk yields the first generated token for free
            tok = self._sample(logits[slot, take - 1], req.sampling)
            req.output.append(tok)
            total = self.controller.seq_length(req.seq_id)
            if len(req.output) >= req.max_new_tokens:
                self._finish(slot, req)
            elif total >= self._cap:
                req.truncated = True        # capacity-bound, not completed
                self._finish(slot, req)

    @staticmethod
    def _logits_to_host(logits: torch.Tensor) -> np.ndarray:
        """The full [B, C, V] logits come to the host every step, as in the
        reference (its ``np.asarray(logits)``): the copy moves the step's
        own dtype, and bfloat16 widens to float32 on the host (exact)."""
        host = logits.cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        return host.numpy()

    def cancel(self, req: Request) -> None:
        """Abort a queued or in-flight request, releasing its batch slot
        and pages immediately.  Finished requests are left untouched."""
        if req.done:
            return
        req.cancelled = True
        self.cancels += 1
        if req in self.waiting:
            self.waiting.remove(req)
            req.done = True
            self.finished.append(req)
        elif req.slot is not None and self.active.get(req.slot) is req:
            self._finish(req.slot, req)

    def _finish(self, slot: int, req: Request) -> None:
        req.done = True
        req.stalled = False      # it completed after all: not a timeout
        self.finished.append(req)
        self.controller.free_seq(req.seq_id)
        del self.active[slot]

    def _sample(self, row: np.ndarray, sp: SamplingParams = GREEDY) -> int:
        """The ONE host sampler.  Tie-break contract: LOWEST token id wins
        every tie (np.argmax returns the first maximal index; top-k uses a
        stable descending sort)."""
        if sp.temperature <= 0.0 or sp.top_k == 1:
            return int(row.argmax())     # first (lowest-id) maximal entry
        z = row.astype(np.float64) / sp.temperature
        if sp.top_k and sp.top_k < len(row):
            keep = np.argsort(-z, kind="stable")[:sp.top_k]
            mask = np.full_like(z, -np.inf)
            mask[keep] = z[keep]
            z = mask
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self.rng.choice(len(row), p=p))

    # ------------------------------------------------------------------ device mirrors

    def _pool_leaves(self) -> List[torch.Tensor]:
        """The stacked [L, P, T, KV, D] pools, in cache-tree order (state
        dicts hold no pages)."""
        out: List[torch.Tensor] = []
        for key in ("group", "tail"):
            for pools in self.caches[key].values():
                if not isinstance(pools, dict):
                    out.extend(pools)
        return out

    def _walk_state(self, fn) -> None:
        """Apply ``fn(leaf, batch_dim)`` to every recurrent/SSM state leaf
        (cache sub-dicts keyed conv/h/ssd; stacked group leaves carry a
        leading layer dim)."""
        def visit(node, batch_dim):
            if isinstance(node, dict):
                if node and set(node) <= RECURRENT_STATE_KEYS:
                    for leaf in node.values():
                        fn(leaf, batch_dim)
                else:
                    for v in node.values():
                        visit(v, batch_dim)

        for key, batch_dim in (("group", 1), ("tail", 0)):
            visit(self.caches.get(key, {}), batch_dim)

    def _zero_slot_state(self, slot: int) -> None:
        """A freshly admitted slot must not inherit the previous occupant's
        recurrent state (pools need no reset: the extent walk only reads
        published positions).  Zeroes the slot in place."""
        self._walk_state(
            lambda leaf, batch_dim: leaf.select(batch_dim, slot).zero_())

    def _sync_page_table(self) -> None:
        """Mirror the controller's extent maps into the device page table.
        Inactive rows stay 0 = the reserved null page, so their fixed-shape
        pad writes are harmless by construction."""
        ctrl = self.controller.page_table()
        pt = np.zeros_like(ctrl[:self.max_batch])
        for slot, req in self.active.items():
            pt[slot] = ctrl[req.seq_id]
        self.caches["page_table"].copy_(torch.from_numpy(pt))

    def _set_device_length(self, slot: int, value: int) -> None:
        """One in-place element write on the device lengths tensor."""
        self.caches["lengths"][slot] = value

    def _copy_page_on_device(self, src_page: int, dst_page: int) -> None:
        """Give a sequence a private copy of a shared tail page in every
        stacked layer pool (the partial-block copy analogue)."""
        for pool in self._pool_leaves():
            pool[:, dst_page].copy_(pool[:, src_page])


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
