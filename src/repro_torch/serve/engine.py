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
    only — slot admission (with prefix-cache attach: a prompt whose prefix
    matches a published page chain adopts those pages and skips their
    prefill chunks entirely), per-slot chunk cursors, page allocation,
    publish-on-page-fill via ``PagedKVCache.commit`` (one 64 B
    ``OP_KV_COMMIT`` oplog entry per page for STRICT sequences),
    refcounted prefix sharing, CoW forks, staged speculative appends with
    ``commit(upto_len)`` and a rollback tombstone, and the host tier
    under the pool.

Consistency modes, sampling parameters and speculative decoding are per
request.  The controller is AUTHORITATIVE for the device page table: the
engine mirrors controller rows into the device tensor before every step.

Where JAX orders device work by dataflow, the port orders it by hand:
demotions copy D2H synchronously into the host arena before the page is
unpinned; promotions copy H2D asynchronously on a side stream, and the
compute stream waits on their event before anything reads a pool page
again; an arena slot a copy still reads is rewritten only after that
copy's event (``core.tier``).  With ``obs`` on, a CUDA engine
synchronizes after each step's dispatch so device time is attributed
honestly; with obs off the step never synchronizes beyond the logits
pull.

The cluster hooks (``serve.cluster``, DESIGN.md §12): ``detach`` for a
session that migrates off a live engine, and the snapshot's reads and
writes.  A snapshot copies its pages and
recurrent state on the device when it is taken (``_capture_pages``,
``_gather_slot_state``), since the source may reuse those pages before the
restore; a restore writes the target's pages on the compute stream after
its promotions (``_write_page``), never through the tier's side stream,
and its page-table row is mirrored only at the flip.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import cast_params
from ..core.kvcache import KVPoolFullError, PagedKVCache
from ..core.modes import Mode
from ..core.oplog import OpLog
from ..core.tier import HostTier
from ..kernels.common import resolve_device
from ..models.registry import ModelAPI
from ..obs import Obs, attach_serving
from .prefix_cache import PrefixCache, _Node

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


@dataclass(frozen=True)
class SpecConfig:
    """Per-session speculative decoding (DESIGN.md §8): an n-gram
    prompt-lookup drafter proposes up to ``k`` tokens per decode step;
    the engine stages them through the SAME fixed-shape chunk lane
    prefill uses, verifies all of them against the target logits in ONE
    step, keeps the longest agreeing prefix and ``rollback``s the rest
    (metadata-only, relink-style).  Greedy-only: a stochastic sampler
    has no stable notion of draft/target agreement, so non-greedy
    requests silently run unspeculated."""
    k: int = 4          # max drafted tokens per step (clamped to C - 1)
    ngram_max: int = 3  # longest suffix n-gram the drafter matches
    ngram_min: int = 1

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError("spec k must be >= 1")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError("need 1 <= ngram_min <= ngram_max")

# cache sub-dict keys that hold recurrent/SSM state (vs paged KV pools):
# the slot-state walks, the recurrent-arch guard for the prefix cache and
# speculation, and the pool walk all consult this set
RECURRENT_STATE_KEYS = frozenset({"conv", "h", "ssd"})


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
    prefix_tokens: int = 0               # prompt tokens adopted from the cache
    spec: Optional[SpecConfig] = None    # speculative decode (None = off)
    spec_drafted: int = 0                # drafted tokens (this request)
    spec_accepted: int = 0               # drafts the target model agreed with
    promoting: bool = False              # host-tier H2D copy in flight: the
                                         # slot is held out of the step until
                                         # the page-table flip lands
    engine_id: Optional[int] = None      # owning engine in a cluster (the
                                         # router tags it; migration retags)
    done: bool = False
    truncated: bool = False              # finished early (pool backpressure)
    stalled: bool = False                # run_until_done hit max_steps first
    cancelled: bool = False              # aborted by the caller
    # obs-only fields (None/0 when the engine runs uninstrumented): raw
    # perf_counter_ns stamps plus the per-request overhead ledger.  Shared
    # batch time is attributed by even split across the step's
    # participants, so request ledgers sum to the engine's phase totals.
    t_submit_ns: int = 0
    t_admit_ns: int = 0
    ledger: Optional[Dict[str, int]] = None

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
                 chunk_tokens: Optional[int] = None, greedy: bool = True,
                 seed: int = 0, mode: Mode = Mode.POSIX,
                 oplog: Optional[OpLog] = None,
                 prefix_cache: "bool | PrefixCache | None" = None,
                 spec: Optional[SpecConfig] = None,
                 host_cache_pages: int = 0,
                 pool_pages: Optional[int] = None,
                 obs: Optional[Obs] = None,
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
        # engine-wide DEFAULT sampling; requests override per-call
        self.default_sampling = GREEDY if greedy \
            else SamplingParams(temperature=1.0)
        self.rng = np.random.default_rng(seed)
        self.caches = api.init_caches(max_batch, max_seq, page_tokens,
                                      device=self.device)
        geom = api.kv_geometry(max_batch, max_seq, page_tokens)
        assert tuple(self.caches["page_table"].shape) == \
            (max_batch, geom.pages_per_seq), "geometry/pool mismatch"
        # cache-pressure cap (benchmarks, capacity planning): the device
        # tensors keep their full geometry — the controller simply never
        # hands out pages past ``pool_pages``
        if pool_pages is not None and 1 < pool_pages < geom.num_pages:
            geom = replace(geom, num_pages=pool_pages)
        self.controller = PagedKVCache(geom, mode=mode, oplog=oplog)
        # prefix cache: True builds one over this controller; an instance
        # is adopted as-is; None/False disables.  Models carrying recurrent
        # state cannot reuse KV pages without also replaying the recurrent
        # scan, so the cache is refused for them.
        self._recurrent = self._has_recurrent_state()
        if prefix_cache and self._recurrent:
            prefix_cache = None
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.controller) if prefix_cache is True
            else prefix_cache or None)
        # host-memory cold tier under the pool (DESIGN.md §8a), page-locked
        # on a CUDA engine so promotions copy asynchronously; only
        # meaningful with a prefix cache (the trie holds the residency
        # markers), hence implicitly refused for recurrent archs too
        self.tier: Optional[HostTier] = None
        if self.prefix_cache is not None and host_cache_pages > 0:
            self.tier = HostTier(host_cache_pages,
                                 read_page=self._gather_page,
                                 write_page=self._scatter_page,
                                 pin_memory=self.device.type == "cuda")
            self.prefix_cache.tier = self.tier
        # staged promotions awaiting their page-table flip; each entry is
        # {"req", "plan": [(node, dst_page, host_slot)], "tokens", "t_enq"}
        self._promotions: List[dict] = []
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.tier is not None
                             and self.device.type == "cuda" else None)
        # event after the last H2D promotion copy, until the compute
        # stream has been made to wait on it (``_await_promotions``)
        self._promote_event: Optional[torch.cuda.Event] = None
        # speculative decoding default (requests override per-submit).
        # Refused for recurrent-state models: rollback rewinds paged KV
        # (metadata-only) but NOT carried conv/h/ssd state
        self.default_spec = None if self._recurrent else spec
        # hard per-slot token cap: the fixed-shape step addresses positions
        # up to lengths + C - 1, which must stay inside the page-table row
        # (this is what makes the page-index clamp of paged_chunk_ids safe)
        self._cap = min(max_seq - 1, geom.max_tokens_per_seq - self.chunk)
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}     # slot -> request
        self.finished: List[Request] = []
        self._rid = itertools.count()
        self.steps = 0
        # plain-int stats, read lazily by the obs registry (DESIGN.md §10)
        self.tokens_processed = 0
        self.truncations = 0
        self.cancels = 0
        self.backpressure_stalls = 0
        # speculative-decode counters (accept rate = accepted / drafted)
        self.spec_steps = 0             # steps that carried >=1 draft
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.spec_rollbacks = 0         # rollbacks that actually shrank
        self.draft_ns = 0               # host drafting time (client bucket)
        # tier promotion counters (lag = enqueue -> page-table flip)
        self.promote_events = 0
        self.promote_lag_ns = 0
        self.obs = obs
        if obs is not None:
            attach_serving(obs, self)
            if self.tier is not None:
                self.tier.tracer = obs.tracer

    # ------------------------------------------------------------------ API

    def submit(self, prompt: List[int], max_new_tokens: int = 16, *,
               mode: Optional[Mode] = None,
               sampling: Optional[SamplingParams] = None,
               spec: Optional[SpecConfig] = None) -> Request:
        if not prompt:
            raise ValueError("empty prompt")
        # an id outside the vocabulary would index past the embedding
        # table inside step() (on a CUDA tensor, a device-side assert that
        # leaves the context unusable); the reference's gather clamps it
        vocab = self.api.cfg.vocab
        bad = [t for t in prompt if not 0 <= t < vocab]
        if bad:
            raise ValueError(f"token ids {bad[:4]} outside [0, {vocab})")
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
        samp = self.default_sampling if sampling is None else sampling
        eff_spec = spec if spec is not None else self.default_spec
        if eff_spec is not None and (
                self._recurrent                       # can't rewind state
                or not (samp.temperature <= 0.0 or samp.top_k == 1)):
            eff_spec = None      # greedy-only (see SpecConfig docstring)
        req = Request(next(self._rid), list(prompt), max_new_tokens,
                      mode=self.controller.mode if mode is None else mode,
                      sampling=samp, spec=eff_spec)
        if self.obs is not None:
            req.t_submit_ns = time.perf_counter_ns()
            if self.obs.tracer is not None:
                self.obs.tracer.instant(
                    "submit", "serve",
                    args={"rid": req.rid, "prompt": len(req.prompt)})
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
            # prefix-cache attach: adopt the longest published page chain
            # matching the prompt (refcounted hard links) — those tokens'
            # prefill chunks are skipped outright, and the device length
            # starts past them
            start = 0
            obs = self.obs
            tracer = obs.tracer if obs is not None else None
            if self.prefix_cache is not None and req.in_prefill:
                links, n_tok = self.prefix_cache.match_links(
                    req.prompt, align=self.chunk)
                links, n_tok = self._promotable(links, n_tok)
                n_host = sum(1 for nd in links if nd.on_host)
                if n_tok and not n_host:
                    pages = [nd.page for nd in links]
                    if tracer is not None:
                        with tracer.span("adopt_prefix", "serve",
                                         args={"rid": req.rid,
                                               "pages": len(pages),
                                               "tokens": n_tok}):
                            self.controller.adopt_prefix(req.seq_id, pages)
                    else:
                        self.controller.adopt_prefix(req.seq_id, pages)
                    req.prompt_pos = req.prefix_tokens = start = n_tok
                elif n_tok:
                    # tiered attach: hard-link the device links, reserve
                    # fresh pages for the host links, and hold the slot
                    # out of the step until the H2D copies are enqueued
                    # and the page table flips (_flip_promotions).  The
                    # device length stays 0 and the slot's page-table row
                    # stays null, so no step reads or writes the chain.
                    t_enq = time.perf_counter_ns()
                    spec = [None if nd.on_host else nd.page for nd in links]
                    _, fresh = self.controller.adopt_prefix_staged(
                        req.seq_id, spec)
                    hosted = [nd for nd in links if nd.on_host]
                    plan: List[Tuple[_Node, int, int]] = [
                        (nd, page, nd.host_slot)
                        for nd, (_, page) in zip(hosted, fresh)]
                    req.promoting = True
                    req.prompt_pos = req.prefix_tokens = n_tok
                    self._promotions.append(
                        {"req": req, "plan": plan, "tokens": n_tok,
                         "t_enq": t_enq})
            self._set_device_length(slot, start)
            self._zero_slot_state(slot)
            if obs is not None:
                # per-request overhead ledger: client/API time is the queue
                # wait from submit to admission; scheduler/device/persistence
                # accrue per step, split evenly across the step's batch
                req.t_admit_ns = time.perf_counter_ns()
                req.ledger = {
                    "client_ns": req.t_admit_ns - req.t_submit_ns,
                    "scheduler_ns": 0, "device_ns": 0, "persistence_ns": 0,
                    "steps": 0}
            self.active[slot] = req

    def step(self) -> None:
        obs = self.obs
        tracer = obs.tracer if obs is not None else None
        if obs is not None:
            t_step0 = time.perf_counter_ns()
            persist0 = self.controller.persist_ns
        self._admit()
        if obs is not None:
            t_admit1 = time.perf_counter_ns()
        if not self.active:
            return
        B = self.max_batch
        # decode-only batches run the WIDTH-1 slice of the same step, so
        # steady-state decode never pays the C-wide compute for 1 token
        prefill_any = any(r.in_prefill for r in self.active.values())
        # drafting pass (host-side prompt lookup) runs BEFORE the width
        # choice: speculative tokens ride the same chunk lane prefill
        # uses, so a step with drafts runs C wide.  Draft time lands in
        # the CLIENT bucket of the overhead split.
        drafts: Dict[int, List[int]] = {}
        draft_ns = 0
        if any(r.spec is not None for r in self.active.values()):
            t_draft0 = time.perf_counter_ns()
            for slot, req in self.active.items():
                sp = req.spec
                if sp is None or req.in_prefill or not req.output:
                    continue
                total = self.controller.seq_length(req.seq_id)
                # width-aware clamp: the feed is 1 + k tokens, and the
                # NEXT step's 1-token append must still fit under _cap
                k = min(sp.k, self.chunk - 1,
                        self._cap - total - 1,
                        req.max_new_tokens - len(req.output) - 1)
                if k >= 1:
                    d = self._draft(req, k)
                    if d:
                        drafts[slot] = d
            t_draft1 = time.perf_counter_ns()
            draft_ns = t_draft1 - t_draft0
            self.draft_ns += draft_ns
            if tracer is not None:
                tracer.complete(
                    "draft", "serve", tracer.rel(t_draft0),
                    tracer.rel(t_draft1),
                    args={"slots": len(drafts),
                          "tokens": sum(map(len, drafts.values()))})
        C = self.chunk if (prefill_any or drafts) else 1
        tokens = np.zeros((B, C), np.int32)
        n_new = np.zeros((B,), np.int32)
        feeds: Dict[int, int] = {}
        spec_feeds: Dict[int, List[int]] = {}    # slot -> drafts actually fed
        for slot, req in list(self.active.items()):
            if req.promoting:
                continue        # H2D copy in flight; joins after the flip
            total = self.controller.seq_length(req.seq_id)
            if req.in_prefill:
                # prompts are bounded at submit; prefill may stage up to
                # that limit regardless of the decode cap below
                take = min(C, len(req.prompt) - req.prompt_pos)
                feed = req.prompt[req.prompt_pos:req.prompt_pos + take]
            else:
                # width-aware overflow guard: a decode/speculative append
                # of ``take`` tokens must keep total + take <= _cap
                room = self._cap - total
                if room <= 0:
                    req.truncated = True    # capacity-bound, not completed
                    self._finish(slot, req)
                    continue
                if slot in drafts:
                    d = drafts[slot][:max(min(room - 1, C - 1), 0)]
                    feed = [req.output[-1]] + d
                    take = len(feed)
                    if d:
                        spec_feeds[slot] = d
                else:
                    take = 1
                    feed = [req.output[-1]]
            # backpressure: only the VALID tokens need pages (pad positions
            # fall back to the null page when the over-reserve can't be
            # had).  Cached-but-idle prefix pins are evicted first — live
            # sequences always outrank the cache — and only a chunk that
            # STILL cannot stage its valid tokens finishes the request,
            # flagged truncated, instead of stalling the batch
            need = self.controller.pages_needed(req.seq_id, total + take)
            if need > self.controller.num_free_pages:
                self.backpressure_stalls += 1
                if self.prefix_cache is not None:
                    self.prefix_cache.release(
                        need - self.controller.num_free_pages)
            if need > self.controller.num_free_pages:
                req.truncated = True
                self._finish(slot, req)
                continue
            tokens[slot, :take] = feed
            n_new[slot] = take
            feeds[slot] = take
            # CoW guard: after a rollback (or a fork/adopt) the kept tail
            # page may still be shared — an append must never write
            # through a shared page (O(1) metadata)
            try:
                cow = self.controller.prepare_append(req.seq_id, take)
            except KVPoolFullError:
                req.truncated = True
                self._finish(slot, req)
                del feeds[slot]
                spec_feeds.pop(slot, None)
                n_new[slot] = 0
                tokens[slot, :] = 0
                continue
            if cow is not None:
                self._copy_page_on_device(*cow)
            # metadata: reserve the FULL chunk's staging slots (pad tokens
            # land in allocated-but-unpublished slots), advance by the valid
            # count, publish (commit + oplog) every page the chunk filled.
            # Speculative feeds STAGE instead (publish=False): their pages
            # are published only for the verified prefix, by the epilogue's
            # commit(upto_len) (DESIGN.md §8)
            self.controller.append_tokens(req.seq_id, take, reserve=C,
                                          publish=slot not in spec_feeds)
        if not feeds:
            # nothing to compute this step, but staged promotions must
            # still land (their adopters are the only work left)
            self._flip_promotions(tracer, overlapped=False)
            return

        self._sync_page_table()
        # keep the participants: finished requests leave ``active`` in the
        # post loop, but the step's shared cost is still theirs to carry
        part_reqs = [self.active[slot] for slot in feeds]
        if obs is not None:
            t_stage1 = time.perf_counter_ns()
        self._await_promotions()
        dev = self.device
        if self._promotions and self._copy_stream is not None:
            # the staged promotions' H2D copies (enqueued after this
            # dispatch) may run beside the step: no slot of it addresses
            # their pages, so they wait only for the work before it
            self._copy_stream.wait_stream(torch.cuda.current_stream(dev))
        logits, self.caches = self.api.serve_step(
            self.params, torch.from_numpy(tokens).to(dev), self.caches,
            torch.from_numpy(n_new).to(dev))
        if obs is not None:
            # honest device attribution: without the sync the call returns
            # once the step is enqueued and device time leaks into the
            # host sampler below (the logits pull syncs anyway)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_dev1 = time.perf_counter_ns()
        # staged promotions land HERE — after the step's compute was
        # enqueued, into pages no slot of the step addresses, so their H2D
        # copies run beside the step and the host-side sampling below;
        # the next step waits on their event before it reads a page
        self._flip_promotions(tracer, overlapped=True)
        logits = self._logits_to_host(logits)
        self.steps += 1
        self.tokens_processed += int(sum(feeds.values()))

        for slot, take in feeds.items():
            req = self.active[slot]
            if req.in_prefill:
                req.prompt_pos += take
                if req.in_prefill:
                    continue              # more prompt chunks to go
                if self.prefix_cache is not None:
                    # prompt fully ingested: publish its full pages into
                    # the trie so later prompts sharing the prefix adopt
                    # them (idempotent for the pages this request itself
                    # adopted at admission)
                    if tracer is not None:
                        with tracer.span("publish", "serve",
                                         args={"rid": req.rid}):
                            self.prefix_cache.insert(
                                req.prompt,
                                self.controller.committed_extents(req.seq_id))
                    else:
                        self.prefix_cache.insert(
                            req.prompt,
                            self.controller.committed_extents(req.seq_id))
            if slot in spec_feeds:
                # draft-and-verify epilogue: all take logits came back
                # from ONE step; accept the longest agreeing prefix and
                # roll back the rejected tail (metadata-only)
                self._verify_spec(slot, req, take, spec_feeds[slot],
                                  logits, tracer)
            else:
                # the chunk's last valid position predicts the next
                # token: the final prefill chunk yields the first
                # generated token for free
                tok = self._sample(logits[slot, take - 1], req.sampling)
                req.output.append(tok)
            total = self.controller.seq_length(req.seq_id)
            if len(req.output) >= req.max_new_tokens:
                self._finish(slot, req)
            elif total >= self._cap:
                req.truncated = True        # capacity-bound, not completed
                self._finish(slot, req)

        if obs is not None:
            self._account_step(obs, tracer, part_reqs, len(feeds),
                               t_step0, t_admit1, t_stage1, t_dev1,
                               persist0, draft_ns,
                               "prefill" if prefill_any else "decode")

    @staticmethod
    def _logits_to_host(logits: torch.Tensor) -> np.ndarray:
        """The full [B, C, V] logits come to the host every step, as in the
        reference (its ``np.asarray(logits)``): the copy moves the step's
        own dtype, and bfloat16 widens to float32 on the host (exact)."""
        host = logits.cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        return host.numpy()

    def _verify_spec(self, slot: int, req: Request, take: int,
                     d: List[int], logits: np.ndarray, tracer) -> None:
        """Accept the longest draft prefix the target model agrees with.

        The step fed ``[output[-1]] + d`` (take = 1 + len(d) positions),
        so position i's logits predict the token AFTER the i-th fed
        token: sample each in turn, stop at the first disagreement —
        every sampled token up to and including that position is a real
        model output (the token after the last accepted draft comes free).

        KV protocol (DESIGN.md §8): the append STAGED all ``take``
        positions (no publish).  ``commit(upto_len=target)`` publishes
        exactly the accepted full pages (STRICT: OP_KV_COMMIT), THEN
        ``rollback(target)`` drops the rejected tail and logs an
        OP_TRUNCATE tombstone on any shrink — in that order, so a crash
        at ANY point replays to exactly the accepted extent.  The rolled
        back positions are staged, unpublished slots that the next chunk
        overwrites; a kept-but-shared tail page is CoW'd on the device."""
        if tracer is not None:
            t_v0 = time.perf_counter_ns()
        new_toks: List[int] = []
        for i in range(take):
            tok = self._sample(logits[slot, i], req.sampling)
            new_toks.append(tok)
            if i < take - 1 and d[i] != tok:
                break
        accepted = len(new_toks) - 1          # drafts the model agreed with
        emit = new_toks[:req.max_new_tokens - len(req.output)]
        req.output.extend(emit)
        req.spec_drafted += len(d)
        req.spec_accepted += accepted
        self.spec_steps += 1
        self.spec_drafted_tokens += len(d)
        self.spec_accepted_tokens += accepted
        self.spec_rejected_tokens += len(d) - accepted
        if tracer is not None:
            t_v1 = time.perf_counter_ns()
            tracer.complete("verify", "serve", tracer.rel(t_v0),
                            tracer.rel(t_v1),
                            args={"rid": req.rid, "drafted": len(d),
                                  "accepted": accepted})
        # the KV invariant (prompt + output[:-1] staged) pins the target:
        # the last emitted token is NEXT step's feed, so its KV position
        # does not exist yet — exactly like normal decode
        total_after = self.controller.seq_length(req.seq_id)
        target = (total_after - take) + len(emit)
        if target < total_after:
            self.spec_rollbacks += 1
        self.controller.commit(req.seq_id, upto_len=target)
        cowed = self._rollback_to(req, target)
        if tracer is not None:
            tracer.complete("rollback", "serve", tracer.rel(t_v1),
                            tracer.now_ns(),
                            args={"rid": req.rid,
                                  "rejected": total_after - target,
                                  "cow": cowed})

    def _account_step(self, obs: Obs, tracer, part_reqs: List[Request],
                      n_part: int, t_step0: int, t_admit1: int,
                      t_stage1: int, t_dev1: int, persist0: int,
                      draft_ns: int, phase: str) -> None:
        """Obs-only epilogue: split the step's wall time into scheduler /
        device / persistence (SplitFS-style attribution, DESIGN.md §10),
        charge the phase ledger and each participant's request ledger, emit
        the step's span family, and tick the windowed profiler.  Drafting
        time is CLIENT time, subtracted from the scheduler bucket."""
        t_end = time.perf_counter_ns()
        persist_ns = self.controller.persist_ns - persist0
        device_ns = t_dev1 - t_stage1
        sched_ns = max((t_end - t_step0) - device_ns - persist_ns
                       - draft_ns, 0)
        obs.ledger.add(phase, sched_ns=sched_ns, device_ns=device_ns,
                       persist_ns=persist_ns, steps=1)
        if draft_ns:
            obs.ledger.add_client(draft_ns)
        for req in part_reqs:
            led = req.ledger
            if led is not None:
                led["scheduler_ns"] += sched_ns // n_part
                led["device_ns"] += device_ns // n_part
                led["persistence_ns"] += persist_ns // n_part
                led["client_ns"] += draft_ns // n_part
                led["steps"] += 1
        if tracer is not None:
            rel = tracer.rel
            tracer.complete("step", "serve", rel(t_step0), rel(t_end),
                            args={"phase": phase, "slots": n_part,
                                  "persist_us": persist_ns / 1e3})
            tracer.complete("admit", "serve", rel(t_step0), rel(t_admit1))
            tracer.complete("schedule", "serve", rel(t_admit1), rel(t_stage1))
            tracer.complete("serve_step", "device", rel(t_stage1),
                            rel(t_dev1))
            tracer.complete("sample", "serve", rel(t_dev1), rel(t_end))
        obs.profiler.observe()

    def cancel(self, req: Request) -> None:
        """Abort a queued or in-flight request, releasing its batch slot
        and pages immediately.  Finished requests are left untouched."""
        if req.done:
            return
        req.cancelled = True
        self.cancels += 1
        if self.obs is not None and self.obs.tracer is not None:
            self.obs.tracer.instant("cancel", "serve",
                                    args={"rid": req.rid})
        if req in self.waiting:
            self.waiting.remove(req)
            req.done = True
            self.finished.append(req)
        elif req.slot is not None and self.active.get(req.slot) is req:
            self._finish(req.slot, req)

    def detach(self, req: Request) -> None:
        """Hand a LIVE request off this engine (session migration,
        DESIGN.md §12): release its slot, sequence, and any staged
        promotion WITHOUT finishing it — the caller re-installs it on
        another engine from its snapshot.  ``free_seq`` tombstones
        (OP_UNLINK) the sequence in THIS engine's log, so this volume's
        crash replay never resurrects a session that moved away.  Called
        only on a live source (straggler steal); a dead engine's state is
        frozen and merely read."""
        if req in self.waiting:
            self.waiting.remove(req)
            return
        if req.slot is not None and self.active.get(req.slot) is req:
            self._promotions = [p for p in self._promotions
                                if p["req"] is not req]
            self.controller.free_seq(req.seq_id)
            del self.active[req.slot]
            req.slot = None
            req.seq_id = None

    def _finish(self, slot: int, req: Request) -> None:
        req.done = True
        req.stalled = False      # it completed after all: not a timeout
        if req.truncated:
            self.truncations += 1
        self.finished.append(req)
        self.controller.free_seq(req.seq_id)
        del self.active[slot]
        obs = self.obs
        if obs is not None and obs.tracer is not None and req.ledger:
            # one request-lifetime span per slot lane, ledger in the args
            tracer = obs.tracer
            tracer.complete(
                f"req{req.rid}", "request", tracer.rel(req.t_admit_ns),
                tracer.now_ns(), tid=100 + slot,
                args={"rid": req.rid, "mode": req.mode.name,
                      "prompt": len(req.prompt), "output": len(req.output),
                      "prefix_tokens": req.prefix_tokens,
                      "spec_drafted": req.spec_drafted,
                      "spec_accepted": req.spec_accepted,
                      "truncated": req.truncated,
                      "cancelled": req.cancelled, **req.ledger})

    def _sample(self, row: np.ndarray, sp: SamplingParams = GREEDY) -> int:
        """The ONE host sampler.  Tie-break contract: LOWEST token id wins
        every tie (np.argmax returns the first maximal index; top-k uses a
        stable descending sort so a tie straddling the k-th place keeps
        exactly the k lowest-id candidates)."""
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

    # ------------------------------------------------------------------ speculation plumbing

    def _draft(self, req: Request, k: int) -> List[int]:
        """Prompt-lookup drafter: find the most recent earlier occurrence
        of the context's longest suffix n-gram (length ngram_max down to
        ngram_min) and propose up to k tokens that followed it.  Pure
        host-side guesswork — no model, no device."""
        ctx = req.prompt + req.output
        sp = req.spec
        for n in range(min(sp.ngram_max, len(ctx) - 1),
                       sp.ngram_min - 1, -1):
            pat = ctx[-n:]
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] != pat:
                    continue
                cont = ctx[i + n:i + n + k]
                if len(cont) < k:
                    # the match runs into the live tail: the span from
                    # i+n to the end repeats with period p, so extend
                    # the draft by cycling it
                    p = len(ctx) - (i + n)
                    cont = [ctx[i + n + (j % p)] for j in range(k)]
                return cont
        return []

    def _rollback_to(self, req: Request, target: int) -> bool:
        """Shrink a live request's KV to ``target`` tokens: controller
        rollback (OP_TRUNCATE tombstone on shrink + CoW of a kept-but-
        shared tail page) plus the device-side page copy and length
        mirror.  The page-table mirror refreshes at the next step's
        ``_sync_page_table``.  Returns True when the kept tail page was
        CoW'd."""
        cow = self.controller.rollback(req.seq_id, target)
        if cow is not None:
            self._copy_page_on_device(*cow)
        self._set_device_length(req.slot, target)
        return cow is not None

    # ------------------------------------------------------------------ host tier (DESIGN.md §8a)

    def _promotable(self, links: List[_Node], n_tok: int,
                    ) -> "Tuple[List[_Node], int]":
        """Trim a matched chain to what this admission can actually take.
        Host-resident links need one fresh device page each; the pool is
        asked to make room (release -> demote idle pins) first, and only
        a chain that STILL cannot reserve its pages is cut back to the
        leading device-resident run, re-aligned to the chunk grid."""
        n_host = sum(1 for nd in links if nd.on_host)
        if not n_host:
            return links, n_tok
        if self.tier is not None:
            shortfall = n_host - self.controller.num_free_pages
            if shortfall > 0:
                self.prefix_cache.release(shortfall)
            if n_host <= self.controller.num_free_pages:
                return links, n_tok
        keep = 0
        for nd in links:
            if nd.on_host:
                break
            keep += 1
        pt = self.page_tokens
        while keep and (keep * pt) % self.chunk:
            keep -= 1
        return links[:keep], keep * pt

    def _flip_promotions(self, tracer, *, overlapped: bool) -> None:
        """Land every staged promotion: enqueue the H2D copies, then flip
        — controller publish (``finish_adopt``: commit + oplog under the
        adopter's mode), trie re-pin (``promote_commit``, which frees the
        arena slot: its next ``put`` waits on the copy's event), and the
        device length that lets the slot feed next step.  The flip
        strictly FOLLOWS the enqueue, and the next step waits on the
        copies' event, so no step reads a promoted page before its bytes
        land.  A node two admissions raced to promote is copied D2D from
        the winner's flipped page instead."""
        if not self._promotions:
            return
        if not overlapped and self._copy_stream is not None:
            self._copy_stream.wait_stream(
                torch.cuda.current_stream(self.device))
        pending, self._promotions = self._promotions, []
        for pr in pending:
            req: Request = pr["req"]
            if req.done:
                # cancelled mid-promotion: free_seq already released the
                # reserved pages; the chain stays host-resident
                continue
            for node, dst, slot in pr["plan"]:
                if node.on_host and node.host_slot == slot:
                    self.tier.promote(slot, dst)
                else:
                    self._copy_page_on_device(node.page, dst)
            self.controller.finish_adopt(req.seq_id)
            for node, dst, slot in pr["plan"]:
                self.prefix_cache.promote_commit(node, dst, slot)
            self._set_device_length(req.slot, pr["tokens"])
            req.promoting = False
            t1 = time.perf_counter_ns()
            lag = t1 - pr["t_enq"]
            self.promote_events += 1
            self.promote_lag_ns += lag
            if tracer is not None:
                # own lane per slot (200+): the [enqueue -> flip] interval
                # deliberately OVERLAPS the engine lane's serve_step span
                tracer.complete(
                    "promote", "tier", tracer.rel(pr["t_enq"]),
                    tracer.rel(t1), tid=200 + req.slot,
                    args={"rid": req.rid, "pages": len(pr["plan"]),
                          "tokens": pr["tokens"], "lag_us": lag / 1e3,
                          "overlapped": overlapped})

    def _await_promotions(self) -> None:
        """Make the compute stream wait for the H2D promotion copies
        enqueued so far: called before any device work that reads or
        writes a pool page (the step, a page copy, a demotion)."""
        if self._promote_event is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._promote_event)
            self._promote_event = None

    def _gather_page(self, page: int) -> List[torch.Tensor]:
        """Views of one physical page across every layer pool, in the
        ``_pool_leaves`` order (the arena's page layout); the demotion
        copies them to the host."""
        self._await_promotions()
        return [pool[:, page] for pool in self._pool_leaves()]

    def _capture_pages(self, pages: List[int]) -> List[List[torch.Tensor]]:
        """A copy of ``pages`` across every layer pool (one gather per
        pool), per page in the ``_pool_leaves`` order: the snapshot's
        bytes.  A copy, not views, because the source may write those
        pages again before the restore reads them (a detached source
        frees them; a parked snapshot waits while others go on)."""
        self._await_promotions()
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        stacked = [pool.index_select(1, idx) for pool in self._pool_leaves()]
        return [[s[:, i] for s in stacked] for i in range(len(pages))]

    def _write_page(self, views: List[torch.Tensor], page: int) -> None:
        """Write a snapshot's page into device page ``page`` on the compute
        stream, after the promotions enqueued so far (a restore: the
        page is staged, and its page-table row is mirrored only at the
        flip)."""
        self._await_promotions()
        for pool, v in zip(self._pool_leaves(), views):
            pool[:, page].copy_(v)

    def _scatter_page(self, views: List[torch.Tensor],
                      page: int) -> Optional[torch.cuda.Event]:
        """H2D write of a demoted page's bytes into device page ``page``.
        On a CUDA engine the copies are enqueued from the pinned arena on
        the side stream, which ``step`` / ``_flip_promotions`` made wait
        for every earlier writer of the page; returns the event after
        them (the compute stream waits on it before it next touches a
        pool page).  On the CPU the copy is done on return."""
        if self._copy_stream is None:
            self._write_page(views, page)
            return None
        leaves = self._pool_leaves()
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            for pool, v in zip(leaves, views):
                # an H2D copy into a strided view (a page of every layer)
                # holds the host until it lands: land it contiguous, then
                # scatter it on the device
                staged = torch.empty(v.shape, dtype=v.dtype,
                                     device=pool.device)
                staged.copy_(v, non_blocking=True)
                pool[:, page].copy_(staged)
            ev = torch.cuda.Event()
            ev.record(stream)
        self._promote_event = ev
        return ev

    # ------------------------------------------------------------------ device mirrors

    def _pool_leaves(self) -> List[torch.Tensor]:
        """The stacked [L, P, T, KV, D] pools in a deterministic walk order
        (cache-tree order over ``group``, ``tail`` and an encoder-decoder's
        ``pools``, the keys a cache tree has; state dicts hold no pages)
        — that order IS the host arena's page layout, shared by
        gather/scatter/copy.  An encoder-decoder's cross K/V are not
        pages: the walk leaves them out, as the reference's does."""
        out: List[torch.Tensor] = []
        for key in ("group", "tail", "pools"):
            node = self.caches.get(key)
            if isinstance(node, tuple):             # (pool_k, pool_v)
                out.extend(node)
            elif node:
                for pools in node.values():
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

    def _has_recurrent_state(self) -> bool:
        """True when any cache leaf is recurrent/SSM state: such models
        fold EVERY token into carried state, so adopting KV pages (or
        rolling them back) without re-running the span would corrupt
        generation."""
        leaves: List[torch.Tensor] = []
        self._walk_state(lambda leaf, batch_dim: leaves.append(leaf))
        return bool(leaves)

    def _zero_slot_state(self, slot: int) -> None:
        """A freshly admitted slot must not inherit the previous occupant's
        recurrent state (pools need no reset: the extent walk only reads
        published positions).  Zeroes the slot in place."""
        self._walk_state(
            lambda leaf, batch_dim: leaf.select(batch_dim, slot).zero_())

    def _gather_slot_state(self, slot: int) -> List[torch.Tensor]:
        """A copy of one slot's recurrent/SSM state across every conv/h/ssd
        leaf, in the ``_walk_state`` order (the migration payload for
        recurrent archs), each leaf in its own dtype."""
        out: List[torch.Tensor] = []
        self._walk_state(lambda leaf, batch_dim: out.append(
            leaf.select(batch_dim, slot).clone()))
        return out

    def _scatter_slot_state(self, slot: int,
                            views: List[torch.Tensor]) -> None:
        """Write a gathered slot state into ``slot`` (same walk order)."""
        it = iter(views)
        self._walk_state(lambda leaf, batch_dim: leaf.select(
            batch_dim, slot).copy_(next(it)))

    def _copy_slot_state(self, src: int, dst: int) -> None:
        """Copy one slot's recurrent state into another, in place."""
        self._walk_state(
            lambda leaf, batch_dim: leaf.select(batch_dim, dst).copy_(
                leaf.select(batch_dim, src)))

    def _sync_page_table(self) -> None:
        """Mirror the controller's extent maps into the device page table.
        Inactive rows stay 0 = the reserved null page, so their fixed-shape
        pad writes are harmless by construction; so do the rows of slots
        whose promotion has not flipped yet (their pad writes at length 0
        would otherwise land in the chain's first page, which may be a
        published trie page)."""
        ctrl = self.controller.page_table()
        pt = np.zeros_like(ctrl[:self.max_batch])
        for slot, req in self.active.items():
            if not req.promoting:
                pt[slot] = ctrl[req.seq_id]
        self.caches["page_table"].copy_(torch.from_numpy(pt))

    def _set_device_length(self, slot: int, value: int) -> None:
        """One in-place element write on the device lengths tensor: a fill
        enqueued on the stream (an item assignment copies a host scalar
        and holds the host until the stream drains)."""
        self.caches["lengths"][slot].fill_(value)

    # ------------------------------------------------------------------ forking

    def fork(self, req: Request) -> Request:
        """Zero-copy fork (beam/speculative): shares full pages by refcount
        (hard links); the partially-filled tail page is CoW-copied on the
        device using the page pair the controller allocates, and the
        slot's recurrent state is copied in place."""
        assert req.slot is not None and not req.done
        # a mid-promotion fork would share a partially-committed extent
        # map; the flip lands at the next step, so callers just step first
        assert not req.promoting, "cannot fork during a staged promotion"
        free_slots = [s for s in range(self.max_batch) if s not in self.active]
        if not free_slots:
            raise RuntimeError("no free slot for fork")
        slot = free_slots[0]
        child = Request(next(self._rid), list(req.prompt), req.max_new_tokens,
                        mode=req.mode, sampling=req.sampling, spec=req.spec)
        child.output = list(req.output)
        child.prompt_pos = req.prompt_pos
        child.prefix_tokens = req.prefix_tokens
        child.slot = slot
        child.seq_id = self.controller.fork(req.seq_id)
        cow = self.controller.prepare_append(child.seq_id, 1)
        if cow is not None:
            self._copy_page_on_device(*cow)
        self._set_device_length(slot, self.controller.seq_length(child.seq_id))
        self._copy_slot_state(req.slot, slot)
        self.active[slot] = child
        self._sync_page_table()
        return child

    def _copy_page_on_device(self, src_page: int, dst_page: int) -> None:
        """Give a sequence a private copy of a shared page in every
        stacked layer pool (the partial-block copy analogue — the only
        data movement a fork or a CoW costs)."""
        self._await_promotions()
        for pool in self._pool_leaves():
            pool[:, dst_page].copy_(pool[:, src_page])


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
