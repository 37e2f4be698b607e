"""Session-oriented serving client over one engine (port of
``repro/serve/api.py``, single-engine form).

``ServeClient`` owns ONE engine (one pool, one step) and
``open_session(mode=...)`` hands out ``Session`` handles, each with its own
consistency mode, default sampling and speculative-decode config, that
coexist on that engine: a STRICT session's page publishes are oplogged, a
POSIX session batched next to it pays nothing.  The prefix cache is ON by
default, as in the reference: shared prompt prefixes adopt published page
chains and skip their prefill.

    client = ServeClient(api, params, max_batch=4, page_tokens=16)
    strict = client.open_session(mode=Mode.STRICT)
    for tok in strict.generate(prompt, max_new_tokens=32):
        ...

``Session.generate`` DRIVES the shared engine while it yields, so
concurrently iterated sessions interleave (continuous batching).  The
reference's cluster mode (``n_engines``, ``n_spares``, ``make_oplog``,
``heartbeat_timeout``) is not ported yet: passing one raises (ROADMAP
queue 1, item 1.7).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Union

from ..core.modes import Mode
from ..core.oplog import OpLog
from ..models.registry import ModelAPI
from ..obs import Obs
from .engine import (Request, SamplingParams, ServingEngine, SpecConfig,
                     refuse_cluster_args)
from .tokenizer import ByteTokenizer

Prompt = Union[str, List[int]]


class Session:
    """One application's handle onto the shared engine: a consistency mode
    plus default sampling parameters and speculative-decode config, all
    overridable per call.  ``spec`` follows the same per-application split
    as the mode: a session that opts into speculation drafts and verifies
    over the rollback path while its neighbors run plain decode."""

    def __init__(self, client: "ServeClient", session_id: int, mode: Mode,
                 sampling: SamplingParams,
                 spec: Optional[SpecConfig] = None) -> None:
        self.client = client
        self.session_id = session_id
        self.mode = mode
        self.sampling = sampling
        self.spec = spec
        self.requests: List[Request] = []
        self.closed = False

    def submit(self, prompt: Prompt, max_new_tokens: int = 16, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               spec: Optional[SpecConfig] = None) -> Request:
        """Queue a request under this session's mode; the engine must be
        pumped (``client.step`` / ``run_until_done`` or any session's
        generator).  A ``str`` prompt goes through the client's tokenizer."""
        if self.closed:
            raise RuntimeError("session is closed")
        if isinstance(prompt, str):
            prompt = self.client.tokenizer.encode(prompt)
        req = self.client.engine.submit(
            list(prompt), max_new_tokens, mode=self.mode,
            sampling=self._sampling(temperature, top_k),
            spec=self.spec if spec is None else spec)
        self.requests.append(req)
        return req

    def generate(self, prompt: Prompt, max_new_tokens: int = 16, *,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 spec: Optional[SpecConfig] = None,
                 max_steps: int = 100000) -> Iterator[int]:
        """Stream generated token ids.  Driving this generator steps the
        SHARED engine, so other sessions' requests advance too.  On a
        ``max_steps`` timeout the request is flagged ``stalled`` and the
        stream ends."""
        req = self.submit(prompt, max_new_tokens,
                          temperature=temperature, top_k=top_k, spec=spec)
        emitted = 0
        steps0 = self.client.engine.steps
        timed_out = False
        try:
            while True:
                while emitted < len(req.output):
                    yield req.output[emitted]
                    emitted += 1
                if req.done:
                    return
                if self.client.engine.steps - steps0 >= max_steps:
                    req.stalled = True
                    timed_out = True
                    return
                self.client.engine.step()
        finally:
            # an abandoned stream must not keep its request decoding and
            # its slot + pages held; our own stalled return stays resumable
            if not req.done and not timed_out:
                self.client.engine.cancel(req)

    def close(self) -> None:
        """Sessions are handles, not resources: closing only refuses new
        submissions (in-flight requests drain normally)."""
        self.closed = True

    def stats(self) -> Dict[str, object]:
        """This session's view: request progress plus (when the client is
        instrumented) its requests' overhead ledgers and the shared engine
        counters/windows."""
        out: Dict[str, object] = {
            "session_id": self.session_id,
            "mode": self.mode.name,
            "submitted": len(self.requests),
            "done": sum(r.done for r in self.requests),
            "tokens_out": sum(len(r.output) for r in self.requests),
        }
        ledgers = [r.ledger for r in self.requests if r.ledger]
        if ledgers:
            out["overhead_ns"] = {
                k: sum(led[k] for led in ledgers) for k in ledgers[0]}
        obs = self.client.engine.obs
        if obs is not None:
            out["engine"] = obs.stats()
        return out

    def _sampling(self, temperature: Optional[float],
                  top_k: Optional[int]) -> SamplingParams:
        if temperature is None and top_k is None:
            return self.sampling
        return SamplingParams(
            temperature=self.sampling.temperature if temperature is None
            else temperature,
            top_k=self.sampling.top_k if top_k is None else top_k)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServeClient:
    """Front end over one ``ServingEngine`` on ``device``: session
    management, the tokenizer front, the prefix cache (ON by default),
    the optional host tier and obs bundle, and the engine pump."""

    def __init__(self, api: ModelAPI, params, *, max_batch: int = 8,
                 max_seq: int = 512, page_tokens: int = 16,
                 chunk_tokens: Optional[int] = None, seed: int = 0,
                 default_mode: Mode = Mode.POSIX,
                 oplog: Optional[OpLog] = None,
                 prefix_cache: bool = True,
                 host_cache_pages: int = 0,
                 pool_pages: Optional[int] = None,
                 tokenizer: Optional[ByteTokenizer] = None,
                 obs: Optional[Obs] = None,
                 device="cuda", **cluster) -> None:
        # host_cache_pages > 0 attaches the host-memory cold tier under
        # the device pool (DESIGN.md §8a): evicted prefix chains spill
        # D2H instead of being forgotten, and matching admissions promote
        # them back with an asynchronous copy.  pool_pages caps the device
        # pool below its geometry (pressure modeling / capacity planning).
        refuse_cluster_args(cluster)
        self._default_mode = default_mode
        self.tokenizer = tokenizer if tokenizer is not None \
            else ByteTokenizer()
        self.engine = ServingEngine(
            api, params, max_batch=max_batch, max_seq=max_seq,
            page_tokens=page_tokens, chunk_tokens=chunk_tokens, seed=seed,
            mode=default_mode, oplog=oplog, prefix_cache=prefix_cache,
            host_cache_pages=host_cache_pages, pool_pages=pool_pages,
            obs=obs, device=device)
        self.obs = obs
        self._sids = itertools.count()
        self.sessions: Dict[int, Session] = {}

    def open_session(self, mode: Optional[Mode] = None, *,
                     temperature: float = 0.0, top_k: int = 0,
                     spec: Optional[SpecConfig] = None) -> Session:
        """A new session in consistency mode ``mode`` (default: the
        client's default mode).  Pass ``spec=SpecConfig(...)`` to
        speculatively decode this session's requests (greedy only;
        ignored for recurrent-state models)."""
        sid = next(self._sids)
        sess = Session(self, sid,
                       self._default_mode if mode is None else mode,
                       SamplingParams(temperature=temperature, top_k=top_k),
                       spec=spec)
        self.sessions[sid] = sess
        return sess

    def step(self) -> None:
        self.engine.step()

    def run_until_done(self, max_steps: int = 10000) -> List[Request]:
        return self.engine.run_until_done(max_steps)

    def stats(self) -> Dict[str, object]:
        ctrl = self.engine.controller
        out: Dict[str, object] = {
            "steps": self.engine.steps,
            "pages_relinked": ctrl.pages_relinked,
            "pages_copied": ctrl.pages_copied,
            "pages_allocated": ctrl.pages_allocated,
            "pages_adopted": ctrl.pages_adopted,
            "utilization": ctrl.utilization(),
            "sessions": len(self.sessions),
        }
        if self.engine.prefix_cache is not None:
            out["prefix_cache"] = self.engine.prefix_cache.stats()
        if self.engine.tier is not None:
            out["tier"] = self.engine.tier.stats()
        if self.obs is not None:
            out["obs"] = self.obs.stats()
        return out

    def dump_trace(self, path: str) -> None:
        """Write the Chrome trace-event JSON (requires ``Obs(trace=True)``
        at construction); view in Perfetto / chrome://tracing."""
        if self.obs is None:
            raise ValueError("client built without obs")
        self.obs.dump_trace(path)
