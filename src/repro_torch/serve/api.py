"""Session-oriented serving client over one engine (port of
``repro/serve/api.py``, single-engine form).

``ServeClient`` owns ONE engine (one pool, one step) and
``open_session(mode=...)`` hands out ``Session`` handles, each with its own
consistency mode and default sampling, that coexist on that engine: a
STRICT session's page publishes are oplogged, a POSIX session batched
next to it pays nothing.

    client = ServeClient(api, params, max_batch=4, page_tokens=16)
    strict = client.open_session(mode=Mode.STRICT)
    for tok in strict.generate(prompt, max_new_tokens=32):
        ...

``Session.generate`` DRIVES the shared engine while it yields, so
concurrently iterated sessions interleave (continuous batching).  The
reference's cluster mode and prefix cache are not ported yet.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Union

from ..core.modes import Mode
from ..core.oplog import OpLog
from ..models.registry import ModelAPI
from .engine import Request, SamplingParams, ServingEngine
from .tokenizer import ByteTokenizer

Prompt = Union[str, List[int]]


class Session:
    """One application's handle onto the shared engine: a consistency mode
    plus default sampling parameters, overridable per call."""

    def __init__(self, client: "ServeClient", session_id: int, mode: Mode,
                 sampling: SamplingParams) -> None:
        self.client = client
        self.session_id = session_id
        self.mode = mode
        self.sampling = sampling
        self.requests: List[Request] = []
        self.closed = False

    def submit(self, prompt: Prompt, max_new_tokens: int = 16, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None) -> Request:
        """Queue a request under this session's mode; the engine must be
        pumped (``client.step`` / ``run_until_done`` or any session's
        generator).  A ``str`` prompt goes through the client's tokenizer."""
        if self.closed:
            raise RuntimeError("session is closed")
        if isinstance(prompt, str):
            prompt = self.client.tokenizer.encode(prompt)
        req = self.client.engine.submit(
            list(prompt), max_new_tokens, mode=self.mode,
            sampling=self._sampling(temperature, top_k))
        self.requests.append(req)
        return req

    def generate(self, prompt: Prompt, max_new_tokens: int = 16, *,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 max_steps: int = 100000) -> Iterator[int]:
        """Stream generated token ids.  Driving this generator steps the
        SHARED engine, so other sessions' requests advance too.  On a
        ``max_steps`` timeout the request is flagged ``stalled`` and the
        stream ends."""
        req = self.submit(prompt, max_new_tokens,
                          temperature=temperature, top_k=top_k)
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

    def _sampling(self, temperature: Optional[float],
                  top_k: Optional[int]) -> SamplingParams:
        if temperature is None and top_k is None:
            return self.sampling
        return SamplingParams(
            temperature=self.sampling.temperature if temperature is None
            else temperature,
            top_k=self.sampling.top_k if top_k is None else top_k)


class ServeClient:
    """Front end over one ``ServingEngine`` on ``device``: session
    management, the tokenizer front and the engine pump."""

    def __init__(self, api: ModelAPI, params, *, max_batch: int = 8,
                 max_seq: int = 512, page_tokens: int = 16,
                 chunk_tokens: Optional[int] = None, seed: int = 0,
                 default_mode: Mode = Mode.POSIX,
                 oplog: Optional[OpLog] = None,
                 tokenizer: Optional[ByteTokenizer] = None,
                 device="cuda") -> None:
        self._default_mode = default_mode
        self.tokenizer = tokenizer if tokenizer is not None \
            else ByteTokenizer()
        self.engine = ServingEngine(
            api, params, max_batch=max_batch, max_seq=max_seq,
            page_tokens=page_tokens, chunk_tokens=chunk_tokens, seed=seed,
            mode=default_mode, oplog=oplog, device=device)
        self._sids = itertools.count()
        self.sessions: Dict[int, Session] = {}

    def open_session(self, mode: Optional[Mode] = None, *,
                     temperature: float = 0.0, top_k: int = 0) -> Session:
        """A new session in consistency mode ``mode`` (default: the
        client's default mode)."""
        sid = next(self._sids)
        sess = Session(self, sid,
                       self._default_mode if mode is None else mode,
                       SamplingParams(temperature=temperature, top_k=top_k))
        self.sessions[sid] = sess
        return sess

    def step(self) -> None:
        self.engine.step()

    def run_until_done(self, max_steps: int = 10000) -> List[Request]:
        return self.engine.run_until_done(max_steps)
