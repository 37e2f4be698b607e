"""The port's engine on the encoder-decoder (whisper-large-v3 SMOKE, fp32)
against the JAX package's, from the same weights
(tests/torch_engine_pair.py).  Its cache tree is ``{page_table, lengths,
pools, cross_k, cross_v}``: the decoder's paged pools sit under
``"pools"``, which the engine walks as its page arena, and the cross K/V
sit beside them, outside the walk, as in the reference.  Neither engine
encodes: each scenario writes both engines' ``cross_k`` / ``cross_v``
from the same frames (the JAX package's ``encode`` and
``encdec_prefill_cross`` for the JAX engine, the port's for the port's),
as a caller of the reference must.

The scenarios: the engines' walks over the cache tree; a POSIX and a
STRICT session through ``ServeClient`` (prefix cache on, as by default),
with a later request adopting a published prefix; and a published chain
demoted to the host tier and promoted back bit for bit, beside the same
requests without the tier.  Every scenario runs on both engines; token
streams, the controller's counters and the STRICT oplog entries must be
equal."""

import numpy as np
import pytest
import torch

from repro.models import encdec as jax_ed
from repro_torch.models import encdec as ed
from torch_engine_pair import (audit, client, counters, engine, entries,
                               libs, oplog, page_bits)

ARCH = "whisper-large-v3"
NEW = 6
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(1, 512, n)]
           for i, n in enumerate((19, 7, 26, 12))]


@pytest.fixture(scope="module")
def pair():
    return libs(ARCH)


def frames(lib, batch):
    cfg = lib.api.cfg
    return np.random.default_rng(17).standard_normal(
        (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def fill_cross(lib, eng):
    """Every slot's cross K/V from its own frames, through the package's
    own encoder: written into the engine's caches, as a caller does."""
    cfg = lib.api.cfg
    x = frames(lib, eng.max_batch)
    if lib.name == "jax":
        import jax.numpy as jnp
        k, v = jax_ed.encdec_prefill_cross(
            eng.params, cfg, jax_ed.encode(eng.params, cfg, jnp.asarray(x)))
        eng.caches = {**eng.caches, "cross_k": k, "cross_v": v}
        return
    with torch.no_grad():
        k, v = ed.encdec_prefill_cross(
            eng.params, cfg, ed.encode(eng.params, cfg, torch.from_numpy(x)))
    eng.caches["cross_k"].copy_(k)
    eng.caches["cross_v"].copy_(v)


def test_cache_walks_take_the_decoder_pools_alone(pair):
    """Both engines walk the same page arena, the decoder's (pool_k,
    pool_v) [L, P, T, KV, hd] under ``"pools"``, and no cross K/V; the
    model carries no recurrent state, so the prefix cache, the host tier
    and speculation stay on."""
    walks = []
    for lib in pair:
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     prefix_cache=True, host_cache_pages=4)
        assert not eng._recurrent and eng.prefix_cache is not None
        assert eng.tier is not None
        walks.append([tuple(p.shape) for p in eng._pool_leaves()])
    cfg = pair[1].api.cfg
    assert walks[0] == walks[1] == [
        (cfg.n_dec_layers, 2 * 8, 8, cfg.n_kv_heads, cfg.head_dim)] * 2


def run_replayed(lib, c, log, reqs) -> int:
    """Step ``c`` until it is idle; after every step each live STRICT
    sequence's crash replay equals its committed pages.  Returns the
    number of such checks."""
    eng, checks = c.engine, 0
    while eng.waiting or eng.active:
        c.step()
        state = lib.replay(log.scan())
        for r in reqs:
            if r.mode is lib.Mode.STRICT and not r.done \
                    and r.seq_id is not None:
                assert state.get(r.seq_id, {}) == \
                    eng.controller.committed_extents(r.seq_id)
                checks += 1
    return checks


def test_posix_and_strict_sessions_stream_equal(pair):
    """Four requests in a POSIX and a STRICT session on four slots, each
    slot with its own cross K/V, then a fifth whose prompt shares the
    first's two full pages and adopts them from the prefix cache: equal
    greedy streams, controller counters and STRICT oplog entries, and
    the STRICT crash replay equal to the committed pages."""
    records = []
    for lib in pair:
        log = oplog(lib)
        c = client(lib, max_batch=4, max_seq=64, page_tokens=8, oplog=log)
        fill_cross(lib, c.engine)
        posix = c.open_session(mode=lib.Mode.POSIX)
        strict = c.open_session(mode=lib.Mode.STRICT)
        reqs = [(strict if i % 2 else posix).submit(p, NEW)
                for i, p in enumerate(PROMPTS)]
        checks = run_replayed(lib, c, log, reqs)
        reqs.append(strict.submit(PROMPTS[0][:16] + [3, 1, 4], NEW))
        checks += run_replayed(lib, c, log, reqs)
        eng = c.engine
        assert checks > 0
        assert all(r.done and not r.truncated and len(r.output) == NEW
                   for r in reqs)
        assert reqs[-1].prefix_tokens == 16
        assert eng.controller.pages_adopted == 2
        records.append(([r.output for r in reqs], counters(eng),
                        entries(log), checks))
    assert records[0] == records[1]


@pytest.mark.parametrize("host_pages", [0, 8])
def test_host_tier_round_trip_of_decoder_pages(pair, host_pages):
    """A request publishes a 17-token prompt's two full pages; the trie
    releases every idle page (to the host tier when it has one, else
    dropped) and the same prompt comes again.  With the tier its chain is
    promoted back into the decoder's pools bit for bit; without it the
    chain is prefilled anew.  Both engines stream the same tokens, with
    and without the tier, and their counters are equal."""
    prompt = list(range(5, 22))
    records = []
    for lib in pair:
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     prefix_cache=True, host_cache_pages=host_pages)
        fill_cross(lib, eng)
        first = eng.submit(prompt, NEW)
        eng.run_until_done()
        pc = eng.prefix_cache
        chain, n_tok = pc.match_links(prompt)
        assert n_tok == 16 and len(chain) == 2
        before = [page_bits(eng, nd.page) for nd in chain]
        assert pc.release(pc.pinned_pages) >= 2
        again = eng.submit(prompt, NEW)
        eng.run_until_done()
        assert first.done and again.done and not again.truncated
        if host_pages:
            assert eng.tier.pages_demoted >= 2
            assert eng.tier.pages_promoted >= 2 and again.prefix_tokens == 16
            chain2, _ = pc.match_links(prompt)
            for i, nd in enumerate(chain2[:2]):
                assert not nd.on_host
                assert np.array_equal(page_bits(eng, nd.page), before[i])
        else:
            assert again.prefix_tokens == 0
        audit(eng)
        records.append((first.output, again.output, counters(eng)))
    assert records[0] == records[1]
    # both requests took slot 0, whose cross K/V they share
    assert records[1][0] == records[1][1]
