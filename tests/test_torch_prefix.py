"""The port's prefix cache and fork against the JAX engine's, at fp32 on
qwen2-1.5b SMOKE with the JAX package's weights: every scenario of
tests/test_serve_api.py's prefix, trie and fork tests runs on both engines
with the same inputs, and each asserts the reference test's expectations
and that the two engines agree — greedy token streams, controller
counters (pages adopted, copied, relinked, pins taken), STRICT oplog
entries and their crash replay.  The trie's unit tests run on the port's
copies with the reference's expectations; mamba2 SMOKE forks as the JAX
engine does and refuses the prefix cache and speculation."""

import numpy as np
import pytest
import torch

from torch_engine_pair import (assert_pages_close, audit, client, counters,
                               drain, engine, entries, leaf_bits, libs,
                               oplog)

from repro_torch.core.kvcache import KVGeometry, PagedKVCache
from repro_torch.serve import PrefixCache, ServeClient

PROMPT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]


@pytest.fixture(scope="module")
def pair():
    return libs()


def both(pair, scenario):
    """Run ``scenario(lib)`` on both engines; the records must agree."""
    jrec, trec = (scenario(lib) for lib in pair)
    assert trec == jrec
    return trec


def test_prefix_admission_skips_prefill_and_pages(pair):
    """A second request sharing a published prefix adopts its pages:
    fewer prefill steps, fewer fresh pages, identical output."""
    prompt = list(range(1, 25))                          # 3 full pages @8

    def scenario(lib):
        plain = client(lib, max_batch=1, max_seq=64, page_tokens=8,
                       prefix_cache=False)
        p = plain.open_session().submit(prompt, max_new_tokens=5)
        plain.run_until_done()
        c = client(lib, max_batch=1, max_seq=64, page_tokens=8)
        eng = c.engine
        sess = c.open_session()
        first = sess.submit(prompt, max_new_tokens=5)
        c.run_until_done()
        alloc_after_first = eng.controller.pages_allocated
        second = sess.submit(prompt, max_new_tokens=5)
        steps0 = eng.steps
        while second.in_prefill:
            eng.step()
        assert eng.steps - steps0 == 1                   # 1 chunk, not 3
        assert second.prefix_tokens == 16                # 2 pages adopted
        c.run_until_done()
        assert second.output == first.output == p.output
        fresh = eng.controller.pages_allocated - alloc_after_first
        assert fresh < 3 and eng.controller.pages_adopted == 2
        rec = (second.output, eng.steps, counters(eng), c.stats()["steps"],
               c.stats()["prefix_cache"])
        drain(eng)
        return rec

    both(pair, scenario)


def test_prefix_cache_never_swallows_whole_prompt(pair):
    """Even on a full-trie hit at least one token must be fed — the first
    output token is sampled from the final prefill chunk's logits."""
    def scenario(lib):
        c = client(lib, max_batch=1, max_seq=64, page_tokens=8)
        sess = c.open_session()
        prompt = list(range(1, 17))                      # exactly 2 pages
        a = sess.submit(prompt, max_new_tokens=4)
        c.run_until_done()
        b = sess.submit(prompt, max_new_tokens=4)        # identical prompt
        c.run_until_done()
        assert b.prefix_tokens == 8                      # trimmed to 1 page
        assert b.output == a.output
        rec = (b.output, counters(c.engine))
        drain(c.engine)
        return rec

    both(pair, scenario)


def test_prefix_refcount_invariants_under_interleavings(pair):
    """No page leaked, no page freed while shared, CoW tail never aliased
    across branches — under admission / free / fork interleavings."""
    prompt = list(range(1, 25))

    def scenario(lib):
        c = client(lib, max_batch=3, max_seq=64, page_tokens=8)
        eng = c.engine
        ctrl = eng.controller
        sess = c.open_session()
        sess.submit(prompt, max_new_tokens=3)
        c.run_until_done()
        pinned = eng.prefix_cache.pinned_pages
        assert pinned == 3                       # 24 tokens = 3 pages
        assert ctrl.num_free_pages == ctrl.geom.num_pages - 1 - pinned
        r2 = sess.submit(prompt, max_new_tokens=6)
        r3 = sess.submit(prompt[:16] + [99, 98, 97], max_new_tokens=6)
        eng.step()                               # admit + chunk
        assert r2.prefix_tokens == 16 and r3.prefix_tokens == 16
        for _ in range(3):
            eng.step()
        child = eng.fork(r2)                     # CoW tail branch
        t2 = ctrl.page_table()[r2.seq_id]
        tc = ctrl.page_table()[child.seq_id]
        tail_idx = ctrl.seq_length(r2.seq_id) // 8
        assert t2[tail_idx] != tc[tail_idx]
        assert list(t2[:2]) == list(tc[:2])      # adopted prefix shared
        c.run_until_done()
        assert not eng.active and not eng.waiting
        assert ctrl.num_free_pages == \
            ctrl.geom.num_pages - 1 - eng.prefix_cache.pinned_pages
        rec = (r2.output, r3.output, child.output, counters(eng))
        eng.prefix_cache.clear()
        assert eng.prefix_cache.pinned_pages == 0
        assert ctrl.num_free_pages == ctrl.geom.num_pages - 1
        return rec

    both(pair, scenario)


def test_fork_copies_the_tail_page_bit_for_bit(pair):
    """Fork mid-decode with a prompt off the page grid: the child's CoW'd
    tail page equals the parent's over the filled slots, bit for bit, and
    parent and child stream the same greedy tokens on both engines."""
    def scenario(lib):
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8)
        req = eng.submit(PROMPT, max_new_tokens=10)
        while len(req.output) < 3:
            eng.step()
        child = eng.fork(req)
        ctrl = eng.controller
        n = ctrl.seq_length(req.seq_id)
        idx, filled = n // 8, n % 8
        assert filled                            # a partial tail page
        src = int(ctrl.page_table()[req.seq_id][idx])
        dst = int(ctrl.page_table()[child.seq_id][idx])
        assert src != dst and ctrl.pages_copied == 1
        for a, b in zip(leaf_bits(eng, src), leaf_bits(eng, dst)):
            assert np.array_equal(a[:, :filled], b[:, :filled])
        eng.run_until_done()
        assert child.output == req.output and len(req.output) == 10
        rec = (req.output, counters(eng))
        drain(eng)
        return rec

    both(pair, scenario)


def test_prefix_cache_evicts_under_pool_pressure(pair):
    """Cached-but-idle prefixes are evicted (leaf-first LRU) before a live
    request is truncated for want of pages."""
    def scenario(lib):
        c = client(lib, max_batch=1, max_seq=64, page_tokens=16)
        eng = c.engine
        g = eng.controller.geom
        sess = c.open_session()
        fill = (g.num_pages - 1) * g.page_tokens * 3 // 4
        sess.submit(list(range(1, fill + 1)), max_new_tokens=1)
        c.run_until_done()
        assert eng.prefix_cache.pinned_pages > 0
        big = (g.num_pages - 1) * g.page_tokens // 2
        # fresh ids inside SMOKE's vocab (the reference test's 7000+ are
        # clamped by JAX's gather; the port's embedding raises on them)
        r2 = sess.submit([400 + i for i in range(big)], max_new_tokens=2)
        c.run_until_done()
        assert r2.done and not r2.truncated
        assert eng.prefix_cache.pages_evicted > 0
        rec = (r2.output, eng.backpressure_stalls, eng.truncations,
               eng.prefix_cache.pages_evicted, counters(eng))
        drain(eng)
        return rec

    both(pair, scenario)


def test_strict_adoption_is_replayable(pair):
    """Adopted extents log under the ADOPTER's mode: a STRICT session that
    adopts a POSIX-published prefix replays completely — and both engines
    log the same entries."""
    def scenario(lib):
        log = oplog(lib)
        c = client(lib, max_batch=2, max_seq=64, page_tokens=8, oplog=log)
        posix = c.open_session(mode=lib.Mode.POSIX)
        strict = c.open_session(mode=lib.Mode.STRICT)
        prompt = list(range(1, 25))
        posix.submit(prompt, max_new_tokens=2)
        c.run_until_done()
        assert len(log.scan()) == 0
        rs = strict.submit(prompt, max_new_tokens=4)
        while rs.in_prefill or not rs.output:
            c.step()
        state = lib.replay(log.scan())
        expected = c.engine.controller.committed_extents(rs.seq_id)
        assert rs.prefix_tokens == 16 and len(expected) >= 2
        assert state[rs.seq_id] == expected
        c.run_until_done()
        rec = (rs.output, entries(log), lib.replay(log.scan()),
               counters(c.engine))
        drain(c.engine)
        return rec

    both(pair, scenario)


def test_mode_and_sampling_survive_fork(pair):
    def scenario(lib):
        log = oplog(lib)
        eng = engine(lib, max_batch=3, max_seq=64, page_tokens=8, oplog=log)
        sp = lib.SamplingParams(temperature=0.5, top_k=7)
        req = eng.submit(PROMPT, max_new_tokens=8, mode=lib.Mode.STRICT,
                         sampling=sp)
        for _ in range(3):
            eng.step()
        child = eng.fork(req)
        assert child.mode is lib.Mode.STRICT and child.sampling == sp
        assert eng.controller.seq_mode(child.seq_id) is lib.Mode.STRICT
        rec = (child.output, counters(eng))
        drain(eng)
        return rec

    both(pair, scenario)


def test_adoption_counters_and_pages_match_reference(pair):
    """Seven prompts sharing a two-page prefix behind one publisher: each
    adopter's prefix and tokens, the engines' counters and the adopted
    pages' contents agree across the engines."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 500, 16).tolist()
    tails = [rng.integers(1, 500, int(n)).tolist()
             for n in rng.integers(3, 20, 4)]
    engines, recs = [], []
    for lib in pair:
        c = client(lib, max_batch=4, max_seq=64, page_tokens=8)
        sess = c.open_session()
        first = sess.submit(shared + tails[0], max_new_tokens=6)
        c.run_until_done()
        reqs = [sess.submit(shared + t, max_new_tokens=6) for t in tails[1:]]
        c.run_until_done()
        assert all(r.prefix_tokens == 16 for r in reqs)
        pages, n_tok = c.engine.prefix_cache.match(shared + [0], align=8)
        assert n_tok == 16
        audit(c.engine)
        engines.append((c.engine, pages))
        recs.append(([first.output] + [r.output for r in reqs],
                     [r.prefix_tokens for r in reqs], c.engine.steps,
                     c.engine.tokens_processed, counters(c.engine)))
    assert recs[1] == recs[0]
    (je, jpages), (te, tpages) = engines
    for jp, tp in zip(jpages, tpages):
        assert_pages_close(je, jp, te, tp)
    for eng, _ in engines:
        drain(eng)


# ---------------------------------------------------------------- recurrent


@pytest.fixture(scope="module")
def mamba_pair():
    def redraw(tree, rng=np.random.default_rng(3)):
        # the init leaves A_log, dt_bias and conv_b at 0 and D_skip at 1
        if isinstance(tree, dict):
            return {k: (rng.uniform(-1.0, 1.0, np.shape(v)).astype(np.float32)
                        if k in ("A_log", "dt_bias", "conv_b", "D_skip")
                        else redraw(v, rng)) for k, v in tree.items()}
        return tree
    return libs("mamba2-1.3b", redraw)


def test_mamba2_fork_matches_reference_and_refuses_cache_and_spec(
        mamba_pair):
    """SSM models fold every token into carried state: the prefix cache
    and speculation are refused, as in the reference, and a fork copies
    the slot's state so parent and child stream the reference's tokens."""
    def scenario(lib):
        eng = engine(lib, max_batch=3, max_seq=64, page_tokens=8,
                     prefix_cache=True, spec=lib.SpecConfig(k=4))
        assert eng.prefix_cache is None and eng.default_spec is None
        r = eng.submit([5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], 8,
                       spec=lib.SpecConfig(k=4))
        assert r.spec is None
        other = eng.submit([3, 4, 5], 6)
        while len(r.output) < 3:
            eng.step()
        child = eng.fork(r)
        eng.run_until_done()
        assert child.output == r.output and len(r.output) == 8
        rec = (r.output, child.output, other.output, counters(eng))
        drain(eng)
        return rec

    both(mamba_pair, scenario)


# ---------------------------------------------------------------- trie unit


def test_trie_match_alignment_and_idempotent_insert():
    kv = PagedKVCache(KVGeometry(num_pages=32, page_tokens=4, max_seqs=4,
                                 pages_per_seq=8))
    pc = PrefixCache(kv)
    s = kv.create_seq()
    prompt = list(range(1, 13))                          # 3 full pages
    kv.append_tokens(s, 12)
    ext = kv.committed_extents(s)
    assert pc.insert(prompt, ext) == 3
    assert pc.insert(prompt, ext) == 0                   # idempotent
    pages, n = pc.match(prompt, align=1)
    assert n == 8 and pages == [ext[0], ext[1]]
    pages, n = pc.match(prompt + [77], align=8)
    assert n == 8
    pages, n = pc.match(prompt + [77], align=5)
    assert n == 0                                        # 4,8,12 all off-grid
    kv.free_seq(s)
    assert kv.num_free_pages == 31 - 3                   # pins keep 3 pages
    pc.clear()
    assert kv.num_free_pages == 31


def test_trie_eviction_is_leaf_first_and_idle_only():
    kv = PagedKVCache(KVGeometry(num_pages=32, page_tokens=4, max_seqs=4,
                                 pages_per_seq=8))
    pc = PrefixCache(kv, capacity_pages=16)
    s = kv.create_seq()
    kv.append_tokens(s, 12)
    prompt = list(range(1, 13))
    pc.insert(prompt, kv.committed_extents(s))
    assert pc.release(1) == 0                            # all shared: no-op
    assert pc.pinned_pages == 3
    kv.free_seq(s)                                       # pins now idle
    assert pc.release(1) == 1
    assert pc.pinned_pages == 2
    pages, n = pc.match(prompt + [0], align=1)           # chain shrank by one
    assert n == 8
    assert pc.release(10) == 2                           # drain fully
    assert pc.pinned_pages == 0
    assert kv.num_free_pages == 31


def test_trie_capacity_evicts_lru():
    kv = PagedKVCache(KVGeometry(num_pages=64, page_tokens=4, max_seqs=8,
                                 pages_per_seq=4))
    pc = PrefixCache(kv, capacity_pages=2)
    a = kv.create_seq()
    kv.append_tokens(a, 8)
    pc.insert([1, 2, 3, 4, 5, 6, 7, 8], kv.committed_extents(a))
    assert pc.pinned_pages == 2
    b = kv.create_seq()
    kv.append_tokens(b, 4)
    pc.insert([9, 10, 11, 12], kv.committed_extents(b))
    assert pc.pinned_pages == 2 and pc.pages_evicted >= 1
    kv.free_seq(a)
    kv.free_seq(b)
    pc.clear()
    assert kv.num_free_pages == 63


def test_client_builds_a_cluster_from_the_cluster_arguments(pair):
    """The reference's cluster arguments build an ``EngineCluster``, each
    taking effect (a lone ``make_oplog`` gives a single engine its log, as
    in the reference); unknown keywords still raise."""
    from repro_torch.core import OpLog, PMDevice
    from repro_torch.serve import EngineCluster

    _, lib = pair

    def make_oplog():
        return OpLog(PMDevice(size=4 * 1024 * 1024), base_block=1,
                     num_blocks=16)
    for kw in ({"n_engines": 2}, {"n_spares": 1},
               {"n_engines": 2, "make_oplog": make_oplog},
               {"n_engines": 2, "heartbeat_timeout": 3.0}):
        c = ServeClient(lib.api, lib.params, max_batch=1, max_seq=32,
                        page_tokens=8, device="cpu", **kw)
        assert isinstance(c.engine, EngineCluster)
        engines = c.engine.engines
        assert len(engines) == 2
        logs = [e.controller.oplog for e in engines]
        if "make_oplog" in kw:
            assert None not in logs and logs[0] is not logs[1]
        else:
            assert logs == [None, None]
        assert c.engine.monitor.timeout_s == kw.get("heartbeat_timeout", 6.0)
        assert list(c.open_session().generate([3, 4, 5], 2))
    single = ServeClient(lib.api, lib.params, max_batch=1, max_seq=32,
                         page_tokens=8, device="cpu", make_oplog=make_oplog)
    assert single.engine.controller.oplog is not None
    if not torch.cuda.is_available():            # the card is the default
        with pytest.raises(RuntimeError, match="is_available"):
            ServeClient(lib.api, lib.params, n_engines=2, n_spares=1)
    with pytest.raises(TypeError):
        ServeClient(lib.api, lib.params, device="cpu", n_engine=2)
    with pytest.raises(TypeError):
        engine(lib, n_engines=2)
