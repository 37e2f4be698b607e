"""The port's speculative decoding over the rollback path (DESIGN.md §8)
against the JAX engine's, at fp32 on qwen2-1.5b SMOKE with the JAX
package's weights: every scenario of tests/test_speculative.py and
tests/test_serve_api.py's spec session test runs on both engines and
asserts the reference test's expectations and that the engines agree —
greedy token streams, step counts, spec counters, STRICT oplog entries
(OP_KV_COMMIT, OP_TRUNCATE) and crash replay.  The controller's rollback
tests, the sampler's tie-breaks, the drafter and ``SpecConfig`` run on
the port's copies with the reference's expectations."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_engine_pair import (client, counters, drain, engine, entries,
                               leaf_bits, libs, oplog)

from repro_torch.configs import get_config
from repro_torch.core.kvcache import KVGeometry, PagedKVCache
from repro_torch.models import build_model, init_params
from repro_torch.serve import SamplingParams, ServingEngine, SpecConfig

# highly compressible: the n-gram drafter locks onto the cycle, so spec
# steps actually carry (and mostly accept) drafts
REPEAT = ([5, 6, 7, 8, 9, 10, 11, 12, 13] * 8)


@pytest.fixture(scope="module")
def pair():
    return libs()


def both(pair, scenario):
    jrec, trec = (scenario(lib) for lib in pair)
    assert trec == jrec
    return trec


def spec_counters(eng) -> dict:
    return {k: getattr(eng, k) for k in (
        "steps", "spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
        "spec_rejected_tokens", "spec_rollbacks", "tokens_processed")}


# ---------------------------------------------------------- output identity


def test_spec_greedy_outputs_identical(pair):
    def scenario(lib):
        outs, steps, engines = [], [], []
        for spec in (None, lib.SpecConfig(k=7)):
            eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                         spec=spec)
            req = eng.submit(REPEAT[:18], max_new_tokens=24)
            eng.run_until_done()
            outs.append(req.output)
            steps.append(eng.steps)
            engines.append(eng)
        assert outs[0] == outs[1], "speculation changed greedy output"
        assert len(outs[1]) == 24
        eng = engines[1]
        assert eng.spec_steps > 0 and eng.spec_accepted_tokens > 0
        assert steps[1] < steps[0], "speculation did not save steps"
        assert eng.spec_drafted_tokens == (eng.spec_accepted_tokens
                                           + eng.spec_rejected_tokens)
        for e in engines:
            assert e.controller.pages_in_use == 0, "leaked pool pages"
        return outs[1], steps, spec_counters(eng), counters(eng)

    both(pair, scenario)


def test_spec_refused_for_nongreedy_sampling(pair):
    def scenario(lib):
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     spec=lib.SpecConfig(k=4))
        greedy = eng.submit([1, 2, 3], max_new_tokens=1)
        assert greedy.spec is not None
        hot = eng.submit([1, 2, 3], max_new_tokens=1,
                         sampling=lib.SamplingParams(temperature=1.0))
        assert hot.spec is None
        topk1 = eng.submit([1, 2, 3], max_new_tokens=1,
                           sampling=lib.SamplingParams(temperature=1.0,
                                                       top_k=1))
        assert topk1.spec is not None
        eng.run_until_done()
        assert eng.controller.pages_in_use == 0
        return greedy.output, topk1.output

    both(pair, scenario)


def test_spec_refused_for_recurrent_state_models():
    cfg = get_config("mamba2-1.3b", smoke=True)
    api = build_model(cfg)
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    eng = ServingEngine(api, params, max_batch=1, max_seq=64, page_tokens=8,
                        spec=SpecConfig(k=4), device="cpu")
    assert eng._recurrent
    assert eng.default_spec is None
    req = eng.submit([1, 2, 3], max_new_tokens=1, spec=SpecConfig(k=4))
    assert req.spec is None


# ------------------------------------------------- rollback CoW (controller)


def test_rollback_cows_kept_shared_tail():
    kv = PagedKVCache(KVGeometry(num_pages=16, page_tokens=8, max_seqs=4,
                                 pages_per_seq=4))
    a = kv.create_seq()
    kv.append_tokens(a, 12)               # pages [p0, p1], tail p1 partial
    b = kv.fork(a)                        # p0/p1 now shared, refcount 2
    p1 = int(kv.page_table()[a][1])
    assert kv.page_refcount(p1) == 2
    cow = kv.rollback(a, 10)              # keeps both pages; tail shared
    assert cow is not None
    src, dst = cow
    assert src == p1 and dst != p1
    assert int(kv.page_table()[a][1]) == dst
    assert int(kv.page_table()[b][1]) == p1
    assert kv.page_refcount(p1) == 1 and kv.page_refcount(dst) == 1
    assert kv.prepare_append(a, 2) is None
    kv.append_tokens(a, 2)
    assert int(kv.page_table()[a][1]) == dst
    assert kv.seq_length(b) == 12
    kv.free_seq(a)
    kv.free_seq(b)
    assert kv.pages_in_use == 0


def test_rollback_aligned_or_private_tail_needs_no_cow():
    kv = PagedKVCache(KVGeometry(num_pages=16, page_tokens=8, max_seqs=4,
                                 pages_per_seq=4))
    a = kv.create_seq()
    kv.append_tokens(a, 12)
    b = kv.fork(a)
    assert kv.rollback(a, 8) is None
    c = kv.create_seq()
    kv.append_tokens(c, 12)
    assert kv.rollback(c, 10) is None
    for sid in (a, b, c):
        kv.free_seq(sid)
    assert kv.pages_in_use == 0


def test_adopt_rollback_append_keeps_pinned_chain_bits(pair):
    """adopt_prefix -> rollback into the adopted span -> re-append leaves
    the trie's pinned page BIT-identical in the device pools."""
    def scenario(lib):
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     prefix_cache=True)
        prompt = list(range(1, 17))                # two full pages
        eng.submit(prompt, max_new_tokens=2)
        eng.run_until_done()
        pages, n_tok = eng.prefix_cache.match(prompt, align=eng.chunk)
        assert n_tok == 8 and len(pages) == 1
        pinned = pages[0]
        snap = leaf_bits(eng, pinned)
        req = eng.submit(prompt, max_new_tokens=4)
        eng.step()                                 # admit: adopts the page
        assert req.prefix_tokens == 8
        assert eng._rollback_to(req, 5)
        assert int(eng.controller.page_table()[req.seq_id][0]) != pinned
        req.prompt_pos = 5
        req.output.clear()
        eng.run_until_done()
        assert req.done and len(req.output) == 4
        assert all(np.array_equal(s, n) for s, n in
                   zip(snap, leaf_bits(eng, pinned)))
        assert eng.prefix_cache.match(prompt, align=eng.chunk) == \
            ([pinned], 8)
        rec = (req.output, counters(eng))
        drain(eng)
        return rec

    both(pair, scenario)


# ------------------------------------------------------- width-aware _cap


def test_spec_append_respects_cap_at_boundary(pair):
    K = 7

    def scenario(lib):
        eng = engine(lib, max_batch=1, max_seq=64, page_tokens=8,
                     spec=lib.SpecConfig(k=K))
        start = eng._cap - K + 1
        req = eng.submit((REPEAT * 4)[:start], max_new_tokens=64)
        max_seen = 0
        for _ in range(200):
            if req.done:
                break
            eng.step()
            if not req.done:
                n = eng.controller.seq_length(req.seq_id)
                max_seen = max(max_seen, n)
                assert n <= eng._cap
        assert req.done and req.truncated
        assert eng.spec_steps > 0
        assert max_seen >= start
        assert eng.controller.pages_in_use == 0
        return req.output, max_seen, spec_counters(eng), eng.truncations

    both(pair, scenario)


# ------------------------------------------------ STRICT tombstone ordering


def test_strict_spec_logs_truncate_tombstones(pair):
    def scenario(lib):
        outs, logs = [], []
        for spec in (None, lib.SpecConfig(k=7)):
            log = oplog(lib)
            eng = engine(lib, max_batch=1, max_seq=64, page_tokens=8,
                         mode=lib.Mode.STRICT, oplog=log, spec=spec)
            req = eng.submit(REPEAT[:18], max_new_tokens=16)
            eng.run_until_done()
            outs.append(req.output)
            scan = log.scan()
            truncates = [e for e in scan if e.op == lib.OP_TRUNCATE]
            if spec is None:
                assert not truncates
            else:
                assert eng.spec_steps > 0
                assert len(truncates) == eng.spec_rollbacks
                state = lib.replay(scan)
                assert lib.replay(scan + scan) == state
                assert req.seq_id not in state
            logs.append((entries(log), spec_counters(eng)))
        assert outs[0] == outs[1]
        return outs[1], logs

    both(pair, scenario)


def test_spec_session_streams_identical_and_gauges_drain(pair):
    """A speculative session streams the same greedy tokens a plain
    session does, spec counters move, and the slot and page gauges drain
    back to zero."""
    prompt = ([5, 6, 7, 8, 9, 10, 11, 12, 13] * 2)[:18]

    def scenario(lib):
        c = client(lib, max_batch=2, max_seq=64, page_tokens=8,
                   obs=lib.Obs())
        plain = list(c.open_session().generate(prompt, max_new_tokens=10))
        assert c.engine.spec_steps == 0
        sc = client(lib, max_batch=2, max_seq=64, page_tokens=8,
                    obs=lib.Obs())
        sess = sc.open_session(spec=lib.SpecConfig(k=5))
        got = list(sess.generate(prompt, max_new_tokens=10))
        assert got == plain
        eng = sc.engine
        assert eng.spec_steps > 0 and eng.spec_drafted_tokens > 0
        snap = eng.obs.registry.snapshot()
        assert snap["spec.steps"] == eng.spec_steps
        assert snap["spec.accept_rate"] == pytest.approx(
            eng.spec_accepted_tokens / eng.spec_drafted_tokens)
        r = sess.submit(prompt, max_new_tokens=2, temperature=1.0)
        assert r.spec is None
        sc.run_until_done()
        rec = (got, spec_counters(eng))
        for e in (c.engine, eng):
            drain(e)
            snap = e.obs.registry.snapshot()
            assert snap["engine.slots_active"] == 0
            assert snap["kv.pages_in_use"] == 0
        return rec

    both(pair, scenario)


# --------------------------------------------------- sampler tie-breaking


def _sampler(seed=0):
    return SimpleNamespace(rng=np.random.default_rng(seed))


def test_greedy_tie_breaks_to_lowest_token_id():
    row = np.array([1.0, 3.0, 3.0, 3.0], np.float32)
    assert ServingEngine._sample(_sampler(), row, SamplingParams()) == 1
    sp = SamplingParams(temperature=1.0, top_k=1)
    assert ServingEngine._sample(_sampler(), row, sp) == 1


def test_top_k_tie_straddling_kth_place_keeps_lowest_ids():
    row = np.array([1.0, 1.0, 1.0, 0.5], np.float32)
    sp = SamplingParams(temperature=1.0, top_k=2)
    seen = {ServingEngine._sample(_sampler(seed), row, sp)
            for seed in range(64)}
    assert seen == {0, 1}, f"top-k boundary tie leaked ids: {seen}"


def test_top_k_no_tie_unchanged():
    row = np.array([0.1, 2.0, 1.0, 3.0], np.float32)
    sp = SamplingParams(temperature=1.0, top_k=2)
    seen = {ServingEngine._sample(_sampler(seed), row, sp)
            for seed in range(64)}
    assert seen == {1, 3}


# ------------------------------------------------------------- the drafter


def test_drafter_prompt_lookup_and_periodic_extrapolation():
    req = SimpleNamespace(prompt=[1, 2, 3, 9, 1, 2, 3], output=[],
                          spec=SpecConfig(k=4, ngram_max=3, ngram_min=1))
    assert ServingEngine._draft(None, req, 4) == [9, 1, 2, 3]
    req2 = SimpleNamespace(prompt=[4, 7, 7, 7], output=[],
                           spec=SpecConfig(k=3, ngram_max=3, ngram_min=1))
    assert ServingEngine._draft(None, req2, 3) == [7, 7, 7]
    req3 = SimpleNamespace(prompt=[1, 2, 3, 4, 5], output=[],
                           spec=SpecConfig(k=3, ngram_max=3, ngram_min=1))
    assert ServingEngine._draft(None, req3, 3) == []


def test_spec_config_validates():
    with pytest.raises(ValueError):
        SpecConfig(k=0)
    with pytest.raises(ValueError):
        SpecConfig(ngram_min=0)
    with pytest.raises(ValueError):
        SpecConfig(ngram_min=3, ngram_max=2)
