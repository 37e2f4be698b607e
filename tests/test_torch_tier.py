"""The port's host tier (DESIGN.md §8a) against the JAX engine's, at fp32
on qwen2-1.5b SMOKE with the JAX package's weights: every scenario of
tests/test_tier.py runs on both engines with the same inputs and asserts
the reference test's expectations and that the engines agree — greedy
token streams, controller and tier counters, STRICT oplog entries and
crash replay, and pages that come back from the host bit for bit (float32
and bfloat16).  The allocator tests run on the port's copies (tensors in
place of numpy arrays) with the reference's expectations.  One scenario
the reference gets wrong is held to the JAX engine without the tier: a
chain whose first pages stay on the device, promoted while another
request steps."""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_engine_pair import (assert_pages_close, audit, client, counters,
                               drain, engine, entries, libs, oplog,
                               page_bits)

from repro_torch.core import FreeList, HostArena, HostTier
from repro_torch.models import build_model


@pytest.fixture(scope="module")
def pair():
    return libs()


def both(pair, scenario):
    jrec, trec = (scenario(lib) for lib in pair)
    assert trec == jrec
    return trec


def tier_counters(eng) -> dict:
    out = dict(eng.tier.stats()) if eng.tier is not None else {}
    pc = eng.prefix_cache
    out.update(hits=pc.hits, demotions=pc.demotions,
               promotions=pc.promotions, evicted=pc.pages_evicted,
               promote_events=eng.promote_events)
    return out


# ------------------------------------------------------------ allocator


def test_freelist_recycles_and_guards_double_free():
    fl = FreeList(4)
    ids = [fl.alloc() for _ in range(4)]
    assert ids == [0, 1, 2, 3] and fl.full and fl.alloc() is None
    fl.free(1)
    assert not fl.full and fl.alloc() == 1      # FIFO recycle, not a bump
    fl.free(3)
    with pytest.raises(ValueError):
        fl.free(3)                               # double free
    with pytest.raises(ValueError):
        fl.free(99)                              # never allocated
    assert fl.alloc() == 3 and fl.in_use == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_arena_round_trips_bytes_and_reuses_regions(dtype):
    gen = torch.Generator().manual_seed(0)

    def views():
        return [torch.randn((2, 4), generator=gen).to(dtype),
                torch.randn((3,), generator=gen).to(dtype)]

    arena = HostArena(capacity_pages=4, chunk_pages=2)
    stash = {}
    for _ in range(4):
        v = views()
        slot = arena.put(v)
        stash[slot] = [x.clone() for x in v]
    assert arena.full and arena.put(views()) is None
    assert arena.regions_created == 2           # 4 pages / chunk_pages=2
    for slot, want in stash.items():
        got = arena.get(slot)
        assert all(a.dtype == dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
    for slot in stash:
        arena.free(slot)
    for _ in range(4):
        assert arena.put(views()) is not None
    assert arena.regions_created == 2 and arena.region_reuses > 0
    assert arena.read_waits == 0                 # no copy was in flight


def test_host_tier_demote_promote_callbacks():
    store = {7: [torch.arange(6, dtype=torch.float32).reshape(2, 3)]}
    writes = {}
    tier = HostTier(2, read_page=lambda p: store[p],
                    write_page=lambda v, p: writes.__setitem__(
                        p, [x.clone() for x in v]))
    slot = tier.demote(7)
    assert slot is not None and tier.host_pages == 1
    tier.promote(slot, 9)
    tier.free(slot)
    assert torch.equal(writes[9][0], store[7][0])
    assert tier.pages_demoted == 1 and tier.pages_promoted == 1
    assert tier.host_pages == 0 and tier.host_drops == 0
    s2 = tier.demote(7)
    tier.free(s2, promoted=False)
    assert tier.host_drops == 1


# ------------------------------------------------ demote/promote round trip


def round_trip(lib, **kw):
    """Publish a chain, spill it, readmit: the promoted pages carry the
    pre-demotion bits."""
    eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                 host_cache_pages=8, prefix_cache=True, **kw)
    prompt = list(range(5, 22))                  # 2 full pages + tail
    req = eng.submit(prompt, max_new_tokens=2)
    eng.run_until_done()
    pc = eng.prefix_cache
    chain, n_tok = pc.match_links(prompt)
    assert n_tok >= 16 and not any(nd.on_host for nd in chain)
    before = [page_bits(eng, nd.page) for nd in chain]
    demoted = pc.release(pc.pinned_pages)        # spill everything idle
    assert demoted >= 2 and eng.tier.host_pages >= 2
    chain2, _ = pc.match_links(prompt)
    assert any(nd.on_host for nd in chain2), "chain did not stay matchable"
    req2 = eng.submit(prompt, max_new_tokens=2)
    eng.run_until_done()
    assert req2.prefix_tokens >= 16, "host-resident chain missed"
    assert eng.tier.pages_promoted >= 2
    chain3, _ = pc.match_links(prompt)
    for i, nd in enumerate(chain3[:len(before)]):
        assert not nd.on_host
        assert np.array_equal(page_bits(eng, nd.page), before[i]), \
            f"page {i} bits changed across the tier round trip"
    assert req.output == req2.output
    audit(eng)
    return eng, chain3, (req.output, req2.prefix_tokens, counters(eng),
                         tier_counters(eng))


def test_evicted_then_readmitted_chain_is_bit_identical(pair):
    (je, jchain, jrec), (te, tchain, trec) = (round_trip(lib) for lib in pair)
    assert trec == jrec
    for jn, tn in zip(jchain, tchain):
        assert_pages_close(je, jn.page, te, tn.page)
    drain(je)
    drain(te)


def test_bf16_pages_round_trip_the_tier_bit_for_bit(pair):
    """The arena holds the leaves' own dtype: a bfloat16 engine's pages
    come back with the same bits (the reference's ml_dtypes views, here
    tensors; ``page_bits`` reads both as uint16)."""
    _, lib = pair
    lib16 = SimpleNamespace(**vars(lib))
    lib16.api = build_model(dataclasses.replace(lib.api.cfg,
                                                dtype=torch.bfloat16))
    eng, chain, _ = round_trip(lib16)
    assert eng._pool_leaves()[0].dtype == torch.bfloat16
    assert page_bits(eng, chain[0].page).dtype == np.uint16
    drain(eng)


def test_tier_outputs_identical_and_hits_recovered(pair):
    """Tier on vs off, same capped pool, same prompts: identical greedy
    outputs, and only the tiered engine re-hits evicted chains."""
    fam = np.random.default_rng(3)
    shared = [list(fam.integers(1, 512, 16)) for _ in range(4)]
    prompts = [s + list(fam.integers(1, 512, 8))
               for _ in range(2) for s in shared]

    def scenario(lib):
        outs, hits, recs = [], [], []
        for host_pages in (16, 0):
            c = client(lib, max_batch=2, max_seq=64, page_tokens=8,
                       pool_pages=7, host_cache_pages=host_pages,
                       prefix_cache=True)
            sess = c.open_session()
            got = []
            for p in prompts:
                r = sess.submit([int(t) for t in p], max_new_tokens=3)
                c.run_until_done()
                got.append(r.output)
            outs.append(got)
            hits.append(c.engine.prefix_cache.hits)
            audit(c.engine)
            recs.append((counters(c.engine), tier_counters(c.engine)))
        assert outs[0] == outs[1], "host tier changed greedy outputs"
        assert hits[0] > 0 and hits[0] >= 2 * hits[1]
        return outs[0], recs

    both(pair, scenario)


def test_release_ladder_demotes_before_forgetting(pair):
    def scenario(lib):
        rec = []
        for host_pages in (8, 0):
            eng = engine(lib, max_batch=1, max_seq=64, page_tokens=8,
                         host_cache_pages=host_pages, prefix_cache=True)
            prompt = list(range(30, 47))
            eng.submit(prompt, max_new_tokens=2)
            eng.run_until_done()
            pc = eng.prefix_cache
            freed = pc.release(pc.pinned_pages)
            assert freed >= 2
            _, n_tok = pc.match_links(prompt)
            if host_pages:
                assert pc.demotions >= 2 and n_tok >= 16
            else:
                assert pc.demotions == 0 and n_tok == 0
            audit(eng)
            rec.append((freed, n_tok, tier_counters(eng)))
        return rec

    both(pair, scenario)


def test_host_leaf_dropped_when_arena_full(pair):
    def scenario(lib):
        eng = engine(lib, max_batch=1, max_seq=64, page_tokens=8,
                     host_cache_pages=2, prefix_cache=True)
        pc = eng.prefix_cache
        outs = []
        for base in (50, 100):
            r = eng.submit(list(range(base, base + 17)), max_new_tokens=2)
            eng.run_until_done()
            pc.release(pc.pinned_pages)
            outs.append(r.output)
        assert eng.tier.host_pages <= 2
        assert eng.tier.host_drops + eng.tier.demote_failures > 0
        audit(eng)
        return outs, tier_counters(eng)

    both(pair, scenario)


def test_pool_pages_caps_metadata_not_device_arrays(pair):
    def scenario(lib):
        full = engine(lib, max_batch=2, max_seq=64, page_tokens=8)
        capped = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                        pool_pages=5)
        assert capped.controller.geom.num_pages == 5
        for a, b in zip(full._pool_leaves(), capped._pool_leaves()):
            assert a.shape == b.shape, "pool cap resized device arrays"
        assert capped.controller.num_free_pages == 4
        req = capped.submit(list(range(5, 30)), max_new_tokens=8)
        capped.run_until_done()
        assert req.done
        return req.output, req.truncated, counters(capped)

    both(pair, scenario)


# ------------------------------------------------- publish ordering / STRICT


def test_strict_replay_identical_with_and_without_tier(pair):
    """Crash replay rebuilds the SAME committed extents whether a chain was
    adopted from device pages or promoted from host, and both engines log
    the same entries."""
    def scenario(lib):
        maps, logs = [], []
        for host_pages in (8, 0):
            log = oplog(lib)
            eng = engine(lib, max_batch=1, max_seq=64, page_tokens=8,
                         oplog=log, mode=lib.Mode.STRICT,
                         host_cache_pages=host_pages, prefix_cache=True)
            prompt = list(range(60, 77))
            eng.submit(prompt, max_new_tokens=2, mode=lib.Mode.STRICT)
            eng.run_until_done()
            if host_pages:
                eng.prefix_cache.release(eng.prefix_cache.pinned_pages)
            req = eng.submit(prompt, max_new_tokens=2, mode=lib.Mode.STRICT)
            eng.run_until_done()
            assert req.prefix_tokens >= 16
            if host_pages:
                assert eng.tier.pages_promoted >= 2
            replayed = lib.replay(log.scan())
            maps.append({sid: {i: page_bits(eng, p).tobytes()
                               for i, p in ext.items()}
                         for sid, ext in replayed.items()})
            logs.append((entries(log), replayed, req.output))
            audit(eng)
        on, off = maps
        assert len(on) == len(off)
        for (_, eon), (_, eoff) in zip(sorted(on.items()),
                                       sorted(off.items())):
            assert set(eon) == set(eoff)
            for i in eon:
                assert eon[i] == eoff[i], "replayed page bits differ"
        return logs

    both(pair, scenario)


def test_staged_adoption_crash_before_flip_replays_to_prefix(pair):
    """A crash between ``adopt_prefix_staged`` and ``finish_adopt`` replays
    to a committed PREFIX of the chain."""
    def scenario(lib):
        log = oplog(lib)
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     oplog=log, mode=lib.Mode.STRICT, host_cache_pages=8,
                     prefix_cache=True)
        prompt = list(range(80, 97))
        eng.submit(prompt, max_new_tokens=2, mode=lib.Mode.STRICT)
        eng.run_until_done()
        pc = eng.prefix_cache
        chain, _ = pc.match_links(prompt)
        deep = chain[-1]
        assert pc._demote(deep) and deep.on_host
        n_before = len(list(log.scan()))
        req = eng.submit(prompt, max_new_tokens=2, mode=lib.Mode.STRICT)
        eng._admit()
        assert req.promoting
        mid = lib.replay(log.scan())
        assert sorted(mid.get(req.seq_id, {})) == [0]
        eng.step()                               # flip lands
        assert not req.promoting
        after = lib.replay(log.scan())[req.seq_id]
        assert sorted(after) == [0, 1]
        assert len(list(log.scan())) > n_before
        eng.run_until_done()
        audit(eng)
        return req.output, entries(log), tier_counters(eng)

    both(pair, scenario)


def test_mixed_chain_promoted_beside_a_step_keeps_its_device_pages(pair):
    """A chain whose first pages stay on the device and whose last is on
    the host, promoted while another request steps: the port holds the
    promoting slot's page-table row at the null page until the flip, so
    the step's pad writes cannot land in the chain's first (published)
    page, and the adopter streams the tokens of the JAX engine without a
    tier.  (The JAX engine with the tier writes those pads into the
    published page and streams other tokens.)"""
    jlib, tlib = pair
    prompt = list(range(80, 105))                # 3 full pages + 1

    def run(lib, tier):
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     host_cache_pages=8 if tier else 0, prefix_cache=True)
        eng.submit(prompt, max_new_tokens=2)
        eng.run_until_done()
        pc = eng.prefix_cache
        chain, _ = pc.match_links(prompt)
        first = page_bits(eng, chain[0].page)
        if tier:
            assert pc._demote(chain[-1])
        filler = eng.submit(list(range(200, 212)), max_new_tokens=6)
        eng.step()
        r = eng.submit(prompt + [3, 2, 1], max_new_tokens=4)
        eng.run_until_done()
        assert r.prefix_tokens == 24 and filler.done
        assert np.array_equal(page_bits(eng, chain[0].page), first)
        if tier:
            assert eng.tier.pages_promoted == 1
        audit(eng)
        return r.output, filler.output

    want = run(jlib, False)
    assert run(tlib, False) == want
    assert run(tlib, True) == want


# ---------------------------------------------------------- overlap proof


def test_promote_span_overlaps_serve_step(pair):
    """The [enqueue -> flip] span on the 200+ lane overlaps a serve_step
    span on the engine lane, and the trace still validates."""
    def scenario(lib):
        obs = lib.Obs(trace=True)
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     host_cache_pages=8, prefix_cache=True, obs=obs)
        shared = list(range(5, 22))
        eng.submit(shared, max_new_tokens=2)
        eng.run_until_done()
        eng.prefix_cache.release(eng.prefix_cache.pinned_pages)
        a = eng.submit(list(range(200, 212)), max_new_tokens=6)
        b = eng.submit(shared + [3, 2, 1], max_new_tokens=2)
        eng.run_until_done()
        doc = obs.tracer.to_chrome()
        assert lib.validate(doc) == []
        evs = doc["traceEvents"]
        promotes = [e for e in evs if e["name"] == "promote"]
        steps = [e for e in evs if e["name"] == "serve_step"]
        assert promotes and steps
        assert all(e["tid"] >= 200 for e in promotes)

        def span(e):
            return e["ts"], e["ts"] + e["dur"]
        overlapped = [p for p in promotes if p["args"]["overlapped"]]
        assert overlapped
        p0, p1 = span(overlapped[0])
        assert any(s0 < p1 and p0 < s1 for s0, s1 in map(span, steps))
        assert json.dumps(doc)
        demotes = [e for e in evs if e["name"] == "demote"]
        assert demotes and all(e["tid"] == 2 for e in demotes)
        return (a.output, b.output, len(promotes), len(demotes),
                sorted({e["name"] for e in evs}))

    both(pair, scenario)


def test_promote_lag_metric_in_profiler_window(pair):
    def scenario(lib):
        obs = lib.Obs()
        eng = engine(lib, max_batch=1, max_seq=64, page_tokens=8,
                     host_cache_pages=8, prefix_cache=True, obs=obs)
        prompt = list(range(5, 22))
        eng.submit(prompt, max_new_tokens=2)
        eng.run_until_done()
        eng.prefix_cache.release(eng.prefix_cache.pinned_pages)
        eng.submit(prompt, max_new_tokens=2)
        eng.run_until_done()
        snap = obs.registry.snapshot()
        assert snap["tier.pages_demoted"] >= 2
        assert snap["tier.pages_promoted"] >= 2
        assert snap["tier.promotes"] >= 1
        assert snap["kv.host_capacity"] == 8
        obs.profiler.flush()
        # every window that saw a promotion reads its lag, whichever
        # window the wall clock closed last
        promoted = [w for w in obs.profiler.windows()
                    if w.counters.get("tier.promotes", 0) > 0]
        assert promoted
        for w in promoted:
            assert w.promote_lag_ms > 0
            assert w.as_dict()["promote_lag_ms"] == round(w.promote_lag_ms, 3)
        return {k: v for k, v in snap.items()
                if k.startswith(("tier.pages", "kv.pages", "trie."))}

    both(pair, scenario)


# ----------------------------------------------------- interleaving audit


def interleave(lib, ops):
    """Apply an op sequence against a tiered engine, auditing invariants
    after every op.  Ops: 0=submit+run, 1=release(spill), 2=readmit the
    oldest prompt, 3=clear the trie."""
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 512, 17)] for _ in range(3)]
    eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                 host_cache_pages=6, prefix_cache=True)
    pc = eng.prefix_cache
    outs = {}
    for i, op in enumerate(ops):
        if op in (0, 2):
            p = prompts[i % len(prompts)] if op == 0 else prompts[0]
            r = eng.submit(p, max_new_tokens=2)
            eng.run_until_done()
            assert outs.setdefault(tuple(p), r.output) == r.output
        elif op == 1:
            pc.release(max(pc.pinned_pages, 1))
        elif op == 3:
            pc.clear()
            assert pc.pinned_pages == 0 and pc.host_nodes == 0
            assert eng.tier.host_pages == 0
        audit(eng)
    return outs, counters(eng), tier_counters(eng)


@pytest.mark.parametrize("ops", [
    [0, 1, 2, 0, 1, 2],            # spill / readmit cycles
    [0, 0, 0, 1, 1, 2, 0],         # multi-chain spill, partial promote
    [0, 1, 3, 0, 2],               # clear() with host residents
    [0, 1, 0, 1, 0, 1, 2, 2],      # arena churn (capacity 6)
])
def test_tier_interleavings_deterministic(pair, ops):
    both(pair, lambda lib: interleave(lib, ops))
