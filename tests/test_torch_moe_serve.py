"""The port's serving engine on the MoE architectures against the JAX
package's, at fp32 on the SMOKE configs with the JAX package's weights:
deepseek-v2-lite-16b (MLA: one latent pool, MoE with a shared expert) and
grok-1-314b (GQA with softcap 30, MoE 4 experts top-2).  Each scenario
runs on both engines with the same schedule, and their records must be
equal, token for token: chunked serving with a prefill beside a decode,
a STRICT crash mid-prefill replayed to the committed pages, prefix
adoption, a host-tier demotion and promotion (the promoted pages carry
the pre-demotion bits), and a cluster kill whose sessions migrate.

The MoE's capacity depends on the rows a step routes (pad rows included),
so a chunked run need not equal a token-at-a-time one in either package:
the two packages are compared on the same schedule, not two schedules
with each other."""

import sys

import numpy as np
import pytest

from torch_engine_pair import (StepClock, assert_pages_close, audit, client,
                               cluster, counters, drain, engine, entries,
                               libs, oplog, page_bits)
from test_torch_cluster import (both_restoring, family_prompts,
                                outputs_by_prompt, record)

ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")
PROMPT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return libs(request.param)


def both(pair, scenario):
    """Run ``scenario(lib)`` on both engines; the records must agree."""
    jrec, trec = (scenario(lib) for lib in pair)
    assert trec == jrec
    return trec


def test_chunked_serving_with_a_prefill_beside_a_decode(pair):
    def scenario(lib):
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     prefix_cache=False)
        a = eng.submit(PROMPT[:5], max_new_tokens=6)
        eng.step()                               # a's prefill alone
        b = eng.submit(PROMPT, max_new_tokens=4)
        eng.run_until_done()
        assert a.done and b.done and len(a.output) == 6
        return a.output, b.output, eng.steps, counters(eng)

    both(pair, scenario)


def test_strict_crash_mid_prefill_replays_to_committed_pages(pair):
    def scenario(lib):
        log = oplog(lib)
        eng = engine(lib, max_batch=1, max_seq=128, page_tokens=8,
                     mode=lib.Mode.STRICT, oplog=log, prefix_cache=False)
        req = eng.submit(list(range(1, 45)), max_new_tokens=4)
        for _ in range(5):                       # 40 of 44 tokens: crash
            eng.step()
        assert req.in_prefill
        expected = eng.controller.committed_extents(req.seq_id)
        state = lib.replay(log.scan())
        assert len(expected) == 5 and state[req.seq_id] == expected
        assert state == lib.replay(list(log.scan()) * 2)
        eng.run_until_done()                     # and it finishes alike
        return req.output, entries(log), state

    both(pair, scenario)


def test_prefix_adoption_skips_prefill(pair):
    prompt = list(range(1, 25))                  # 3 full pages @8

    def scenario(lib):
        c = client(lib, max_batch=1, max_seq=64, page_tokens=8)
        eng = c.engine
        sess = c.open_session()
        first = sess.submit(prompt, max_new_tokens=5)
        c.run_until_done()
        second = sess.submit(prompt, max_new_tokens=5)
        steps0 = eng.steps
        while second.in_prefill:
            eng.step()
        assert eng.steps - steps0 == 1           # 1 chunk, not 3
        assert second.prefix_tokens == 16
        c.run_until_done()
        rec = (first.output, second.output, eng.steps, counters(eng))
        drain(eng)
        return rec

    both(pair, scenario)


def test_tier_demotion_and_promotion(pair):
    """Publish a chain, spill it to the host tier, readmit: the promoted
    pages carry the pre-demotion bits (every layer pool: deepseek's one
    latent pool, grok's K and V) and both engines stream alike."""
    prompt = list(range(5, 22))                  # 2 full pages + tail

    def scenario(lib):
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     host_cache_pages=8, prefix_cache=True)
        req = eng.submit(prompt, max_new_tokens=2)
        eng.run_until_done()
        pc = eng.prefix_cache
        chain, _ = pc.match_links(prompt)
        before = [page_bits(eng, nd.page) for nd in chain]
        assert pc.release(pc.pinned_pages) >= 2 and eng.tier.host_pages >= 2
        req2 = eng.submit(prompt, max_new_tokens=2)
        eng.run_until_done()
        assert req2.prefix_tokens >= 16 and eng.tier.pages_promoted >= 2
        chain2, _ = pc.match_links(prompt)
        for i, nd in enumerate(chain2[:len(before)]):
            assert not nd.on_host
            assert np.array_equal(page_bits(eng, nd.page), before[i])
        audit(eng)
        return eng, chain2, (req.output, req2.output, req2.prefix_tokens,
                             counters(eng))

    (je, jchain, jrec), (te, tchain, trec) = (scenario(lib) for lib in pair)
    assert trec == jrec
    for jn, tn in zip(jchain, tchain):
        assert_pages_close(je, jn.page, te, tn.page)
    drain(je)
    drain(te)


def test_cluster_kill_migrates_sessions(pair, monkeypatch):
    """tests/test_cluster.py's kill on a two-engine cluster with a spare:
    the busiest engine dies mid-decode, its sessions resume on the spare
    from their snapshots (MLA's latent pages, grok's K/V pages), and every
    output equals the unkilled run's; at max_batch 2 a step routes 16
    rows, within both SMOKE configs' exact capacity, so no pick drops.
    Step times are ``StepClock``'s (tests/test_torch_cluster.py)."""
    for lib in pair:
        monkeypatch.setattr(sys.modules[lib.Cluster.__module__], "time",
                            StepClock())

    def scenario(lib):
        prompts = family_prompts(lib.api.cfg.vocab, 6)

        def run(kill: bool):
            c = cluster(lib, n_engines=2, n_spares=1, max_batch=2,
                        max_seq=64, page_tokens=8, heartbeat_timeout=3.0)
            reqs = [c.submit(p, max_new_tokens=12) for p in prompts]
            if kill:
                for _ in range(3):
                    c.step()
                victim = max(range(2), key=lambda e: (
                    len(c.engines[e].active), len(c.engines[e].waiting)))
                assert c.engines[victim].active, "kill landed on idle"
                c.kill(victim)
            done = c.run_until_done(max_steps=600)
            assert len(done) == len(reqs) and all(r.done for r in reqs)
            return c, done

        ref_c, ref = run(kill=False)
        c, done = run(kill=True)
        assert c.sessions_migrated >= 1
        assert c.policy.steals == 1 and c.monitor.deaths == 1
        assert outputs_by_prompt(done) == outputs_by_prompt(ref)
        return outputs_by_prompt(done), record(ref_c), record(c)

    _, restores = both_restoring(pair, monkeypatch, scenario)
    assert restores.pages, "no page was migrated"
