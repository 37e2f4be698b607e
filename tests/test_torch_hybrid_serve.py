"""The port's engine on the RG-LRU hybrid (recurrentgemma-9b SMOKE, fp32,
window 32) against the JAX package's, from the same weights
(tests/torch_engine_pair.py): a hybrid is the first architecture whose
cache tree holds both paged pools (``group/b2_attn``) and recurrent state
(``group/b{0,1}_rec``, ``tail/t0_rec``).

The engine caps a slot at ``window + page_tokens - chunk`` tokens (the
reference's ``_cap``: the page chain of a windowed model holds window +
one page), so a request passes the window only where a chunk is shorter
than a page.  The scenarios: chunked prefill against token-at-a-time for a
28-token prompt and 10 greedy tokens (38 tokens, past the window of 32),
at pages of 8 (chunks of 2) and pages of 16 (chunks of 8); four requests
through two slots, so admission must zero a reused slot's state; the
engine's refusals (prefix cache, host tier, speculation) and its walks
over the two kinds of cache leaf; and a session snapshot whose pages and
state restore on another engine.  Every scenario runs on both engines;
token streams must be equal."""

import numpy as np
import pytest

from torch_engine_pair import bits, engine, libs

ARCH = "recurrentgemma-9b"
PROMPT = [int(t) for t in np.random.default_rng(3).integers(1, 512, 28)]
NEW = 10


@pytest.fixture(scope="module")
def pair():
    return libs(ARCH)


@pytest.mark.parametrize("page_tokens,chunk", [(8, 2), (16, 8)])
def test_chunked_equals_token_at_a_time_past_the_window(pair, page_tokens,
                                                        chunk):
    """tests/test_chunked_prefill.py's engine scenario, on a request that
    passes the window: the same tokens whether the prompt goes in
    ``chunk`` or 1 token at a time, in ceil(28 / chunk) prefill steps, on
    both engines."""
    outs = []
    for lib in pair:
        results, steps = {}, {}
        for C in (1, chunk):
            eng = engine(lib, max_batch=2, max_seq=64,
                         page_tokens=page_tokens, chunk_tokens=C)
            req = eng.submit(PROMPT, max_new_tokens=NEW)
            eng.run_until_done()
            assert req.done and not req.truncated
            assert len(PROMPT) + len(req.output) > lib.api.cfg.attn_window
            results[C] = (req.output, eng.controller.pages_relinked)
            steps[C] = eng.steps
        assert results[1] == results[chunk]
        # ceil(28 / C) prefill steps (the last yields the first token),
        # then one decode step a token
        for C, n in steps.items():
            assert n == -(-len(PROMPT) // C) + NEW - 1, (C, n)
        outs.append(results[chunk][0])
    assert outs[0] == outs[1] and len(outs[0]) == NEW


def test_streams_with_slot_reuse(pair):
    """Two slots, four requests: the third and fourth take slots a
    finished request left, so their streams are right only if admission
    zeroes every rec layer's state (the group's and the tail's)."""
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [3, 4, 5],
               [40, 41, 42, 43, 44, 45, 46, 47, 48], [9, 8, 7, 6, 5]]
    outs = []
    for lib in pair:
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     chunk_tokens=8)
        reqs = [eng.submit(p, n) for p, n in zip(prompts, (4, 7, 6, 5))]
        eng.run_until_done()
        assert all(r.done and not r.truncated for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert [len(o) for o in outs[1]] == [4, 7, 6, 5]


def test_refusals_and_cache_walks(pair):
    """Both engines refuse the prefix cache (and so the host tier) and
    speculation for the hybrid, and walk the same leaves: the one
    attention layer's two pools as the page arena, and the conv and h
    leaves of the group's rec layers (batch dim 1) and the tail's (batch
    dim 0) as a slot's state."""
    jlib, tlib = pair
    walks = []
    for lib in pair:
        eng = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     prefix_cache=True, host_cache_pages=16)
        assert eng._recurrent and eng.prefix_cache is None
        assert eng.tier is None and eng.default_spec is None
        pools = [tuple(p.shape) for p in eng._pool_leaves()]
        dims = []
        eng._walk_state(lambda leaf, dim: dims.append(
            (tuple(leaf.shape), dim)) or leaf)
        state = [np.asarray(x.numpy() if hasattr(x, "numpy") else x)
                 for x in eng._gather_slot_state(1)]
        walks.append((pools, dims, [s.shape for s in state]))
    assert walks[0] == walks[1]
    pools, dims, _ = walks[1]
    cfg = tlib.api.cfg
    assert pools == [(1, 2 * 5, 8, 1, cfg.head_dim)] * 2
    assert sorted(d for _, d in dims) == [0, 0, 1, 1, 1, 1]


def test_snapshot_restores_pages_and_state_on_another_engine(pair):
    """A session 4 tokens into its decode moves to a fresh engine: the
    snapshot carries the attention layer's pages and every rec layer's
    state, the restored slot holds them bit for bit, and the session
    finishes with the tokens of an undisturbed run, on both packages."""
    outs = []
    for lib in pair:
        ref = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     chunk_tokens=8)
        want = ref.submit(PROMPT[:20], max_new_tokens=12)
        ref.run_until_done()
        src = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     chunk_tokens=8)
        dst = engine(lib, max_batch=2, max_seq=64, page_tokens=8,
                     chunk_tokens=8)
        dst.submit([7, 8, 9], max_new_tokens=3)        # slot 0 taken
        dst.step()
        req = src.submit(PROMPT[:20], max_new_tokens=12)
        while len(req.output) < 4:
            src.step()
        snap = lib.snapshot_session(src, req)
        assert snap.page_bytes and all(snap.page_bytes)
        assert snap.state is not None and len(snap.state) == 6
        src.detach(req)
        moved = lib.restore_session(dst, snap)
        assert moved.slot == 1
        now = dst._gather_slot_state(moved.slot)
        assert all(np.array_equal(bits(a), bits(b))
                   for a, b in zip(now, snap.state))
        dst.run_until_done()
        assert moved.done and moved.output == want.output
        outs.append(moved.output)
    assert outs[0] == outs[1]
