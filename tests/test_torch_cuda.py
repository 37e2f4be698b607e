"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the code paths chip_smoke.py does not reach at the serving shapes:
float32, small and odd head dims (the scalar tile loads, the 8/4/2-byte
append copies), pages of 8 and 32 tokens, one and many context splits,
MQA, window and softcap, and head dims above 256 (MLA's latent D=576 with
one pool as K and V, the latent kernel and the float32 scalar path); the
serve step's fused append and attention,
bitwise against the unfused kernel path over the same loaders, splits and
pages and over idle slots, pads on the null page and straddling chunks;
the flash kernel over causal, windowed,
softcapped, non-causal and ragged shapes in float32 and bf16 at head dims
64, 128 and 256, groups of 1 and 6, operands TMA cannot address as given,
and its repeatability, and its backward kernel over the same shapes (and
its launch count, repeatability, unaligned operands and argument checks);
the ssd_chunk kernel over float32 and bf16 with ragged
L, H, P and N and chunks longer than 256, its backward kernel over the same
(and its repeatability and argument checks), and its autograd Function's
gradients — and the SMOKE
models' serve step, greedy engine output and train step (qwen2 and
mamba2), kernel path against plain path; and the engine's host tier and
speculative decoding on the card: a bf16 page round trip through the
pinned arena bit for bit, an arena slot rewritten while the promotion
that read it is still in flight, and a verify step after a rollback; and
the engine cluster on the card: a session restored beside a queued
promotion, and a kill whose migrated sessions stream the CPU cluster's
tokens.

Needs a card: every test skips without one.  On the card, run

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports the JAX package,
which the port's machine does not have)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import HostArena
from repro_torch.kernels import (attention, attention_bwd, attention_fwd,
                                 common, kv_append_chunk, paged_attention,
                                 paged_attention_append_chunk,
                                 paged_attention_chunk, ssd_chunk,
                                 ssd_chunk_bwd, ssd_chunk_fwd, ssd_chunk_ref)
from repro_torch.models import build_model, init_params
from repro_torch.models.attention import paged_chunk_ids
from repro_torch.serve import (EngineCluster, ServingEngine, SpecConfig,
                               restore_session, snapshot_session)
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.optimizer import leaves

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# kernel vs plain version: float32 differs only in summation order; bf16
# outputs round once more, about one bf16 ulp of values O(1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev, DTYPES[dtype])


ATTN_CASES = [
    # B, C, H, KV, D, P, T, N, window, softcap, dtype, contexts
    (3, 8, 8, 2, 64, 16, 16, 8, None, None, "float32", "spread"),  # splits > 1
    (2, 4, 4, 2, 32, 8, 8, 4, None, None, "float32", "spread"),   # one split
    (2, 5, 4, 1, 12, 8, 8, 4, None, None, "bfloat16", "spread"),  # D=12
    (2, 5, 4, 2, 12, 8, 8, 4, None, None, "float32", "spread"),   # SMOKE D
    (2, 4, 4, 2, 32, 8, 8, 8, 16, None, "bfloat16", "spread"),    # window
    (2, 4, 4, 2, 32, 8, 8, 8, None, 30.0, "bfloat16", "spread"),  # softcap
    (2, 3, 4, 2, 256, 8, 32, 6, None, None, "bfloat16", "spread"),  # T=32
    (4, 1, 16, 1, 128, 32, 16, 8, None, None, "bfloat16", "spread"),  # MQA
    # the tensor-core path over G in {1, 6, 8} and D in {64, 128, 256}
    (3, 16, 2, 2, 64, 40, 16, 12, None, None, "bfloat16", "spread"),    # G=1
    (4, 16, 12, 2, 128, 64, 16, 16, None, None, "bfloat16", "spread"),  # G=6
    (8, 1, 12, 2, 128, 64, 16, 16, None, None, "bfloat16", "spread"),   # C=1
    (2, 16, 8, 1, 256, 40, 16, 16, None, None, "bfloat16", "spread"),   # G=8
    (2, 16, 16, 2, 64, 40, 16, 12, None, None, "bfloat16", "spread"),   # G=8
    (3, 1, 8, 1, 64, 40, 16, 12, None, None, "bfloat16", "spread"),     # G=8
    (2, 16, 16, 1, 128, 40, 16, 8, None, None, "bfloat16", "spread"),  # 2x128
    (4, 16, 12, 2, 128, 64, 16, 16, None, 30.0, "bfloat16", "spread"),  # cap
    # short contexts in a long table: most splits hold no tile
    (8, 1, 12, 2, 128, 128, 16, 64, None, None, "bfloat16", "short"),
    (8, 16, 12, 2, 128, 128, 16, 64, None, None, "bfloat16", "short"),
    (4, 1, 12, 2, 128, 128, 16, 64, None, None, "float32", "short"),
    # a window smaller than one page
    (3, 16, 12, 2, 128, 48, 16, 12, 5, None, "bfloat16", "spread"),
    (3, 1, 12, 2, 128, 48, 16, 12, 5, None, "bfloat16", "spread"),
    (3, 16, 12, 2, 128, 48, 16, 12, 5, None, "float32", "spread"),
    # float32 over G and D
    (3, 16, 12, 2, 128, 48, 16, 12, None, None, "float32", "spread"),
    (4, 1, 8, 1, 256, 40, 16, 10, None, None, "float32", "spread"),
    (2, 16, 6, 6, 64, 40, 16, 10, None, None, "float32", "spread"),
]

LATENT_CASES = [
    # B, C, H, KV, D, P, T, N, window, softcap, dtype, contexts, alias: the
    # latent head dim (MLA: one KV head, 16 query heads, one pool as K and V)
    (8, 16, 16, 1, 576, 600, 16, 64, None, None, "bfloat16", "spread", True),
    (8, 1, 16, 1, 576, 600, 16, 64, None, None, "bfloat16", "spread", True),
    (8, 16, 16, 1, 576, 600, 16, 64, None, None, "bfloat16", "short", True),
    (3, 3, 16, 1, 576, 40, 16, 12, None, None, "bfloat16", "spread", True),
    (2, 16, 16, 1, 576, 40, 16, 12, None, None, "bfloat16", "spread", False),
    (2, 16, 16, 1, 576, 40, 16, 12, 40, None, "bfloat16", "spread", True),
    (2, 16, 16, 1, 576, 40, 16, 12, None, 30.0, "bfloat16", "spread", True),
    (3, 5, 8, 2, 320, 40, 16, 10, None, None, "bfloat16", "spread", False),
    (4, 16, 16, 1, 576, 64, 16, 12, None, None, "float32", "spread", True),
    (4, 1, 16, 1, 576, 64, 16, 12, None, None, "float32", "spread", True),
]


@pytest.mark.parametrize(
    "B,C,H,KV,D,P,T,N,window,softcap,dtype,contexts,alias", LATENT_CASES)
def test_paged_attention_latent_head_dim_matches_plain(
        cuda, B, C, H, KV, D, P, T, N, window, softcap, dtype, contexts,
        alias):
    """Head dims above 256: the bf16 latent kernel (three column-slice
    blocks a row group, one pool read once for K and V when passed twice)
    and the float32 scalar path, against the plain version; repeatable."""
    rng = np.random.default_rng(B * 1000 + C * 10 + D)
    q, pk, pv, pt, lens = attn_inputs(rng, B, C, H, KV, D, P, T, N, dtype,
                                      contexts, cuda)
    if alias:
        pv = pk
    kw = dict(window=window, softcap=softcap)
    common.reset_launch_counts()
    out = paged_attention_chunk(q, pk, pv, pt, lens, **kw)
    ref = paged_attention_chunk(q, pk, pv, pt, lens, impl="ref", **kw)
    again = paged_attention_chunk(q, pk, pv, pt, lens, **kw)
    torch.cuda.synchronize()
    assert common.LAUNCHES["paged_attention_chunk"] == 2
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.equal(out, again)


def attn_inputs(rng, B, C, H, KV, D, P, T, N, dtype, contexts, dev):
    """``contexts``: "spread" draws pre-chunk lengths over [0, N*T - C]
    with both ends present; "short" keeps them under two pages."""
    q = randn(rng, (B, C, H, D), dtype, dev)
    pk = randn(rng, (P, T, KV, D), dtype, dev)
    pv = randn(rng, (P, T, KV, D), dtype, dev)
    pt = torch.from_numpy(rng.integers(0, P, (B, N)).astype(np.int32)).to(dev)
    if contexts == "short":
        lens = rng.integers(0, 2 * T, B)
    else:
        lens = rng.integers(0, N * T - C + 1, B)
        lens[0], lens[-1] = 0, N * T - C
    return q, pk, pv, pt, torch.from_numpy(lens.astype(np.int32)).to(dev)


@pytest.mark.parametrize("B,C,H,KV,D,P,T,N,window,softcap,dtype,contexts",
                         ATTN_CASES)
def test_paged_attention_kernel_matches_plain(cuda, B, C, H, KV, D, P, T, N,
                                              window, softcap, dtype,
                                              contexts):
    rng = np.random.default_rng(B * 1000 + C * 10 + D)
    q, pk, pv, pt, lens = attn_inputs(rng, B, C, H, KV, D, P, T, N, dtype,
                                      contexts, cuda)
    kw = dict(window=window, softcap=softcap)
    common.reset_launch_counts()
    out = paged_attention_chunk(q, pk, pv, pt, lens, **kw)
    ref = paged_attention_chunk(q, pk, pv, pt, lens, impl="ref", **kw)
    torch.cuda.synchronize()
    assert common.LAUNCHES["paged_attention_chunk"] == 1
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    dec = paged_attention(q[:, 0].contiguous(), pk, pv, pt, lens + 1, **kw)
    torch.testing.assert_close(dec.float(), out[:, 0].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("C", [16, 1])
def test_paged_attention_kernel_is_bitwise_repeatable(cuda, C):
    """The split merge runs in a fixed order: two calls on the same inputs
    give the same bits (qwen2-1.5b's serving shape, several splits)."""
    rng = np.random.default_rng(C)
    args = attn_inputs(rng, 8, C, 12, 2, 128, 512, 16, 64, "bfloat16",
                       "spread", cuda)
    first = paged_attention_chunk(*args)
    second = paged_attention_chunk(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("KV,D,dtype", [
    (2, 128, "bfloat16"),     # 512 B rows: 16-byte copies
    (1, 12, "bfloat16"),      # 24 B rows: 8-byte copies
    (1, 3, "float32"),        # 12 B rows: 4-byte copies
    (1, 3, "bfloat16"),       # 6 B rows: 2-byte copies
])
def test_kv_append_kernel_matches_plain_off_page0(cuda, KV, D, dtype):
    rng = np.random.default_rng(D)
    B, C, P, T = 3, 6, 10, 4
    pool = randn(rng, (P, T, KV, D), dtype, cuda)
    new = randn(rng, (B, C, KV, D), dtype, cuda)
    pt = torch.tensor([[1, 2, 5, 6], [3, 4, 7, 8], [9, 0, 0, 0]],
                      dtype=torch.int32, device=cuda)
    lens = torch.tensor([3, 5, 2], dtype=torch.int32, device=cuda)
    _, pids, sids = paged_chunk_ids(pt, lens, C, T)
    out = kv_append_chunk(pool.clone(), new, pids, sids)
    ref = kv_append_chunk(pool.clone(), new, pids, sids, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(out[1:], ref[1:])


def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 2, 640, device=cuda, dtype=torch.bfloat16)
    pool = torch.zeros(4, 4, 1, 640, device=cuda, dtype=torch.bfloat16)
    pt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    lens = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                  # D > 576
        paged_attention_chunk(q, pool, pool, pt, lens)
    with pytest.raises(ValueError):                  # bf16 D > 256, D % 8
        paged_attention_chunk(q[..., :300].contiguous(),
                              pool[..., :300].contiguous(),
                              pool[..., :300].contiguous(), pt, lens)
    with pytest.raises(ValueError):                  # fused: D > 256
        q5, p5 = q[..., :576].contiguous(), pool[..., :576].contiguous()
        paged_attention_append_chunk(q5, p5[:1, :1], p5[:1, :1], p5, p5, pt,
                                     lens, pt[:, :1], pt[:, :1])
    with pytest.raises(TypeError):                   # fp16 is not taken
        paged_attention_chunk(q[..., :64].half().contiguous(),
                              pool[..., :64].half().contiguous(),
                              pool[..., :64].half().contiguous(), pt, lens)
    with pytest.raises(ValueError):                  # non-contiguous
        kv_append_chunk(pool[..., :64], q[:, :, :1, :64], pt[:, :1],
                        pt[:, :1])


FUSED_CASES = [
    # B, C, H, KV, D, P, T, N, layout, window, softcap, dtype
    (8, 16, 12, 2, 128, 600, 16, 64, "spread", None, None, "bfloat16"),
    (8, 1, 12, 2, 128, 600, 16, 64, "spread", None, None, "bfloat16"),
    (8, 16, 12, 2, 128, 600, 16, 64, "idle", None, None, "bfloat16"),
    (8, 1, 12, 2, 128, 600, 16, 64, "idle", None, None, "bfloat16"),
    (8, 16, 12, 2, 128, 600, 16, 64, "straddle", None, None, "bfloat16"),
    (8, 16, 12, 2, 128, 600, 16, 64, "pads", None, None, "bfloat16"),
    (8, 16, 12, 2, 128, 600, 16, 64, "spread", 256, None, "bfloat16"),
    (8, 16, 12, 2, 128, 600, 16, 64, "spread", None, 30.0, "bfloat16"),
    (8, 16, 12, 2, 128, 600, 16, 64, "spread", None, None, "float32"),
    (8, 1, 12, 2, 128, 600, 16, 64, "idle", None, None, "float32"),
    (2, 4, 4, 2, 32, 16, 8, 4, "spread", None, None, "float32"),  # 1 split
    (3, 5, 4, 1, 12, 40, 8, 8, "spread", None, None, "bfloat16"),  # D=12
    (3, 5, 4, 2, 12, 40, 8, 8, "straddle", 9, None, "float32"),   # D=12
    (2, 3, 4, 2, 256, 24, 32, 6, "spread", None, None, "bfloat16"),  # T=32
    (2, 16, 16, 1, 64, 40, 16, 12, "idle", None, None, "bfloat16"),  # G=16
    (3, 16, 2, 2, 64, 48, 16, 12, "straddle", 20, None, "bfloat16"),  # G=1
]


def fused_inputs(rng, B, C, H, KV, D, P, T, N, kind, dtype, dev):
    """q, k_new, v_new, pools, table, lengths and the chunk's (page, slot)
    ids of one scenario; every sequence has distinct pages off the null
    page, and ``kind`` is "spread" (lengths anywhere a chunk fits),
    "straddle" (every chunk starts C // 2 tokens before a page boundary),
    "pads" (sequence 0's chunk runs from mid page 1 into page 2, whose
    table entry and every later one is 0: its tokens there land on the
    null page, each slot once) or "idle" (the last slot at length 0 with an
    all-zero row)."""
    pt = rng.permutation(np.arange(1, P))[:B * N].reshape(B, N)
    if kind == "straddle":
        lens = rng.integers(1, N - 1, B) * T - C // 2
    else:
        lens = rng.integers(0, N * T - C + 1, B)
    if kind == "pads":
        lens[0] = T + T // 2
        pt[0, 2:] = 0
    if kind == "idle":
        pt[-1] = 0
        lens[-1] = 0
    pt = torch.from_numpy(pt.astype(np.int32)).to(dev)
    lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    _, pids, sids = paged_chunk_ids(pt, lens, C, T)
    return (randn(rng, (B, C, H, D), dtype, dev),
            randn(rng, (B, C, KV, D), dtype, dev),
            randn(rng, (B, C, KV, D), dtype, dev),
            randn(rng, (P, T, KV, D), dtype, dev),
            randn(rng, (P, T, KV, D), dtype, dev), pt, lens, pids, sids)


@pytest.mark.parametrize("B,C,H,KV,D,P,T,N,kind,window,softcap,dtype",
                         FUSED_CASES)
def test_fused_append_attention_equals_unfused_kernel_path(
        cuda, B, C, H, KV, D, P, T, N, kind, window, softcap, dtype):
    """The fused kernel's output bitwise that of kv_append_chunk on each
    pool and then paged_attention_chunk, its pools byte-equal off the null
    page 0 (where pad writes race), one launch under its own name; and the
    plain version to TOL."""
    rng = np.random.default_rng(B * 100 + C * 10 + D)
    q, kn, vn, pk, pv, pt, lens, pids, sids = fused_inputs(
        rng, B, C, H, KV, D, P, T, N, kind, dtype, cuda)
    kw = dict(window=window, softcap=softcap)
    a_k, a_v = pk.clone(), pv.clone()
    kv_append_chunk(a_k, kn, pids, sids)
    kv_append_chunk(a_v, vn, pids, sids)
    want = paged_attention_chunk(q, a_k, a_v, pt, lens, **kw)
    common.reset_launch_counts()
    f_k, f_v = pk.clone(), pv.clone()
    got = paged_attention_append_chunk(q, kn, vn, f_k, f_v, pt, lens, pids,
                                       sids, **kw)
    r_k, r_v = pk.clone(), pv.clone()
    plain = paged_attention_append_chunk(q, kn, vn, r_k, r_v, pt, lens,
                                         pids, sids, impl="ref", **kw)
    torch.cuda.synchronize()
    assert common.LAUNCHES["paged_attention_append_chunk"] == 1
    assert common.LAUNCHES["kv_append_chunk"] == 0
    assert common.LAUNCHES["paged_attention_chunk"] == 0
    assert torch.equal(got, want)
    for f, a, r in ((f_k, a_k, r_k), (f_v, a_v, r_v)):
        assert torch.equal(f[1:], a[1:]) and torch.equal(f[1:], r[1:])
    torch.testing.assert_close(got.float(), plain.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_fused_append_attention_rejects_what_it_cannot_take(cuda):
    rng = np.random.default_rng(0)
    q, kn, vn, pk, pv, pt, lens, pids, sids = fused_inputs(
        rng, 2, 4, 4, 2, 32, 16, 8, 4, "spread", "bfloat16", cuda)
    with pytest.raises(ValueError):                  # k_new of another C
        paged_attention_append_chunk(q, kn[:, :3].contiguous(), vn, pk, pv,
                                     pt, lens, pids, sids)
    with pytest.raises(TypeError):                   # k_new not the pools'
        paged_attention_append_chunk(q, kn.float(), vn, pk, pv, pt, lens,
                                     pids, sids)
    with pytest.raises(ValueError):                  # non-contiguous
        paged_attention_append_chunk(
            q, kn.transpose(2, 3).contiguous().transpose(2, 3), vn, pk, pv,
            pt, lens, pids, sids)


def _smoke(cuda):
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return cfg, api, init_params(api.init_specs(), gen, device=cuda)


def test_smoke_serve_step_kernel_path_matches_plain_path(cuda):
    cfg, api, params = _smoke(cuda)
    caches = api.init_caches(3, 32, 8, device=cuda)
    caches["page_table"].copy_(torch.tensor(
        [[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], dtype=torch.int32))
    caches["lengths"].copy_(torch.tensor([5, 3, 0], dtype=torch.int32))
    tok = torch.randint(1, cfg.vocab, (3, 8), device=cuda, dtype=torch.int32)
    n = torch.tensor([8, 6, 0], dtype=torch.int32, device=cuda)

    def clone(c):
        return {"page_table": c["page_table"].clone(),
                "lengths": c["lengths"].clone(), "tail": {},
                "group": {k: tuple(t.clone() for t in v)
                          for k, v in c["group"].items()}}

    lk, ck = api.serve_step(params, tok, clone(caches), n)
    lr, cr = api.serve_step(params, tok, clone(caches), n, impl="ref")
    for b, k in enumerate([8, 6, 0]):
        torch.testing.assert_close(lk[b, :k], lr[b, :k], atol=1e-4, rtol=1e-4)
    for a, r in zip(ck["group"]["b0_attn"], cr["group"]["b0_attn"]):
        torch.testing.assert_close(a[:, 1:], r[:, 1:], atol=1e-4, rtol=1e-4)
    assert torch.equal(ck["lengths"], cr["lengths"])


def test_smoke_engine_on_card_streams_cpu_tokens(cuda):
    cfg, api, params = _smoke(cuda)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = ServingEngine(api, params, max_batch=2, max_seq=64,
                            page_tokens=8, device=dev)
        reqs = [eng.submit([5, 6, 7, 8, 9, 10, 11, 12, 13], 6),
                eng.submit([3, 4, 5], 6)]
        eng.run_until_done()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------- host tier


def _tier_engine(cuda, dtype, host_pages):
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=dtype)
    api = build_model(cfg)
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    return ServingEngine(api, params, max_batch=2, max_seq=64,
                         page_tokens=8, host_cache_pages=host_pages,
                         prefix_cache=True, device=cuda)


def _page(eng, page):
    return [v.clone() for v in eng._gather_page(page)]


def test_tier_round_trips_bf16_pages_bit_for_bit(cuda):
    """Demote a published bf16 chain into the pinned arena and promote it
    back on the side stream: the promoted pages hold the same bits."""
    eng = _tier_engine(cuda, torch.bfloat16, 8)
    prompt = list(range(5, 22))                  # 2 full pages + tail
    req = eng.submit(prompt, max_new_tokens=3)
    eng.run_until_done()
    pc = eng.prefix_cache
    chain, n_tok = pc.match_links(prompt)
    assert n_tok == 16
    want = [_page(eng, nd.page) for nd in chain]
    assert pc.release(pc.pinned_pages) >= 2
    assert all(nd.on_host for nd in chain)
    regions = [b for r in eng.tier.arena._regions.values() for b in r]
    assert regions and all(b.is_pinned() and b.dtype == torch.bfloat16
                           for b in regions)
    req2 = eng.submit(prompt, max_new_tokens=3)
    eng.run_until_done()
    assert req2.prefix_tokens == 16 and eng.tier.pages_promoted == 2
    for nd, w in zip(chain, want):
        assert not nd.on_host
        for got, exp in zip(_page(eng, nd.page), w):
            assert torch.equal(got.view(torch.int16), exp.view(torch.int16))
    assert req2.output == req.output


def test_promotion_slot_rewritten_by_a_demotion_before_the_next_step(cuda):
    """Hazard of the asynchronous promotion: the flip frees the arena
    slots while their H2D copies are still queued (here behind a held
    device); a demotion before the next step lands in one of them.  It
    waits for the copy, so the promoted page gets the demoted chain's
    bits and the arena the new page's."""
    eng = _tier_engine(cuda, torch.float32, 2)
    pc = eng.prefix_cache
    p_prompt, q_prompt = list(range(5, 22)), list(range(40, 57))
    first = eng.submit(p_prompt, max_new_tokens=3)
    eng.run_until_done()
    p_nodes, _ = pc.match_links(p_prompt)
    want = [_page(eng, nd.page) for nd in p_nodes]
    assert pc.release(pc.pinned_pages) == 2 and eng.tier.arena.full
    eng.submit(q_prompt, max_new_tokens=3)
    eng.run_until_done()
    q_nodes, _ = pc.match_links(q_prompt)
    q_want = _page(eng, q_nodes[0].page)
    r = eng.submit(p_prompt, max_new_tokens=3)
    eng._admit()
    assert r.promoting
    torch.cuda._sleep(1_000_000_000)             # hold the device ~0.5 s
    eng._flip_promotions(None, overlapped=False)
    assert eng.tier.host_pages == 0 and not r.promoting
    assert pc._demote(q_nodes[0])                # into a just-freed slot
    assert eng.tier.arena.read_waits == 1
    eng.run_until_done()
    for nd, w in zip(p_nodes, want):
        for got, exp in zip(_page(eng, nd.page), w):
            assert torch.equal(got, exp)
    for got, exp in zip(eng.tier.read(q_nodes[0].host_slot), q_want):
        assert torch.equal(got, exp.cpu())
    assert r.output == first.output


def test_arena_put_waits_for_the_copy_reading_its_slot(cuda):
    """The arena's own guard, without the engine's stream order: a host
    write into a slot whose H2D copy is still queued waits for it."""
    arena = HostArena(1, pin_memory=True)
    src = torch.arange(1 << 16, dtype=torch.float32, device=cuda)
    slot = arena.put([src])
    dst = torch.empty_like(src)
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1_000_000_000)
        dst.copy_(arena.get(slot)[0], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
    arena.mark_read(slot, ev)
    arena.free(slot)
    assert arena.put([torch.zeros(1 << 16)]) == slot
    assert arena.read_waits == 1
    torch.cuda.synchronize()
    assert torch.equal(dst, src)


def test_restore_beside_a_queued_promotion_writes_on_the_compute_stream(
        cuda):
    """A snapshot restored onto an engine whose promotion copies are still
    queued on the side stream (behind a held device) writes its pages on
    the compute stream after them, never through the tier: the restored
    pages hold the captured bits, the promoted ones the demoted chain's,
    and both sessions stream the tokens of undisturbed runs."""
    eng = _tier_engine(cuda, torch.float32, 2)
    pc = eng.prefix_cache
    p_prompt, s_prompt = list(range(5, 22)), list(range(60, 83))
    first = eng.submit(p_prompt, max_new_tokens=6)
    eng.run_until_done()
    p_nodes, _ = pc.match_links(p_prompt)
    want = [_page(eng, nd.page) for nd in p_nodes]
    assert pc.release(pc.pinned_pages) == 2
    src = ServingEngine(eng.api, eng.params, max_batch=2, max_seq=64,
                        page_tokens=8, device=cuda)
    alone = src.submit(s_prompt, max_new_tokens=8)
    src.run_until_done()
    moved = src.submit(s_prompt, max_new_tokens=8)
    while len(moved.output) < 3:
        src.step()
    snap = snapshot_session(src, moved)
    captured = [[v.clone() for v in views] for views in snap.page_bytes]
    src.detach(moved)
    r = eng.submit(p_prompt, max_new_tokens=6)
    eng._admit()
    assert r.promoting
    torch.cuda._sleep(1_000_000_000)             # hold the device ~0.5 s
    eng._flip_promotions(None, overlapped=False)
    assert eng._promote_event is not None
    restore_session(eng, snap)
    assert eng._promote_event is None            # the compute stream waits
    pages = eng.controller.snapshot_seq(moved.seq_id).pages
    for page, views in zip(pages, captured):
        for got, exp in zip(_page(eng, page), views):
            assert torch.equal(got, exp)
    eng.run_until_done()
    for nd, w in zip(p_nodes, want):
        for got, exp in zip(_page(eng, nd.page), w):
            assert torch.equal(got, exp)
    assert r.output == first.output and moved.output == alone.output


def test_cluster_kill_on_card_streams_cpu_tokens(cuda):
    """tests/test_cluster.py's kill on the card: the busiest engine dies
    after 3 ticks, its sessions migrate to the spare (the fused kernel
    then runs on the restored pages) and every stream equals the CPU
    cluster's, which runs the plain versions."""
    cfg, api, params = _smoke(cuda)
    rng = np.random.default_rng(7)
    heads = [list(rng.integers(1, cfg.vocab, 16)) for _ in range(2)]
    prompts = [heads[i % 2] + list(rng.integers(1, cfg.vocab, 6 + i % 5))
               for i in range(6)]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        c = EngineCluster(api, params, n_engines=2, n_spares=1, max_batch=2,
                          max_seq=64, page_tokens=8, heartbeat_timeout=3.0,
                          device=dev)
        reqs = [c.submit(p, max_new_tokens=12) for p in prompts]
        for _ in range(3):
            c.step()
        c.kill(max(range(2), key=lambda e: (len(c.engines[e].active),
                                            len(c.engines[e].waiting))))
        c.run_until_done(max_steps=600)
        assert all(r.done and len(r.output) == 12 for r in reqs)
        assert c.sessions_migrated >= 1 and c.policy.steals == 1
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_spec_verify_after_rollback_runs_the_fused_kernel(cuda):
    """A speculative step after a rollback feeds 1 + k tokens through the
    fused append and attention over the rolled-back (staged, unpublished)
    slots: one launch a layer and step, and the greedy stream of the CPU
    engine and of the card without speculation."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    prompt = ([5, 6, 7, 8, 9, 10, 11, 12, 13] * 2)[:18]
    calls, outs = [], []
    for dev, spec in ((cuda, SpecConfig(k=4)), (torch.device("cpu"),
                                                 SpecConfig(k=4)),
                      (cuda, None)):
        holder = {}

        def step(p, t, c, n, impl=None):
            calls.append((dev.type, spec is not None, int(n.max()),
                          holder["eng"].spec_rollbacks))
            return api.serve_step(p, t, c, n, impl=impl)
        eng = ServingEngine(dataclasses.replace(api, serve_step=step),
                            params, max_batch=2, max_seq=64, page_tokens=8,
                            spec=spec, device=dev)
        holder["eng"] = eng
        common.reset_launch_counts()
        req = eng.submit(prompt, max_new_tokens=24)
        eng.run_until_done()
        if dev.type == "cuda":
            assert common.LAUNCHES["paged_attention_append_chunk"] == \
                cfg.n_layers * eng.steps
        outs.append(req.output)
    assert outs[0] == outs[1] == outs[2]
    assert any(c[:3] == ("cuda", True, 5) and c[3] >= 1 for c in calls), \
        calls


FLASH_CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, softcap, dtype
    (2, 256, 256, 4, 2, 64, True, None, None, "bfloat16"),
    (1, 384, 384, 12, 2, 128, True, None, None, "bfloat16"),
    (1, 256, 256, 4, 1, 256, True, None, None, "bfloat16"),
    (1, 512, 512, 4, 2, 128, True, 100, None, "bfloat16"),     # window
    (1, 256, 256, 4, 2, 128, True, None, 30.0, "bfloat16"),    # softcap
    (2, 100, 300, 4, 2, 64, False, None, None, "bfloat16"),    # non-causal
    (1, 1000, 1000, 4, 2, 128, True, None, None, "bfloat16"),  # ragged S
    (1, 77, 77, 2, 1, 12, True, 16, None, "bfloat16"),         # D=12
    # the wgmma kernel's edges, at D in {64, 128, 256} and groups of 1 and
    # 6: the training shape; Sq not a multiple of the 128-row block and Sk
    # not a multiple of the 128- (64-) key tile, causal and not; Sk below
    # one tile; B=2 with a ragged Sk (a map that ran one sequence into the
    # next would read its rows in place of zeros); a window that starts
    # mid-tile; softcap at every head dim; Sq=1
    (1, 4096, 4096, 12, 2, 128, True, None, None, "bfloat16"),
    (1, 300, 333, 6, 1, 128, True, None, None, "bfloat16"),
    (2, 333, 300, 6, 6, 128, False, None, None, "bfloat16"),
    (2, 200, 77, 12, 2, 64, False, None, None, "bfloat16"),
    (2, 150, 50, 6, 6, 256, True, None, None, "bfloat16"),
    (2, 1000, 1000, 12, 2, 128, True, None, None, "bfloat16"),
    (2, 700, 700, 6, 1, 256, True, None, None, "bfloat16"),
    (2, 520, 520, 6, 6, 64, True, None, None, "bfloat16"),
    (1, 1024, 1024, 12, 2, 128, True, 200, None, "bfloat16"),
    (1, 1100, 1100, 6, 6, 256, True, 300, None, "bfloat16"),
    (2, 640, 640, 6, 1, 64, True, 100, 20.0, "bfloat16"),
    (1, 1024, 1024, 12, 2, 256, True, None, 50.0, "bfloat16"),
    (1, 500, 700, 6, 6, 64, False, None, 30.0, "bfloat16"),
    (3, 1, 300, 12, 2, 128, False, None, None, "bfloat16"),
    (2, 256, 256, 4, 2, 64, True, None, None, "float32"),
    (1, 200, 200, 4, 2, 128, True, 64, 20.0, "float32"),
    (1, 130, 70, 2, 2, 256, False, None, None, "float32"),
    # the float32 backward's edges (3xTF32 kernels, 64-row blocks, 32 at
    # D=256, 32-row steps): D off 4 (tiles loaded by the threads), D=32, a
    # group of 6 and of 1 folded, Sq/Sk off the tiles causal and not, a
    # window and a group at D=256 with Sk below one block, Sq=1
    (2, 77, 77, 6, 1, 12, True, 16, None, "float32"),
    (1, 300, 333, 12, 2, 32, True, None, None, "float32"),
    (2, 333, 300, 6, 6, 128, False, None, 30.0, "float32"),
    (1, 150, 50, 6, 2, 256, True, 40, None, "float32"),
    (3, 1, 300, 12, 2, 64, False, None, None, "float32"),
    # the float32 forward's tensor-core kernel (64-row blocks, 32-key tiles)
    # at phase 1's float32 mask edges: a ragged S, a window, a softcap
    (1, 1000, 1000, 12, 2, 128, True, None, None, "float32"),
    (1, 1000, 1000, 12, 2, 128, True, 256, None, "float32"),
    (1, 1000, 1000, 12, 2, 128, True, None, 30.0, "float32"),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,softcap,dtype",
                         FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, D, causal,
                                    window, softcap, dtype):
    rng = np.random.default_rng(Sq * 7 + D)
    q = randn(rng, (B, Sq, H, D), dtype, cuda)
    k = randn(rng, (B, Sk, KV, D), dtype, cuda)
    v = randn(rng, (B, Sk, KV, D), dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    common.reset_launch_counts()
    out, lse = attention_fwd(q, k, v, **kw)
    ref, ref_lse = attention_fwd(q, k, v, impl="ref", **kw)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == 1
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_kernel_is_bitwise_repeatable(cuda, D):
    """No atomics: two calls on the same inputs give the same bits (the
    training shape's group of 6, a ragged causal length)."""
    rng = np.random.default_rng(D)
    q = randn(rng, (1, 1500, 12, D), "bfloat16", cuda)
    k = randn(rng, (1, 1500, 2, D), "bfloat16", cuda)
    v = randn(rng, (1, 1500, 2, D), "bfloat16", cuda)
    first = attention_fwd(q, k, v, causal=True)
    second = attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("D", [64, 256])
def test_flash_f32_kernel_is_bitwise_repeatable(cuda, D):
    """The float32 forward (3xTF32 tensor cores) gives the same bits every
    call: no atomics, a fixed product order."""
    rng = np.random.default_rng(D + 1)
    q = randn(rng, (1, 700, 6, D), "float32", cuda)
    k = randn(rng, (1, 700, 2, D), "float32", cuda)
    v = randn(rng, (1, 700, 2, D), "float32", cuda)
    first = attention_fwd(q, k, v, causal=True, softcap=30.0)
    second = attention_fwd(q, k, v, causal=True, softcap=30.0)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_kernel_takes_operands_off_16_bytes(cuda, which):
    """An operand whose base sits 2 bytes into its storage (contiguous, but
    not what TMA addresses) gives the same result as an aligned copy."""
    rng = np.random.default_rng(5)
    t = {"q": randn(rng, (1, 300, 4, 128), "bfloat16", cuda),
         "k": randn(rng, (1, 200, 2, 128), "bfloat16", cuda),
         "v": randn(rng, (1, 200, 2, 128), "bfloat16", cuda)}
    buf = torch.empty(t[which].numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(t[which].shape)
    shifted.copy_(t[which])
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    want = attention_fwd(t["q"], t["k"], t["v"], causal=False)
    t[which] = shifted
    common.reset_launch_counts()
    got = attention_fwd(t["q"], t["k"], t["v"], causal=False)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_flash_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        attention(q, q, q, q_offset=4)
    with pytest.raises(NotImplementedError):
        attention(q, q, q, lengths=torch.ones(1, dtype=torch.int32,
                                              device=cuda))
    big = torch.zeros(1, 8, 2, 320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # D > 256
        attention(big, big, big)
    with pytest.raises(ValueError):                  # CPU tensor, kernel asked
        attention(q.cpu(), q.cpu(), q.cpu(), impl="cuda")
    with pytest.raises(TypeError):                   # fp16 is not taken
        attention(q.half(), q.half(), q.half())


# backward kernel vs blockwise_bwd, (atol as a share of the grad's largest
# magnitude, rtol): float32 takes its products in 3xTF32 (about 2^-21
# relative each) and sums in another order; bf16 rounds P and dS to bf16
# before the products (2^-9 relative each, as SDPA does) and the grads
# once more on the way out
FLASH_BWD_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (1e-2, 3e-2)}


def flash_bwd_inputs(rng, B, Sq, Sk, H, KV, D, dtype, dev):
    return (randn(rng, (B, Sq, H, D), dtype, dev),
            randn(rng, (B, Sk, KV, D), dtype, dev),
            randn(rng, (B, Sk, KV, D), dtype, dev),
            randn(rng, (B, Sq, H, D), dtype, dev))


def check_flash_grads(got, want, dtype):
    atol, rtol = FLASH_BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        scale = max(float(b.float().abs().max()), 1e-6)
        torch.testing.assert_close(a.float(), b.float(), atol=atol * scale,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,softcap,dtype",
                         FLASH_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, B, Sq, Sk, H, KV, D, causal,
                                        window, softcap, dtype):
    rng = np.random.default_rng(Sq * 11 + D)
    q, k, v, g = flash_bwd_inputs(rng, B, Sq, Sk, H, KV, D, dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = attention_fwd(q, k, v, **kw)
    common.reset_launch_counts()
    got = attention_bwd(q, k, v, out, lse, g, **kw)
    want = attention_bwd(q, k, v, out, lse, g, impl="ref", **kw)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention_bwd"] == 1
    check_flash_grads(got, want, dtype)


def test_flash_backward_launches_the_kernel_once(cuda):
    """One backward through autograd: one backward launch, no plain
    backward; impl="ref" launches nothing."""
    rng = np.random.default_rng(3)
    q, k, v, g = (x.requires_grad_() for x in flash_bwd_inputs(
        rng, 1, 300, 300, 6, 2, 128, "bfloat16", cuda))
    for impl, launches in ((None, 1), ("ref", 0)):
        common.reset_launch_counts()
        torch.autograd.grad(attention(q, k, v, impl=impl), (q, k, v), g)
        torch.cuda.synchronize()
        assert common.LAUNCHES["flash_attention_bwd"] == launches


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bwd_kernel_is_bitwise_repeatable(cuda, D):
    """No atomics: two backwards of the same inputs give the same bits (a
    group of 6 folded from per-head partials, a ragged causal length)."""
    rng = np.random.default_rng(D + 1)
    q, k, v, g = flash_bwd_inputs(rng, 1, 1500, 1500, 12, 2, D, "bfloat16",
                                  cuda)
    out, lse = attention_fwd(q, k, v)
    first = attention_bwd(q, k, v, out, lse, g)
    second = attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 256])
def test_flash_bwd_f32_kernel_is_bitwise_repeatable(cuda, D):
    """The float32 kernels too: two backwards of the same inputs give the
    same bits (a group of 6 folded, a ragged causal length)."""
    rng = np.random.default_rng(D + 2)
    q, k, v, g = flash_bwd_inputs(rng, 1, 700, 700, 12, 2, D, "float32",
                                  cuda)
    out, lse = attention_fwd(q, k, v)
    first = attention_bwd(q, k, v, out, lse, g)
    second = attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["q", "k", "g"])
def test_flash_bwd_f32_kernel_takes_operands_off_16_bytes(cuda, which):
    """A float32 operand 4 bytes into its storage: the kernels load their
    tiles by thread in place of cp.async and give the same bits."""
    rng = np.random.default_rng(8)
    q, k, v, g = flash_bwd_inputs(rng, 1, 300, 200, 4, 2, 64, "float32",
                                  cuda)
    out, lse = attention_fwd(q, k, v, causal=False)
    t = {"q": q, "k": k, "g": g}
    want = attention_bwd(q, k, v, out, lse, g, causal=False)
    buf = torch.empty(t[which].numel() + 1, dtype=torch.float32, device=cuda)
    shifted = buf[1:].view(t[which].shape)
    shifted.copy_(t[which])
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    t[which] = shifted
    got = attention_bwd(t["q"], t["k"], v, out, lse, t["g"], causal=False)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["q", "k", "v", "out", "g"])
def test_flash_bwd_kernel_takes_operands_off_16_bytes(cuda, which):
    """An operand whose base sits 2 bytes into its storage gives the same
    grads as an aligned copy."""
    rng = np.random.default_rng(7)
    q, k, v, g = flash_bwd_inputs(rng, 1, 300, 200, 4, 2, 128, "bfloat16",
                                  cuda)
    out, lse = attention_fwd(q, k, v, causal=False)
    t = {"q": q, "k": k, "v": v, "out": out, "g": g}
    want = attention_bwd(*(t[n] for n in ("q", "k", "v", "out")), lse, g,
                         causal=False)
    buf = torch.empty(t[which].numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(t[which].shape)
    shifted.copy_(t[which])
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    t[which] = shifted
    common.reset_launch_counts()
    got = attention_bwd(t["q"], t["k"], t["v"], t["out"], lse, t["g"],
                        causal=False)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention_bwd"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_bwd_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(NotImplementedError):         # q_offset on the card
        attention(q, q, q, q_offset=4).sum().backward()
    with pytest.raises(NotImplementedError):         # lengths on the card
        attention(q, q, q, lengths=torch.ones(1, dtype=torch.int32,
                                              device=cuda))
    x = q.detach()
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError):                  # lse of the wrong shape
        attention_bwd(x, x, x, x, lse[:, :, :4], x)
    with pytest.raises(ValueError):                  # lse not float32
        attention_bwd(x, x, x, x, lse.bfloat16(), x)
    with pytest.raises(ValueError):                  # dO of the wrong shape
        attention_bwd(x, x, x, x, lse, x[:, :4])
    with pytest.raises(TypeError):                   # dO of another dtype
        attention_bwd(x, x, x, x, lse, x.float())
    big = torch.zeros(1, 8, 2, 320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # D > 256
        attention_bwd(big, big, big, big, lse, big)
    with pytest.raises(ValueError):                  # CPU tensor, kernel asked
        attention_bwd(x.cpu(), x.cpu(), x.cpu(), x.cpu(), lse.cpu(), x.cpu(),
                      impl="cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_train_step_kernel_path_matches_plain_path(cuda, dtype):
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=DTYPES[dtype])
    api = build_model(cfg)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65))
                           .astype(np.int32)).to(cuda)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    out = {}
    for impl in (None, "ref"):
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = init_params(api.init_specs(), gen, device=cuda)
        step, init_state = make_train_step(
            api, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
            microbatches=2, impl=impl)
        state = init_state(params, device=cuda)
        common.reset_launch_counts()
        state, metrics = step(state, batch)
        out[impl] = (float(metrics["loss"]), state["params"],
                     common.LAUNCHES["flash_attention"],
                     common.LAUNCHES["flash_attention_bwd"])
    # two microbatches, each layer's forward run again by remat "full", its
    # backward once
    assert out[None][2] == 2 * 2 * cfg.n_layers and out["ref"][2] == 0
    assert out[None][3] == 2 * cfg.n_layers and out["ref"][3] == 0
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert out[None][0] == pytest.approx(out["ref"][0], rel=tol)
    for a, b in zip(leaves(out[None][1]), leaves(out["ref"][1])):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-2)


SSD_CASES = [
    # B', L, H, P, N, dtype
    (2, 256, 8, 64, 128, "float32"),     # the path's per-chunk shape
    (2, 32, 8, 16, 16, "float32"),       # tests/test_kernels.py's shapes
    (1, 64, 4, 32, 8, "float32"),
    (2, 16, 2, 8, 4, "bfloat16"),
    (1, 100, 6, 64, 128, "float32"),     # ragged L, H not a multiple of 4
    (1, 100, 6, 64, 128, "bfloat16"),
    (1, 70, 3, 130, 257, "float32"),     # P > 64 (two column tiles), N > 256
    # chunks longer than the 256 positions whose scores a block keeps: key
    # tiles walked in windows, y's partials carried in the workspace
    (2, 512, 8, 64, 128, "float32"),
    (2, 600, 6, 64, 128, "bfloat16"),
    (1, 1100, 3, 5, 7, "float32"),
]


def ssd_inputs(rng, Bp, L, H, P, N, dtype, dev):
    dt = torch.from_numpy((np.abs(rng.standard_normal((Bp, L, H))) * 0.1)
                          .astype(np.float32)).to(dev)
    A = torch.from_numpy(-np.abs(rng.standard_normal(H)).astype(np.float32)
                         * 0.5).to(dev)
    return (randn(rng, (Bp, L, H, P), dtype, dev), dt,
            torch.cumsum(dt * A, dim=1).contiguous(),
            randn(rng, (Bp, L, N), dtype, dev),
            randn(rng, (Bp, L, N), dtype, dev))


@pytest.mark.parametrize("Bp,L,H,P,N,dtype", SSD_CASES)
def test_ssd_chunk_kernel_matches_plain(cuda, Bp, L, H, P, N, dtype):
    """float32: summation order only (2e-5 of the output's scale).  bf16:
    kernel and plain version round float32 sums that agree to ~1e-6, so
    they differ by at most one bf16 ulp (rtol 1.6e-2)."""
    rng = np.random.default_rng(L * 7 + H)
    args = ssd_inputs(rng, Bp, L, H, P, N, dtype, cuda)
    common.reset_launch_counts()
    out = ssd_chunk_fwd(*args)
    ref = ssd_chunk_fwd(*args, impl="ref")
    torch.cuda.synchronize()
    assert common.LAUNCHES["ssd_chunk"] == 1
    assert out.dtype == args[0].dtype and torch.isfinite(out).all()
    scale = float(ref.float().abs().max())
    tol = (2e-5 * scale, 2e-5) if dtype == "float32" else (4e-3, 1.6e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol[0],
                               rtol=tol[1])


def test_ssd_chunk_function_grads_match_autograd_of_plain(cuda):
    rng = np.random.default_rng(3)
    args = ssd_inputs(rng, 2, 100, 6, 16, 24, "float32", cuda)
    dy = randn(rng, (2, 100, 6, 16), "float32", cuda)
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    common.reset_launch_counts()
    ga = torch.autograd.grad(ssd_chunk(*a), a, dy)
    gb = torch.autograd.grad(ssd_chunk_ref(*b), b, dy)
    assert common.LAUNCHES["ssd_chunk"] == 1
    assert common.LAUNCHES["ssd_chunk_bwd"] == 1
    for x, y in zip(ga, gb):
        scale = float(y.abs().max())
        torch.testing.assert_close(x, y, atol=1e-5 * scale, rtol=1e-4)
    # impl="ref" keeps the backward plain on the card too
    common.reset_launch_counts()
    c = [t.clone().requires_grad_() for t in args]
    gc = torch.autograd.grad(ssd_chunk(*c, impl="ref"), c, dy)
    assert common.LAUNCHES["ssd_chunk"] == common.LAUNCHES["ssd_chunk_bwd"] \
        == 0
    for x, y in zip(gc, ssd_chunk_bwd(*args, dy, impl="ref")):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


SSD_BWD_CASES = [
    # B', L, H, P, N, dtype
    (16, 256, 64, 64, 128, "float32"),   # the training path's shape
    (2, 256, 64, 64, 128, "bfloat16"),
    (4, 100, 6, 64, 128, "float32"),     # ragged L, one short head group
    (4, 100, 6, 64, 128, "bfloat16"),
    (2, 32, 8, 16, 16, "float32"),       # the SMOKE model's chunk
    (2, 100, 10, 5, 7, "float32"),       # P = 5, N = 7: scalar tile loads
    (1, 70, 3, 130, 257, "float32"),     # three column tiles of P, N > 256
    (3, 64, 9, 64, 128, "float32"),      # one tile; heads 8 + 1
    # chunks longer than 256 (query tiles walked in windows): mamba2 at
    # chunk 512 over the path's 4096 tokens, bf16, ragged over 5 windows
    (8, 512, 64, 64, 128, "float32"),
    (2, 600, 6, 64, 128, "bfloat16"),
    (1, 1100, 3, 5, 7, "float32"),
]


@pytest.mark.parametrize("Bp,L,H,P,N,dtype", SSD_BWD_CASES)
def test_ssd_chunk_bwd_kernel_matches_plain(cuda, Bp, L, H, P, N, dtype):
    """Every grad against the plain backward on the same inputs: float32
    differs in summation order and the 3xTF32 split (1e-5 of the grad's
    scale, rtol 1e-4, chip_smoke.py's SSD_GRAD_TOL); bf16 grads round
    float32 values that agree to that, so by one bf16 ulp (rtol 1.6e-2)."""
    rng = np.random.default_rng(L * 5 + H + P)
    args = ssd_inputs(rng, Bp, L, H, P, N, dtype, cuda)
    dy = randn(rng, (Bp, L, H, P), dtype, cuda)
    common.reset_launch_counts()
    got = ssd_chunk_bwd(*args, dy)
    want = ssd_chunk_bwd(*args, dy, impl="ref")
    torch.cuda.synchronize()
    assert common.LAUNCHES["ssd_chunk_bwd"] == 1
    for name, a, b, inp in zip(("x", "dt", "dA_cs", "Bm", "Cm"), got, want,
                               args):
        assert a.dtype == inp.dtype and a.shape == inp.shape, name
        assert torch.isfinite(a).all(), name
        scale = float(b.float().abs().max())
        atol, rtol = ((1e-5, 1e-4) if a.dtype == torch.float32
                      else (2e-5, 1.6e-2))
        torch.testing.assert_close(a.float(), b.float(), atol=atol * scale,
                                   rtol=rtol, msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("L", [256, 512])
def test_ssd_chunk_bwd_kernel_is_bitwise_repeatable(cuda, L):
    """No atomics: partial sums meet in a fixed order, so every grad has
    the same bits on every call (at L = 512 with two windows)."""
    rng = np.random.default_rng(11)
    args = ssd_inputs(rng, 4, L, 24, 64, 128, "float32", cuda)
    dy = randn(rng, (4, L, 24, 64), "float32", cuda)
    first = ssd_chunk_bwd(*args, dy)
    for _ in range(3):
        again = ssd_chunk_bwd(*args, dy)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_ssd_chunk_bwd_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    rng = np.random.default_rng(0)
    x, dt, cs, Bm, Cm = ssd_inputs(rng, 1, 8, 2, 4, 4, "float32", cuda)
    dy = torch.ones_like(x)
    with pytest.raises(ValueError):                  # dy's shape
        ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy[:, :4].contiguous())
    with pytest.raises(TypeError):                   # dy in x's dtype
        ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy.bfloat16())
    with pytest.raises(TypeError):                   # dt must be float32
        ssd_chunk_bwd(x, dt.bfloat16(), cs, Bm, Cm, dy)
    with pytest.raises(ValueError):                  # non-contiguous
        ssd_chunk_bwd(x.transpose(1, 2), dt, cs, Bm, Cm, dy)
    with pytest.raises(ValueError):                  # CPU tensor, kernel asked
        ssd_chunk_bwd(*(t.cpu() for t in (x, dt, cs, Bm, Cm, dy)),
                      impl="cuda")


def test_ssd_chunk_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    rng = np.random.default_rng(0)
    x, dt, cs, Bm, Cm = ssd_inputs(rng, 1, 8, 2, 4, 4, "float32", cuda)
    with pytest.raises(TypeError):                   # dt must be float32
        ssd_chunk_fwd(x, dt.bfloat16(), cs, Bm, Cm)
    with pytest.raises(TypeError):                   # x, Bm, Cm: one dtype
        ssd_chunk_fwd(x, dt, cs, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError):                  # shapes
        ssd_chunk_fwd(x, dt[:, :4].contiguous(), cs, Bm, Cm)
    with pytest.raises(ValueError):                  # non-contiguous
        ssd_chunk_fwd(x.transpose(1, 2), dt, cs, Bm, Cm)
    with pytest.raises(ValueError):                  # CPU tensor, kernel asked
        ssd_chunk_fwd(*(t.cpu() for t in (x, dt, cs, Bm, Cm)), impl="cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_smoke_train_step_kernel_path_matches_plain_path(cuda, dtype):
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              dtype=DTYPES[dtype])
    api = build_model(cfg)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65))
                           .astype(np.int32)).to(cuda)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    out = {}
    for impl in (None, "ref"):
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = init_params(api.init_specs(), gen, device=cuda)
        step, init_state = make_train_step(
            api, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
            microbatches=2, impl=impl)
        state = init_state(params, device=cuda)
        common.reset_launch_counts()
        state, metrics = step(state, batch)
        out[impl] = (float(metrics["loss"]), state["params"],
                     common.LAUNCHES["ssd_chunk"],
                     common.LAUNCHES["ssd_chunk_bwd"])
    # two microbatches, each layer's forward run again by remat "full"
    assert out[None][2] == 2 * 2 * cfg.n_layers and out["ref"][2] == 0
    assert out[None][3] == 2 * cfg.n_layers and out["ref"][3] == 0
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert out[None][0] == pytest.approx(out["ref"][0], rel=tol)
    for a, b in zip(leaves(out[None][1]), leaves(out["ref"][1])):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-2)


def test_mamba2_smoke_engine_on_card_streams_cpu_tokens(cuda):
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(api.init_specs(), gen, device=cuda)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = ServingEngine(api, params, max_batch=2, max_seq=64,
                            page_tokens=8, device=dev)
        reqs = [eng.submit([5, 6, 7, 8, 9, 10, 11, 12, 13], 6),
                eng.submit([3, 4, 5], 6), eng.submit([7, 7, 7, 7], 5)]
        eng.run_until_done()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
