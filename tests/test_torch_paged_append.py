"""The serve step's fused append and attention
(``repro_torch.kernels.paged_attention_append_chunk``).

On the CPU its plain version, the two appends then the attention, is held
against the JAX package's ``kv_append_chunk`` and ``paged_attention_chunk``
(their oracles, and their Pallas kernels in interpret mode) on the output
and on both pools: a 16-token chunk over two pages, the decode slice, a
chunk that straddles a page, pad tokens routed to the null page 0, an idle
slot, a window and a softcap, in float32 and bf16.  Inputs come from a
seeded numpy rng and go through both packages.  The fused kernel itself
is held against the unfused kernel path on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_append_chunk as jax_kv_append_chunk
from repro.kernels import kv_append_chunk_ref as jax_kv_append_chunk_ref
from repro.kernels import paged_attention_chunk as jax_paged_chunk
from repro.kernels import paged_attention_chunk_ref as jax_paged_chunk_ref
from repro_torch import kernels as tk
from repro_torch.models.attention import paged_chunk_ids

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# as tests/test_torch_kernels.py: float32 sums in another order; bf16 is
# rounded at other places by XLA and torch, about one ulp of values O(1)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def layout(rng, kind, B, C, T, N, P):
    """(page_table [B, N], pre-chunk lengths [B]) of one scenario: distinct
    pages off the null page for every sequence, with

      * "spread": lengths anywhere a chunk fits in the table;
      * "straddle": every chunk starts C // 2 tokens before a page
        boundary and crosses it;
      * "pads": sequence 0's chunk runs from mid page 1 into page 2, whose
        table entry (and every later one) is 0, so its tokens there, pads
        in the engine, land on the null page (each slot once while C <=
        3T/2);
      * "idle": the last slot idle (length 0, an all-zero row)."""
    assert B * N < P
    pt = rng.permutation(np.arange(1, P))[:B * N].reshape(B, N)
    if kind == "straddle":
        lens = rng.integers(1, N - 1, B) * T - C // 2
    else:
        lens = rng.integers(0, N * T - C + 1, B)
    if kind == "pads":
        lens[0] = T + T // 2            # chunk from mid page 1 onwards
        pt[0, 2:] = 0
    if kind == "idle":
        pt[-1] = 0
        lens[-1] = 0
    return pt.astype(np.int32), lens.astype(np.int32)


CPU_CASES = [
    # name, layout, C, window, softcap, dtype
    ("c16", "spread", 16, None, None, "float32"),
    ("c1", "spread", 1, None, None, "float32"),
    ("straddle", "straddle", 6, None, None, "float32"),
    ("pads-to-null-page", "pads", 8, None, None, "float32"),
    ("idle-slot", "idle", 16, None, None, "float32"),
    ("window", "spread", 16, 5, None, "float32"),
    ("softcap", "spread", 16, None, 30.0, "float32"),
    ("c16-bf16", "spread", 16, None, None, "bfloat16"),
    ("c1-bf16-idle", "idle", 1, None, None, "bfloat16"),
]


@pytest.mark.parametrize("name,kind,C,window,softcap,dtype", CPU_CASES,
                         ids=[c[0] for c in CPU_CASES])
def test_fused_plain_matches_jax_append_then_attention(name, kind, C, window,
                                                       softcap, dtype):
    rng = np.random.default_rng(len(name) * 31 + C)
    B, H, KV, D, P, T, N = 3, 4, 2, 32, 24, 8, 6
    pt, lens = layout(rng, kind, B, C, T, N, P)
    pids, sids = (x.numpy() for x in paged_chunk_ids(
        torch.from_numpy(pt), torch.from_numpy(lens), C, T)[1:])
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    vn = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    pk = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    pv = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    (jq, tq), (jkn, tkn), (jvn, tvn) = (both(x, dtype) for x in (q, kn, vn))
    (jpk, tpk), (jpv, tpv) = both(pk, dtype), both(pv, dtype)
    jpt, jl, jp, js = map(jnp.asarray, (pt, lens, pids, sids))
    kw = dict(window=window, softcap=softcap)

    out = tk.paged_attention_append_chunk(
        tq, tkn, tvn, tpk, tpv, torch.from_numpy(pt),
        torch.from_numpy(lens), torch.from_numpy(pids),
        torch.from_numpy(sids), **kw)
    assert out.dtype == tq.dtype and out.shape == tq.shape

    # the oracles, then the Pallas kernels in interpret mode
    rk = jax_kv_append_chunk_ref(jpk, jkn, jp, js)
    rv = jax_kv_append_chunk_ref(jpv, jvn, jp, js)
    ref = jax_paged_chunk_ref(jq, rk, rv, jpt, jl, **kw)
    ik = jax_kv_append_chunk(jpk.copy(), jkn, jp, js, impl="interpret")
    iv = jax_kv_append_chunk(jpv.copy(), jvn, jp, js, impl="interpret")
    pal = jax_paged_chunk(jq, ik, iv, jpt, jl, impl="interpret", **kw)

    tol = ATTN_TOL[dtype]
    for want in (ref, pal):
        np.testing.assert_allclose(as_f32(out), as_f32(want), atol=tol,
                                   rtol=tol)
    for got, want in ((tpk, rk), (tpv, rv), (tpk, ik), (tpv, iv)):
        np.testing.assert_array_equal(as_f32(got)[1:], as_f32(want)[1:])


def test_fused_plain_is_the_three_plain_calls():
    """The plain version is exactly kv_append_chunk on K, on V, then
    paged_attention_chunk: bitwise, pools included (page 0 too: one
    sequence's pads land there, each slot once)."""
    rng = np.random.default_rng(5)
    B, C, H, KV, D, P, T, N = 3, 8, 4, 2, 32, 24, 8, 6
    pt, lens = layout(rng, "pads", B, C, T, N, P)
    pt, lens = torch.from_numpy(pt), torch.from_numpy(lens)
    _, pids, sids = paged_chunk_ids(pt, lens, C, T)
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, C, H, D), (B, C, KV, D), (B, C, KV, D)))
    pk = torch.from_numpy(rng.standard_normal((P, T, KV, D))
                          .astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal((P, T, KV, D))
                          .astype(np.float32))
    a_k, a_v = pk.clone(), pv.clone()
    tk.kv_append_chunk(a_k, kn, pids, sids)
    tk.kv_append_chunk(a_v, vn, pids, sids)
    want = tk.paged_attention_chunk(q, a_k, a_v, pt, lens, window=7)
    f_k, f_v = pk.clone(), pv.clone()
    got = tk.paged_attention_append_chunk(q, kn, vn, f_k, f_v, pt, lens,
                                          pids, sids, window=7)
    assert torch.equal(got, want)
    assert torch.equal(f_k, a_k) and torch.equal(f_v, a_v)
