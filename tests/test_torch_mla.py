"""The port's MLA serve path against the JAX package's, on the CPU.

  * ``paged_attention_chunk``'s plain version at the latent shape (head
    dim R + dr = 576, one KV head, 16 query heads, the SAME pool passed as
    K and V) against the JAX op, its oracle and its Pallas kernel in
    interpret mode: C=16 and C=1, ragged lengths, a chunk straddling a
    page, pads on the null page, an idle slot, float32 and bf16; and
    ``kv_append_chunk`` at that row width;
  * ``mla_serve`` on deepseek-v2-lite-16b SMOKE (one latent pool of
    R + dr = 40) against the reference's, output and pool, with the JAX
    ops as oracles and in interpret mode.

Inputs come from a seeded numpy rng and go through both packages.  The
CUDA kernel at D = 576 is held against the same plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py (phase 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import kv_append_chunk as jax_kv_append_chunk
from repro.kernels import paged_attention_chunk as jax_paged_chunk
from repro.models.attention import mla_serve as jax_mla_serve
from repro_torch import kernels as tk
from repro_torch.configs import get_config
from repro_torch.models.attention import mla_init, mla_serve, paged_chunk_ids
from repro_torch.models.spec import tree_map_specs

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# float32: sums in another order; bf16 rounds at other places in XLA and
# torch, about one ulp of values O(1) (tests/test_torch_paged_append.py)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LATENT = 576                      # deepseek-v2-lite: kv_lora_rank 512 + 64


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def layout(rng, kind, B, C, T, N, P):
    """(page_table [B, N], pre-chunk lengths [B]): distinct pages off the
    null page; "straddle" starts every chunk C // 2 before a page boundary,
    "pads" sends sequence 0's tokens past its table's end to the null
    page, "idle" gives the last slot length 0 and an all-zero row."""
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
    return pt.astype(np.int32), lens.astype(np.int32)


LATENT_CASES = [
    # name, layout, C, dtype
    ("c16", "spread", 16, "float32"),
    ("c1", "spread", 1, "float32"),
    ("straddle", "straddle", 6, "float32"),
    ("pads-to-null-page", "pads", 8, "float32"),
    ("idle-slot", "idle", 16, "float32"),
    ("c16-bf16", "spread", 16, "bfloat16"),
    ("c1-bf16-idle", "idle", 1, "bfloat16"),
]


@pytest.mark.parametrize("name,kind,C,dtype", LATENT_CASES,
                         ids=[c[0] for c in LATENT_CASES])
def test_latent_append_and_attention_match_jax(name, kind, C, dtype):
    """The chunk's latents appended into one pool, then attention with
    that pool as K and V, at D = 576, KV = 1, 16 heads: the port's plain
    versions against the JAX oracles and the Pallas kernels (interpret)."""
    rng = np.random.default_rng(len(name) * 7 + C)
    B, H, D, P, T, N = 3, 16, LATENT, 20, 8, 5
    jd, td = DTYPES[dtype]
    pt, lens = layout(rng, kind, B, C, T, N, P)
    pids, sids = (x.numpy() for x in paged_chunk_ids(
        torch.from_numpy(pt), torch.from_numpy(lens), C, T)[1:])
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    new = rng.standard_normal((B, C, 1, D)).astype(np.float32)
    pool = rng.standard_normal((P, T, 1, D)).astype(np.float32)
    tq, tnew, tpool = (torch.from_numpy(x).to(td) for x in (q, new, pool))
    jq, jnew, jpool = (jnp.asarray(x, jd) for x in (q, new, pool))
    jpt, jl, jp, js = map(jnp.asarray, (pt, lens, pids, sids))

    tk.kv_append_chunk(tpool, tnew, torch.from_numpy(pids),
                       torch.from_numpy(sids))
    out = tk.paged_attention_chunk(tq, tpool, tpool, torch.from_numpy(pt),
                                   torch.from_numpy(lens))
    assert out.dtype == td and out.shape == (B, C, H, D)

    tol = ATTN_TOL[dtype]
    for impl in ("ref", "interpret"):
        jp_new = jax_kv_append_chunk(jpool.copy(), jnew, jp, js, impl=impl)
        # the appended rows carry the same bits (a copy); page 0 takes pads
        np.testing.assert_array_equal(as_f32(tpool)[1:],
                                      as_f32(jp_new)[1:])
        want = jax_paged_chunk(jq, jp_new, jp_new, jpt, jl, impl=impl)
        for b in range(B):
            if kind == "idle" and b == B - 1:
                continue             # an idle slot reads the null page
            np.testing.assert_allclose(as_f32(out[b]), as_f32(want[b]),
                                       atol=tol, rtol=tol, err_msg=impl)


def test_latent_head_dim_takes_aliased_and_separate_pools():
    """One pool passed twice gives what two equal pools give."""
    rng = np.random.default_rng(3)
    B, C, H, D, P, T, N = 2, 4, 16, LATENT, 12, 8, 4
    pt, lens = layout(rng, "spread", B, C, T, N, P)
    q = torch.from_numpy(rng.standard_normal((B, C, H, D)).astype(np.float32))
    pool = torch.from_numpy(
        rng.standard_normal((P, T, 1, D)).astype(np.float32))
    args = (torch.from_numpy(pt), torch.from_numpy(lens))
    one = tk.paged_attention_chunk(q, pool, pool, *args)
    two = tk.paged_attention_chunk(q, pool, pool.clone(), *args)
    assert torch.equal(one, two)


def mla_cfgs(dtype):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jax_get_config("deepseek-v2-lite-16b",
                                               smoke=True), dtype=jd),
            dataclasses.replace(get_config("deepseek-v2-lite-16b",
                                           smoke=True), dtype=td))


MLA_CASES = {
    # name: (lengths, C)
    "prefill_chunk": ([0, 5, 0], 8),
    "straddling": ([13, 3, 0], 8),
    "decode_c1": ([9, 30, 0], 1),
}


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_serve_matches_jax(case, dtype, impl, monkeypatch):
    """Output and latent pool of one MLA serve step, the JAX side through
    its oracles or its Pallas kernels in interpret mode."""
    lengths, C = MLA_CASES[case]
    jcfg, tcfg = mla_cfgs(dtype)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(len(case) + C)
    B, T = 3, 8
    pt = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                  np.int32)
    lat = tcfg.kv_lora_rank + tcfg.qk_rope_dim
    p = tree_map_specs(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
        .astype(np.float32), mla_init(tcfg))
    x = rng.standard_normal((B, C, tcfg.d_model)).astype(np.float32)
    pool = rng.standard_normal((11, T, 1, lat)).astype(np.float32)

    monkeypatch.setenv("REPRO_KERNEL_IMPL", impl)
    j_out, j_pool = jax_mla_serve(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x, jd),
        jnp.asarray(pool, jd), jnp.asarray(pt), jnp.asarray(lengths,
                                                            jnp.int32))
    t_pool = torch.from_numpy(pool).to(td)
    t_out, t_pool2 = mla_serve(
        {k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
        torch.from_numpy(x).to(td), t_pool, torch.from_numpy(pt),
        torch.tensor(lengths, dtype=torch.int32))
    assert t_pool2 is t_pool and t_out.dtype == td
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    for b in range(B - 1):               # the last slot is idle
        np.testing.assert_allclose(as_f32(t_out[b]), as_f32(j_out[b]),
                                   atol=tol, rtol=tol)
    np.testing.assert_allclose(as_f32(t_pool)[1:], as_f32(j_pool)[1:],
                               atol=tol, rtol=tol)
