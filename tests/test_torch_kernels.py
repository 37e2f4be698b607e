"""The port's kernel modules against the JAX package: the plain PyTorch
versions of kv_append and paged_attention held against the JAX oracles and
against the Pallas kernels in interpret mode, on the shapes
tests/test_kernels.py sweeps.  Inputs come from a seeded numpy rng and go
through both packages.  (The CUDA kernels themselves run only on the card;
chip_smoke.py holds them against these plain versions there.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_append_chunk as jax_kv_append_chunk
from repro.kernels import kv_append_chunk_ref as jax_kv_append_chunk_ref
from repro.kernels import paged_attention as jax_paged_attention
from repro.kernels import paged_attention_chunk as jax_paged_chunk
from repro.kernels import paged_attention_chunk_ref as jax_paged_chunk_ref
from repro.kernels import paged_attention_ref as jax_paged_ref
from repro_torch import kernels as tk
from repro_torch.kernels import common
from repro_torch.kernels.paged_attention.ops import (MAX_SPLITS, TILE_KEYS,
                                                     block_rows, plan_splits,
                                                     workspace_floats)
from repro_torch.kernels.flash_attention.ops import TMA_ALIGN, tma_operands

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: both sides do the same f32 arithmetic in another order.  bf16: XLA
# and torch round bf16 at different places (the einsum inputs/outputs and
# the final cast), so outputs agree to about one bf16 ulp of values O(1).
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def both(x, dtype="float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def ints(x):
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def chunk_ids(pt, lengths, C, T):
    """(page_ids, slot_ids) of a chunk as models/attention.paged_chunk_ids
    computes them, including the clamp to the table row."""
    pos = np.asarray(lengths)[:, None] + np.arange(C)[None, :]
    pp = np.minimum(pos // T, np.asarray(pt).shape[1] - 1)
    return np.take_along_axis(np.asarray(pt), pp, axis=1), pos % T


# ---------------------------------------------------------------- kv append


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 3, 5])
def test_kv_append_chunk_matches_jax(start, dtype):
    """Bit-exact on every page but the null page 0, including chunks that
    straddle a page and pad tokens routed to page 0 by a zero table entry."""
    rng = np.random.default_rng(start)
    P, T, KV, D, B, C = 10, 4, 2, 16, 3, 6
    pool0 = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    new = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    pt = np.array([[1, 2, 5, 6], [3, 4, 7, 8], [9, 0, 0, 0]], np.int32)
    pids, sids = chunk_ids(pt, [start, start + 1, 2], C, T)
    jpool, tpool = both(pool0, dtype)
    jnew, tnew = both(new, dtype)
    (jp, tp), (js, ts) = ints(pids), ints(sids)
    ref = jax_kv_append_chunk_ref(jpool, jnew, jp, js)
    pal = jax_kv_append_chunk(jpool.copy(), jnew, jp, js, impl="interpret")
    out = tk.kv_append_chunk(tpool, tnew, tp, ts)
    assert out is tpool                             # updated in place
    np.testing.assert_array_equal(as_f32(out)[1:], as_f32(ref)[1:])
    np.testing.assert_array_equal(as_f32(out)[1:], as_f32(pal)[1:])


def test_kv_append_single_token_is_the_c1_slice():
    rng = np.random.default_rng(1)
    P, T, KV, D, B = 8, 4, 2, 16, 3
    new = torch.from_numpy(rng.standard_normal((B, KV, D)).astype(np.float32))
    pids = torch.tensor([7, 0, 3], dtype=torch.int32)
    sids = torch.tensor([2, 0, 3], dtype=torch.int32)
    a = tk.kv_append(torch.zeros(P, T, KV, D), new, pids, sids)
    b = tk.kv_append_chunk(torch.zeros(P, T, KV, D), new[:, None],
                           pids[:, None], sids[:, None])
    c = tk.kv_append_ref(torch.zeros(P, T, KV, D), new, pids, sids)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy(), c.numpy())


# ---------------------------------------------------------------- paged attention

PAGED_CHUNK_CASES = [
    # B, C, H, KV, D, P, T, N, window, softcap, dtype
    (2, 4, 4, 2, 32, 8, 8, 4, None, None, "float32"),
    (3, 8, 8, 2, 64, 16, 16, 8, None, None, "float32"),
    (2, 5, 4, 1, 32, 8, 8, 4, None, None, "float32"),    # MQA, C not pow2
    (2, 4, 4, 2, 32, 8, 8, 4, 16, None, "float32"),      # sliding window
    (2, 4, 4, 2, 32, 8, 8, 4, None, 30.0, "float32"),    # softcap
    (2, 16, 12, 2, 128, 12, 16, 4, None, None, "bfloat16"),  # qwen2 widths
    (2, 1, 12, 2, 128, 12, 16, 4, None, None, "bfloat16"),   # decode slice
]


@pytest.mark.parametrize("B,C,H,KV,D,P,T,N,window,softcap,dtype",
                         PAGED_CHUNK_CASES)
def test_paged_chunk_matches_jax(B, C, H, KV, D, P, T, N, window, softcap,
                                 dtype):
    rng = np.random.default_rng(B * 100 + C)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    pk = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    pv = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    pt = rng.integers(0, P, (B, N)).astype(np.int32)
    lens = rng.integers(0, N * T - C, B).astype(np.int32)
    (jq, tq), (jk, tk_), (jv, tv) = both(q, dtype), both(pk, dtype), \
        both(pv, dtype)
    (jpt, tpt), (jl, tl) = ints(pt), ints(lens)
    ref = jax_paged_chunk_ref(jq, jk, jv, jpt, jl, window=window,
                              softcap=softcap)
    pal = jax_paged_chunk(jq, jk, jv, jpt, jl, window=window,
                          softcap=softcap, impl="interpret")
    out = tk.paged_attention_chunk(tq, tk_, tv, tpt, tl, window=window,
                                   softcap=softcap)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(as_f32(out), as_f32(ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(as_f32(out), as_f32(pal), atol=tol, rtol=tol)


def test_paged_chunk_straddling_page_with_window():
    """A chunk whose queries cross a page boundary, under a window that
    drops whole early pages: the port equals the JAX oracle."""
    rng = np.random.default_rng(7)
    B, C, H, KV, D, P, T, N, window = 2, 6, 4, 2, 32, 12, 4, 6, 5
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    pk = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    pv = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    pt = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 0]], np.int32)
    lens = np.array([9, 14], np.int32)              # 9..14 and 14..19
    (jq, tq), (jk, tk_), (jv, tv) = both(q), both(pk), both(pv)
    (jpt, tpt), (jl, tl) = ints(pt), ints(lens)
    ref = jax_paged_chunk_ref(jq, jk, jv, jpt, jl, window=window)
    out = tk.paged_attention_chunk(tq, tk_, tv, tpt, tl, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


PAGED_DECODE_CASES = [
    # B, H, KV, D, P, T, N, window
    (3, 8, 2, 64, 16, 16, 8, None),
    (2, 4, 4, 32, 8, 8, 4, None),
    (4, 16, 1, 128, 32, 16, 8, None),      # MQA
    (3, 8, 2, 64, 16, 16, 8, 32),          # sliding window
]


@pytest.mark.parametrize("B,H,KV,D,P,T,N,window", PAGED_DECODE_CASES)
def test_paged_decode_matches_jax_and_equals_chunk_c1(B, H, KV, D, P, T, N,
                                                      window):
    """The decode form (lengths = total valid keys) against the JAX oracle
    and the Pallas kernel, and equal to the chunk form at C=1 with
    lengths - 1."""
    rng = np.random.default_rng(H * 10 + D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pk = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    pv = rng.standard_normal((P, T, KV, D)).astype(np.float32)
    pt = rng.integers(0, P, (B, N)).astype(np.int32)
    lens = rng.integers(1, N * T, B).astype(np.int32)
    (jq, tq), (jk, tk_), (jv, tv) = both(q), both(pk), both(pv)
    (jpt, tpt), (jl, tl) = ints(pt), ints(lens)
    ref = jax_paged_ref(jq, jk, jv, jpt, jl, window=window)
    pal = jax_paged_attention(jq, jk, jv, jpt, jl, window=window,
                              impl="interpret")
    out = tk.paged_attention(tq, tk_, tv, tpt, tl, window=window)
    plain = tk.paged_attention_ref(tq, tk_, tv, tpt, tl, window=window)
    chunk = tk.paged_attention_chunk(tq[:, None], tk_, tv, tpt, tl - 1,
                                     window=window)[:, 0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(plain.numpy(), out.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(chunk.numpy(), out.numpy())


def test_paged_chunk_row_without_keys_is_zero_not_nan():
    """A query row that sees no key (window 0) gives 0 after the 1e-20
    clamp, never NaN — the finite NEG_INF contract."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 2, 8)).astype(np.float32))
    pk = torch.from_numpy(rng.standard_normal((4, 4, 1, 8)).astype(np.float32))
    pt = torch.tensor([[1, 2]], dtype=torch.int32)
    out = tk.paged_attention_chunk(q, pk, pk, pt,
                                   torch.tensor([3], dtype=torch.int32),
                                   window=0)
    assert torch.isfinite(out).all() and (out == 0).all()


# ---------------------------------------------------------------- dispatch policy


def test_kernel_on_cpu_tensor_raises_and_ref_counts_no_launch():
    common.reset_launch_counts()
    pool = torch.zeros(4, 4, 1, 8)
    new = torch.ones(1, 2, 1, 8)
    ids = torch.tensor([[1, 1]], dtype=torch.int32)
    slots = torch.tensor([[0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.kv_append_chunk(pool, new, ids, slots, impl="cuda")
    with pytest.raises(ValueError):
        tk.paged_attention_chunk(new, pool, pool, ids,
                                 torch.tensor([0], dtype=torch.int32),
                                 impl="cuda")
    with pytest.raises(ValueError):
        tk.paged_attention_append_chunk(
            new, new, new, pool, pool, ids,
            torch.tensor([0], dtype=torch.int32), ids, slots, impl="cuda")
    with pytest.raises(ValueError):
        tk.kv_append_chunk(pool, new, ids, slots, impl="pallas")
    tk.kv_append_chunk(pool, new, ids, slots)               # CPU -> plain
    tk.kv_append_chunk(pool, new, ids, slots, impl="ref")
    tk.paged_attention_chunk(new, pool, pool, ids,
                             torch.tensor([0], dtype=torch.int32))
    tk.paged_attention_append_chunk(new, new, new, pool, pool, ids,
                                    torch.tensor([0], dtype=torch.int32),
                                    ids, slots)
    assert pool[1, :2].eq(1).all()
    assert common.LAUNCHES == {"kv_append_chunk": 0,
                               "paged_attention_chunk": 0,
                               "paged_attention_append_chunk": 0,
                               "paged_attention_chunk:float32": 0,
                               "paged_attention_append_chunk:float32": 0,
                               "flash_attention": 0,
                               "flash_attention_bwd": 0, "ssd_chunk": 0,
                               "ssd_chunk_bwd": 0}


def test_cuda_device_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA request is valid here")
    with pytest.raises(RuntimeError):
        common.resolve_device("cuda")
    assert common.resolve_device("cpu").type == "cpu"


def test_kernel_sources_carry_their_notes():
    """Each CUDA source names the TPU kernel it replaces, its bound on the
    card and what its design does about it; the build keys on them."""
    for name, tpu in (("kv_append.cu", "kv_append/kernel.py::kv_append_chunk"),
                      ("paged_attention.cu",
                       "paged_attention/kernel.py::"),
                      ("flash_attention.cu",
                       "flash_attention/kernel.py::flash_attention"),
                      ("flash_attention_bwd.cu",
                       "flash_attention/kernel.py::flash_attention"),
                      ("ssd_chunk.cu", "ssd_chunk/kernel.py::ssd_chunk"),
                      ("ssd_chunk_bwd.cu", "ssd_chunk/kernel.py::ssd_chunk")):
        text = (common.CSRC / name).read_text()
        assert tpu in text
        assert "What bounds it on this card" in text
        assert "What the design does about it" in text
    header = (common.CSRC / "mma_bf16.cuh").read_text()
    assert "shared by flash_attention.cu" in header.lower()
    for name in ("flash_attention.cu", "paged_attention.cu"):
        assert '#include "mma_bf16.cuh"' in (common.CSRC / name).read_text()
    # the float32 path's 3xTF32 products and the latent kernel's wgmma
    paged = (common.CSRC / "paged_attention.cu").read_text()
    for header in ("mma_tf32.cuh", "wgmma_bf16.cuh"):
        assert f'#include "{header}"' in paged
    for kernel in ("paged_attention_f32_kernel", "paged_latent_kernel"):
        assert kernel in paged
    # one note each for the bf16 GQA, float32 and latent bodies
    for phrase in ("What bounds it on this card",
                   "What the design does about it"):
        assert paged.count(phrase) >= 3
    assert len(common.source_hash()) == 16


@pytest.mark.parametrize("B,C,H,KV,D,N,T,sms", [
    (8, 16, 12, 2, 128, 64, 16, 132),   # qwen2-1.5b serving: a prefill chunk
    (8, 1, 12, 2, 128, 64, 16, 132),    # ... and a decode step
    (1, 1, 12, 2, 128, 4, 16, 132),     # a table of one 64-key tile
    (64, 16, 12, 2, 128, 64, 16, 132),  # more blocks than SMs
    (2, 16, 16, 1, 128, 8, 16, 132),    # 256 query rows: two row groups
    (1, 1, 8, 1, 64, 2048, 16, 132),    # a long table: capped splits
    (3, 5, 4, 2, 12, 3, 8, 1),          # one SM
    # deepseek-v2-lite's latent (MLA): 16 heads over one KV head of 576,
    # pages of 16 (phase 2's table) and of 8 (the MLA cluster's)
    (8, 16, 16, 1, 576, 64, 16, 132),
    (8, 1, 16, 1, 576, 64, 16, 132),
    (8, 16, 16, 1, 576, 128, 8, 132),
    (8, 1, 16, 1, 576, 128, 8, 132),
])
def test_paged_attention_split_plan(B, C, H, KV, D, N, T, sms):
    """At least one split, no more than the table's pages or 64-key tiles
    (or the kernel's cap), one wave of the kernel's blocks (one per split,
    row group of ``block_rows`` and KV head of a sequence), and a
    workspace of each split's (acc, m, l) per output row, none for one
    split."""
    check_split_plan(B, C, H, KV, D, N, T, sms, f32=False)


@pytest.mark.parametrize("B,C,H,KV,D,N,T,sms", [
    (8, 16, 12, 2, 128, 64, 16, 132),   # qwen2's float32 lanes
    (8, 1, 12, 2, 128, 64, 16, 132),
    (8, 16, 16, 1, 576, 64, 16, 132),   # deepseek's float32 latent
    (8, 1, 16, 1, 576, 64, 16, 132),
    (2, 16, 16, 1, 576, 128, 8, 132),   # the MLA cluster: 2 slots, T=8
    (2, 1, 16, 1, 576, 128, 8, 132),
])
def test_paged_attention_f32_split_plan(B, C, H, KV, D, N, T, sms):
    """The float32 kernel's plan: its blocks own 32 rows above D = 256
    (four column slices of a row tile), 128 up to it; the same rules."""
    check_split_plan(B, C, H, KV, D, N, T, sms, f32=True)


def check_split_plan(B, C, H, KV, D, N, T, sms, f32):
    splits = plan_splits(B, C, H, KV, N, T, sms, D, f32)
    assert 1 <= splits <= min(N, -(-N * T // TILE_KEYS), MAX_SPLITS)
    assert block_rows(D, f32) == (128 if D <= 256 else 32 if f32 else 64)
    groups = -(-C * (H // KV) // block_rows(D, f32))
    assert splits == 1 or B * KV * groups * splits <= sms
    assert workspace_floats(B, C, H, D, 1) == 0
    assert workspace_floats(B, C, H, D, splits) == (
        0 if splits == 1 else B * C * H * splits * (D + 2))


@pytest.mark.parametrize("D", [12, 64, 100, 128, 256])
def test_flash_tma_operands_pad_and_realign(D):
    """The bf16 flash kernel's TMA maps need 16-byte bases and row strides:
    a head dim that is not a multiple of 8 gets zero columns (scores and
    the kept output columns do not move), a base off 16 bytes is copied,
    and operands that need neither come back as the same tensors."""
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((2, 7, 3, D))
                         .astype(np.float32)).bfloat16()
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    aligned = x.data_ptr() % TMA_ALIGN == 0
    for t in (x, shifted):
        (y,) = tma_operands(t)
        assert y.is_contiguous() and y.data_ptr() % TMA_ALIGN == 0
        assert y.shape[-1] == -(-D // 8) * 8
        assert torch.equal(y[..., :D], x)
        assert not y[..., D:].any()
        if D % 8 == 0 and t.data_ptr() % TMA_ALIGN == 0:
            assert y is t
    assert aligned


def test_hopper_helpers_are_the_flash_kernels_alone():
    """wgmma, TMA and mbarrier helpers live in wgmma_bf16.cuh, which the
    flash kernels and the paged file's latent kernel include, and no other
    kernel; the old mma.sync flash path is gone."""
    flash = (common.CSRC / "flash_attention.cu").read_text()
    assert '#include "wgmma_bf16.cuh"' in flash
    assert "flash_tc_kernel" not in flash and "flash_wgmma_kernel" in flash
    for name in ("flash_attention_bwd.cu", "paged_attention.cu"):
        assert '#include "wgmma_bf16.cuh"' in (common.CSRC / name).read_text()
    for name in ("kv_append.cu", "ssd_chunk.cu"):
        assert "wgmma_bf16" not in (common.CSRC / name).read_text()
