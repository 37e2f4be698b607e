"""The float32 flash forward kernel's schedule (``flash_f32_tc_kernel``:
64-row blocks, 32-key tiles from a multiple of 32, the online softmax in
log2 units and both products in 3xTF32), mirrored in plain PyTorch
(``repro_torch.kernels.flash_attention.tiled.flash_fwd_f32_tiled``), held
against the JAX package's dense oracle (``repro.kernels.attention_ref``)
at the tolerance the kernel is held to on the card (``chip_smoke.py``'s
``FLASH_TOL[torch.float32]`` and ``LSE_ATOL``): phase 1's float32 shape
(S=512, D=64), a ragged S at D=128, a window, a softcap, non-causal with
Sq != Sk, MQA at D=256 and a row that sees no key.  So the 3xTF32 split
of every operand keeps the forward inside its float32 bound before any
run on the card.  The lse reference is the oracle's math in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention.tiled import (flash_fwd_f32_tiled,
                                                       tf32)

# chip_smoke.py: FLASH_TOL[torch.float32] (atol, rtol) and LSE_ATOL
OUT_TOL = (2e-5, 2e-5)
LSE_ATOL = 1e-4

CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, softcap
    (1, 512, 512, 4, 2, 64, True, None, None),        # phase 1's shape
    (1, 300, 300, 6, 2, 128, True, None, None),       # ragged S, D=128
    (1, 300, 300, 4, 2, 128, True, 100, None),        # window
    (1, 256, 256, 4, 2, 64, True, None, 30.0),        # softcap
    (2, 100, 170, 4, 4, 32, False, None, None),       # non-causal, Sq != Sk
    (1, 90, 90, 4, 1, 256, True, 33, 20.0),           # MQA, D=256, both
]
IDS = ["s512-d64", "ragged-d128", "window", "softcap", "noncausal",
       "mqa-d256"]


def lse_ref(q, k, v, causal, window, softcap):
    """Row log-sum-exp of the oracle's scores, in float64: [B, H, Sq]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64) * D ** -0.5, kk)
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = np.where(mask, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,softcap", CASES,
                         ids=IDS)
def test_f32_forward_mirror_matches_jax_oracle(B, Sq, Sk, H, KV, D, causal,
                                               window, softcap):
    rng = np.random.default_rng(Sq + D + H)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), **kw))
    out, lse = flash_fwd_f32_tiled(*map(torch.from_numpy, (q, k, v)), **kw)
    assert out.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(out.numpy(), want, atol=OUT_TOL[0],
                               rtol=OUT_TOL[1])
    np.testing.assert_allclose(lse.numpy(), lse_ref(q, k, v, **kw),
                               atol=LSE_ATOL, rtol=0)


def test_f32_forward_mirror_row_without_keys_is_zero():
    """Window 0 leaves every row without a key: out 0 (the clamped
    denominator), never NaN, and lse -1e30 + log(1e-20), as the bf16
    kernel and the plain forward write it."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 40, 2, 16), (1, 40, 1, 16), (1, 40, 1, 16)))
    out, lse = flash_fwd_f32_tiled(q, k, v, causal=True, window=0)
    assert torch.equal(out, torch.zeros_like(out))
    torch.testing.assert_close(lse, torch.full_like(lse, -1e30))


def test_tf32_split_keeps_ten_mantissa_bits_and_the_rest():
    """big = tf32(x) has its 13 low mantissa bits clear, rounds to nearest
    with ties away from zero, and big + tf32(x - big) is x to 2^-22."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    big = tf32(x)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    small = tf32(x - big)
    assert ((x - big - small).abs() <= x.abs() * 2.0 ** -22).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tf32(tie), torch.tensor([1.0 + 2.0 ** -10,
                                                -(1.0 + 2.0 ** -10)]))
