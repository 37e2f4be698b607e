"""The schedule of the flash attention backward kernels, mirrored in plain
PyTorch (``repro_torch.kernels.flash_attention.tiled``), against jax.vjp
of the JAX package's dense oracle (``repro.kernels.attention_ref``) and
against the port's plain backward (``blockwise_bwd``): MHA, GQA and MQA;
head dims 32, 64, 128 and 256; ragged lengths (200, 130 x 70, one query
row) that leave short query and key tiles and padded workspace rows; a
window, a softcap, and non-causal attention; in float32 and with bf16
inputs and the kernels' bf16 rounding of P and dS.  The forward's out and
lse come from the port's plain forward.  Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref as jax_attention_ref
from repro_torch.kernels import blockwise_bwd, blockwise_fwd
from repro_torch.kernels.flash_attention.tiled import flash_bwd_tiled

# float32 on every side, summed in other orders (the oracle's dense
# products against the tiles'): atol as a share of the grad's largest
# magnitude, rtol
F32_TOL = (1e-5, 1e-4)
# bf16 inputs: the mirror reads the bf16 out for delta and rounds P and dS
# to bf16 (2^-9 relative each) and the grads once more; the oracle works
# on the same bf16 values in float32
BF16_TOL = (1e-2, 3e-2)

CASES = [
    # B, Sq, Sk, H, KV, D, causal, window, softcap
    (2, 200, 200, 4, 4, 64, True, None, None),       # MHA, ragged S
    (1, 200, 200, 6, 2, 128, True, None, None),      # GQA (the path's group)
    (2, 130, 130, 4, 1, 32, True, None, None),       # MQA
    (1, 150, 150, 2, 1, 256, True, None, None),      # D = 256
    (2, 130, 70, 4, 2, 64, False, None, None),       # Sq 130 x Sk 70
    (1, 300, 300, 4, 2, 64, True, 50, None),         # window
    (1, 200, 200, 4, 2, 32, True, None, 20.0),       # softcap
    (1, 200, 200, 4, 2, 128, False, None, None),     # non-causal
    (1, 150, 150, 2, 2, 32, False, 40, 30.0),        # all three options
    (3, 1, 77, 4, 2, 64, False, None, None),         # one query row
]
IDS = ["mha", "gqa", "mqa", "d256", "ragged130x70", "window", "softcap",
       "noncausal", "window-softcap", "one-row"]


def inputs(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sq, H, D)).astype(np.float32))


def jax_grads(q, k, v, g, causal, window, softcap):
    """jax.vjp of the dense oracle, float32."""
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention_ref(
        q_, k_, v_, causal=causal, window=window, softcap=softcap),
        *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def check(got, want, tol, what):
    atol, rtol = tol
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, name)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, atol=atol * scale, rtol=rtol,
                                   err_msg=f"{what}: {name}")


def tiled(q, k, v, g, causal, window, softcap, **kw):
    kw_opts = dict(causal=causal, window=window, softcap=softcap)
    out, lse = blockwise_fwd(q, k, v, **kw_opts)
    return flash_bwd_tiled(q, k, v, out, lse, g, **kw_opts, **kw)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,softcap", CASES,
                         ids=IDS)
def test_tiled_bwd_matches_jax_vjp_float32(B, Sq, Sk, H, KV, D, causal,
                                           window, softcap):
    arrays = inputs(B, Sq, Sk, H, KV, D, seed=Sq + Sk + D + H)
    want = jax_grads(*arrays, causal, window, softcap)
    got = tiled(*map(torch.from_numpy, arrays), causal, window, softcap)
    assert all(x.dtype == torch.float32 for x in got)
    check([x.numpy() for x in got], want, F32_TOL, "tiled vs jax.vjp")


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,softcap", CASES,
                         ids=IDS)
def test_tiled_bwd_bf16_matches_jax_vjp(B, Sq, Sk, H, KV, D, causal, window,
                                        softcap):
    """bf16 inputs with P and dS rounded to bf16, as the bf16 kernels do,
    against the oracle in float32 on the same bf16 values."""
    arrays = inputs(B, Sq, Sk, H, KV, D, seed=2 * Sq + D + KV)
    tin = [torch.from_numpy(a).bfloat16() for a in arrays]
    want = jax_grads(*(t.float().numpy() for t in tin), causal, window,
                     softcap)
    got = tiled(*tin, causal, window, softcap, round_bf16=True)
    assert all(x.dtype == torch.bfloat16 for x in got)
    check([x.float().numpy() for x in got], want, BF16_TOL,
          "tiled (bf16) vs jax.vjp")


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,softcap", CASES,
                         ids=IDS)
def test_tiled_bwd_matches_plain(B, Sq, Sk, H, KV, D, causal, window,
                                 softcap):
    arrays = inputs(B, Sq, Sk, H, KV, D, seed=3 * Sq + Sk + D)
    q, k, v, g = map(torch.from_numpy, arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = blockwise_fwd(q, k, v, **kw)
    want = blockwise_bwd(q, k, v, out, lse, g, **kw)
    got = flash_bwd_tiled(q, k, v, out, lse, g, **kw)
    check([x.numpy() for x in got], [x.numpy() for x in want], F32_TOL,
          "tiled vs blockwise_bwd")


@pytest.mark.parametrize("kv_tile,q_step,q_tile,k_step", [
    (64, 64, 128, 64),      # D = 256's key tile
    (32, 16, 32, 16),       # many short tiles on both frames
    (64, 32, 64, 32),       # the float32 kernels' tiles, D <= 128
    (32, 32, 32, 32),       # ... and at D = 256
])
def test_tiled_bwd_other_tiles_match_jax_vjp(kv_tile, q_step, q_tile,
                                             k_step):
    """The decomposition does not depend on the tile sizes: other tiles
    give the same grads (a causal window that starts mid-tile, GQA)."""
    arrays = inputs(1, 190, 190, 6, 2, 32, seed=kv_tile + q_step)
    want = jax_grads(*arrays, True, 70, None)
    got = tiled(*map(torch.from_numpy, arrays), True, 70, None,
                kv_tile=kv_tile, q_step=q_step, q_tile=q_tile, k_step=k_step,
                pad=q_tile)
    check([x.numpy() for x in got], want, F32_TOL, "tiled (tiles) vs jax")


def test_tiled_bwd_rows_that_see_no_key_get_zero_grads():
    """A row whose window holds no key (window 0, causal) has lse -1e30
    from the forward and gets zero dq, as the oracle's."""
    arrays = inputs(1, 70, 70, 2, 1, 32, seed=9)
    q, k, v, g = map(torch.from_numpy, arrays)
    got = tiled(q, k, v, g, True, 0, None)
    want = jax_grads(*arrays, True, 0, None)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert not a.abs().max() and not np.abs(b).max()
