"""The schedule of the ssd_chunk backward kernel, mirrored in plain PyTorch
(``repro_torch.kernels.ssd_chunk.tiled``), against jax.vjp of the JAX
oracle and against the port's written-out backward, at ragged shapes: L
of 100 and 256 (one short query / key tile, and several), head counts
that are not a multiple of the head group, P of 5 and 64 (one column
tile, and two), N of 7 and 128; and chunks whose key tiles are seen by
more query tiles than a block keeps scores for at once (L of 512 and 600
in windows of 4 tiles of 64, L = 100 in windows of 2 tiles of 16).
Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_chunk_ref as jax_ssd_chunk_ref
from repro_torch.kernels import ssd_chunk_bwd_plain, ssd_chunk_bwd_tiled

NAMES = ("x", "dt", "dA_cs", "Bm", "Cm")
# float32 on every side, summed in other orders: tests/test_torch_ssm.py's
# bound for the written-out backward against jax.vjp, with atol taken as a
# share of the grad's largest magnitude (as chip_smoke.py's SSD_GRAD_TOL):
# at N = 128 and L = 256 the grads reach ~2e3, against O(10) there
ATOL, RTOL = 1e-5, 1e-4

CASES = [
    # B', L, H, P, N, head_group, p_tile
    (2, 100, 6, 5, 7, 4, 64),       # ragged L, H = 4 + 2, P = 5, N = 7
    (1, 256, 10, 64, 128, 8, 64),   # the path's L, P, N; H = 8 + 2
    (2, 100, 6, 64, 128, 8, 64),    # one group of 6 heads
    (1, 256, 3, 5, 7, 2, 4),        # P = 5 in two column tiles
    (2, 100, 5, 64, 7, 4, 32),      # two column tiles of P = 64
]

# B', L, H, P, N, head_group, p_tile, tile, window: more query tiles than a
# window, so the kernel carries dx, ddt and Q's column sums across windows
WINDOW_CASES = [
    (1, 512, 3, 64, 128, 2, 64, 64, 4),   # L = 512: two windows of 256
    (1, 600, 3, 5, 7, 2, 64, 64, 4),      # 10 tiles, the last one short
    (2, 100, 5, 5, 7, 4, 4, 16, 2),       # 7 tiles of 16 in windows of 2
]


def inputs(B, L, H, P, N, seed):
    """tests/test_kernels.py's inputs (dt = 0.1 |n|, A = -0.5 |n|, cs =
    cumsum(dt * A)) and an upstream gradient, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, L, H))) * 0.1).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)) * 0.5
    cs = np.cumsum(dt * A, axis=1).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    return (x, dt, cs, Bm, Cm), dy


def check(got, want, what):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, name)
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, atol=ATOL * scale, rtol=RTOL,
                                   err_msg=f"{what}: d{name}")


@pytest.mark.parametrize("B,L,H,P,N,group,p_tile", CASES)
def test_tiled_bwd_matches_jax_vjp(B, L, H, P, N, group, p_tile):
    arrays, dy = inputs(B, L, H, P, N, seed=L + H + P)
    _, vjp = jax.vjp(jax_ssd_chunk_ref, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    got = ssd_chunk_bwd_tiled(*map(torch.from_numpy, arrays),
                              torch.from_numpy(dy), head_group=group,
                              p_tile=p_tile)
    check([g.numpy() for g in got], want, "tiled vs jax.vjp")


@pytest.mark.parametrize("B,L,H,P,N,group,p_tile", CASES)
def test_tiled_bwd_matches_plain(B, L, H, P, N, group, p_tile):
    arrays, dy = inputs(B, L, H, P, N, seed=2 * L + N)
    tin = [torch.from_numpy(a) for a in arrays]
    got = ssd_chunk_bwd_tiled(*tin, torch.from_numpy(dy), head_group=group,
                              p_tile=p_tile)
    want = ssd_chunk_bwd_plain(*tin, torch.from_numpy(dy))
    check([g.numpy() for g in got], [w.numpy() for w in want],
          "tiled vs plain")


@pytest.mark.parametrize("B,L,H,P,N,group,p_tile,tile,window",
                         WINDOW_CASES)
def test_tiled_bwd_windows_match_jax_vjp(B, L, H, P, N, group, p_tile, tile,
                                         window):
    arrays, dy = inputs(B, L, H, P, N, seed=L + tile)
    _, vjp = jax.vjp(jax_ssd_chunk_ref, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    got = ssd_chunk_bwd_tiled(*map(torch.from_numpy, arrays),
                              torch.from_numpy(dy), head_group=group,
                              p_tile=p_tile, tile=tile, window=window)
    check([g.numpy() for g in got], want, "tiled (windows) vs jax.vjp")


@pytest.mark.parametrize("B,L,H,P,N,group,p_tile,tile,window",
                         WINDOW_CASES)
def test_tiled_bwd_windows_match_plain(B, L, H, P, N, group, p_tile, tile,
                                       window):
    arrays, dy = inputs(B, L, H, P, N, seed=2 * L + window)
    tin = [torch.from_numpy(a) for a in arrays]
    got = ssd_chunk_bwd_tiled(*tin, torch.from_numpy(dy), head_group=group,
                              p_tile=p_tile, tile=tile, window=window)
    want = ssd_chunk_bwd_plain(*tin, torch.from_numpy(dy))
    check([g.numpy() for g in got], [w.numpy() for w in want],
          "tiled (windows) vs plain")


def test_tiled_bwd_returns_each_input_dtype():
    arrays, dy = inputs(1, 40, 3, 8, 8, seed=5)
    tin = [torch.from_numpy(a) for a in arrays]
    for k in (0, 3, 4):                     # x, Bm, Cm in bf16
        tin[k] = tin[k].bfloat16()
    got = ssd_chunk_bwd_tiled(*tin, torch.from_numpy(dy).bfloat16(),
                              head_group=2)
    want = ssd_chunk_bwd_plain(*tin, torch.from_numpy(dy).bfloat16())
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                   rtol=2e-2)
