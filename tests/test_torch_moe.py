"""The port's MoE channel mixer (``repro_torch.models.layers.moe_apply``)
against the JAX package's, at the SMOKE widths of deepseek-v2-lite-16b
(8 routed experts top-2, one shared expert) and grok-1-314b (4 experts
top-2): in float32 to 1e-5 in the regime where no pick can drop (T*K <=
4E, exact capacity), in one where the capacity rule drops picks and with
tied router logits (the lower expert index first, as in lax.top_k); the
set of kept (token, k) picks equal to the reference's, and pad rows of a
serve step routed like real ones (they take capacity from later tokens).
Inputs and weights come from a seeded numpy rng and go through both
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.layers import moe_apply as jax_moe_apply
from repro_torch.configs import get_config
from repro_torch.models.layers import moe_apply, moe_init, moe_route
from repro_torch.models.spec import tree_map_specs

ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")
# float32: the same products, summed in another order
TOL = 1e-5


def cfg_pair(arch, **kw):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def drop_cfgs(arch):
    """A config pair whose capacity can overflow: at capacity factor 2 an
    expert holds 2TK/E picks, and one expert takes at most T, so E must
    exceed 2K.  grok's SMOKE has 4 experts top-2 (capacity T: nothing can
    drop), so it takes its published 8 experts here."""
    kw = {"n_experts": 8} if arch == "grok-1-314b" else {}
    return cfg_pair(arch, **kw)


def draw(tcfg, rng, B, S, skew=0.0):
    """(params, x, u) as numpy float32; ``skew`` > 0 gives every token a
    shared component along the unit vector u, which the router maps onto
    expert 0, so that expert overflows (u is None without skew)."""
    p = tree_map_specs(
        lambda s: (rng.standard_normal(s.shape)
                   * (s.scale or s.shape[-2] ** -0.5)).astype(np.float32),
        moe_init(tcfg))
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    u = None
    if skew:
        u = rng.standard_normal(tcfg.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 2.0 * u
        p["router"][:, 0] += skew * u
    return p, x, u


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def jax_kept(p, jcfg, x):
    """The reference's kept (token, k) picks, from its own lines
    (``repro/models/layers.py:135-149``): top-k of the float32 router
    logits, the capacity rule and the exclusive running count."""
    E, K = jcfg.n_experts, jcfg.top_k
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    T = xt.shape[0]
    logits = (xt @ jnp.asarray(p["router"])).astype(jnp.float32)
    _, experts = jax.lax.top_k(logits, K)
    capacity = T * K if T * K <= 4 * E else max(1, int(2 * T * K // E))
    flat = experts.reshape(-1)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot,
                              flat[:, None], axis=1)[:, 0]
    return np.asarray(experts), np.asarray(pos < capacity)


def run_both(cfgs, p, x):
    jcfg, tcfg = cfgs
    out_j = np.asarray(jax_moe_apply(to_jax(p), jcfg, jnp.asarray(x)))
    out_t = moe_apply(to_torch(p), tcfg, torch.from_numpy(x)).numpy()
    return out_j, out_t


@pytest.mark.parametrize("regime", ["exact_capacity", "drops", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, regime):
    """fp32 outputs to 1e-5 and the same kept picks; with drops, some
    picks really overflow (and their weight is zero in both)."""
    rng = np.random.default_rng(0)
    cfgs = cfg_pair(arch) if regime == "exact_capacity" else drop_cfgs(arch)
    jcfg, tcfg = cfgs
    E, K = tcfg.n_experts, tcfg.top_k
    if regime == "exact_capacity":       # T*K <= 4E: a decode step's size
        p, x, _ = draw(tcfg, rng, B=2, S=(4 * E) // (2 * K))
    elif regime == "ties":               # experts 0 and 1 tie in every row:
        p, x, _ = draw(tcfg, rng, B=2, S=(4 * E) // (2 * K))
        p["router"][:, 1] = p["router"][:, 0]    # the lower index first
    else:                                # T*K > 4E, expert 0 overflows
        p, x, _ = draw(tcfg, rng, B=2, S=4 * E, skew=8.0)
    T = x.shape[0] * x.shape[1]
    out_j, out_t = run_both(cfgs, p, x)
    np.testing.assert_allclose(out_t, out_j, atol=TOL, rtol=TOL)

    experts_j, keep_j = jax_kept(p, jcfg, x)
    _, experts_t, keep_t, slot, cap = moe_route(
        to_torch(p), tcfg, torch.from_numpy(x).reshape(T, -1))
    np.testing.assert_array_equal(experts_t.numpy(), experts_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    assert int(slot.max()) <= E * cap
    assert (slot.numpy() == E * cap).sum() == (~keep_j).sum()
    if regime == "ties":
        both_picked = (experts_j == 0).any(-1) & (experts_j == 1).any(-1)
        assert both_picked.any()
    if regime != "drops":
        assert T * K <= 4 * E and keep_j.all()
    else:
        assert T * K > 4 * E and 0 < (~keep_j).sum() < T * K


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_rows_are_routed(arch):
    """A serve step's pad rows go through the router like real tokens
    (the reference does not mask them): slot 0's second half stands for
    pad rows, once drawn toward expert 0 like the real rows and once away
    from it.  Toward it, they fill expert 0's capacity before slot 1's
    real rows (token-major order) and push those picks into the overflow
    row; away from it, slot 1's first rows get expert 0.  So the pads'
    values change real rows' outputs, and the port follows the reference
    in both steps."""
    rng = np.random.default_rng(1)
    cfgs = drop_cfgs(arch)
    E = cfgs[1].n_experts
    p, x, u = draw(cfgs[1], rng, B=2, S=4 * E, skew=8.0)
    half = x.shape[1] // 2
    away = x.copy()
    away[0, half:] -= 6.0 * u
    outs = {}
    for name, xs in (("toward", x), ("away", away)):
        out_j, out_t = run_both(cfgs, p, xs)
        np.testing.assert_allclose(out_t, out_j, atol=TOL, rtol=TOL)
        outs[name] = out_t
    diff = np.abs(outs["toward"][1] - outs["away"][1]).max(-1)
    assert diff[:half].max() > 1e-3          # slot 1's real rows moved
