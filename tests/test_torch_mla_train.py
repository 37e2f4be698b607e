"""MLA training and the MoE's load-balance loss against the JAX package:

  * the flash op (``repro_torch.kernels.attention``) with V narrower than
    Q/K (``Dv < D``, MLA's 128 beside 192): forward and grads against the
    JAX dense oracle (``repro.kernels.attention_ref``, which takes a V
    width of its own) and its ``jax.vjp``, causal and non-causal, windowed,
    softcapped and at a ragged ``Sq != Sk``, on the plain lane and through
    ``tiled.py``'s schedules of the kernels (V, ``out`` and the upstream
    gradient zero-padded to D as the op pads them, ``dv`` sliced back);
  * ``attention.mla_train`` against the reference's on deepseek-v2-lite's
    SMOKE config (Q/K 24 wide, V 16): output and every grad in float32; in
    bf16 each is held to be as accurate as the reference's (at most twice
    the JAX bf16 result's distance from the port's float32 one, plus 2^-8
    of its scale), as tests/test_torch_encdec.py holds its bf16 grads;
  * ``layers.moe_aux_loss`` against the reference's on deepseek's and
    grok's SMOKE configs, with router logits that tie in every row (the
    lower expert first, as ``lax.top_k``), the loss and its router grad.

Tolerances.  float32: the same products summed in other orders, the
output and loss to 2e-5 (tests/test_torch_train.py's ``ATTN_TOL``), grads
to atol 1e-5 of the grad's largest magnitude and rtol 1e-4
(tests/test_torch_flash_bwd.py's ``F32_TOL``).  bf16 inputs: the output
to 2e-2 (one bf16 ulp of O(1) values); grads to atol 1e-2 of the largest
magnitude and rtol 3e-2 (``BF16_TOL``: the schedule rounds P and dS to
bf16 before its products, as the bf16 kernels do).  Inputs come from
numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import attention_ref as jax_attention_ref
from repro.models.attention import mla_train as jax_mla_train
from repro.models.layers import moe_aux_loss as jax_moe_aux_loss
from repro_torch.configs import get_config
from repro_torch.kernels import attention, blockwise_fwd
from repro_torch.kernels.flash_attention.ops import pad_v
from repro_torch.kernels.flash_attention.tiled import (flash_bwd_tiled,
                                                       flash_fwd_f32_tiled)
from repro_torch.models.attention import gqa_train, mla_init, mla_train
from repro_torch.models.layers import moe_aux_loss, moe_init
from repro_torch.models.spec import tree_map_specs

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
OUT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 3e-2)}
DS = "deepseek-v2-lite-16b"


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def check_grads(got, want, tol, what):
    atol, rtol = tol
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = f32(a), f32(b)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, atol=atol * scale, rtol=rtol,
                                   err_msg=f"{what}: {name}")


# ---------------------------------------------------------------- the op at Dv < D

CASES = [
    # B, Sq, Sk, H, KV, D, Dv, causal, window, softcap, dtype
    (2, 64, 64, 4, 4, 24, 16, True, None, None, "float32"),   # deepseek SMOKE
    (1, 200, 200, 2, 2, 192, 128, True, None, None, "float32"),  # full MLA
    (1, 96, 96, 4, 2, 48, 32, True, None, 20.0, "float32"),   # softcap, GQA
    (2, 40, 72, 4, 4, 24, 16, False, None, None, "float32"),  # Sq < Sk
    (1, 130, 70, 2, 1, 64, 40, False, None, None, "float32"),  # Sq > Sk, MQA
    (1, 150, 150, 4, 2, 32, 16, True, 40, None, "float32"),   # window
    (1, 200, 200, 2, 2, 192, 128, True, None, None, "bfloat16"),
    (2, 40, 72, 4, 4, 24, 16, False, None, 30.0, "bfloat16"),
]
IDS = ["smoke", "mla192", "softcap", "sq40-sk72", "sq130-sk70", "window",
       "mla192-bf16", "cross-softcap-bf16"]


def draw(case, seed):
    B, Sq, Sk, H, KV, D, Dv, *_, dtype = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv), (B, Sq, H, Dv))]
    td = DT[dtype][1]
    tin = [torch.from_numpy(a).to(td) for a in arrays]
    # the oracle works in float32 on the values the port sees
    return [f32(t) for t in tin], tin


def jax_out_and_grads(arrays, causal, window, softcap):
    q, k, v, g = map(jnp.asarray, arrays)
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_attention_ref(
        q_, k_, v_, causal=causal, window=window, softcap=softcap), q, k, v)
    return np.asarray(out), [np.asarray(x) for x in vjp(g)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_attention_with_narrow_v_matches_jax(case):
    """The op's plain lane (autograd through ``blockwise_fwd`` /
    ``blockwise_bwd`` on the padded V): out [B, Sq, H, Dv] and dq, dk, dv
    against the oracle and its vjp."""
    *_, causal, window, softcap, dtype = case
    arrays, (q, k, v, g) = draw(case, seed=sum(case[:7]))
    want_out, want = jax_out_and_grads(arrays, causal, window, softcap)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention(*ts, causal=causal, window=window, softcap=softcap)
    assert out.shape == g.shape and out.dtype == q.dtype
    tol = OUT_TOL[dtype]
    np.testing.assert_allclose(f32(out), want_out, atol=tol, rtol=tol)
    got = torch.autograd.grad(out, ts, g)
    assert [x.shape for x in got] == [x.shape for x in (q, k, v)]
    check_grads(got, want, GRAD_TOL[dtype], "plain lane")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiled_schedules_with_padded_v_match_jax(case):
    """The kernels' schedules (``tiled.py``) on V, out and dO zero-padded
    to D as ``ops.attention`` pads them: the backward's grads with dv
    sliced to Dv and, in float32, the 3xTF32 forward's output sliced."""
    *_, causal, window, softcap, dtype = case
    Dv = case[6]
    arrays, (q, k, v, g) = draw(case, seed=2 * sum(case[:7]))
    want_out, want = jax_out_and_grads(arrays, causal, window, softcap)
    kw = dict(causal=causal, window=window, softcap=softcap)
    vp, gp = pad_v(q, v, g)
    assert vp.shape[-1] == q.shape[-1] and not vp[..., Dv:].any()
    if dtype == "float32":
        out, _ = flash_fwd_f32_tiled(q, k, vp, **kw)
        assert not out[..., Dv:].any()
        np.testing.assert_allclose(f32(out[..., :Dv]), want_out, atol=2e-5,
                                   rtol=2e-5)
    out, lse = blockwise_fwd(q, k, vp, **kw)
    dq, dk, dv = flash_bwd_tiled(q, k, vp, out, lse, gp,
                                 round_bf16=dtype == "bfloat16", **kw)
    assert not dv[..., Dv:].any()          # zero dO columns: zero dv there
    check_grads((dq, dk, dv[..., :Dv]), want, GRAD_TOL[dtype], "tiled")


def test_v_wider_than_qk_raises():
    q, k = torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="wider"):
        attention(q, k, torch.zeros(1, 8, 2, 24))


# ---------------------------------------------------------------- mla_train


def mla_cfgs(dtype):
    jd, td = DT[dtype]
    return (dataclasses.replace(jax_get_config(DS, smoke=True), dtype=jd),
            dataclasses.replace(get_config(DS, smoke=True), dtype=td))


def mla_draw(tcfg, seed, B=2, S=40):
    rng = np.random.default_rng(seed)
    p = tree_map_specs(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0]))
        .astype(np.float32), mla_init(tcfg))
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    r = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    return p, x, pos, r


def jax_mla(jcfg, p, x, pos, r):
    """Output and the grads of sum(out * r) w.r.t. x and every parameter."""
    jd = jcfg.dtype
    out, vjp = jax.vjp(lambda p_, x_: jax_mla_train(
        p_, jcfg, x_, jnp.asarray(pos)), jax.tree.map(jnp.asarray, p),
        jnp.asarray(x, jd))
    dp, dx = vjp(jnp.asarray(r, jd))
    return f32(out), {k: f32(v) for k, v in dp.items()}, f32(dx)


def torch_mla(tcfg, p, x, pos, r):
    td = tcfg.dtype
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).to(td).requires_grad_()
    out = mla_train(tp, tcfg, tx, torch.from_numpy(pos))
    keys = list(tp)
    grads = torch.autograd.grad(out, [tp[k] for k in keys] + [tx],
                                torch.from_numpy(r).to(td))
    return f32(out), {k: f32(g) for k, g in zip(keys, grads)}, f32(grads[-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_mla_train_matches_jax_float32(seed):
    jcfg, tcfg = mla_cfgs("float32")
    assert tcfg.qk_nope_dim + tcfg.qk_rope_dim > tcfg.v_head_dim
    args = mla_draw(tcfg, seed)
    (jo, jp, jx), (to, tp, tx) = jax_mla(jcfg, *args), torch_mla(tcfg, *args)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=1e-4)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-5 * np.abs(
            jp[k]).max(), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(tx, jx, atol=1e-5 * np.abs(jx).max(),
                               rtol=1e-4)


def test_mla_train_bf16_is_as_accurate_as_jax():
    """bf16: the port's output and grads no farther from the port's float32
    result than twice the reference's bf16 ones, plus 2^-8 of the scale."""
    jcfg, tcfg = mla_cfgs("bfloat16")
    _, tcfg32 = mla_cfgs("float32")
    args = mla_draw(tcfg, 3)
    jo, jp, jx = jax_mla(jcfg, *args)
    to, tp, tx = torch_mla(tcfg, *args)
    truth_o, truth_p, truth_x = torch_mla(tcfg32, *args)
    pairs = [("out", to, jo, truth_o), ("dx", tx, jx, truth_x)] + [
        (k, tp[k], jp[k], truth_p[k]) for k in jp]
    for what, a, b, t in pairs:
        scale = np.abs(t).max()
        port_err, jax_err = np.abs(a - t).max(), np.abs(b - t).max()
        assert port_err <= 2 * jax_err + 2.0 ** -8 * scale, (
            what, port_err, jax_err)


def test_gqa_train_refuses_an_mla_config():
    _, tcfg = mla_cfgs("float32")
    with pytest.raises(ValueError, match="mla_train"):
        gqa_train({}, tcfg, torch.zeros(1, 4, tcfg.d_model),
                  torch.zeros(1, 4, dtype=torch.int32))


# ---------------------------------------------------------------- moe_aux_loss


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("arch", [DS, "grok-1-314b"])
def test_moe_aux_loss_matches_jax(arch, ties):
    """float32 loss to 1e-6 relative and its router grad to 1e-5; with
    ``ties`` experts 0 and 1 have equal router columns, so every row's
    logits tie and the pick goes to the lower expert in both packages."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32)
    rng = np.random.default_rng(7)
    p = tree_map_specs(
        lambda s: (rng.standard_normal(s.shape)
                   * (s.scale or s.shape[-2] ** -0.5)).astype(np.float32),
        moe_init(tcfg))
    p["router"] *= 20.0          # spread the routes over the experts
    if ties:
        p["router"][:, 1] = p["router"][:, 0]
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda r: jax_moe_aux_loss(
        {**jax.tree.map(jnp.asarray, p), "router": r}, jcfg,
        jnp.asarray(x)))(jnp.asarray(p["router"]))
    tp = {k: v for k, v in p.items() if k != "router"}
    router = torch.from_numpy(p["router"]).requires_grad_()
    tl = moe_aux_loss({**tp, "router": router}, tcfg, torch.from_numpy(x))
    (tg,) = torch.autograd.grad(tl, router)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(f32(tg), f32(jg),
                               atol=1e-5 * np.abs(f32(jg)).max(), rtol=1e-5)
    assert float(tl.detach()) > 0
