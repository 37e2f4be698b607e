"""The port's Mamba2 slice against the JAX package: the plain ssd_chunk
against the JAX oracle and the Pallas kernel in interpret mode, its written
out backward against jax.vjp, the kernel-form mamba2_train against the
reference's inline form, the loss and every grad of mamba2 SMOKE, the
serve step with idle slots and partial chunks, greedy engine streams with
a reused slot, and the serving cast.  Inputs come from numpy seeds;
weights are the JAX package's, carried across with repro_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ssd_chunk as jax_ssd_chunk
from repro.kernels import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.ssm import mamba2_init as jax_mamba2_init
from repro.models.ssm import mamba2_train as jax_mamba2_train
from repro.serve import ServingEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs import mamba2_1_3b as port_mamba2
from repro_torch.kernels import (ssd_chunk, ssd_chunk_bwd_plain,
                                 ssd_chunk_ref)
from repro_torch.models import build_model
from repro_torch.models.ssm import mamba2_train
from repro_torch.serve import ServingEngine
from repro_torch.train import make_loss_and_grad
from repro_torch.train.optimizer import leaves

# fp32 on both sides: the same arithmetic summed in another order
FP32_TOL = 2e-5


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def ssd_inputs(B, L, H, P, N, dtype, seed=1):
    """tests/test_kernels.py's inputs: dt = 0.1 |n|, A = -0.5 |n|,
    cs = cumsum(dt * A) along the chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((B, L, H))) * 0.1).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)) * 0.5
    cs = np.cumsum(dt * A, axis=1).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jax_in = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(cs),
              jnp.asarray(Bm, jd), jnp.asarray(Cm, jd))
    # the port gets the very values JAX holds (bf16 rounded once, there)
    torch_in = tuple(torch.from_numpy(np.array(a, np.float32)).to(t)
                     for a, t in zip(jax_in, (td, torch.float32,
                                              torch.float32, td, td)))
    return jax_in, torch_in


# ---------------------------------------------------------------- (a) forward

SSD_CASES = [   # tests/test_kernels.py:306-310, plus ragged L with H=6
    (2, 32, 8, 16, 16, 4, "float32"),
    (1, 64, 4, 32, 8, 4, "float32"),
    (2, 16, 2, 8, 4, 2, "bfloat16"),
    (1, 100, 6, 16, 8, 2, "float32"),
]


@pytest.mark.parametrize("B,L,H,P,N,ht,dtype", SSD_CASES)
def test_ssd_chunk_ref_matches_jax_oracle_and_interpret_kernel(
        B, L, H, P, N, ht, dtype):
    """fp32: 2e-5 (summation order).  bf16: both return bf16 rounded from
    float32 sums that agree to ~1e-6, so they differ by at most one bf16
    ulp (2^-7 relative at the bottom of a binade: rtol 1.6e-2)."""
    jin, tin = ssd_inputs(B, L, H, P, N, dtype)
    out = ssd_chunk_ref(*tin)
    assert out.dtype == tin[0].dtype and out.shape == tin[0].shape
    tol = dict(atol=FP32_TOL, rtol=FP32_TOL) if dtype == "float32" \
        else dict(atol=4e-3, rtol=1.6e-2)
    for ref in (jax_ssd_chunk_ref(*jin),
                jax_ssd_chunk(*jin, impl="interpret", h_tile=ht)):
        np.testing.assert_allclose(f32(out), f32(ref), **tol)
    # the op (autograd Function) on a CPU tensor is the plain version
    torch.testing.assert_close(ssd_chunk(*tin), out, rtol=0, atol=0)


def test_ssd_chunk_rejects_the_kernel_on_cpu_tensors():
    _, tin = ssd_inputs(1, 8, 2, 4, 4, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk(*tin, impl="cuda")


# ---------------------------------------------------------------- (b) backward


@pytest.mark.parametrize("B,L,H,P,N", [(2, 32, 8, 16, 16), (1, 100, 6, 16, 8),
                                       (3, 17, 3, 5, 7)])
def test_ssd_chunk_bwd_plain_matches_jax_vjp(B, L, H, P, N):
    """All five input grads against jax.vjp of the JAX oracle, and the
    Function's backward against torch.autograd through the plain forward
    (fp32, summation order: 1e-4 relative, 1e-5 absolute)."""
    jin, tin = ssd_inputs(B, L, H, P, N, "float32", seed=B + L)
    dy = np.random.default_rng(7).standard_normal((B, L, H, P)) \
        .astype(np.float32)
    _, vjp = jax.vjp(jax_ssd_chunk_ref, *jin)
    jgrads = vjp(jnp.asarray(dy))
    tgrads = ssd_chunk_bwd_plain(*tin, torch.from_numpy(dy))
    for name, a, b in zip(("x", "dt", "dA_cs", "Bm", "Cm"), tgrads, jgrads):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(f32(a), f32(b), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    req = [t.clone().requires_grad_() for t in tin]
    auto = torch.autograd.grad(ssd_chunk_ref(*req), req, torch.from_numpy(dy))
    req = [t.clone().requires_grad_() for t in tin]
    fn = torch.autograd.grad(ssd_chunk(*req), req, torch.from_numpy(dy))
    for a, b, c in zip(fn, tgrads, auto):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------- (c) mamba2_train


def cfg_pair(**kw):
    jcfg = dataclasses.replace(jax_get_config("mamba2-1.3b", smoke=True),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def randomize(tree, rng):
    """The JAX init leaves A_log, dt_bias and conv_b at 0 and D_skip at 1;
    draw them, so every parameter's path is exercised."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.uniform(-1.0, 1.0, np.shape(v)).astype(np.float32)
                        if k in ("A_log", "dt_bias", "conv_b", "D_skip")
                        else walk(v)) for k, v in node.items()}
        return np.asarray(node)
    return walk(tree)


@pytest.fixture(scope="module")
def model_params():
    """(jax params, numpy params) of mamba2 SMOKE, randomized as above."""
    jcfg, _ = cfg_pair()
    api = jax_build_model(jcfg)
    np_params = randomize(jax_init_params(api.init_specs(),
                                          jax.random.PRNGKey(0)),
                          np.random.default_rng(3))
    return jax.tree.map(jnp.asarray, np_params), np_params


@pytest.mark.parametrize("chunks", [1, 4])
def test_mamba2_train_kernel_form_matches_reference_inline_form(chunks):
    """The port's intra-chunk term goes through ssd_chunk, the
    reference's is inline einsums; the two agree at fp32 (S = chunk has
    no inter-chunk term, S = 4 chunks runs the recurrence)."""
    jcfg, tcfg = cfg_pair()
    rng = np.random.default_rng(chunks)
    np_p = randomize(jax.tree.map(np.asarray, jax_init_params(
        jax_mamba2_init(jcfg), jax.random.PRNGKey(1))), rng)
    S = chunks * jcfg.ssm_chunk
    u = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jout = jax_mamba2_train(jax.tree.map(jnp.asarray, np_p), jcfg,
                            jnp.asarray(u))
    tout = mamba2_train(convert.params_from_numpy(np_p, device="cpu"), tcfg,
                        torch.from_numpy(u))
    np.testing.assert_allclose(f32(tout), f32(jout), atol=FP32_TOL,
                               rtol=FP32_TOL)


# ---------------------------------------------------------------- (d) loss and grads


@pytest.mark.parametrize("S", [32, 64])
def test_mamba2_loss_and_every_grad_match_jax(model_params, S):
    """fp32: loss at rtol 1e-5, every grad leaf (A_log, D_skip and dt_bias
    through the ssd_chunk backward included) at rtol 1e-4 / atol 1e-6."""
    jparams, np_params = model_params
    jcfg, tcfg = cfg_pair()
    rng = np.random.default_rng(S)
    tok = rng.integers(0, jcfg.vocab, (2, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    jl, jg = jax.value_and_grad(jax_build_model(jcfg).loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = make_loss_and_grad(build_model(tcfg), 1)(
        convert.params_from_numpy(np_params, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tflat = [f32(g) for g in leaves(tg)]
    jflat = [np.asarray(g, np.float32) for g in jax.tree.leaves(jg)]
    assert len(tflat) == len(jflat) == 11
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- (e) serve step


def test_mamba2_serve_step_matches_jax_with_idle_slots_and_partial_chunks(
        model_params):
    """Three chunked steps (C=8: full, partial and idle slots; then a C=1
    decode with an idle slot): the valid logits and both state leaves
    (conv, ssd) after every step, at fp32."""
    jparams, np_params = model_params
    jcfg, tcfg = cfg_pair()
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    tparams = convert.params_from_numpy(np_params, device="cpu")
    B, max_seq, T = 3, 64, 8
    jc = japi.init_caches(B, max_seq, T)
    tc = tapi.init_caches(B, max_seq, T, device="cpu")
    assert set(tc["group"]["b0_ssm"]) == {"conv", "ssd"}
    rng = np.random.default_rng(5)
    for C, n_new in ((8, [8, 5, 0]), (8, [3, 8, 0]), (1, [1, 0, 1])):
        tok = rng.integers(1, jcfg.vocab, (B, C)).astype(np.int32)
        n = np.asarray(n_new, np.int32)
        jl, jc = japi.serve_step(jparams, jnp.asarray(tok), jc,
                                 jnp.asarray(n))
        tl, tc = tapi.serve_step(tparams, torch.from_numpy(tok), tc,
                                 torch.from_numpy(n))
        for b, k in enumerate(n_new):
            np.testing.assert_allclose(f32(tl[b, :k]), f32(jl[b, :k]),
                                       atol=1e-4, rtol=1e-4)
        for key in ("conv", "ssd"):
            np.testing.assert_allclose(f32(tc["group"]["b0_ssm"][key]),
                                       f32(jc["group"]["b0_ssm"][key]),
                                       atol=1e-5, rtol=1e-4, err_msg=key)
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))


# ---------------------------------------------------------------- (f) engine


@pytest.mark.parametrize("chunk", [1, 8])
def test_mamba2_engine_streams_reference_tokens_with_slot_reuse(
        model_params, chunk):
    """Two slots, four requests: the third and fourth are admitted to
    slots a finished request left, so their streams are right only if
    admission zeroes the slot's state, as the reference does."""
    jparams, np_params = model_params
    jcfg, tcfg = cfg_pair()
    kw = dict(max_batch=2, max_seq=64, page_tokens=8, chunk_tokens=chunk)
    jeng = JaxEngine(jax_build_model(jcfg), jparams, prefix_cache=None, **kw)
    teng = ServingEngine(build_model(tcfg),
                         convert.params_from_numpy(np_params, device="cpu"),
                         device="cpu", **kw)
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [3, 4, 5],
               [40, 41, 42, 43, 44, 45, 46, 47, 48], [9, 8, 7, 6, 5]]
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, n) for p, n in zip(prompts, (4, 7, 6, 5))]
        eng.run_until_done()
        assert all(r.done and not r.truncated for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert [len(o) for o in outs[1]] == [4, 7, 6, 5]


# ---------------------------------------------------------------- (g) serving cast


def test_cast_params_keeps_the_float32_leaves_of_mamba2(model_params):
    """A_log, D_skip, dt_bias and the norms stay float32 bit for bit (the
    model reads them in float32); every other leaf is cast to bf16."""
    _, np_params = model_params
    cfg = get_config("mamba2-1.3b", smoke=True)
    params = convert.params_from_numpy(np_params, device="cpu")
    cast = convert.cast_params(params, cfg)
    ssm, orig = cast["group"]["b0_ssm"]["ssm"], params["group"]["b0_ssm"]["ssm"]
    for key in ("A_log", "D_skip", "dt_bias", "norm_w"):
        assert ssm[key].dtype == torch.float32
        assert torch.equal(ssm[key], orig[key])
    assert cast["group"]["b0_ssm"]["norm1"]["w"].dtype == torch.float32
    assert cast["final_norm"]["w"].dtype == torch.float32
    for key in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert ssm[key].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_mamba2_config_fields_equal_reference(which):
    import repro.configs.mamba2_1_3b as ref_mod
    ref, port = getattr(ref_mod, which), getattr(port_mamba2, which)
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert jnp.dtype(v).name == str(getattr(port, f.name)).split(".")[-1]
        else:
            assert getattr(port, f.name) == v, f.name
    assert get_config("mamba2-1.3b", smoke=which == "SMOKE") is port
