"""The port's RG-LRU, the hybrid layer tail (recurrentgemma-9b) and the VLM
prefix (internvl2-1b) against the JAX package, at SMOKE width: the RG-LRU's
training scan, single-token decode and masked chunked serve step; the scan
at S=4096 where every ``a_t`` is tiny; recurrentgemma's whole serve step
(logits and every cache leaf, the tail's state included) in the four
``STEP_CASES`` of tests/test_torch_model.py, float32 and bf16; both
architectures' logits, loss and every grad against ``jax.grad``
(internvl2 with its patch embeddings); and the serving cast of
``a_param``.  Weights are the JAX package's (``repro.models.init_params``)
carried across with repro_torch.convert; the leaves the JAX init sets to
constants (``a_param``, the biases) are redrawn, so every path is
exercised.

Tolerances.  The RG-LRU functions: 1e-5 (atol and rtol) in float32, where
the port's doubling scan and ``jax.lax.associative_scan`` sum the same
products over other trees, and 2e-2 in bf16 (XLA and torch round the bf16
products at other places).  The serve step and the forward: as
tests/test_torch_model.py, 1e-4 in float32 and 2e-2 in bf16 on the
logits; each cache leaf to the same tol times max(1, max |leaf|), but
the bf16 recurrent state, which is held to be as accurate as the
reference's against a float32 step (the test's docstring says why).  Loss
rtol 1e-5 and every grad leaf rtol 1e-4 / atol 1e-6 in float32, as
tests/test_torch_ssm.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params, ssm
from repro_torch.models.lm import lm_logits
from repro_torch.models.spec import FLOAT32_KEYS
from repro_torch.train import make_loss_and_grad
from repro_torch.train.optimizer import leaves

RG = "recurrentgemma-9b"
VLM = "internvl2-1b"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RGLRU_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# redrawn in U(-1, 1): the JAX init leaves them at 0 (biases) or 1
REDRAWN = ("a_param", "b_i", "b_r", "conv_b")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def cfg_pair(arch, dtype="float32", **kw):
    jd, td = DT[dtype]
    return (dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jd,
                                **kw),
            dataclasses.replace(get_config(arch, smoke=True), dtype=td,
                                **kw))


def randomize(tree, rng):
    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.uniform(-1.0, 1.0, np.shape(v)).astype(np.float32)
                        if k in REDRAWN else walk(v))
                    for k, v in node.items()}
        return np.asarray(node)
    return walk(tree)


def np_params(jcfg, seed=0):
    api = jax_build_model(jcfg)
    return randomize(jax.tree.map(np.asarray, jax_init_params(
        api.init_specs(), jax.random.PRNGKey(seed))),
        np.random.default_rng(seed + 3))


def close(got, want, tol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err, tol)


# ---------------------------------------------------------------- the RG-LRU


def rglru_pair(dtype, seed=1, a_param=None):
    jcfg, tcfg = cfg_pair(RG, dtype)
    rng = np.random.default_rng(seed)
    p = randomize(jax.tree.map(np.asarray, jax_init_params(
        jax_ssm.rglru_init(jcfg), jax.random.PRNGKey(seed))), rng)
    if a_param is not None:
        p["a_param"] = a_param(rng, p["a_param"].shape)
    return jcfg, tcfg, p, rng


def jax_rglru_train(jcfg):
    return jax.jit(lambda p, u: jax_ssm.rglru_train(p, jcfg, u))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_train_matches_jax(dtype):
    jcfg, tcfg, p, rng = rglru_pair(dtype)
    u = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    want = jax_rglru_train(jcfg)(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(u, jcfg.dtype))
    got = ssm.rglru_train(convert.params_from_numpy(p, device="cpu"), tcfg,
                          torch.from_numpy(u).to(tcfg.dtype))
    assert got.dtype == tcfg.dtype
    tol = RGLRU_TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


def random_state(jcfg, rng, B):
    L = jcfg.lru_width
    return {"conv": np.asarray(jnp.asarray(
                rng.standard_normal((B, 3, L)).astype(np.float32),
                jcfg.dtype)),
            "h": rng.standard_normal((B, L)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_and_masked_serve_match_jax(dtype):
    """One C=8 chunk with n_new 0, 3 and 8 (an idle slot, a partial chunk
    and a full one) from a random state, then a C=1 decode step: the
    valid outputs and both state leaves (conv in cfg.dtype, h float32)."""
    jcfg, tcfg, p, rng = rglru_pair(dtype, seed=2)
    tol = RGLRU_TOL[dtype]
    jp = jax.tree.map(jnp.asarray, p)
    tp = convert.params_from_numpy(p, device="cpu")
    st = random_state(jcfg, rng, 3)
    jst = jax.tree.map(jnp.asarray, st)
    tst = convert.caches_from_numpy(st, device="cpu")
    n_new = [0, 3, 8]
    u = rng.standard_normal((3, 8, jcfg.d_model)).astype(np.float32)
    jo, jst = jax_ssm.rglru_serve(jp, jcfg, jnp.asarray(u, jcfg.dtype), jst,
                                  jnp.asarray(n_new, jnp.int32))
    to, tst = ssm.rglru_serve(tp, tcfg, torch.from_numpy(u).to(tcfg.dtype),
                              tst, torch.tensor(n_new, dtype=torch.int32))
    for b, k in enumerate(n_new):
        np.testing.assert_allclose(f32(to[b, :k]), f32(jo[b, :k]), atol=tol,
                                   rtol=tol)
    assert tst["conv"].dtype == tcfg.dtype and tst["h"].dtype == torch.float32
    # the idle slot's state is the state it came in with, bit for bit
    np.testing.assert_array_equal(f32(tst["h"][0]), st["h"][0])
    for key in ("conv", "h"):
        np.testing.assert_allclose(f32(tst[key]), f32(jst[key]), atol=tol,
                                   rtol=tol, err_msg=key)
    u1 = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    jo, jst = jax_ssm.rglru_decode(jp, jcfg, jnp.asarray(u1, jcfg.dtype), jst)
    to, tst = ssm.rglru_decode(tp, tcfg, torch.from_numpy(u1).to(tcfg.dtype),
                               tst)
    np.testing.assert_allclose(f32(to), f32(jo), atol=tol, rtol=tol)
    for key in ("conv", "h"):
        np.testing.assert_allclose(f32(tst[key]), f32(jst[key]), atol=tol,
                                   rtol=tol, err_msg=key)


def test_rglru_train_at_4096_with_tiny_decays_stays_finite():
    """a_param in [4, 6]: a_t = exp(-8 softplus(a_param) r_t) lies between
    ~1e-21 and ~0.4, so the running product of a_t underflows to 0 within
    a few dozen positions and a scan that divided by it would overflow;
    the doubling scan stays finite and agrees with the reference at
    float32's tolerance."""
    jcfg, tcfg, p, rng = rglru_pair(
        "float32", seed=4,
        a_param=lambda r, s: r.uniform(4.0, 6.0, s).astype(np.float32))
    u = rng.standard_normal((1, 4096, jcfg.d_model)).astype(np.float32)
    tp = convert.params_from_numpy(p, device="cpu")
    xc = ssm.causal_conv1d(torch.from_numpy(u) @ tp["proj_x"], tp["conv_w"],
                           tp["conv_b"])
    a, _ = ssm._rglru_coeffs(tp, tcfg, xc)
    assert float(a.min()) < 1e-12
    # the running product over 64 positions is 0 in float32, every channel
    assert float(torch.cumprod(a[0, :64], 0)[-1].max()) == 0.0
    got = ssm.rglru_train(tp, tcfg, torch.from_numpy(u))
    assert torch.isfinite(got).all()
    want = jax_rglru_train(jcfg)(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(u))
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)


def test_linear_scan_is_the_recurrence():
    """The doubling scan against the plain loop h_t = a_t h_{t-1} + b_t
    over a length that is not a power of two, in float64."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0, 1, (2, 37, 5)))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(ssm.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- serve step

T_PAGE = 8
PT = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
STEP_CASES = {       # tests/test_torch_model.py's
    # name: (lengths, n_new, C)
    "full_prefill_chunk": ([0, 0, 0], [8, 8, 0], 8),
    "partial_chunk_straddling_page": ([5, 3, 0], [8, 6, 0], 8),
    "decode_c1": ([9, 14, 0], [1, 1, 0], 1),
    "mixed_n_new_idle_slot": ([4, 10, 0], [8, 1, 0], 8),
}
# recurrentgemma SMOKE at 5 layers: one group of (rec, rec, attn) and the
# full config's tail of two rec layers (38 = 12 * 3 + 2)
RG_LAYERS = 5


def cache_leaves(tree):
    """A cache tree's tensors in JAX's flattening order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in cache_leaves(v)]
    return [tree]


def random_caches(jc, jcfg, rng):
    """The JAX init_caches tree with every pool and state leaf drawn."""
    def draw(a):
        a = np.asarray(a)
        x = rng.standard_normal(a.shape).astype(np.float32)
        return np.asarray(jnp.asarray(x, a.dtype))
    return {"page_table": PT,
            "lengths": np.zeros(3, np.int32),
            "group": jax.tree.map(draw, jc["group"]),
            "tail": jax.tree.map(draw, jc["tail"])}


def as_float32(tree):
    return jax.tree.map(
        lambda a: a if a.dtype.kind in "iu" else np.asarray(a, np.float32),
        tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_recurrentgemma_serve_step_matches_jax(case, dtype):
    """Logits and the attention pools against the JAX step at TOL.  The
    recurrent state (conv, h of b0_rec, b1_rec, t0_rec, t1_rec): at TOL in
    float32; in bf16 each package's state sits up to ~2.6% of the leaf's
    largest value from the float32 step on the same inputs by rounding
    alone (XLA and torch round the bf16 residual stream at other places
    through four layers), so there each leaf is held to be as accurate as
    the reference's: its largest distance from the port's float32 step at
    most twice the JAX bf16 step's, plus one bf16 ulp of the leaf's
    scale."""
    lengths, n_new, C = STEP_CASES[case]
    jcfg, tcfg = cfg_pair(RG, dtype, n_layers=RG_LAYERS)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    rng = np.random.default_rng(len(case))
    B = 3
    jc = japi.init_caches(B, 32, T_PAGE)
    tc = tapi.init_caches(B, 32, T_PAGE, device="cpu")
    assert set(tc["tail"]) == set(jc["tail"]) == {"t0_rec", "t1_rec"}
    for j, t in zip(jax.tree.leaves(jc), cache_leaves(tc)):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
    np_caches = random_caches(jc, jcfg, rng)
    np_caches["lengths"] = np.array(lengths, np.int32)
    params = np_params(jcfg)
    tokens = rng.integers(1, tcfg.vocab, (B, C)).astype(np.int32)
    n = torch.tensor(n_new, dtype=torch.int32)
    tparams = convert.params_from_numpy(params, device="cpu")
    j_logits, j_new = japi.serve_step(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, np_caches), jnp.asarray(n_new, jnp.int32))
    tcaches = convert.caches_from_numpy(np_caches, device="cpu")
    t_logits, t_new = tapi.serve_step(tparams, torch.from_numpy(tokens),
                                      tcaches, n)
    tol = TOL[dtype]
    assert t_logits.shape == (B, C, tcfg.vocab) and t_logits.dtype == tcfg.dtype
    for b in range(B):
        k = n_new[b]
        np.testing.assert_allclose(f32(t_logits[b, :k]), f32(j_logits[b, :k]),
                                   atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_new["lengths"].numpy(),
                                  np.asarray(j_new["lengths"]))
    for tp, jp in zip(t_new["group"]["b2_attn"], j_new["group"]["b2_attn"]):
        close(tp[:, 1:], np.asarray(jp)[:, 1:], tol, "group/b2_attn")
    if dtype == "bfloat16":               # the float32 step, same inputs
        _, ref = build_model(dataclasses.replace(
            tcfg, dtype=torch.float32)).serve_step(
            tparams, torch.from_numpy(tokens),
            convert.caches_from_numpy(as_float32(np_caches), device="cpu"), n)
    for part, keys in (("group", ("b0_rec", "b1_rec")),
                       ("tail", ("t0_rec", "t1_rec"))):
        for key in keys:
            for leaf in ("conv", "h"):
                what = f"{part}/{key}/{leaf}"
                got, want = t_new[part][key][leaf], j_new[part][key][leaf]
                if dtype == "float32":
                    close(got, want, tol, what)
                    continue
                truth = f32(ref[part][key][leaf])
                scale = max(1.0, np.abs(truth).max())
                port_err = np.abs(f32(got) - truth).max()
                jax_err = np.abs(f32(want) - truth).max()
                assert port_err <= 2 * jax_err + 2.0 ** -8 * scale, (
                    what, port_err, jax_err)
    # pools and state are updated in the caller's tensors
    assert t_new["group"]["b2_attn"][0] is tcaches["group"]["b2_attn"][0]
    assert t_new["tail"]["t1_rec"]["h"] is tcaches["tail"]["t1_rec"]["h"]


# ---------------------------------------------------------------- logits, loss, grads


def batch_of(arch, jcfg, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, jcfg.vocab, (2, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if arch == VLM:
        batch["patch_embeds"] = rng.standard_normal(
            (2, jcfg.n_patch_tokens, jcfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,S", [(RG, 48), (VLM, 24)])
def test_logits_loss_and_every_grad_match_jax(arch, S):
    """float32.  recurrentgemma's S=48 crosses its window of 32 and runs
    its tail; internvl2's logits cover the patch positions and its loss
    the text positions after them."""
    jcfg, tcfg = cfg_pair(arch)
    params = np_params(jcfg)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    batch = batch_of(arch, jcfg, S, seed=S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = convert.params_from_numpy(params, device="cpu")
    jlog = jax.jit(japi.logits)(jparams, jbatch)
    with torch.no_grad():
        tlog = tapi.logits(tparams, tbatch)
    n_pre = jcfg.n_patch_tokens if arch == VLM else 0
    assert tlog.shape == (2, n_pre + S, tcfg.vocab)
    np.testing.assert_allclose(f32(tlog), f32(jlog), atol=1e-4, rtol=1e-4)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jparams, jbatch)
    tl, tg = make_loss_and_grad(tapi, 1)(tparams, tbatch)
    tflat = [f32(g) for g in leaves(tg)]
    jflat = [np.asarray(g, np.float32) for g in jax.tree.leaves(jg)]
    assert len(tflat) == len(jflat) == len(jax.tree.leaves(jparams))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_vlm_logits_with_no_patches_are_the_decoders():
    """The prefix only prepends: with zero patches the VLM's logits are
    the decoder's on the tokens alone (the serve path's view)."""
    _, tcfg = cfg_pair(VLM)
    api = build_model(tcfg)
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    tok = torch.randint(0, tcfg.vocab, (2, 12), dtype=torch.int32)
    with torch.no_grad():
        a = api.logits(params, {"tokens": tok,
                                "patch_embeds": torch.zeros(2, 0,
                                                            tcfg.d_model)})
        b = lm_logits(params, tcfg, tok)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- serving cast


def test_cast_params_keeps_a_param_in_float32():
    """``a_param`` (read in float32 by ``_rglru_coeffs``) keeps its stored
    float32 bits through ``cast_params`` and through the cast at birth
    (``init_params(..., dtype=)``), as Mamba2's A_log, D_skip and
    dt_bias do: 0.1234567 is not a bf16 value, and survives both bit for
    bit; every other RG-LRU matrix and bias is cast to bf16."""
    assert "a_param" in FLOAT32_KEYS
    cfg = get_config(RG, smoke=True)
    api = build_model(cfg)
    specs = api.init_specs()
    params = init_params(specs, torch.Generator().manual_seed(0),
                         device="cpu")
    for rec in (params["group"]["b0_rec"]["rec"],
                params["tail"]["t0_rec"]["rec"]):
        rec["a_param"].fill_(0.1234567)
    cast = convert.cast_params(params, cfg)
    born = init_params(specs, torch.Generator().manual_seed(0),
                       device="cpu", dtype=cfg.dtype)
    want = torch.tensor(0.1234567, dtype=torch.float32)
    assert float(want.to(torch.bfloat16)) != float(want)
    for tree in (cast["group"]["b0_rec"]["rec"],
                 cast["tail"]["t0_rec"]["rec"]):
        assert tree["a_param"].dtype == torch.float32
        assert torch.equal(tree["a_param"],
                           want.expand_as(tree["a_param"]))
        for key in ("proj_x", "proj_gate", "conv_w", "conv_b", "w_i", "b_i",
                    "w_r", "b_r", "out_proj"):
            assert tree[key].dtype == torch.bfloat16, key
    for tree in (born["group"]["b0_rec"]["rec"],
                 born["tail"]["t0_rec"]["rec"]):
        assert tree["a_param"].dtype == torch.float32
        assert torch.equal(tree["a_param"],
                           torch.ones_like(tree["a_param"]))
        assert tree["w_r"].dtype == torch.bfloat16


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", [RG, VLM])
def test_param_tree_matches_reference(arch, smoke):
    """The port's ParamSpec tree has the reference's keys, shapes and
    init rules, the tail's unstacked layers included."""
    from repro.models.spec import tree_map_specs as jax_tree_map_specs
    from repro_torch.models.spec import tree_map_specs

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in flat(tree[k], prefix + (k,))]
        return [(prefix, tree)]

    def desc(s):
        return (tuple(s.shape), tuple(s.logical), s.init, s.scale)

    jt = jax_tree_map_specs(desc, jax_build_model(
        jax_get_config(arch, smoke=smoke)).init_specs())
    tt = tree_map_specs(desc, build_model(
        get_config(arch, smoke=smoke)).init_specs())
    assert flat(tt) == flat(jt)
    assert ("tail" in tt) == (arch == RG)
