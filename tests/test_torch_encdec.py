"""The port's encoder-decoder (whisper-large-v3) against the JAX package, at
SMOKE width: the parameter tree key for key, the sinusoids, ``cross_kv``
and ``gqa_cross`` on their own, the encoder output, the teacher-forced
logits, the loss and every grad against ``jax.grad``, the serving caches
(keys, shapes, dtypes) and ``encdec_prefill_cross``, the whole serve step
(logits, pools, ``cross_k``, ``cross_v``, ``lengths``) in
tests/test_torch_archs.py's four ``STEP_CASES``, a chunked prefill and
decode run step for step, and the plain flash schedule at the cross
attention's shapes (Sq = 1 or 16 against ragged key counts, and S = 1500
non-causal, which the reference pads to blocks of 128).  Weights are the
JAX package's (``repro.models.init_params``) carried across with
repro_torch.convert; the biases the JAX init sets to 0 are redrawn, so
every path is exercised.

Tolerances, as tests/test_torch_archs.py's ``TOL``: 1e-4 in float32 (the
same products summed in another order) and 2e-2 in bf16 (XLA and torch
round bf16 at other places), each times max(1, the largest magnitude of
what is compared): an entry near zero is a sum of products of that size
and carries their rounding.  Grads: float32 rtol 1e-4 / atol 1e-6 and the
loss rtol 1e-5, as tests/test_torch_hybrid.py.  In bf16 each package's
grads sit 0.3-2.5% of the leaf's largest magnitude from the float32 grads
by rounding alone (XLA and torch round the bf16 activations at other
places through the encoder and decoder), and the two packages up to 2.5%
from each other, so each bf16 grad leaf is held to be as accurate as the
reference's, as tests/test_torch_hybrid.py holds a bf16 state: its
largest distance from the port's float32 grad at most twice the JAX bf16
grad's, plus 2^-8 of the leaf's scale."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_ed
from repro.models import init_params as jax_init_params
from repro.models.attention import cross_kv as jax_cross_kv
from repro.models.attention import gqa_cross as jax_gqa_cross
from repro.models.spec import tree_map_specs as jax_tree_map_specs
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import attention
from repro_torch.models import build_model
from repro_torch.models import encdec as ed
from repro_torch.models.attention import cross_kv, gqa_cross
from repro_torch.models.spec import tree_map_specs
from repro_torch.train import make_loss_and_grad
from repro_torch.train.optimizer import leaves

ARCH = "whisper-large-v3"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# zero in the JAX init: redrawn in U(-0.5, 0.5)
REDRAWN = ("b", "bi", "bo")

# tests/test_torch_archs.py's serve-step cases
T_PAGE = 8
PT = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
STEP_CASES = {
    # name: (lengths, n_new, C)
    "full_prefill_chunk": ([0, 0, 0], [8, 8, 0], 8),
    "partial_chunk_straddling_page": ([5, 3, 0], [8, 6, 0], 8),
    "decode_c1": ([9, 14, 0], [1, 1, 0], 1),
    "mixed_n_new_idle_slot": ([4, 10, 0], [8, 1, 0], 8),
}


def cfg_pair(dtype="float32"):
    jd, td = DT[dtype]
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=jd),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=td))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.size:
        err = np.abs(got - want).max()
        assert err <= tol * max(1.0, np.abs(want).max()), (what, err, tol)


_PARAMS = {}


def np_params():
    """The JAX package's fp32 SMOKE weights, the zero biases redrawn."""
    if not _PARAMS:
        jcfg, _ = cfg_pair()
        rng = np.random.default_rng(3)

        def walk(node):
            if isinstance(node, dict):
                return {k: (rng.uniform(-0.5, 0.5, np.shape(v))
                            .astype(np.float32) if k in REDRAWN
                            else walk(v)) for k, v in node.items()}
            return np.asarray(node)
        _PARAMS["p"] = walk(jax.tree.map(np.asarray, jax_init_params(
            jax_build_model(jcfg).init_specs(), jax.random.PRNGKey(0))))
    return _PARAMS["p"]


def both_params():
    p = np_params()
    return jax.tree.map(jnp.asarray, p), convert.params_from_numpy(
        p, device="cpu")


def frames_of(jcfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, jcfg.enc_frames, jcfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- config, params


@pytest.mark.parametrize("smoke", [True, False])
def test_param_tree_matches_reference(smoke):
    """The port's ParamSpec tree has the reference's keys, shapes, logical
    axes and init rules (stacked ``encoder`` and ``decoder``), and the
    JAX package's parameters convert into it key for key."""
    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in flat(tree[k], prefix + (k,))]
        return [(prefix, tree)]

    def desc(s):
        return (tuple(s.shape), tuple(s.logical), s.init, s.scale)

    jt = jax_tree_map_specs(desc, jax_build_model(
        jax_get_config(ARCH, smoke=smoke)).init_specs())
    tt = tree_map_specs(desc, build_model(
        get_config(ARCH, smoke=smoke)).init_specs())
    assert flat(tt) == flat(jt)
    assert set(tt) == {"embed", "encoder", "enc_norm", "decoder",
                       "final_norm"}
    if smoke:
        tparams = convert.params_from_numpy(np_params(), device="cpu")
        got = [(path, tuple(t.shape)) for path, t in flat(tparams)]
        assert got == [(path, d[0]) for path, d in flat(jt)]
        for (_, t), (_, a) in zip(flat(tparams), flat(np_params())):
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("offset", [0, 7, 441])
def test_sinusoid_positions_match_jax(offset):
    got = ed.sinusoid_positions(16, 64, offset)
    want = jax_ed.sinusoid_positions(16, 64, offset)
    assert got.dtype == torch.float32 and got.shape == (16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


# ---------------------------------------------------------------- cross attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_and_gqa_cross_match_jax(dtype):
    """On their own, on one decoder layer's ``cross_attn`` weights:
    K/V from the encoder output, then C=5 queries against them."""
    jcfg, tcfg = cfg_pair(dtype)
    jp, tp = both_params()
    jl = jax.tree.map(lambda a: a[1], jp["decoder"]["cross_attn"])
    tl = {k: v[1] for k, v in tp["decoder"]["cross_attn"].items()}
    rng = np.random.default_rng(11)
    enc = rng.standard_normal((2, jcfg.enc_frames, jcfg.d_model)) \
        .astype(np.float32)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jenc, jx = (jnp.asarray(a, jcfg.dtype) for a in (enc, x))
    tenc, tx = (torch.from_numpy(a).to(tcfg.dtype) for a in (enc, x))
    jk, jv = jax_cross_kv(jl, jcfg, jenc)
    tk, tv = cross_kv(tl, tcfg, tenc)
    assert tk.shape == (2, jcfg.enc_frames, jcfg.n_kv_heads, jcfg.head_dim)
    close(tk, jk, TOL[dtype], "k")
    close(tv, jv, TOL[dtype], "v")
    out = gqa_cross(tl, tcfg, tx, tk, tv)
    assert out.shape == (2, 5, tcfg.d_model) and out.dtype == tcfg.dtype
    close(out, jax_gqa_cross(jl, jcfg, jx, jk, jv), TOL[dtype], "out")


def flash_inputs(rng, B, Sq, Sk, H, KV, D, dtype):
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = draw(B, Sq, H, D), draw(B, Sk, KV, D), draw(B, Sk, KV, D)
    jd, td = DT[dtype]
    return ([jnp.asarray(a, jd) for a in (q, k, v)],
            [torch.from_numpy(a).to(td) for a in (q, k, v)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(1, 37), (16, 37), (1, 1500),
                                   (16, 1500)])
def test_plain_flash_at_cross_shapes_matches_jax(Sq, Sk, dtype):
    """The flash op's plain version (``blockwise_fwd``: the CPU lane of
    ``kernels.attention``) non-causally at the cross attention's query
    counts (C=1 decode, C=16 prefill) against ragged key counts, against
    ``repro.kernels.attention`` (its ``ref`` lane, as the reference's
    tests run it on the CPU)."""
    (jq, jk, jv), (tq, tk, tv) = flash_inputs(
        np.random.default_rng(Sq * Sk), 2, Sq, Sk, 4, 2, 16, dtype)
    want = jax_attention(jq, jk, jv, causal=False, impl="ref")
    got = attention(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_at_encoder_shape_matches_jax_padding_branch(dtype):
    """S = 1500 non-causal (whisper's encoder), narrow heads: the
    reference pads q and K/V to 1536 and masks the padded keys with a
    static ``kv_len`` (``ops.py``'s padding branch); the plain schedule
    takes the ragged last block as it is."""
    (jq, jk, jv), (tq, tk, tv) = flash_inputs(
        np.random.default_rng(1500), 1, 1500, 1500, 2, 2, 16, dtype)
    want = jax_attention(jq, jk, jv, causal=False, impl="ref")
    got = attention(tq, tk, tv, causal=False)
    close(got, want, TOL[dtype])


# ---------------------------------------------------------------- encode, logits, loss, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_logits_loss_and_every_grad_match_jax(dtype):
    """The encoder output, the teacher-forced logits through the API
    (``batch["frames"]``), the loss and the grad of every leaf against
    ``jax.value_and_grad`` of the reference's loss."""
    jcfg, tcfg = cfg_pair(dtype)
    jp, tp = both_params()
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jcfg.vocab, (2, 13)).astype(np.int32)
    batch = {"frames": frames_of(jcfg, 2, 5), "tokens": tok[:, :-1],
             "targets": tok[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = TOL[dtype]
    with torch.no_grad():
        tenc = ed.encode(tp, tcfg, tbatch["frames"])
        tlog = tapi.logits(tp, tbatch)
    assert tenc.dtype == tcfg.dtype
    close(tenc, jax_ed.encode(jp, jcfg, jbatch["frames"]), tol, "encode")
    assert tlog.shape == (2, 12, tcfg.vocab)
    close(tlog, jax.jit(japi.logits)(jp, jbatch), tol, "logits")
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jp, jbatch)
    tl, tg = make_loss_and_grad(tapi, 1)(tp, tbatch)
    tflat = [f32(g) for g in leaves(tg)]
    jflat = [f32(g) for g in jax.tree.leaves(jg)]
    assert len(tflat) == len(jflat) == len(jax.tree.leaves(jp))
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a, b in zip(tflat, jflat):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        return
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol)
    _, truth = make_loss_and_grad(build_model(cfg_pair()[1]), 1)(tp, tbatch)
    paths = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    for what, a, b, t in zip(paths, tflat, jflat, leaves(truth)):
        t = f32(t)
        scale = np.abs(t).max()
        port_err, jax_err = np.abs(a - t).max(), np.abs(b - t).max()
        assert port_err <= 2 * jax_err + 2.0 ** -8 * scale, (
            what, port_err, jax_err)


# ---------------------------------------------------------------- serving


def random_caches(jc, rng, lengths):
    """The JAX init_caches tree with the pools and cross K/V drawn."""
    def draw(a):
        a = np.asarray(a)
        return np.asarray(jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32), a.dtype))
    return {"page_table": PT, "lengths": np.array(lengths, np.int32),
            "pools": tuple(draw(p) for p in jc["pools"]),
            "cross_k": draw(jc["cross_k"]), "cross_v": draw(jc["cross_v"])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_and_prefill_cross_match_jax(dtype):
    """The cache tree's keys, shapes and dtypes, on the device asked for;
    the cross K/V of every decoder layer, stacked [L, B, Senc, KV, hd]."""
    jcfg, tcfg = cfg_pair(dtype)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jc = japi.init_caches(3, 32, T_PAGE)
    tc = tapi.init_caches(3, 32, T_PAGE, device="cpu")
    assert set(tc) == set(jc) == {"page_table", "lengths", "pools",
                                  "cross_k", "cross_v"}
    assert isinstance(tc["pools"], tuple) and len(tc["pools"]) == 2
    for key in ("page_table", "lengths", "cross_k", "cross_v"):
        j, t = jc[key], tc[key]
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name, key
    for j, t in zip(jc["pools"], tc["pools"]):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == tcfg.dtype and t.device.type == "cpu"
    np.testing.assert_array_equal(tc["page_table"].numpy(),
                                  np.asarray(jc["page_table"]))
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            tapi.init_caches(3, 32, T_PAGE)
    jp, tp = both_params()
    frames = frames_of(jcfg, 3, 9)
    jenc = jax_ed.encode(jp, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        tenc = ed.encode(tp, tcfg, torch.from_numpy(frames))
    jk, jv = jax_ed.encdec_prefill_cross(jp, jcfg, jenc)
    tk, tv = ed.encdec_prefill_cross(tp, tcfg, tenc)
    assert tuple(tk.shape) == tuple(jc["cross_k"].shape)
    assert tk.dtype == tv.dtype == tcfg.dtype
    close(tk, jk, TOL[dtype], "cross_k")
    close(tv, jv, TOL[dtype], "cross_v")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_encdec_serve_step_matches_jax(case, dtype):
    """One serve step from random pools and cross K/V: the valid rows'
    logits, the pools off the null page, the (unchanged) cross K/V and
    ``lengths``; the pools are updated in the caller's tensors."""
    lengths, n_new, C = STEP_CASES[case]
    jcfg, tcfg = cfg_pair(dtype)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    rng = np.random.default_rng(len(case))
    B = 3
    np_caches = random_caches(japi.init_caches(B, 32, T_PAGE), rng, lengths)
    tokens = rng.integers(1, tcfg.vocab, (B, C)).astype(np.int32)
    jp, tp = both_params()
    j_logits, j_new = jax.jit(japi.serve_step)(
        jp, jnp.asarray(tokens), jax.tree.map(jnp.asarray, np_caches),
        jnp.asarray(n_new, jnp.int32))
    tcaches = convert.caches_from_numpy(np_caches, device="cpu")
    t_logits, t_new = tapi.serve_step(tp, torch.from_numpy(tokens), tcaches,
                                      torch.tensor(n_new, dtype=torch.int32))
    tol = TOL[dtype]
    assert t_logits.shape == (B, C, tcfg.vocab) and t_logits.dtype == tcfg.dtype
    for b in range(B):                    # valid rows only: idle slots
        k = n_new[b]                      # attend over page 0 by design
        close(t_logits[b, :k], j_logits[b, :k], tol, f"logits slot {b}")
    np.testing.assert_array_equal(t_new["lengths"].numpy(),
                                  np.asarray(j_new["lengths"]))
    for i, (tpool, jpool) in enumerate(zip(t_new["pools"], j_new["pools"])):
        close(tpool[:, 1:], np.asarray(jpool)[:, 1:], tol, f"pool{i}")
    for key in ("cross_k", "cross_v"):
        close(t_new[key], j_new[key], 0.0, key)
    assert t_new["pools"][0] is tcaches["pools"][0]
    assert t_new["cross_k"] is tcaches["cross_k"]


def test_chunked_prefill_then_decode_matches_jax_step_for_step():
    """float32: two slots' prompts (11 and 5 tokens) prefilled in chunks
    of 8 beside each other, then four greedy decode steps (the next
    token of each slot the JAX step's argmax), from cross K/V of random
    frames; the logits of every step and the final pools equal."""
    jcfg, tcfg = cfg_pair()
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jp, tp = both_params()
    B, C = 2, 8
    frames = frames_of(jcfg, B, 21)
    jc = japi.init_caches(B, 32, T_PAGE)
    jk, jv = jax_ed.encdec_prefill_cross(
        jp, jcfg, jax_ed.encode(jp, jcfg, jnp.asarray(frames)))
    jc = {**jc, "cross_k": jk, "cross_v": jv}
    tc = tapi.init_caches(B, 32, T_PAGE, device="cpu")
    with torch.no_grad():
        tk, tv = ed.encdec_prefill_cross(
            tp, tcfg, ed.encode(tp, tcfg, torch.from_numpy(frames)))
    tc["cross_k"].copy_(tk)
    tc["cross_v"].copy_(tv)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jcfg.vocab, n).tolist() for n in (11, 5)]
    pos = [0, 0]
    nxt = [None, None]
    jstep = jax.jit(japi.serve_step)
    for step in range(6):
        tokens = np.zeros((B, C), np.int32)
        n_new = [0, 0]
        for b in range(B):
            if pos[b] < len(prompts[b]):
                chunk = prompts[b][pos[b]:pos[b] + C]
            else:
                chunk = [nxt[b]]
            tokens[b, :len(chunk)] = chunk
            n_new[b] = len(chunk)
        width = C if step < 2 else 1
        tokens = tokens[:, :width]
        jl, jc = jstep(jp, jnp.asarray(tokens), jc,
                       jnp.asarray(n_new, jnp.int32))
        tl, tc = tapi.serve_step(tp, torch.from_numpy(tokens), tc,
                                 torch.tensor(n_new, dtype=torch.int32))
        for b in range(B):
            close(tl[b, :n_new[b]], jl[b, :n_new[b]], TOL["float32"],
                  f"step {step} slot {b}")
            nxt[b] = int(np.argmax(np.asarray(jl[b, n_new[b] - 1])))
            pos[b] += n_new[b]
    assert pos == [11 + 4, 5 + 5]
    np.testing.assert_array_equal(tc["lengths"].numpy(), pos)
    for tpool, jpool in zip(tc["pools"], jc["pools"]):
        close(tpool[:, 1:], np.asarray(jpool)[:, 1:], TOL["float32"])
