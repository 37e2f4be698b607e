"""The port's training path against the JAX package on qwen2-1.5b SMOKE:
the flash attention op (plain forward against the JAX oracle and the
Pallas kernel in interpret mode; its backward against jax.grad of the
JAX blockwise flash), the loss and every parameter grad, the remat
policies, AdamW and its schedule, the train step with and without
microbatches, the data pipeline, and the loop.  Inputs come from a seeded
numpy rng and weights from the JAX package (repro_torch.convert)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.kernels import attention as jax_attention
from repro.kernels import attention_ref as jax_attention_ref
from repro.kernels.flash_attention.blockwise import (
    _blockwise_fwd_impl as jax_blockwise_fwd)
from repro.kernels.flash_attention.blockwise import (
    blockwise_attention as jax_blockwise)
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.attention import gqa_train as jax_gqa_train
from repro.models.lm import lm_logits as jax_lm_logits
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import schedule as jax_schedule
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.kernels import (attention, attention_ref, blockwise_fwd,
                                 common)
from repro_torch.models import build_model
from repro_torch.models.attention import gqa_train
from repro_torch.models.lm import lm_logits, lm_loss
from repro_torch.train import (AdamWConfig, LoopConfig, adamw_init,
                               adamw_update, make_loss_and_grad,
                               make_train_step, run_training, schedule)
from repro_torch.train.optimizer import leaves

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# attention outputs: float32 differs only in summation order; bf16 rounds
# the inputs' products and the output once more (one bf16 ulp of O(1))
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def both(x, dtype="float32"):
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x)).to(td)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def qkv(seed, B, Sq, Sk, H, KV, D, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *s: both(rng.standard_normal(s).astype(np.float32), dtype)
    return mk(B, Sq, H, D), mk(B, Sk, KV, D), mk(B, Sk, KV, D)


# ---------------------------------------------------------------- attention op

# B, Sq, Sk, H, KV, D, causal, window, softcap, dtype: the cases of
# tests/test_kernels.py's FLASH_CASES, then a ragged length and non-causal
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None, "float32"),
    (1, 512, 512, 8, 8, 128, True, None, None, "float32"),
    (2, 256, 256, 4, 1, 64, True, 128, None, "float32"),
    (1, 256, 256, 4, 4, 64, True, None, 30.0, "float32"),
    (1, 256, 256, 2, 2, 128, True, None, None, "bfloat16"),
    (1, 384, 384, 6, 2, 64, True, 128, None, "float32"),
    (1, 200, 200, 4, 2, 32, True, None, None, "float32"),      # ragged S
    (1, 200, 200, 4, 2, 32, True, 64, 20.0, "bfloat16"),
    (2, 128, 256, 4, 2, 64, False, None, None, "float32"),     # non-causal
    (1, 128, 256, 4, 1, 64, False, None, 30.0, "bfloat16"),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,softcap,dtype",
                         ATTN_CASES)
def test_attention_matches_jax_oracle_and_interpret_kernel(
        B, Sq, Sk, H, KV, D, causal, window, softcap, dtype):
    (jq, tq), (jk, tk), (jv, tv) = qkv(Sq + D, B, Sq, Sk, H, KV, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    common.reset_launch_counts()
    out = attention(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype and common.LAUNCHES["flash_attention"] == 0
    tol = ATTN_TOL[dtype]
    for ref in (jax_attention_ref(jq, jk, jv, **kw),
                jax_attention(jq, jk, jv, impl="interpret", **kw)):
        np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(attention_ref(tq, tk, tv, **kw)),
                               f32(out), atol=tol, rtol=tol)


@pytest.mark.parametrize("blk_q,blk_k", [(64, 64), (48, 80), (200, 32)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 70),
                                           (False, None), (False, 50)])
def test_blockwise_blocks_and_lse_match_jax(blk_q, blk_k, causal, window):
    """Any block sizes (ragged last blocks, band edges mid-block) give the
    oracle's output and the JAX blockwise forward's row log-sum-exp."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(7, 2, 256, 256, 4, 2, 32, "float32")
    out, lse = blockwise_fwd(tq, tk, tv, causal=causal, window=window,
                             blk_q=blk_q, blk_k=blk_k)
    ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    _, jlse = jax_blockwise_fwd(jq, jk, jv, causal, window, None, 128, 128)
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(f32(lse), f32(jlse), atol=2e-5, rtol=2e-5)


def test_attention_q_offset_and_lengths_take_the_oracle():
    (jq, tq), (jk, tk), (jv, tv) = qkv(3, 2, 8, 32, 4, 2, 16, "float32")
    lens = np.array([20, 5], np.int32)
    kw = dict(causal=True, window=12, q_offset=24)
    out = attention(tq, tk, tv, lengths=torch.from_numpy(lens), **kw)
    ref = jax_attention_ref(jq, jk, jv, lengths=jnp.asarray(lens), **kw)
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError):             # the kernel needs the card
        attention(tq, tk, tv, impl="cuda")


# B, S, H, KV, D, window, softcap: tests/test_kernels.py's fwd+bwd cases,
# then a ragged length (against the JAX oracle's autodiff: the JAX
# blockwise flash needs block multiples)
GRAD_CASES = [
    (2, 256, 4, 2, 64, None, None),
    (1, 512, 8, 8, 128, None, None),
    (2, 256, 4, 1, 64, 128, None),
    (1, 256, 4, 4, 64, None, 30.0),
    (1, 200, 4, 2, 32, 64, 20.0),
]


@pytest.mark.parametrize("B,S,H,KV,D,window,softcap", GRAD_CASES)
def test_attention_grads_match_jax_blockwise(B, S, H, KV, D, window,
                                             softcap):
    (jq, tq), (jk, tk), (jv, tv) = qkv(S + H, B, S, S, H, KV, D, "float32")

    def jloss(q, k, v):
        if S % 128:
            o = jax_attention_ref(q, k, v, causal=True, window=window,
                                  softcap=softcap)
        else:
            o = jax_blockwise(q, k, v, True, window, softcap, 128, 128)
        return (o ** 2).sum()

    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tloss = (attention(*ts, window=window, softcap=softcap) ** 2).sum()
    tgrads = torch.autograd.grad(tloss, ts)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    np.testing.assert_allclose(float(tloss.detach()),
                               float(jloss(jq, jk, jv)),
                               rtol=1e-4)
    for a, b, name in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(f32(a), f32(b), atol=5e-4, rtol=5e-4,
                                   err_msg=name)


# ---------------------------------------------------------------- model loss


def cfg_pair(dtype="float32", **kw):
    jd, td = DT[dtype]
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b", smoke=True),
                               dtype=jd, **kw)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                               dtype=td, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = cfg_pair()
    api = jax_build_model(jcfg)
    params = jax_init_params(api.init_specs(), jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def smoke_batch(cfg, B=2, S=32, seed=4, step=0):
    return TokenPipeline(cfg, global_batch=B, seq_len=S,
                         seed=seed).batch_at(step)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def flat_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("kw", [
    {}, {"window": 8}, {"causal": False, "use_rope": False},
    {"return_kv": True}, {"kv_override": True}],
    ids=["causal", "window", "full_no_rope", "return_kv", "kv_override"])
def test_gqa_train_matches_jax(jax_params, kw):
    jcfg, tcfg = cfg_pair()
    jp = jax.tree.map(lambda a: a[0], jax_params[0]["group"]["b0_attn"]["attn"])
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    B, S = 2, 24
    (jx, tx) = both(rng.standard_normal((B, S, jcfg.d_model)).astype(
        np.float32))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_override"):        # cross attention over 40 other keys
        shape = (B, 40, jcfg.n_kv_heads, jcfg.head_dim)
        (jk, tk), (jv, tv) = (both(rng.standard_normal(shape).astype(
            np.float32)) for _ in range(2))
        jkw["kv_override"], tkw["kv_override"] = (jk, jv), (tk, tv)
    jout = jax_gqa_train(jp, jcfg, jx, jnp.asarray(pos), **jkw)
    tout = gqa_train(tp, tcfg, tx, torch.from_numpy(pos.copy()), **tkw)
    if kw.get("return_kv"):
        (jout, jkv), (tout, tkv) = jout, tout
        for a, b in zip(tkv, jkv):
            np.testing.assert_allclose(f32(a), f32(b), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f32(tout), f32(jout), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_grad_match_jax(jax_params, dtype):
    """fp32: the same arithmetic in another order (loss rtol 1e-5, grads
    rtol 1e-4 / atol 1e-6).  bf16: XLA and torch round bf16 activations at
    other places, so each grad leaf is held by its relative norm error
    (2e-2) and the loss by rtol 2e-2."""
    jcfg, tcfg = cfg_pair(dtype)
    jparams, np_params = jax_params
    batch = smoke_batch(tcfg)
    japi = jax_build_model(jcfg)
    jl, jg = jax.value_and_grad(japi.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = convert.params_from_numpy(np_params, device="cpu")
    tl, tg = make_loss_and_grad(build_model(tcfg), 1)(tparams,
                                                      torch_batch(batch))
    tflat, jflat = [f32(g) for g in leaves(tg)], flat_np(jg)
    assert len(tflat) == len(jflat) == len(jax.tree.leaves(np_params))
    if dtype == "float32":
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a, b in zip(tflat, jflat):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    else:
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)
        for a, b in zip(tflat, jflat):
            assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_the_grads_of_no_remat(jax_params, remat):
    _, np_params = jax_params
    _, base_cfg = cfg_pair(remat="none")
    batch = torch_batch(smoke_batch(base_cfg))
    outs = {}
    for r in ("none", remat):
        cfg = dataclasses.replace(base_cfg, remat=r)
        params = convert.params_from_numpy(np_params, device="cpu")
        outs[r] = make_loss_and_grad(build_model(cfg), 1)(params, batch)
    assert float(outs["none"][0]) == float(outs[remat][0])
    for a, b in zip(leaves(outs["none"][1]), leaves(outs[remat][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_lm_loss_rejects_prefix_embeds(jax_params):
    """Prefix embeddings are ported (ROADMAP item 2.7): the logits with a
    prefix equal the reference's (fp32), and ``lm_loss`` rejects a prefix
    its targets do not cover (the reference's masked reduce fails to
    broadcast there), as it rejects a prefix of the wrong width."""
    jcfg, tcfg = cfg_pair()
    params = convert.params_from_numpy(jax_params[1], device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, tcfg.vocab, (1, 4)).astype(np.int32)
    pre = rng.standard_normal((1, 2, tcfg.d_model)).astype(np.float32)
    want = jax_lm_logits(jax_params[0], jcfg, jnp.asarray(tok),
                         prefix_embeds=jnp.asarray(pre))
    with torch.no_grad():
        got = lm_logits(params, tcfg, torch.from_numpy(tok),
                        prefix_embeds=torch.from_numpy(pre))
    np.testing.assert_allclose(f32(got), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    tok = torch.from_numpy(tok)
    with pytest.raises(ValueError):
        lm_loss(params, tcfg, tok, tok,
                prefix_embeds=torch.from_numpy(pre))
    with pytest.raises(RuntimeError):
        lm_loss(params, tcfg, tok, tok,
                prefix_embeds=torch.zeros(1, 2, tcfg.d_model + 1))


# ---------------------------------------------------------------- optimizer


def random_tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "group": {"w": rng.standard_normal((2, 5, 3)).astype(np.float32),
                      "b": rng.standard_normal((7,)).astype(np.float32)},
            "z": rng.standard_normal((1,)).astype(np.float32)}


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_adamw_update_matches_jax(seed, clip_norm):
    rng = np.random.default_rng(seed)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm)
    p_np = random_tree(rng)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = convert.params_from_numpy(p_np, device="cpu")
    jstate, tstate = jax_adamw_init(jp), adamw_init(tp)
    for _ in range(4):
        g_np = random_tree(rng)
        jp, jstate, jm = jax_adamw_update(JaxAdamWConfig(**cfg), jp,
                                          jax.tree.map(jnp.asarray, g_np),
                                          jstate)
        tp, tstate, tm = adamw_update(AdamWConfig(**cfg), tp,
                                      convert.params_from_numpy(g_np, "cpu"),
                                      tstate)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 4
    # atol: one float32 ulp of the O(1e-2..1) operands of p - lr * step,
    # which can cancel to a result far smaller than they are
    for t, j in ((tp, jp), (tstate["mu"], jstate["mu"]),
                 (tstate["nu"], jstate["nu"])):
        for a, b in zip(leaves(t), flat_np(j)):
            np.testing.assert_allclose(f32(a), b, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 50, 120])
def test_schedule_matches_jax(step):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    t = schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    j = jax_schedule(JaxAdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


# ---------------------------------------------------------------- train step


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_jax(microbatches):
    """Two AdamW steps from the same params and batches: losses at rtol
    1e-5 (fp32), params at tests/test_train_serve.py's tolerance."""
    jcfg, tcfg = cfg_pair()
    japi = jax_build_model(jcfg)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    batches = [TokenPipeline(tcfg, global_batch=8, seq_len=16,
                             seed=5).batch_at(i) for i in range(2)]
    jstep, _, _, jinit = jax_make_train_step(
        japi, mesh, JaxAdamWConfig(**opt), microbatches=microbatches)
    with jax.set_mesh(mesh):
        jparams = jax_init_params(japi.init_specs(), jax.random.PRNGKey(1))
        tparams = convert.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")
        jstate = jinit(jparams)
        jlosses = []
        for b in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            jlosses.append(float(m["loss"]))
        jfinal = flat_np(jstate["params"])
    tstep, tinit = make_train_step(build_model(tcfg), AdamWConfig(**opt),
                                   microbatches=microbatches)
    tstate = tinit(tparams, device="cpu")
    tlosses = []
    for b in batches:
        tstate, m = tstep(tstate, torch_batch(b))
        tlosses.append(float(m["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for a, b in zip(leaves(tstate["params"]), jfinal):
        np.testing.assert_allclose(f32(a), b, atol=2e-3, rtol=2e-2)


# ---------------------------------------------------------------- data + loop


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_pipeline_batches_are_byte_identical(shard, num_shards):
    jcfg, tcfg = cfg_pair()
    kw = dict(global_batch=4, seq_len=24, seed=11, shard=shard,
              num_shards=num_shards)
    jp, tp = JaxTokenPipeline(jcfg, **kw), TokenPipeline(tcfg, **kw)
    for step in (0, 3):
        a, b = jp.batch_at(step), tp.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert next(jp)["tokens"].tobytes() == next(tp)["tokens"].tobytes()
    tp.restore(5)
    assert tp.snapshot() == 5
    assert tp.reshard(0, 1).snapshot() == 5


def test_run_training_lowers_loss_on_cpu():
    cfg = get_config("qwen2-1.5b", smoke=True)
    pipe = TokenPipeline(cfg, global_batch=4, seq_len=32, seed=3)
    res = run_training(build_model(cfg), pipe, LoopConfig(steps=12),
                       AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12),
                       device="cpu")
    assert res.steps_run == 12 == len(res.step_seconds)
    assert np.all(np.isfinite(res.losses))
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3]) - 0.1


def test_run_training_crash_at_raises_after_the_step():
    cfg = get_config("qwen2-1.5b", smoke=True)
    pipe = TokenPipeline(cfg, global_batch=2, seq_len=8, seed=0)
    with pytest.raises(RuntimeError, match="injected crash at step 2"):
        run_training(build_model(cfg), pipe, LoopConfig(steps=5),
                     AdamWConfig(), device="cpu", crash_at=2)
    assert pipe.snapshot() == 2


def test_run_training_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config("qwen2-1.5b", smoke=True)
    pipe = TokenPipeline(cfg, global_batch=2, seq_len=8, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        run_training(build_model(cfg), pipe, LoopConfig(steps=1),
                     AdamWConfig())
