"""The port's gradient codec (``repro_torch.dist.compression``) and its
one-rank train step against the JAX package's (``repro.dist.compression``,
``repro.train.step``) on numpy-seeded inputs, on the CPU.

- ``plan_buckets`` / ``grad_bucket_plan``: equal plans on qwen2-1.5b's
  published and SMOKE leaf sizes at several caps;
- ``quantize_int8``, ``dequantize_int8``, ``quantize_with_feedback``:
  bitwise equal, on a ragged length, an all-zero block (the ``tiny``
  clamp of the scale) and exact .5 ties (both round half to even);
- ``topk_sparsify``: the same mask where magnitudes tie at the threshold;
- ``bucketed_compressed_psum`` over a one-rank gloo group (a FileStore in
  the test's tmp_path, destroyed at teardown): bitwise the reference's
  one-pod manual region (``tests/test_pod_compression.py:_pod1_reduce``)
  for both codecs;
- the reference's numpy telescoping scenario (four ranks' residuals
  carried, or collapsed to rank 0's) through the port's codec, bitwise
  the reference's;
- the one-rank compressed train step on SMOKE qwen2 in float32 against
  the reference's on a one-pod mesh: losses within rtol 1e-5 and
  residuals within 1e-5 (the same products summed in another order), but
  for the rare element where the grads' rounding moved ``x / scale``
  across a .5 tie: the two residuals then differ by one quantization step
  (``assert_residuals_close``: at most 0.1% of a bucket's elements, each
  within twice the bucket's largest residual, which is about a block's
  scale).  Measured: 2 of 14080 elements flipped, by 6.9e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.dist import compression as ref
from repro.models import build_model as jax_build_model
from repro.models.spec import init_params as jax_init_params
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.step import grad_bucket_plan as jax_grad_bucket_plan
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.dist import compression as port
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.step import grad_bucket_plan
from test_pod_compression import _pod1_reduce, _toy_tree


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo process group over a FileStore in ``tmp_path``."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def assert_residuals_close(got: np.ndarray, want: np.ndarray,
                           atol: float = 1e-5, flip_share: float = 1e-3
                           ) -> int:
    """``got`` within ``atol`` of ``want`` but for at most ``flip_share``
    of the elements, each within one quantization step (at most twice
    the largest |want| + atol); returns the count of such flips."""
    diff = np.abs(got - want)
    flips = diff > atol
    assert flips.mean() <= flip_share, (int(flips.sum()), got.size)
    step = 2 * np.abs(want).max() + atol
    assert (diff[flips] <= step).all(), (diff.max(), step)
    return int(flips.sum())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def bits(x) -> np.ndarray:
    """A float32 array's bits (so -0.0 and 0.0 differ, NaNs compare)."""
    return np.asarray(x, np.float32).view(np.uint32)


# --------------------------------------------------------------- bucket plan


@pytest.mark.parametrize("cap", [1 << 10, 1 << 14, 1 << 18, 1 << 22,
                                 1 << 30])
@pytest.mark.parametrize("smoke", [True, False])
def test_grad_bucket_plan_equals_reference(smoke, cap):
    want = jax_grad_bucket_plan(jax_build_model(
        jax_get_config("qwen2-1.5b", smoke=smoke)), bucket_elems=cap)
    got = grad_bucket_plan(build_model(get_config("qwen2-1.5b", smoke=smoke)),
                           bucket_elems=cap)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_qwen2_plan_at_the_default_cap():
    """Leaves stacked over 28 layers each exceed the 4 Mi cap."""
    plan = grad_bucket_plan(build_model(get_config("qwen2-1.5b")))
    assert sum(len(g) for g in plan.groups) == 14
    assert sum(plan.sizes) == 1_543_714_304
    assert plan.num_buckets == 10 and max(plan.sizes) == 385_351_680
    smoke = grad_bucket_plan(build_model(get_config("qwen2-1.5b",
                                                    smoke=True)),
                             bucket_elems=1 << 14)
    assert smoke.num_buckets == 5


@pytest.mark.parametrize("sizes,cap", [([512, 32, 256, 8, 4096, 16, 16], 600),
                                       ([100, 200, 300], 1 << 30),
                                       ([7], 1), ([3, 3, 3], 6)])
def test_plan_buckets_equals_reference(sizes, cap):
    assert dataclasses.astuple(port.plan_buckets(sizes, bucket_elems=cap)) \
        == dataclasses.astuple(ref.plan_buckets(sizes, bucket_elems=cap))
    with pytest.raises(ValueError):
        port.plan_buckets(sizes, bucket_elems=0)


# ------------------------------------------------------------------- codecs


def codec_inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if name == "normal_2d":
        return rng.standard_normal((16, 48)).astype(np.float32)
    if name == "ragged_1000":
        return (rng.standard_normal(1000) * 3).astype(np.float32)
    if name == "zero_block":
        x = rng.standard_normal(3 * port.BLOCK).astype(np.float32)
        x[port.BLOCK:2 * port.BLOCK] = 0.0
        return x
    if name == "half_ties":
        # amax 127 gives scale 1.0 exactly: every k + 0.5 is a tie, which
        # both packages round half to even
        x = np.concatenate([[127.0], np.arange(-127, 127) + 0.5, [0.0]]
                           ).astype(np.float32)
        return np.concatenate([x, -x, x[:100] * 0.25])
    if name == "small_values":
        # normal float32 far below 1; XLA's CPU backend flushes subnormals
        # to zero where torch keeps them, so none is drawn here
        return (rng.standard_normal(300) * 1e-30).astype(np.float32)
    raise KeyError(name)


CODEC_CASES = ["normal_2d", "ragged_1000", "zero_block", "half_ties",
               "small_values"]


@pytest.mark.parametrize("case", CODEC_CASES)
def test_quantize_dequantize_bitwise(case):
    x = codec_inputs(case)
    q_r, s_r, pad_r = ref.quantize_int8(jnp.asarray(x))
    q_p, s_p, pad_p = port.quantize_int8(t(x))
    assert pad_p == pad_r == (-x.size) % port.BLOCK
    assert q_p.dtype == torch.int8 and s_p.dtype == torch.float32
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(bits(s_p.numpy()), bits(s_r))
    d_r = ref.dequantize_int8(q_r, s_r, pad_r, x.shape)
    d_p = port.dequantize_int8(q_p, s_p, pad_p, x.shape)
    assert tuple(d_p.shape) == x.shape
    np.testing.assert_array_equal(bits(d_p.numpy()), bits(d_r))
    if case == "half_ties":   # a tie went to the even neighbour
        assert (q_p.numpy().ravel()[1:5] == [-126, -126, -124, -124]).all()
    if case == "zero_block":  # the tiny clamp: scale > 0, q == 0
        assert float(s_p[1]) == torch.finfo(torch.float32).tiny
        assert not q_p[1].any()


@pytest.mark.parametrize("case", CODEC_CASES)
def test_quantize_with_feedback_bitwise(case):
    x = codec_inputs(case)
    err = (np.random.default_rng(5).standard_normal(x.shape) * 0.01
           ).astype(np.float32)
    q_r, s_r, pad_r, e_r = ref.quantize_with_feedback(jnp.asarray(x),
                                                      jnp.asarray(err))
    q_p, s_p, pad_p, e_p = port.quantize_with_feedback(t(x), t(err))
    assert pad_p == pad_r
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(bits(s_p.numpy()), bits(s_r))
    np.testing.assert_array_equal(bits(e_p.numpy()), bits(e_r))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.25, 0.5, 1.0])
def test_topk_mask_with_ties_equals_reference(frac):
    rng = np.random.default_rng(3)
    # magnitudes on a grid of 8 values: ties at every threshold
    x = (rng.integers(-8, 9, 1000) * 0.125).astype(np.float32)
    v_r, m_r = ref.topk_sparsify(jnp.asarray(x), frac)
    v_p, m_p = port.topk_sparsify(t(x), frac)
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_r))
    np.testing.assert_array_equal(bits(v_p.numpy()), bits(v_r))
    assert int(m_p.sum()) >= max(1, round(frac * x.size))


# ----------------------------------------------- the bucketed reduction, W=1


@pytest.mark.parametrize("codec", ["int8", "topk"])
@pytest.mark.parametrize("bucket_elems", [300, 1 << 20])
def test_one_rank_bucketed_reduction_equals_reference(codec, bucket_elems,
                                                      group):
    tree = _toy_tree()
    plan = port.plan_buckets([int(a.size) for a in tree],
                             bucket_elems=bucket_elems)
    red_r, err_r = _pod1_reduce(tree, ref.plan_buckets(
        [int(a.size) for a in tree], bucket_elems=bucket_elems), codec)
    errs = port.init_residuals(plan)
    red_p, err_p = port.bucketed_compressed_psum(
        [t(a) for a in tree], errs, group, plan=plan, codec=codec,
        topk_frac=0.25)
    assert all(not e.any() for e in errs), "residuals are not modified"
    assert len(red_p) == len(tree)
    for a, b in zip(red_p, red_r):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))
    for a, b in zip(err_p, err_r):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))
    # the reduction's identity on one rank: reduced + residual == input
    for b_, g in enumerate(plan.groups):
        flat = port.bucket_flat([t(a) for a in tree], plan, b_)
        red = port.bucket_flat(red_p, plan, b_)
        np.testing.assert_array_equal((flat - red).numpy(),
                                      err_p[b_].numpy())


def test_unknown_codec_raises(group):
    plan = port.plan_buckets([4])
    with pytest.raises(ValueError, match="unknown codec"):
        port.bucketed_compressed_psum([torch.ones(4)],
                                      port.init_residuals(plan), group,
                                      plan=plan, codec="fp8")
    with pytest.raises(ValueError, match="residuals"):
        port.bucketed_compressed_psum([torch.ones(4)], [], group, plan=plan)
    with pytest.raises(ValueError, match="unknown codec"):
        make_train_step(build_model(get_config("qwen2-1.5b", smoke=True)),
                        AdamWConfig(), pod_group=group, codec="fp8")


@pytest.mark.parametrize("fault", ["monitor", "policy"])
def test_run_training_refuses_the_fault_path_over_a_group(group, fault):
    """Each rank would plan on its own and leave the others blocked in a
    collective, so a group takes no monitor and no policy."""
    from repro_torch.data import TokenPipeline
    from repro_torch.dist import FaultPolicy, HeartbeatMonitor
    from repro_torch.train import LoopConfig, run_training

    cfg = get_config("qwen2-1.5b", smoke=True)
    monitor = HeartbeatMonitor([0])
    kw = {"monitor": monitor} if fault == "monitor" else {
        "policy": FaultPolicy(monitor, assignment={0: 0},
                              chips_per_worker=1, model_axis=1)}
    with pytest.raises(ValueError, match="does not run over a pod_group"):
        run_training(build_model(cfg),
                     TokenPipeline(cfg, global_batch=2, seq_len=8, seed=0),
                     LoopConfig(steps=1), AdamWConfig(), device="cpu",
                     pod_group=group, **kw)


# -------------------------------------- the per-rank residuals telescope


def telescope(quantize, dequantize, asarray, tonp, collapse: bool):
    """tests/test_pod_compression.py's scenario through one package:
    four ranks, six steps, each rank's residual carried (or collapsed to
    rank 0's every step)."""
    pods, steps, n = 4, 6, 512
    grads = np.random.default_rng(7).standard_normal(
        (steps, pods, n)).astype(np.float32)
    errs = [asarray(np.zeros(n, np.float32)) for _ in range(pods)]
    applied = asarray(np.zeros(n, np.float32))
    for s in range(steps):
        deqs = []
        for p in range(pods):
            q, scale, pad, new_err = quantize(asarray(grads[s, p]), errs[p])
            deqs.append(dequantize(q, scale, pad, (n,)))
            errs[p] = new_err
        if collapse:
            errs = [errs[0]] * pods
        applied = applied + sum(deqs) / pods
    true_sum = grads.mean(axis=1).sum(axis=0)
    return tonp(applied), np.stack([tonp(e) for e in errs]), true_sum


@pytest.mark.parametrize("collapse", [False, True])
def test_per_rank_residuals_telescope_as_the_reference(collapse):
    got = telescope(port.quantize_with_feedback, port.dequantize_int8,
                    t, lambda x: x.numpy(), collapse)
    want = telescope(ref.quantize_with_feedback, ref.dequantize_int8,
                     jnp.asarray, np.asarray, collapse)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(bits(a), bits(b))
    applied, errs, true_sum = got
    drift = np.abs(applied + errs.mean(axis=0) - true_sum).max()
    if not collapse:
        assert drift <= 1e-4 and np.abs(errs.mean(axis=0)).max() < 0.1
    else:
        ok = telescope(port.quantize_with_feedback, port.dequantize_int8,
                       t, lambda x: x.numpy(), False)
        drift_ok = np.abs(ok[0] + ok[1].mean(axis=0) - ok[2]).max()
        assert drift > 50 * drift_ok, "collapsed residuals must drift"


# ----------------------------------------------- the one-rank train step


def test_one_rank_compressed_step_matches_reference(group):
    """Two compressed steps on a one-pod mesh and on a one-rank group,
    from the same float32 SMOKE weights and batch."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b", smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                               dtype=torch.float32)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (4, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    step, _, bsh, init_state = jax_make_train_step(
        japi, mesh, JaxAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
        compress_pod_grads=True, bucket_elems=1 << 14)
    with jax.set_mesh(mesh):
        params = jax_init_params(japi.init_specs(), jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, params)
        state = init_state(params)
        b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                           bsh)
        want_loss = []
        for _ in range(2):
            state, m = step(state, b)
            want_loss.append(float(m["loss"]))
        want_err = [np.asarray(e) for e in state["err"]]

    tstep, tinit, _ = make_train_step(
        tapi, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
        pod_group=group, bucket_elems=1 << 14)
    tstate = tinit(convert.params_from_numpy(np_params, device="cpu"),
                   device="cpu")
    assert [e.numel() for e in tstate["err"]] == [e.size for e in want_err]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_loss = []
    for _ in range(2):
        tstate, m = tstep(tstate, tb)
        got_loss.append(float(m["loss"]))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=0)
    assert any(float(e.abs().max()) > 0 for e in tstate["err"])
    for a, b in zip(tstate["err"], want_err):
        assert_residuals_close(a.numpy(), b)
