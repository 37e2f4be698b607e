"""Training of every family beyond the dense and SSM ones against the JAX
package, at SMOKE width:

  * the MoE models (deepseek-v2-lite-16b: MLA attention, 8 experts top-2
    and a shared expert; grok-1-314b: GQA, softcap 30, 4 experts top-2):
    the logits, the loss and the grad of every parameter against
    ``jax.value_and_grad`` of the reference's loss, in float32;
  * two AdamW steps of the train step (tests/test_torch_train.py's
    ``test_train_step_matches_jax``) for deepseek, grok, recurrentgemma-9b
    (the RG-LRU hybrid with its layer tail), internvl2-1b (the VLM: patch
    embeddings before the tokens, the loss on the text) and
    whisper-large-v3 (the encoder-decoder: frames through the encoder,
    cross attention in every decoder layer), each with two microbatches,
    from the same parameters and the same pipeline batches;
  * the port's copy of ``repro/configs/shapes.py`` (the training
    sequence of ``chip_smoke.py``'s train phases): every ``ShapeCfg``
    field and every architecture's ``shapes_for``.

Weights are the JAX package's (``repro.models.init_params``), carried
across with repro_torch.convert.  Tolerances: logits atol = rtol = 1e-4
(the same float32 products summed in another order), the loss rtol 1e-5,
grads rtol 1e-4 and atol 1e-6 (as tests/test_torch_hybrid.py); the step
losses rtol 1e-5 and the parameters after two steps atol 2e-3, rtol 2e-2
(tests/test_torch_train.py's, after tests/test_train_serve.py).  In
float32 the MoE's routes cannot flip between the packages except at an
exact tie, which both break to the lower expert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, shapes
from repro_torch.data import TokenPipeline
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, make_loss_and_grad, make_train_step
from repro_torch.train.optimizer import leaves

MOE = ("deepseek-v2-lite-16b", "grok-1-314b")
FAMILIES = MOE + ("recurrentgemma-9b", "internvl2-1b", "whisper-large-v3")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def cfg_pair(arch):
    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                dtype=jnp.float32),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype=torch.float32))


def params_pair(jcfg, seed=0):
    jp = jax_init_params(jax_build_model(jcfg).init_specs(),
                         jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def batches(tcfg, n, B, S, seed):
    pipe = TokenPipeline(tcfg, global_batch=B, seq_len=S, seed=seed)
    return [pipe.batch_at(i) for i in range(n)]


@pytest.mark.parametrize("arch", MOE)
def test_moe_logits_loss_and_every_grad_match_jax(arch):
    """At 2 x 24 tokens deepseek's capacity rule (2TK/E = 12 picks an
    expert) can drop picks, as a training step's does."""
    jcfg, tcfg = cfg_pair(arch)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    jp, tp = params_pair(jcfg, seed=2)
    (batch,) = batches(tcfg, 1, 2, 24, seed=9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlog = jax.jit(japi.logits)(jp, jbatch)
    with torch.no_grad():
        tlog = tapi.logits(tp, tbatch)
    assert tlog.shape == (2, 24, tcfg.vocab)
    np.testing.assert_allclose(f32(tlog), f32(jlog), atol=1e-4, rtol=1e-4)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jp, jbatch)
    tl, tg = make_loss_and_grad(tapi, 1)(tp, tbatch)
    tflat, jflat = [f32(g) for g in leaves(tg)], jax.tree.leaves(jg)
    assert len(tflat) == len(jflat) == len(jax.tree.leaves(jp))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    for what, a, b in zip(paths, tflat, jflat):
        np.testing.assert_allclose(a, f32(b), rtol=1e-4, atol=1e-6,
                                   err_msg=what)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """Two AdamW steps of two microbatches each from the same params and
    batches: the losses at rtol 1e-5 and the parameters after them."""
    jcfg, tcfg = cfg_pair(arch)
    japi = jax_build_model(jcfg)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    bs = batches(tcfg, 2, 4, 16, seed=5)
    jstep, _, _, jinit = jax_make_train_step(
        japi, mesh, JaxAdamWConfig(**opt), microbatches=2)
    with jax.set_mesh(mesh):
        jparams, tparams = params_pair(jcfg, seed=1)
        jstate = jinit(jparams)
        jlosses = []
        for b in bs:
            jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            jlosses.append(float(m["loss"]))
        jfinal = [f32(x) for x in jax.tree.leaves(jstate["params"])]
    tstep, tinit, _ = make_train_step(build_model(tcfg), AdamWConfig(**opt),
                                   microbatches=2)
    tstate = tinit(tparams, device="cpu")
    tlosses = []
    for b in bs:
        tstate, m = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        tlosses.append(float(m["loss"]))
    assert all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    tfinal = leaves(tstate["params"])
    assert len(tfinal) == len(jfinal)
    for a, b in zip(tfinal, jfinal):
        np.testing.assert_allclose(f32(a), b, atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("name", ["TRAIN_4K", "PREFILL_32K", "DECODE_32K",
                                  "LONG_500K"])
def test_shape_fields_equal_reference(name):
    port, ref = getattr(shapes, name), getattr(jax_shapes, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [dataclasses.asdict(s) for s in shapes.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in jax_shapes.ALL_SHAPES]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_for_equals_reference(arch):
    got = [s.name for s in shapes.shapes_for(get_config(arch))]
    want = [s.name for s in jax_shapes.shapes_for(jax_get_config(arch))]
    assert got == want
