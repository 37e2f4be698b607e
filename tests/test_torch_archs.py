"""Every architecture the port registers, against the JAX package's: the
config fields, serving weights cast as they are born (bitwise those of
``cast_params`` over the float32 draw), and one whole serve step (``lm_serve_step``: logits and
every cache leaf) at SMOKE width in the four cases of
tests/test_torch_model.py's ``STEP_CASES``, in float32 and bf16, for the
architectures this slice brought: deepseek-v2-lite-16b (MLA + MoE with a
shared expert), grok-1-314b (GQA, softcap 30, MoE 4 experts top-2),
qwen2-72b, minitron-8b (relu2) and starcoder2-7b (layernorm, gelu,
biases, window 32).  Weights are the JAX package's, carried across with
repro_torch.convert; the pools are random.

Tolerances: logits elementwise, atol = rtol = 1e-4 in float32 (the same
products summed in another order) and 2e-2 in bf16 (XLA and torch round
bf16 at other places: about one ulp of values O(1)); pools, which hold
values up to ~4 after a layer, to the same tol times max(1, max |pool|):
an entry near zero is a sum of products of that size and carries their
rounding (as tests/torch_engine_pair.py's ``KV_TOL``).

The MoE's routes: XLA and torch round a bf16 router logit on either side
of a top-k boundary when two logits are within one bf16 ulp (at SMOKE
width, 2 of the 4 deepseek bf16 cases have such a row).  A flipped row
takes another expert, a different result rather than a rounding of the
same one, so the MoE cases record every layer's picks in both packages
(the JAX step's layer scan unrolled) and pin the port's to the
reference's: each flip is named and fails the case unless, in bf16, the
port's two logits lie within one bf16 ulp (a near-tie that rounding
decides); in float32 any flip fails.  The rest of the step is then held
to the tolerances above on the same routes."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.blocks as jax_blocks
import repro_torch.models.layers as port_layers
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.scan_util import unroll_scans
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model, init_params
from repro_torch.train.optimizer import leaves

NEW_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b", "qwen2-72b",
             "minitron-8b", "starcoder2-7b")
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# as tests/test_torch_model.py (module docstring)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

T_PAGE = 8
PT = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
STEP_CASES = {
    # name: (lengths, n_new, C)
    "full_prefill_chunk": ([0, 0, 0], [8, 8, 0], 8),
    "partial_chunk_straddling_page": ([5, 3, 0], [8, 6, 0], 8),
    "decode_c1": ([9, 14, 0], [1, 1, 0], 1),
    "mixed_n_new_idle_slot": ([4, 10, 0], [8, 1, 0], 8),
}


def module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registered_config_fields_equal_reference(arch, which):
    ref = getattr(importlib.import_module(
        f"repro.configs.{module_name(arch)}"), which)
    port = get_config(arch, smoke=which == "SMOKE")
    ref_f = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    port_f = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
    assert set(ref_f) == set(port_f)
    for name, v in ref_f.items():
        if name in ("dtype", "param_dtype"):
            assert jnp.dtype(v).name == str(port_f[name]).split(".")[-1]
        else:
            assert port_f[name] == v, name
    assert port.kv_pages_per_seq(1000, 16) == ref.kv_pages_per_seq(1000, 16)
    assert port.pattern_for_layers() == ref.pattern_for_layers()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cast_at_birth_equals_cast_params(arch):
    """``init_params(..., dtype=cfg.dtype)`` gives, leaf for leaf, the
    bits and dtypes of ``cast_params(init_params(...))`` from the same
    generator: norms and FLOAT32_KEYS stay float32, the rest bf16."""
    cfg = get_config(arch, smoke=True)
    specs = build_model(cfg).init_specs()
    born = init_params(specs, torch.Generator().manual_seed(3),
                       device="cpu", dtype=cfg.dtype)
    cast = convert.cast_params(init_params(
        specs, torch.Generator().manual_seed(3), device="cpu"), cfg)
    a, b = leaves(born), leaves(cast)
    assert len(a) == len(b)
    assert {x.dtype for x in a} == {torch.float32, torch.bfloat16}
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def cfg_pair(arch, dtype):
    jd, td = DT[dtype]
    return (dataclasses.replace(jax_get_config(arch, smoke=True), dtype=jd),
            dataclasses.replace(get_config(arch, smoke=True), dtype=td))


_PARAMS = {}


def np_params(arch):
    """The JAX package's fp32 SMOKE weights of ``arch``, as numpy."""
    if arch not in _PARAMS:
        jcfg, _ = cfg_pair(arch, "float32")
        api = jax_build_model(jcfg)
        _PARAMS[arch] = jax.tree.map(
            np.asarray, jax_init_params(api.init_specs(),
                                        jax.random.PRNGKey(0)))
    return _PARAMS[arch]


class JaxRoutes:
    """The JAX block module's MoE calls, in order: each call's router
    logits [T, E] (float32) and top-k picks [T, K]."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = jax_blocks.moe_apply

        def wrapped(p, cfg, x):
            xt = x.reshape(-1, x.shape[-1])
            logits = (xt @ p["router"].astype(cfg.dtype)).astype(jnp.float32)
            picks = jax.lax.top_k(logits, cfg.top_k)[1]
            self.calls.append((np.asarray(logits), np.asarray(picks)))
            return inner(p, cfg, x)
        monkeypatch.setattr(jax_blocks, "moe_apply", wrapped)


class PinnedRoutes:
    """The port's top-k pinned to the JAX package's picks, call by call,
    so both packages run the rest of the step on the same routes; the
    port's own picks and logits are kept for ``flips``."""

    def __init__(self, monkeypatch, jax_routes):
        self.own = []
        self.jax = jax_routes
        inner = port_layers.top_k_experts

        def pinned(logits, K):
            _, own = inner(logits, K)
            self.own.append((logits.numpy().copy(), own.numpy()))
            picks = torch.from_numpy(
                self.jax.calls[len(self.own) - 1][1].astype(np.int64))
            return logits.gather(1, picks), picks
        monkeypatch.setattr(port_layers, "top_k_experts", pinned)

    def flips(self, C):
        """(layer, slot, position, gap, ulp) of every row whose own picks
        differ from the reference's: gap is the port's logit of its own
        pick less its logit of the reference's pick there (0 on an exact
        tie), the largest over the row's differing picks, and ulp one bf16
        ulp at the larger of those two logits."""
        assert len(self.own) == len(self.jax.calls)
        out = []
        for layer, ((logits, own), (_, ref)) in enumerate(
                zip(self.own, self.jax.calls)):
            for row in np.nonzero((own != ref).any(-1))[0]:
                pairs = [(logits[row, a], logits[row, b])
                         for a, b in zip(own[row], ref[row]) if a != b]
                gap = max(float(x - y) for x, y in pairs)
                top = max(max(abs(x), abs(y)) for x, y in pairs)
                out.append((layer, int(row) // C, int(row) % C, gap,
                            float(2.0 ** (np.floor(np.log2(top)) - 7))))
        return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_serve_step_matches_jax(arch, case, dtype, monkeypatch):
    lengths, n_new, C = STEP_CASES[case]
    jcfg, tcfg = cfg_pair(arch, dtype)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    rng = np.random.default_rng(len(case))
    B = 3
    jc = japi.init_caches(B, 32, T_PAGE)
    shapes = [tuple(p.shape) for p in jc["group"]["b0_attn"]]
    tc = tapi.init_caches(B, 32, T_PAGE, device="cpu")
    assert shapes == [tuple(p.shape) for p in tc["group"]["b0_attn"]]
    pools = tuple(np.asarray(jnp.asarray(
        rng.standard_normal(s).astype(np.float32), jcfg.dtype))
        for s in shapes)
    tokens = rng.integers(1, tcfg.vocab, (B, C)).astype(np.int32)
    np_caches = {"page_table": PT, "lengths": np.array(lengths, np.int32),
                 "group": {"b0_attn": pools}, "tail": {}}
    params = np_params(arch)
    routes = None
    if tcfg.n_experts:
        routes = PinnedRoutes(monkeypatch, JaxRoutes(monkeypatch))
    with unroll_scans():                      # eager layers: picks are seen
        j_logits, j_new = japi.serve_step(
            jax.tree.map(jnp.asarray, params), jnp.asarray(tokens),
            jax.tree.map(jnp.asarray, np_caches),
            jnp.asarray(n_new, jnp.int32))
    tcaches = convert.caches_from_numpy(np_caches, device="cpu")
    tcaches["tail"] = {}
    t_logits, t_new = tapi.serve_step(
        convert.params_from_numpy(params, device="cpu"),
        torch.from_numpy(tokens), tcaches,
        torch.tensor(n_new, dtype=torch.int32))
    if routes is not None:
        assert len(routes.own) == tcfg.n_layers
        flips = routes.flips(C)
        beyond = [f for f in flips if dtype != "bfloat16" or f[3] > f[4]]
        assert not beyond, (
            "route flips between the packages beyond a bf16 near-tie at "
            f"(layer, slot, position, gap, ulp): {beyond}")
    tol = TOL[dtype]
    assert t_logits.shape == (B, C, tcfg.vocab) and t_logits.dtype == tcfg.dtype
    for b in range(B):                    # valid rows only: idle slots
        k = n_new[b]                      # attend over page 0 by design
        np.testing.assert_allclose(t_logits[b, :k].float().numpy(),
                                   np.asarray(j_logits[b, :k], np.float32),
                                   atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_new["lengths"].numpy(),
                                  np.asarray(j_new["lengths"]))
    for tp, jp in zip(t_new["group"]["b0_attn"], j_new["group"]["b0_attn"]):
        got = tp[:, 1:].float().numpy()
        want = np.asarray(jp[:, 1:], np.float32)
        err = np.abs(got - want).max()
        assert err <= tol * max(1.0, np.abs(want).max()), (err, tol)
    assert t_new["group"]["b0_attn"][0] is tcaches["group"]["b0_attn"][0]
