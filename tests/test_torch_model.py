"""The port's model modules against the JAX package on qwen2-1.5b SMOKE:
config fields, parameter conversion key for key, norms, MLPs, RoPE, chunk
addressing, and the whole serve step (logits and every cache leaf) in the
four cases of a full prefill chunk, a partial chunk straddling a page,
decode at C=1, and mixed n_new with an idle slot.  Weights are the JAX
package's, carried across with repro_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.attention import apply_rope as jax_apply_rope
from repro.models.attention import paged_chunk_ids as jax_paged_chunk_ids
from repro.models.layers import mlp_apply as jax_mlp_apply
from repro.models.layers import norm_apply as jax_norm_apply
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs import qwen2_1_5b as port_qwen
from repro_torch.models import build_model, init_params
from repro_torch.models.attention import apply_rope, paged_chunk_ids
from repro_torch.models.layers import mlp_apply, norm_apply
from repro_torch.models.spec import tree_map_specs

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: same arithmetic, other summation order.  bf16: XLA and torch round
# bf16 at different places (matmul outputs, bias adds, the attention cast).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def cfg_pair(dtype="float32", **kw):
    jd, td = DT[dtype]
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b", smoke=True),
                               dtype=jd, **kw)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                               dtype=td, **kw)
    return jcfg, tcfg


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = cfg_pair()
    api = jax_build_model(jcfg)
    params = jax_init_params(api.init_specs(), jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------- config + params


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_fields_equal_reference(which):
    import repro.configs.qwen2_1_5b as ref_mod
    ref, port = getattr(ref_mod, which), getattr(port_qwen, which)
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


def test_unported_archs_raise_with_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("whisper-large-v3")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                                        family="moe"))


def test_params_from_numpy_key_for_key(jax_params):
    """Converted parameters equal the JAX ones leaf for leaf, and the
    port's own ParamSpec tree has exactly the same keys and shapes."""
    params, np_params = jax_params
    _, tcfg = cfg_pair()
    tparams = convert.params_from_numpy(np_params, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_t = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat_t[path] = node
    walk(tparams, ())
    assert len(flat_t) == len(jleaves)
    for path, leaf in jleaves:
        key = tuple(p.key for p in path)
        np.testing.assert_array_equal(flat_t[key].numpy(), np.asarray(leaf))
    specs = {}
    tree_map_specs(lambda s: specs.setdefault(len(specs), s.shape),
                   build_model(tcfg).init_specs())
    assert sorted(specs.values()) == sorted(
        tuple(np.shape(leaf)) for _, leaf in jleaves)
    # port init_params: same tree, generator-drawn, zeros/ones rules kept
    g = torch.Generator(device="cpu").manual_seed(0)
    own = init_params(build_model(tcfg).init_specs(), g, device="cpu")
    assert own["group"]["b0_attn"]["attn"]["bq"].eq(0).all()
    assert own["final_norm"]["w"].eq(1).all()
    assert abs(float(own["embed"].std()) - 0.02) < 0.005


def test_bf16_leaves_round_trip_through_uint16_view():
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 24).reshape(2, 3, 4),
                               jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    t = convert.caches_from_numpy({"a": (x,)}, device="cpu")["a"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy(t), x.astype(np.float32))


def test_cast_params_keeps_norms_in_f32(jax_params):
    _, np_params = jax_params
    _, tcfg = cfg_pair("bfloat16")
    cast = convert.cast_params(
        convert.params_from_numpy(np_params, device="cpu"), tcfg)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["group"]["b0_attn"]["attn"]["bq"].dtype == torch.bfloat16
    assert cast["group"]["b0_attn"]["norm1"]["w"].dtype == torch.float32
    assert cast["final_norm"]["w"].dtype == torch.float32


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_jax(norm, dtype):
    rng = np.random.default_rng(0)
    jcfg, tcfg = cfg_pair(dtype, norm=norm)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    p = {"w": rng.standard_normal(48).astype(np.float32),
         "b": rng.standard_normal(48).astype(np.float32)}
    out_j = jax_norm_apply(jax.tree.map(jnp.asarray, p), jcfg,
                           jnp.asarray(x, jcfg.dtype))
    out_t = norm_apply({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                       torch.from_numpy(x).to(tcfg.dtype))
    assert out_t.dtype == tcfg.dtype
    np.testing.assert_allclose(f32(out_t), f32(out_j), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_apply_matches_jax(mlp, dtype):
    rng = np.random.default_rng(1)
    # gelu runs with layernorm so the bias-ful variant (bi/bo) is covered
    norm = "layernorm" if mlp == "gelu" else "rmsnorm"
    jcfg, tcfg = cfg_pair(dtype, mlp=mlp, norm=norm)
    from repro_torch.models.layers import mlp_init
    specs = mlp_init(tcfg)
    p = tree_map_specs(
        lambda s: (rng.standard_normal(s.shape) / 8).astype(np.float32), specs)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    out_j = jax_mlp_apply(jax.tree.map(jnp.asarray, p), jcfg,
                          jnp.asarray(x, jcfg.dtype))
    out_t = mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                      torch.from_numpy(x).to(tcfg.dtype))
    np.testing.assert_allclose(f32(out_t), f32(out_j), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("rot_dims", [None, 8])
def test_apply_rope_matches_jax(rot_dims):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 12)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 6)).astype(np.int32)
    out_j = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, rot_dims)
    out_t = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       rot_dims)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4,
                               rtol=1e-4)


def test_paged_chunk_ids_match_jax_including_clamp():
    pt = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    lens = np.array([5, 9], np.int32)            # second row runs past N*T
    for C in (1, 4, 8):
        ref = jax_paged_chunk_ids(jnp.asarray(pt), jnp.asarray(lens), C, 4)
        out = paged_chunk_ids(torch.from_numpy(pt), torch.from_numpy(lens),
                              C, 4)
        for a, b in zip(out, ref):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------- serve step

T_PAGE = 8
PT = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
STEP_CASES = {
    # name: (lengths, n_new, C)
    "full_prefill_chunk": ([0, 0, 0], [8, 8, 0], 8),
    "partial_chunk_straddling_page": ([5, 3, 0], [8, 6, 0], 8),
    "decode_c1": ([9, 14, 0], [1, 1, 0], 1),
    "mixed_n_new_idle_slot": ([4, 10, 0], [8, 1, 0], 8),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_lm_serve_step_matches_jax(jax_params, case, dtype):
    lengths, n_new, C = STEP_CASES[case]
    _, np_params = jax_params
    jcfg, tcfg = cfg_pair(dtype)
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    rng = np.random.default_rng(len(case))
    B, P = 3, 12
    jc = japi.init_caches(B, 32, T_PAGE)
    assert jc["group"]["b0_attn"][0].shape == (2, P, T_PAGE, 2, 12)
    pools = tuple(rng.standard_normal((2, P, T_PAGE, 2, 12)).astype(np.float32)
                  for _ in range(2))
    tokens = rng.integers(1, 512, (B, C)).astype(np.int32)
    np_caches = {"page_table": PT, "lengths": np.array(lengths, np.int32),
                 "group": {"b0_attn": tuple(
                     np.asarray(jnp.asarray(p, jcfg.dtype)) for p in pools)},
                 "tail": {}}
    jcaches = jax.tree.map(jnp.asarray, np_caches)
    tcaches = convert.caches_from_numpy(np_caches, device="cpu")
    tcaches["tail"] = {}
    j_logits, j_new = japi.serve_step(jax.tree.map(jnp.asarray, np_params),
                                      jnp.asarray(tokens), jcaches,
                                      jnp.asarray(n_new, jnp.int32))
    t_logits, t_new = tapi.serve_step(
        convert.params_from_numpy(np_params, device="cpu"),
        torch.from_numpy(tokens), tcaches,
        torch.tensor(n_new, dtype=torch.int32))
    tol = TOL[dtype]
    assert t_logits.shape == (B, C, tcfg.vocab) and t_logits.dtype == tcfg.dtype
    for b in range(B):                    # valid rows only: idle slots
        k = n_new[b]                      # attend over page 0 by design
        np.testing.assert_allclose(f32(t_logits[b, :k]), f32(j_logits[b, :k]),
                                   atol=tol, rtol=tol)
    np.testing.assert_array_equal(t_new["lengths"].numpy(),
                                  np.asarray(j_new["lengths"]))
    np.testing.assert_array_equal(t_new["page_table"].numpy(), PT)
    for tp, jp in zip(t_new["group"]["b0_attn"], j_new["group"]["b0_attn"]):
        np.testing.assert_allclose(f32(tp)[:, 1:], f32(jp)[:, 1:], atol=tol,
                                   rtol=tol)
    # the step updated the caller's pools in place
    assert t_new["group"]["b0_attn"][0] is tcaches["group"]["b0_attn"][0]
