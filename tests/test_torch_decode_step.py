"""``ModelAPI.decode_step`` (the C=1 slice of ``serve_step`` with ``n_new``
of ones) against the JAX package's ``api.decode_step`` for every SMOKE
architecture, in float32: the JAX package's weights carried across with
``repro_torch.convert``, the caches drawn at random from a seed (pools,
recurrent state, an encoder-decoder's cross K/V) on a page table whose
two sequences hold 9 and 14 tokens, and two decode steps in a row.

Tolerances as tests/test_torch_archs.py's float32 ones: logits atol =
rtol = 1e-4 (the same products summed in another order); every float
cache leaf within 1e-4 times max(1, its largest magnitude); lengths and
page table equal.  ``ModelConfig.has_decode_step`` is the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.tree import leaves
from repro_torch.models import build_model

TOL = 1e-4
B, MAX_SEQ, T_PAGE = 2, 32, 8
PAGE_TABLE = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
LENGTHS = np.array([9, 14], np.int32)


def random_caches(caches, rng):
    """The JAX package's cache tree with every float leaf drawn N(0, 1)
    and the page table and lengths above."""
    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "page_table" in name:
            return PAGE_TABLE
        if "lengths" in name:
            return LENGTHS
        return rng.standard_normal(leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, caches)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_jax(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32)
    assert tcfg.has_decode_step == jcfg.has_decode_step
    japi, tapi = jax_build_model(jcfg), build_model(tcfg)
    params = jax.tree.map(np.asarray, jax_init_params(
        japi.init_specs(), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(sum(map(ord, arch)))
    np_caches = random_caches(japi.init_caches(B, MAX_SEQ, T_PAGE), rng)
    jc = jax.tree.map(jnp.asarray, np_caches)
    tc = convert.caches_from_numpy(np_caches, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, device="cpu")
    for step in range(2):
        tokens = rng.integers(1, tcfg.vocab, (B, 1)).astype(np.int32)
        j_logits, jc = japi.decode_step(jp, jnp.asarray(tokens), jc)
        t_logits, tc = tapi.decode_step(tp, torch.from_numpy(tokens), tc)
        assert t_logits.shape == (B, 1, tcfg.vocab)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=TOL, rtol=TOL, err_msg=f"step {step}")
        want = jax.tree.leaves(jc)
        got = leaves(tc)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            if not np.issubdtype(w.dtype, np.floating):
                np.testing.assert_array_equal(g.numpy(), w)
                continue
            err = np.abs(g.numpy() - w).max()
            assert err <= TOL * max(1.0, np.abs(w).max()), (step, err)
    np.testing.assert_array_equal(tc["lengths"].numpy(), LENGTHS + 2)
