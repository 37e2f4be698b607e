"""The port's mesh train step for the encoder-decoder (whisper-large-v3 at
SMOKE width: 2 encoder and 2 decoder layers, 4 heads over 4, 16 frames)
against the JAX package's ``make_train_step`` on host meshes of the same
shapes, on the CPU (``tests/torch_train_mesh_pair.py``): float32 SMOKE
weights from ``PRNGKey(0)``, 8 x 32 tokens and [8, 16, 64] frames from
numpy seed 0, three AdamW steps of 2 microbatches on (1, 2), (2, 1),
(2, 2) and (1, 4).

A rank holds whole heads of the encoder's ``attn`` and the decoder's
``self_attn`` and ``cross_attn`` (KV = H: nothing is copied), its block
of the FFN and of the tied vocabulary, with FSDP over "data" on the
contraction dims; each layer's shards are gathered inside its remat'd
layer, the decoder looks its tokens up vocab-parallel, and the
encoder's output enters the decoder through one column-parallel entry.

Gates, the dense file's: losses and grad norms within rtol 1e-5; every
gathered param within atol 1e-4; step 1's gathered grads within rtol
1e-4 / atol 1e-6 of ``jax.value_and_grad``; every replicated leaf
bitwise equal across its holders.  Without the entry on the encoder's
output (``cross-entry``, at (1, 2)) the encoder's grads keep this rank's
heads' part and miss.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_mesh_pair import tag
from torch_train_mesh_pair import (MB, MESHES, PARAM_ATOL, broken_reading,
                                   check_grads, check_losses, check_params,
                                   gathered, run_cases, smoke_api)

ARCH = "whisper-large-v3"
CASES = {ARCH: (ARCH, MESHES)}
# the reading at (1, 2) on the CPU: loss and grad-norm relative gaps,
# param gap, step 1's grad excess (the largest ratio of an element's
# error to the grads' bound): 5.0e-4 / 1.9e-2 / 5.5e-3 / 2.3e3
BROKEN = {"cross-entry": ARCH}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("train_mesh_encdec"), CASES,
                     BROKEN)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_losses_and_grad_norms_match_the_reference(runs, mesh):
    check_losses(*runs, ARCH, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_gathered_params_match_the_reference(runs, mesh):
    check_params(*runs, ARCH, ARCH, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_step_one_grads_match_value_and_grad(runs, mesh):
    check_grads(*runs, ARCH, ARCH, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_replicated_leaves_stay_bitwise_equal(runs, mesh):
    """gather_params raises where two holders of a piece differ: the
    norms, ``bo`` and every leaf a mesh axis leaves whole, params and
    both moments after three steps; the encoder's and decoder's final
    norms are the same bytes on the model ranks of data rank 0."""
    _, ranks = runs
    for what in ("params", "mu", "nu"):
        gathered(ranks, mesh, ARCH, ARCH, what)
    a = [r for r, _ in ranks[mesh][:mesh[1]]]
    for key in ("enc_norm/w", "final_norm/b", "decoder/mlp/bo"):
        for r in range(1, mesh[1]):
            np.testing.assert_array_equal(a[0][f"{ARCH}/nu/{key}"],
                                          a[r][f"{ARCH}/nu/{key}"])


def test_no_cross_entry_misses_the_reference(runs):
    """Each layer's cross K/V read this rank's KV heads only: without the
    entry, the encoder's output keeps this rank's part of their grads,
    and every encoder weight misses."""
    jax_out, ranks = runs
    got = broken_reading(jax_out, ranks, ARCH, ARCH, "cross-entry")
    assert got["grads"] > 1 and got["params"] > PARAM_ATOL, got


def model_all_reduces() -> int:
    """The all_reduces over "model" of one step at model > 1: a
    microbatch's decoder embedding sum, the tied head's entry and the
    encoder output's entry (backward); an encoder layer's attention sum
    (forward and remat recompute), MLP sum (forward; the recompute stops
    before it) and two entries (backward): 5; a decoder layer's self and
    cross attention sums (forward, recompute), MLP sum (forward) and
    three entries (backward): 8."""
    cfg = smoke_api(ARCH).cfg
    return MB * (3 + 5 * cfg.n_enc_layers + 8 * cfg.n_dec_layers)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_collectives_a_step(runs, mesh):
    """Each rank's collectives over "model" in step 2: the all_reduces
    above and one logits gather a microbatch; the clip norm's one
    all_reduce over the mesh."""
    _, ranks = runs
    m = mesh[1]
    for _, rec in ranks[mesh]:
        got = {(k, a): n for k, a, n in rec["collectives"][ARCH]}
        assert got.get(("all_reduce", "model"), 0) == (
            model_all_reduces() if m > 1 else 0), got
        assert got.get(("all_gather", "model"), 0) == (MB if m > 1 else 0)
        assert got[("all_reduce", "mesh")] == 1, got
