"""The port's mesh train step for Mamba2 (mamba2-1.3b), the RG-LRU hybrid
(recurrentgemma-9b: one (rec, rec, attn) group and a tail layer at SMOKE
depth) and the VLM (internvl2-1b) against the JAX package's
``make_train_step`` on host meshes of the same shapes, on the CPU
(``tests/torch_train_mesh_pair.py``): float32 SMOKE weights from
``PRNGKey(0)``, 8 x 32 tokens (and internvl2's [8, 8, 56] patch
embeddings) from numpy seed 0, three AdamW steps of 2 microbatches on
(1, 2), (2, 1), (2, 2) and (1, 4).

A rank holds Mamba2's whole SSD heads (z, x and dt columns of
``in_proj``, x's conv channels; B and C whole, a ``Segments`` entry),
the RG-LRU's block of channels, whole query heads and whole or copied
KV heads (recurrentgemma's one KV head on every model rank; internvl2's
two at (1, 4) on two ranks each), with FSDP over "data" on the
contraction dims.

Gates, the dense file's: losses and grad norms within rtol 1e-5; every
gathered param within atol 1e-4; step 1's gathered grads within rtol
1e-4 / atol 1e-6 of ``jax.value_and_grad``.  Every whole segment and
replicated leaf (B and C's columns, the norms, a copied KV head) stays
bitwise equal across its holders, params and both moments.  The clip
norm counts each split segment on its model rank (``norm_share``).  Each
broken form, run at (1, 2), must miss the reference (``BROKEN``, each
with its reading on the CPU).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist.sharding import Segments, train_specs
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig
from repro_torch.train.optimizer import global_norm
from repro_torch.train.step import make_train_step
from torch_mesh_pair import shape_mesh, tag
from torch_train_mesh_pair import (LOSS_RTOL, MB, MESHES, PARAM_ATOL,
                                   broken_reading,
                                   check_grads, check_losses, check_params,
                                   gathered, run_cases, smoke_api)

CASES = {arch: (arch, MESHES)
         for arch in ("mamba2-1.3b", "recurrentgemma-9b", "internvl2-1b")}
# each broken form -> its case; the readings at (1, 2) on the CPU: loss
# and grad-norm relative gaps, param gap, step 1's grad excess (the
# largest ratio of an element's error to the grads' bound):
#   norm-sum      4.5e-4 / 3.8e-2 / 5.4e-3 / 2.0e4
#   bc-entry      6.1e-4 / 0.10   / 5.5e-3 / 3.0e4
#   segment-norm  1.6e-7 / 5.2e-3 / 6.2e-6 / 0.25 (the grads are right;
#                 Adam all but undoes the clip's other scale)
#   gate-sum      1.9e-4 / 2.7e-2 / 5.3e-3 / 1.1e4
BROKEN = {
    "norm-sum": "mamba2-1.3b",
    "bc-entry": "mamba2-1.3b",
    "segment-norm": "mamba2-1.3b",
    "gate-sum": "recurrentgemma-9b",
}
NORM_CASE = "mamba2-1.3b"
PAIRS = [(c, m) for c, (_, ms) in CASES.items() for m in ms]
IDS = [f"{c}-{tag(m)}" for c, m in PAIRS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("train_mesh_state"), CASES,
                     BROKEN, (NORM_CASE,))


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_losses_and_grad_norms_match_the_reference(runs, case, mesh):
    check_losses(*runs, case, mesh)


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_gathered_params_match_the_reference(runs, case, mesh):
    check_params(*runs, CASES[case][0], case, mesh)


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_step_one_grads_match_value_and_grad(runs, case, mesh):
    check_grads(*runs, CASES[case][0], case, mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_whole_segments_and_copies_stay_bitwise_equal(runs, mesh):
    """gather_params raises where two holders of a piece differ: Mamba2's
    B and C columns of ``in_proj`` and the conv, every norm, the RG-LRU's
    and the VLM's copied KV heads, every leaf a mesh axis leaves whole,
    params and both moments after three steps.  On the model ranks of
    data rank 0, B and C's columns are the same bytes and z's differ."""
    _, ranks = runs
    for case, (arch, _) in CASES.items():
        for what in ("params", "mu", "nu"):
            gathered(ranks, mesh, arch, case, what)
    m = mesh[1]
    if m == 1:
        return
    cfg = smoke_api("mamba2-1.3b").cfg
    di = cfg.ssm_expand * cfg.d_model // m
    n = cfg.ssm_state
    a = [r for r, _ in ranks[mesh][:m]]
    for what in ("params", "mu", "nu"):
        key = f"mamba2-1.3b/{what}/group/b0_ssm/ssm/"
        for r in range(1, m):
            np.testing.assert_array_equal(
                a[0][key + "in_proj"][..., 2 * di:2 * di + 2 * n],
                a[r][key + "in_proj"][..., 2 * di:2 * di + 2 * n])
            np.testing.assert_array_equal(a[0][key + "conv_w"][:, di:],
                                          a[r][key + "conv_w"][:, di:])
            assert not np.array_equal(a[0][key + "in_proj"][..., :di],
                                      a[r][key + "in_proj"][..., :di])
    for key in ("recurrentgemma-9b/params/group/b2_attn/attn/wk",
                "recurrentgemma-9b/nu/tail/t0_rec/norm1/w"):
        for r in range(1, m):
            np.testing.assert_array_equal(a[0][key], a[r][key])


@pytest.mark.parametrize("mesh", MESHES, ids=tag)
def test_clip_norm_counts_split_segments(runs, mesh):
    """``sharded_norm`` of mamba2's step-1 grads as the ranks hold them,
    each rank counting what ``norm_share`` gives it, equals the global
    norm of the gathered grads; ``first_holder`` alone, which counts a
    ``Segments`` leaf on model rank 0 only, drops the z, x and dt blocks
    of the other model ranks and reads lower wherever "model" splits
    (1.6730 at (1, 2) and (2, 2), 1.6688 at (1, 4), against 1.6818)."""
    _, ranks = runs
    grads = gathered(ranks, mesh, "mamba2-1.3b", NORM_CASE, "grads")
    want = float(global_norm({k: torch.from_numpy(v)
                              for k, v in grads.items()}))
    for _, rec in ranks[mesh]:
        got, old = rec["norm"][NORM_CASE]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        if mesh[1] == 1:
            assert old == got
        else:
            assert old < want * (1 - 1e-3), (old, want)


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_forms_miss_the_reference(runs, name):
    """Each broken form at (1, 2) lands outside the gates: step 1's grads
    (the two sums with an identity backward, no entry on B and C) or the
    grad norm (the old clip count; its grads are right)."""
    jax_out, ranks = runs
    case = BROKEN[name]
    got = broken_reading(jax_out, ranks, CASES[case][0], case, name)
    if name == "segment-norm":
        assert got["grads"] <= 1, got
        assert got["grad_norm"] > LOSS_RTOL, got
    else:
        assert got["grads"] > 1, got
    assert got["params"] > PARAM_ATOL or got["grad_norm"] > LOSS_RTOL, got


def model_collectives(arch: str, m: int) -> dict:
    """The collectives over "model" of one step at model = ``m`` > 1, by
    kind.  A microbatch: the embedding's sum and the head's entry (2
    all_reduce) and the logits' gather (1 all_gather); a layer, in the
    forward, the remat recompute and the backward (the recompute of a
    layer group stops after the last product whose input the backward
    keeps, so the group's last sum does not run again):

      * Mamba2 (a group of one layer): the gated norm's sum (forward,
        recompute, backward), ``out_proj``'s sum (forward), the entries
        on ``u`` and on B and C (backward): 6;
      * an RG-LRU layer within its group: the gates' sum, ``out_proj``'s
        and the MLP's (forward and recompute; the gates' backward too),
        the entries on ``u`` and before the MLP (backward): 9; in the
        tail, which runs without remat: 6;
      * an attention layer last in its group: its sum (forward,
        recompute), the MLP's (forward), two entries (backward): 5.

    A KV head copied onto every model rank (recurrentgemma's one) sums
    its ``wk`` and ``wv`` grads over the model group once a step."""
    cfg = smoke_api(arch).cfg
    if cfg.family == "ssm":
        per_mb = 6 * cfg.n_layers
    elif cfg.family == "hybrid":
        per_mb = 9 + 9 + 5 + 6                   # one group, a tail rec
    else:
        per_mb = 5 * cfg.n_layers
    copied = 2 if cfg.n_kv_heads == 1 else 0
    return {"all_reduce": MB * (2 + per_mb) + copied, "all_gather": MB}


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_collectives_a_step(runs, case, mesh):
    """Each rank's collectives over "model" in step 2
    (``model_collectives``); over the mesh the clip norm's one
    all_reduce."""
    _, ranks = runs
    m = mesh[1]
    want = model_collectives(CASES[case][0], m)
    for _, rec in ranks[mesh]:
        got = {(k, a): n for k, a, n in rec["collectives"][case]}
        for kind, n in want.items():
            assert got.get((kind, "model"), 0) == (n if m > 1 else 0), \
                (kind, got)
        assert got[("all_reduce", "mesh")] == 1, got


def test_state_train_specs():
    """Full-width specs at (2, 2): Mamba2's ``in_proj`` keeps FSDP on D
    and takes ``Segments`` on its columns (z, x, dt by heads; B and C
    whole), ``out_proj`` rows by heads, ``A_log`` by heads; the RG-LRU's
    projections by channels with FSDP on D, ``w_i`` by rows."""
    mesh = shape_mesh(2, 2)
    api = build_model(get_config("mamba2-1.3b"))
    ssm = train_specs(api.cfg, mesh, api.init_specs())["group"]["b0_ssm"][
        "ssm"]
    seg = ssm["in_proj"][-1]
    assert ssm["in_proj"][:2] == (None, "data") and isinstance(seg, Segments)
    assert seg.parts == ((4096, True), (4096, True), (128, False),
                         (128, False), (64, True))
    assert ssm["out_proj"] == (None, "model", "data")
    assert ssm["A_log"] == ssm["norm_w"] == (None, "model")
    assert isinstance(ssm["conv_w"][1], Segments)
    api = build_model(get_config("recurrentgemma-9b"))
    specs = train_specs(api.cfg, mesh, api.init_specs())
    for lead, rec in (((None,), specs["group"]["b0_rec"]["rec"]),
                      ((), specs["tail"]["t0_rec"]["rec"])):
        assert rec["proj_x"] == rec["proj_gate"] == lead + ("data", "model")
        assert rec["w_i"] == rec["w_r"] == lead + ("model",)
        assert rec["out_proj"] == lead + ("model", "data")


def test_whole_heads_rule_for_the_full_vlm():
    """internvl2-1b's 14 heads split whole at model=2 and not at model=4
    (ROADMAP item 7.1)."""
    api = build_model(get_config("internvl2-1b"))
    step, init, specs = make_train_step(api, AdamWConfig(),
                                        mesh=shape_mesh(2, 2))
    assert callable(step) and callable(init) and specs is not None
    with pytest.raises(ValueError, match="item 7.1"):
        make_train_step(api, AdamWConfig(), mesh=shape_mesh(1, 4))
