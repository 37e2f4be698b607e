"""The port's mesh serve step on Mamba2 and the RG-LRU hybrid (ROADMAP
item 7.4) against the JAX package's ``make_serve_step``, on the CPU
(``tests/torch_mesh_pair.py``'s harness).

Mamba2 is split by whole SSD heads and the RG-LRU by LRU channels
(``dist.sharding.state_specs``): a rank holds its heads' (channels')
weights and state, B and C whole, and sums the gated norm's mean of
squares, the RG-LRU's gate pre-activations and the output projections
once a layer a step.  The reference keeps the state whole over "model"
and lets the partitioner reshard; the gathered state is the same.

Cases, at SMOKE width on (1, 2), (2, 1), (2, 2) and (1, 4), under both
variants: mamba2-1.3b (8 SSD heads of 16, state 16: 4 or 2 a rank) and
recurrentgemma-9b (64 LRU channels, 4 heads over 1 KV head, copied on
every rank, window 32; one (rec, rec, attn) group and a rec tail).
"""

import pytest

from torch_mesh_pair import (VARIANTS, check_case, collectives, run_cases,
                             smoke_api, tag)

ALL = ((1, 2), (2, 1), (2, 2), (1, 4))
CASES = {                            # case -> (arch, meshes, overrides)
    "mamba2": ("mamba2-1.3b", ALL, {}),
    "recurrentgemma": ("recurrentgemma-9b", ALL, {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("mesh_state"), CASES)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case,mesh", [(c, m) for c, (_, ms, _) in
                                       CASES.items() for m in ms],
                         ids=lambda x: x if isinstance(x, str) else tag(x))
def test_state_mesh_step_matches_reference_variants(runs, case, mesh,
                                                    variant):
    check_case(runs, CASES, case, mesh, variant)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_do_not_depend_on_the_chunk(runs, case):
    """One sharded step's collectives at C=8 (the chunk) and at C=1 (a
    decode) are as many, on every rank: the embedding's sum and the
    vocab's gather, and per layer two for Mamba2 (the gated norm's sum
    of squares, out_proj), three for a rec layer (the gates, out_proj,
    the MLP) and two for an attention layer."""
    arch = CASES[case][0]
    cfg = smoke_api(arch, {}).cfg
    per = {"ssm": 2, "rec": 3, "attn": 2}
    want = 2 + sum(per[k] for k in cfg.pattern_for_layers())
    for mesh in ((1, 2), (2, 2), (1, 4)):
        for steps in collectives(runs, case, mesh):
            assert steps == [want] * len(steps), (mesh, steps, want)
    for steps in collectives(runs, case, (2, 1)):     # no model group
        assert steps == [0] * len(steps)
