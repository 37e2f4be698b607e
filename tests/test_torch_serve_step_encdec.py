"""The port's mesh serve step on the encoder-decoder and the VLM
(ROADMAP item 7.5) against the JAX package's ``make_serve_step``, on the
CPU (``tests/torch_mesh_pair.py``'s harness).

whisper-large-v3's decoder splits its self-attention pools and its cross
K/V by KV heads over "model" and by rows over "data"; each rank computes
its own heads' cross K/V (``encdec_prefill_cross`` over its shards) from
the whole encoder's output of its rows, and sums the cross attention's
``wo`` partials once a layer a step.  internvl2-1b serves through the
dense step (neither package's serve step takes the patch embeddings).

Cases, at SMOKE width on (1, 2), (2, 1), (2, 2) and (1, 4), under both
variants: whisper (4 heads over 4 KV heads, 16 encoder frames) and
internvl2 (4 heads over 2 KV heads, copied at model=4); and internvl2
with a vocabulary of 513 on (1, 2) and (2, 2), which model=2 does not
divide: the embedding and the head stay whole on every rank (the
divisibility fallback) and no vocab gather runs, as internvl2-1b's
151655 at model=2.
"""

import pytest

from torch_mesh_pair import (B, MAX_SEQ, PAGE, VARIANTS, check_case,
                             collectives, run_cases, shape_mesh, smoke_api,
                             tag)
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.step import make_serve_step

ALL = ((1, 2), (2, 1), (2, 2), (1, 4))
CASES = {                            # case -> (arch, meshes, overrides)
    "whisper": ("whisper-large-v3", ALL, {}),
    "internvl2": ("internvl2-1b", ALL, {}),
    "internvl2-v513": ("internvl2-1b", ((1, 2), (2, 2)), {"vocab": 513}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("mesh_encdec"), CASES)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case,mesh", [(c, m) for c, (_, ms, _) in
                                       CASES.items() for m in ms],
                         ids=lambda x: x if isinstance(x, str) else tag(x))
def test_encdec_vlm_mesh_step_matches_reference_variants(runs, case, mesh,
                                                         variant):
    check_case(runs, CASES, case, mesh, variant)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_do_not_depend_on_the_chunk(runs, case):
    """One sharded step's collectives at C=8 and at C=1 are as many, on
    every rank: the embedding's sum and the vocab's gather (neither
    where the vocabulary stays whole), and per layer the self
    attention's, the cross attention's (whisper) and the MLP's sums."""
    arch, meshes, over = CASES[case]
    cfg = smoke_api(arch, over).cfg
    split_vocab = cfg.vocab % 2 == 0
    per_layer = 3 if cfg.family == "encdec" else 2
    layers = cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers
    want = 2 * split_vocab + per_layer * layers
    for mesh in meshes:
        for steps in collectives(runs, case, mesh):
            assert steps == [want if mesh[1] > 1 else 0] * len(steps), \
                (mesh, steps, want)


def test_internvl2_vocab_stays_whole_at_model_2():
    """internvl2-1b's 151655 rows do not split over model=2: the
    embedding (tied, so the head too) stays whole on every rank."""
    cfg = get_config("internvl2-1b")
    assert cfg.vocab % 2 and cfg.tie_embeddings
    api = build_model(cfg)
    caches = api.init_caches(B, MAX_SEQ, PAGE, device="cpu")
    _, pspecs, _ = make_serve_step(api, shape_mesh(1, 2), caches)
    assert pspecs["embed"] == ()
    assert pspecs["group"]["b0_attn"]["attn"]["wq"][-1] == "model"
