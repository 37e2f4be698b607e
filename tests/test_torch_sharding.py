"""The port's partition rules (``repro_torch.dist.sharding``,
``repro_torch.models.spec.partition_specs``) against the reference's
(``repro.dist.sharding``, ``repro.models.spec``) on shape-only meshes
(the reference tests' ``FakeMesh`` idiom): ``serve_rules``,
``train_rules``, ``batch_axes``, ``fit_batch_axes``, every architecture's
``partition_specs`` and ``cache_specs`` equal the reference's, a spec
being the tuple of a ``PartitionSpec``.  The one difference is the
port's whole-head rule, asserted as such.  ``shard_params`` and
``gather_params`` round-trip every rank's shards bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist import sharding as ref_sharding
from repro.models import build_model as jax_build_model
from repro.models.spec import partition_specs as ref_partition_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import sharding
from repro_torch.launch.mesh import Mesh, rank_coords
from repro_torch.models import build_model, init_params
from repro_torch.models.spec import partition_specs


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
    "4x2": dict(data=4, model=2),
    "2x2": dict(data=2, model=2),
    "1x4": dict(data=1, model=4),
    "pod2": dict(pod=2, data=1, model=1),
    "model8": dict(model=8),
}


def is_spec(t) -> bool:
    """A port spec: per dim None, an axis name or a tuple of names."""
    return all(x is None or isinstance(x, str) or (
        isinstance(x, tuple) and all(isinstance(y, str) for y in x))
        for x in t)


def flat(tree, path=()):
    """{path: leaf} of nested dicts / tuples (a PartitionSpec is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flat(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)) and not isinstance(
            tree, jax.sharding.PartitionSpec) and not is_spec(tree):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat(t, path + (str(i),)))
        return out
    return {path: tree}


def as_port(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("name", list(MESHES))
def test_rule_tables_equal_reference(name):
    mesh = FakeMesh(**MESHES[name])
    assert sharding.serve_rules(mesh) == ref_sharding.serve_rules(mesh)
    for pod in (True, False):
        assert sharding.train_rules(mesh, include_pod_in_fsdp=pod) == \
            ref_sharding.train_rules(mesh, include_pod_in_fsdp=pod)
    assert sharding.batch_axes(mesh) == ref_sharding.batch_axes(mesh)
    for batch in (1, 2, 3, 4, 8, 16, 32, 64):
        assert sharding.fit_batch_axes(mesh, batch) == \
            ref_sharding.fit_batch_axes(mesh, batch), batch


@pytest.mark.parametrize("name", ["16x16", "2x16x16", "4x2", "1x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_equal_reference(arch, name):
    """Every leaf of every architecture's full-width parameter tree, under
    the serving and the training rules."""
    mesh = FakeMesh(**MESHES[name])
    ours = build_model(get_config(arch)).init_specs()
    theirs = jax_build_model(jax_get_config(arch)).init_specs()
    for rules in (sharding.serve_rules, sharding.train_rules):
        got = flat(partition_specs(ours, rules(mesh), mesh))
        want = {k: as_port(v) for k, v in flat(ref_partition_specs(
            theirs, getattr(ref_sharding, rules.__name__)(mesh),
            mesh)).items()}
        assert got == want


@pytest.mark.parametrize("name", ["16x16", "4x2", "2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, name):
    mesh = FakeMesh(**MESHES[name])
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch,
                                                             smoke=True)
    batch = 32 if mesh.shape["data"] == 16 else 8
    ours = build_model(cfg).init_caches(batch, 64, 16, device="cpu")
    japi = jax_build_model(jcfg)
    theirs = jax.eval_shape(lambda: japi.init_caches(batch, 64,
                                                     page_tokens=16))
    got = flat(sharding.cache_specs(mesh, ours))
    want = {k: as_port(v) for k, v in flat(jax.tree.map(
        lambda s: s, ref_sharding.cache_specs(mesh, theirs),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))).items()}
    assert got == want


def test_whole_head_rule_is_the_documented_difference():
    """qwen2-1.5b at model=4: the reference splits its two KV heads of 128
    into quarters of a 256-wide dim (and 12 heads into 3 a rank); the port
    splits whole heads only and refuses the mesh (ROADMAP item 7.1)."""
    mesh = FakeMesh(data=1, model=4)
    japi = jax_build_model(jax_get_config("qwen2-1.5b"))
    ref = ref_partition_specs(japi.init_specs(),
                              ref_sharding.serve_rules(mesh), mesh)
    attn = ref["group"]["b0_attn"]["attn"]
    cfg = get_config("qwen2-1.5b")
    assert cfg.n_kv_heads % 4 and (cfg.n_kv_heads * cfg.head_dim) % 4 == 0
    assert tuple(attn["wk"]) == (None, None, "model")    # inside a head
    assert tuple(attn["wq"]) == (None, None, "model")
    with pytest.raises(ValueError, match="item 7.1"):
        sharding.check_whole_heads(cfg, mesh)
    # where model divides both, the port takes the reference's specs
    sharding.check_whole_heads(cfg, FakeMesh(data=4, model=2))
    sharding.check_whole_heads(get_config("qwen2-72b"), mesh)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_and_gather_round_trip_bitwise(shape):
    cfg = dataclasses.replace(get_config("qwen2-72b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    axes = {"data": shape[0], "model": shape[1]}
    mesh0 = FakeMesh(**axes)
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    caches = api.init_caches(4, 32, 8, device="cpu")
    for pool in caches["group"]["b0_attn"]:
        pool.copy_(torch.randn(pool.shape, generator=torch.Generator()
                               .manual_seed(pool.numel())))
    specs = partition_specs(api.init_specs(), sharding.serve_rules(mesh0),
                            mesh0)
    cspecs = sharding.cache_specs(mesh0, caches)
    for tree, sp in ((params, specs), (caches, cspecs)):
        shards = [sharding.shard_params(tree, sp, Mesh(
            shape=axes, coords=rank_coords(axes, r), groups={}))
            for r in range(shape[0] * shape[1])]
        back = sharding.gather_params(shards, sp, Mesh(
            shape=axes, coords=rank_coords(axes, 0), groups={}))
        a, b = flat(back), flat(tree)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # a rank's pool holds its data shard's pages and its model shard's
    # KV heads (two KV heads at model=4 stay whole: cache_specs' fallback)
    mine = sharding.shard_params(caches, cspecs, Mesh(
        shape=axes, coords=rank_coords(axes, shape[0] * shape[1] - 1),
        groups={}))
    L, P, T, KV, hd = caches["group"]["b0_attn"][0].shape
    assert mine["group"]["b0_attn"][0].shape == (
        L, P // shape[0], T, KV // shape[1] if KV % shape[1] == 0 else KV, hd)


def test_rank_coords_are_row_major():
    axes = {"data": 2, "model": 3}
    got = [rank_coords(axes, r) for r in range(6)]
    want = np.arange(6).reshape(2, 3)
    for r, c in enumerate(got):
        assert want[c["data"], c["model"]] == r
