"""The port's partition rules (``repro_torch.dist.sharding``,
``repro_torch.models.spec.partition_specs``) against the reference's
(``repro.dist.sharding``, ``repro.models.spec``) on shape-only meshes
(the reference tests' ``FakeMesh`` idiom): ``serve_rules``,
``train_rules``, ``batch_axes``, ``fit_batch_axes``, every architecture's
``partition_specs`` and ``cache_specs`` equal the reference's, a spec
being the tuple of a ``PartitionSpec``.  The one difference is the
port's head rule (``head_specs``: replicated KV heads copied whole
where the reference splits inside a head), asserted as such.
``shard_params`` and ``gather_params`` round-trip every rank's shards
bitwise.
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
    """A port spec: per dim None, an axis name, a tuple of names or one
    of the port's own entries (``Copies``, ``Segments``)."""
    return all(x is None or isinstance(x, (str, sharding.Copies,
                                           sharding.Segments)) or (
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


def port_specs(arch: str, mesh, smoke: bool = False):
    """The port's serving specs (``head_specs`` over the reference's
    rules) of ``arch``'s parameters and of its caches (8 slots of 64
    tokens in pages of 16)."""
    api = build_model(get_config(arch, smoke=smoke))
    like = api.init_specs()
    caches = api.init_caches(8, 64, 16, device="cpu") if smoke else None
    cspecs = sharding.cache_specs(mesh, caches) if smoke else {}
    pspecs, cspecs = sharding.head_specs(
        api.cfg, mesh, partition_specs(like, sharding.serve_rules(mesh),
                                       mesh), cspecs, like, caches or {})
    return pspecs, cspecs, caches


def test_whole_head_rule_is_the_documented_difference():
    """qwen2-1.5b at model=4: the reference splits its two KV heads of 128
    into quarters of the 256-wide dim (and 12 heads into 3 a rank) and
    keeps the whole pool on every rank; the port copies each KV head onto
    the two ranks whose query heads read it (``Copies``): rank r holds KV
    head r // 2, in ``wk`` / ``wv`` / ``bk`` / ``bv`` and in its pool.  A
    model axis that does not divide the query heads, or that neither
    divides nor is divided by the KV heads, raises (ROADMAP item 7.1);
    where it divides both, the port takes the reference's specs."""
    mesh = FakeMesh(data=1, model=4)
    japi = jax_build_model(jax_get_config("qwen2-1.5b"))
    ref = ref_partition_specs(japi.init_specs(),
                              ref_sharding.serve_rules(mesh), mesh)
    attn = ref["group"]["b0_attn"]["attn"]
    cfg = get_config("qwen2-1.5b")
    assert cfg.n_kv_heads % 4 and (cfg.n_kv_heads * cfg.head_dim) % 4 == 0
    assert tuple(attn["wk"]) == (None, None, "model")    # inside a head
    assert tuple(attn["wq"]) == (None, None, "model")
    pspecs, _, _ = port_specs("qwen2-1.5b", mesh)
    mine = pspecs["group"]["b0_attn"]["attn"]
    copies = sharding.Copies("model", cfg.n_kv_heads)
    for k in ("wk", "wv", "bk", "bv"):
        assert mine[k][-1] == copies, k
    assert mine["wq"] == tuple(attn["wq"]) and mine["wo"] == tuple(
        attn["wo"])
    hd = cfg.head_dim
    for r in range(4):
        m = Mesh(shape={"data": 1, "model": 4},
                 coords={"data": 0, "model": r}, groups={})
        shape, block = sharding.shard_block(
            (cfg.n_layers, cfg.d_model, cfg.n_kv_heads * hd), mine["wk"], m)
        assert shape == (cfg.n_layers, cfg.d_model, hd) and block == r // 2
    # the SMOKE config's pools: [L, P, T, 1, hd] a rank, the same copy rule
    smoke = FakeMesh(data=1, model=4)
    _, cspecs, caches = port_specs("qwen2-1.5b", smoke, smoke=True)
    for spec, pool in zip(cspecs["group"]["b0_attn"],
                          caches["group"]["b0_attn"]):
        assert spec[3:] == (copies,), spec
        m = Mesh(shape={"data": 1, "model": 4},
                 coords={"data": 0, "model": 3}, groups={})
        assert sharding.shard_block(pool.shape, spec, m) == (
            pool.shape[:3] + (1, pool.shape[4]), 1)
    for arch, axes in (("qwen2-1.5b", dict(data=1, model=8)),
                       ("qwen2-1.5b", dict(data=1, model=3))):
        with pytest.raises(ValueError, match="item 7.1"):
            port_specs(arch, FakeMesh(**axes))
    for arch, axes in (("qwen2-1.5b", dict(data=4, model=2)),
                       ("qwen2-72b", dict(data=1, model=4)),
                       ("deepseek-v2-lite-16b", dict(data=1, model=4))):
        m = FakeMesh(**axes)
        got, _, _ = port_specs(arch, m)
        want = ref_partition_specs(
            jax_build_model(jax_get_config(arch)).init_specs(),
            ref_sharding.serve_rules(m), m)
        assert flat(got) == {k: as_port(v) for k, v in flat(want).items()}


def test_replicated_kv_heads_round_trip_and_copies_must_agree():
    """qwen2-1.5b's SMOKE tree at (1, 4): the shards of every rank gather
    back to the whole tree bitwise (one copy of each KV head taken), and a
    rank whose copy differs makes ``gather_params`` raise."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    axes = {"data": 1, "model": 4}
    pspecs, cspecs, caches = port_specs("qwen2-1.5b", FakeMesh(**axes),
                                        smoke=True)
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    for pool in caches["group"]["b0_attn"]:
        pool.copy_(torch.randn(pool.shape, generator=torch.Generator()
                               .manual_seed(pool.numel())))
    meshes = [Mesh(shape=axes, coords=rank_coords(axes, r), groups={})
              for r in range(4)]
    for tree, sp in ((params, pspecs), (caches, cspecs)):
        shards = [sharding.shard_params(tree, sp, m) for m in meshes]
        back = sharding.gather_params(shards, sp, meshes[0])
        a, b = flat(back), flat(tree)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    shards = [sharding.shard_params(caches, cspecs, m) for m in meshes]
    assert shards[1]["group"]["b0_attn"][0].shape[-2] == 1
    shards[1]["group"]["b0_attn"][0][0, 1, 0, 0, 0] += 1.0
    with pytest.raises(ValueError, match="copies of block"):
        sharding.gather_params(shards, cspecs, meshes[0])


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


def segment_meshes(axes: dict) -> list:
    return [Mesh(shape=axes, coords=rank_coords(axes, r), groups={})
            for r in range(axes["data"] * axes["model"])]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_state_rule_round_trip_bitwise(arch):
    """The SMOKE tree and caches (random state) of each recurrent family
    at (2, 2): every rank's shards, ``Segments`` entries included, gather
    back to the whole tree bitwise, B and C of Mamba2 taken once; a
    rank's in_proj holds its heads' z, x and dt and the whole B and C."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    axes = {"data": 2, "model": 2}
    pspecs, cspecs, caches = state_port_specs(arch, FakeMesh(**axes))
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    gen = torch.Generator().manual_seed(1)
    for leaf in flat(caches).values():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    meshes = segment_meshes(axes)
    for tree, sp in ((params, pspecs), (caches, cspecs)):
        shards = [sharding.shard_params(tree, sp, m) for m in meshes]
        back = sharding.gather_params(shards, sp, meshes[0])
        a, b = flat(back), flat(tree)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    if arch == "mamba2-1.3b":
        di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        nh = di // cfg.ssm_head_dim
        w = params["group"]["b0_ssm"]["ssm"]["in_proj"]
        mine = sharding.shard_params(params, pspecs, meshes[3])
        got = mine["group"]["b0_ssm"]["ssm"]["in_proj"]
        h = di // 2                     # rank (1, 1): model block 1
        want = torch.cat([w[..., h:di], w[..., di + h:2 * di],
                          w[..., 2 * di:2 * di + 2 * n],
                          w[..., 2 * di + 2 * n + nh // 2:]], dim=-1)
        assert torch.equal(got, want)
        assert sharding.shard_block(w.shape, pspecs["group"]["b0_ssm"]["ssm"]
                                    ["in_proj"], meshes[3])[0] == \
            tuple(w.shape[:-1]) + (di + 2 * n + nh // 2,)


def test_unequal_copies_of_a_whole_segment_raise():
    """Mamba2's B columns of in_proj (and the conv state's B channels)
    are whole on every rank: a rank whose copy differs makes
    ``gather_params`` raise."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              dtype=torch.float32)
    api = build_model(cfg)
    axes = {"data": 1, "model": 2}
    pspecs, cspecs, caches = state_port_specs("mamba2-1.3b",
                                              FakeMesh(**axes))
    params = init_params(api.init_specs(), torch.Generator().manual_seed(0),
                         device="cpu")
    meshes = segment_meshes(axes)
    di = cfg.ssm_expand * cfg.d_model
    shards = [sharding.shard_params(params, pspecs, m) for m in meshes]
    # rank 1's in_proj: z | x of its heads (di/2 each), then B
    shards[1]["group"]["b0_ssm"]["ssm"]["in_proj"][0, 0, di] += 1.0
    with pytest.raises(ValueError, match="copies of block"):
        sharding.gather_params(shards, pspecs, meshes[0])
    shards = [sharding.shard_params(caches, cspecs, m) for m in meshes]
    shards[1]["group"]["b0_ssm"]["conv"][0, 0, 0, di // 2] += 1.0
    with pytest.raises(ValueError, match="copies of block"):
        sharding.gather_params(shards, cspecs, meshes[0])


def state_port_specs(arch: str, mesh, smoke: bool = True):
    """The port's serving specs of ``arch`` (the head rule, then the
    state rule, over the reference's) and its caches (8 slots of 64
    tokens in pages of 16)."""
    api = build_model(get_config(arch, smoke=smoke))
    like = api.init_specs()
    caches = api.init_caches(8, 64, 16, device="cpu")
    pspecs, cspecs = sharding.head_specs(
        api.cfg, mesh, partition_specs(like, sharding.serve_rules(mesh),
                                       mesh),
        sharding.cache_specs(mesh, caches), like, caches)
    pspecs, cspecs = sharding.state_specs(api.cfg, mesh, pspecs, cspecs,
                                          like, caches)
    return pspecs, cspecs, caches


def test_state_rule_is_the_documented_difference():
    """At model=4 the reference cuts Mamba2's in_proj (z | x | B | C |
    dt) into contiguous column blocks that cross the segments, keeps
    conv_w, A_log, D_skip, dt_bias and the ssd and conv state whole and
    lets the partitioner reshard; the port splits whole SSD heads
    (``Segments``: z, x and dt by heads, B and C whole; the state on its
    head dim and x channels).  The RG-LRU's parameters are the
    reference's own layout (w_i / w_r rows split, columns whole); its h
    and conv state, whole in the reference, split by channels.  Every
    other leaf is the reference's.  A model axis that does not divide
    the SSD heads or the LRU channels raises."""
    mesh = FakeMesh(data=1, model=4)
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = get_config(arch)
        japi = jax_build_model(jax_get_config(arch))
        ref = flat(ref_partition_specs(japi.init_specs(),
                                       ref_sharding.serve_rules(mesh), mesh))
        pspecs, cspecs, caches = state_port_specs(arch, mesh, smoke=False)
        got = flat(pspecs)
        ref_caches = flat(sharding.cache_specs(mesh, caches))
        if arch == "mamba2-1.3b":
            di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
            nh = di // cfg.ssm_head_dim
            ssm = ("group", "b0_ssm", "ssm")
            xbc = sharding.Segments("model", ((di, True), (n, False),
                                              (n, False)))
            want = {
                "in_proj": (None, None, sharding.Segments(
                    "model", ((di, True), (di, True), (n, False),
                              (n, False), (nh, True)))),
                "conv_w": (None, xbc), "conv_b": (None, xbc),
                "A_log": (None, "model"), "D_skip": (None, "model"),
                "dt_bias": (None, "model"), "norm_w": (None, "model"),
                "out_proj": (None, "model")}
            assert tuple(ref[ssm + ("in_proj",)]) == (None, None, "model")
            for k in ("conv_w", "A_log", "D_skip", "dt_bias"):
                assert tuple(ref[ssm + (k,)]) in ((), (None, "model")), k
            diff = {p[-1]: s for p, s in got.items()
                    if s != tuple(ref[p])}
            assert {p[-1]: got[p] for p in got if p[:3] == ssm} == want
            assert set(diff) <= set(want)
            state = {"ssd": (None, "data", "model"),
                     "conv": (None, "data", None, xbc)}
            kind = ("group", "b0_ssm")
        else:
            rec = ("group", "b0_rec", "rec")
            assert tuple(ref[rec + ("w_i",)]) == (None, "model")
            assert {p: s for p, s in got.items()    # attn: the head rule
                    if s != tuple(ref[p]) and "attn" not in p} == {}
            state = {"h": (None, "data", "model"),
                     "conv": (None, "data", None, "model")}
            kind = ("group", "b0_rec")
        for k, spec in state.items():
            assert ref_caches[kind + (k,)] == (None, "data")  # model: whole
            assert flat(cspecs)[kind + (k,)] == spec, k
        assert {p: s for p, s in flat(cspecs).items() if s != ref_caches[p]
                and p[-1] not in state and not p[1].endswith("attn")} == {}
    for arch, m in (("mamba2-1.3b", 3), ("recurrentgemma-9b", 3)):
        with pytest.raises(ValueError, match="does not divide"):
            state_port_specs(arch, FakeMesh(data=1, model=m), smoke=False)
