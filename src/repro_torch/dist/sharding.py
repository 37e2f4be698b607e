"""Mesh-shape-driven partition rules and the per-rank shards they give:
the port's counterpart of ``repro/dist/sharding.py``.

Rules map the models' logical axis names (on every ``ParamSpec``) to
mesh axes; ``models.spec.spec_for`` applies them with the reference's
divisibility fallback.  The rule functions are pure functions of
``mesh.shape`` (a mapping of axis name to size), so a shape-only stand-in
works, and they return the port's specs: per-dim tuples equal to
``tuple(P(...))`` of the reference's ``PartitionSpec``s.

``shard_params`` slices each leaf of a tree to the calling rank's block
(``mesh.coords``); ``gather_params`` puts the blocks of every rank back
together (the tests' inverse).  There is no partitioner: a rank holds its
own shard and runs its own program (``serve.step``).

Deliberate difference (ROADMAP queue 3): the port's serve step splits
whole heads only (``head_specs``).  The reference's ``spec_for`` checks
divisibility on the ``H * hd`` and ``KV * hd`` dims, so qwen2-1.5b's two
KV heads at model=4 split inside a head (``wk``: ``(None, None,
"model")``) while every rank keeps the whole pool and GSPMD reshards.
The port copies each KV head instead, onto the ``model / KV`` ranks
whose query heads read it: its ``wk`` / ``wv`` / ``bk`` / ``bv``
columns and its pool's head (a ``Copies`` entry), so a rank's pool
holds exactly the KV heads its query heads read.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Sequence, Tuple

import torch

from ..launch.mesh import rank_coords
from ..models.spec import Spec, partition_specs
from ..tree import leaves, map_with_path

# Order matters: "pod" is the outermost (slowest) axis, so it comes first
# in every batch spec.
_BATCH_AXIS_ORDER = ("pod", "data")

# Logical axes that carry tensor parallelism.
_TP_AXES = ("heads", "kv", "ffn", "expert", "vocab")


def train_rules(mesh: Any, *, include_pod_in_fsdp: bool = True) -> Dict:
    """FSDP over data (and pod, unless the pod axis is reduced by hand)
    on the contraction dims, TP over model on the per-layer parallel
    dims."""
    shape = mesh.shape
    fsdp = tuple(a for a in _BATCH_AXIS_ORDER
                 if a in shape and (a != "pod" or include_pod_in_fsdp))
    fsdp_rule: Any = fsdp[0] if len(fsdp) == 1 else (fsdp or None)
    model = "model" if "model" in shape else None
    rules: Dict = {"embed": fsdp_rule, "embed_tbl": fsdp_rule}
    rules.update({ax: model for ax in _TP_AXES})
    return rules


def train_specs(cfg, mesh: Any, params_like: Any) -> Any:
    """The specs every rank of the mesh train step shards its parameters
    and optimizer moments with (``shard_params``) and gathers them with
    (``gather_params``): the reference's ``train_rules`` through
    ``partition_specs`` (FSDP over "data" on the contraction dim, tensor
    parallelism over "model"), then the parameter half of
    ``head_specs`` (whole query heads; whole or copied KV heads).

    The MoE family takes the same rules: the experts ``[E, D, F]`` /
    ``[E, F, D]`` whole on each model rank (``("model", "data")`` /
    ``("model", None, "data")``; where "model" does not divide E, the
    experts stay whole and their FFN splits), the router ``("data",)``,
    replicated over "model", the shared experts as a dense MLP; MLA's
    ``wq`` / ``w_uk`` / ``w_uv`` / ``wo`` by whole heads and its latent
    ``w_dkv`` ``("data",)``, whole on every model rank.
    Mamba2 and the RG-LRU then take the parameter half of
    ``state_specs``: Mamba2 by whole SSD heads (``in_proj``'s z, x and
    dt columns, x's conv channels, ``A_log``, ``D_skip``, ``dt_bias``,
    ``norm_w``, ``out_proj``'s rows; B and C whole, a ``Segments``
    entry), the RG-LRU by LRU channels; "data" stays on the contraction
    dims (``in_proj``'s, ``out_proj``'s and ``proj_x`` / ``proj_gate``'s
    D).  The encoder-decoder's attentions (encoder ``attn``, decoder
    ``self_attn`` and ``cross_attn``) split whole heads as any GQA does,
    and so does the VLM's trunk.  ``params_like``: the model's
    ``ParamSpec`` tree."""
    specs = partition_specs(params_like, train_rules(mesh), mesh)
    specs = head_specs(cfg, mesh, specs, {}, params_like, {})[0]
    return state_specs(cfg, mesh, specs, {}, params_like, {})[0]


def axis_dim(spec: Spec, axis: str):
    """The dim of a spec split over ``axis`` (alone or among others), or
    None."""
    for d, entry in enumerate(spec):
        if not isinstance(entry, (Copies, Segments)) and axis in _axes(entry):
            return d
    return None


def copies_of(spec: Spec, mesh: Any) -> int:
    """The number of model ranks that hold each block of a spec's
    ``Copies`` dim (1 where it has none)."""
    for entry in spec:
        if isinstance(entry, Copies):
            return mesh.shape[entry.axis] // entry.blocks
    return 1


def first_holder(spec: Spec, mesh: Any) -> bool:
    """Whether the calling rank is the first of the ranks that hold its
    block of a leaf: its index is 0 on every mesh axis the spec does not
    split, and first among the ranks of a ``Copies`` block.  Summing
    over the first holders counts each piece of the leaf once, but for a
    ``Segments`` dim, which counts here as whole over its axis (its
    split segments on that axis's other ranks: ``norm_share``)."""
    split = {a for e in spec if not isinstance(e, Copies) for a in _axes(e)}
    for axis, size in mesh.shape.items():
        copies = [e for e in spec if isinstance(e, Copies) and e.axis == axis]
        if copies:
            holders = size // copies[0].blocks   # ranks a copied block
        elif axis in split:
            continue
        else:
            holders = size                       # the whole axis
        if mesh.coords[axis] % holders:
            return False
    return True


def norm_share(spec: Spec, mesh: Any):
    """The part of the calling rank's block of a leaf that it counts in a
    sum over the mesh that must see each piece once (the clip norm):
    ``first_holder`` where the spec has no ``Segments`` dim; with one,
    the rank counts its split segments wherever it is on the segments'
    axis and the whole segments (held alike by every rank of the axis)
    only at index 0 there, as ``first_holder`` counts the other axes.
    Returns True (the whole block), False (nothing) or ``(dim, pieces)``:
    the (start, width) of each counted piece of the block's ``dim``."""
    seg = [(d, e) for d, e in enumerate(spec) if isinstance(e, Segments)]
    if not seg:
        return first_holder(spec, mesh)
    (dim, entry), = seg
    first = dataclasses.replace(mesh, coords={**mesh.coords, entry.axis: 0})
    if not first_holder(spec, first):
        return False
    if mesh.coords[entry.axis] == 0:
        return True
    n, pieces, start = mesh.shape[entry.axis], [], 0
    for width, split in entry.parts:
        width = width // n if split else width
        if split:
            pieces.append((start, width))
        start += width
    return dim, tuple(pieces)


def holder_pieces(spec: Spec, shape: Sequence[int], mesh: Any) -> tuple:
    """The calling rank's block of a leaf of global ``shape`` under
    ``spec``, cut where the set of ranks that hold it changes: per piece,
    ``(dim, start, width)`` in the block (None: the whole block) and its
    holders' key, the sorted mesh axes of size > 1 whose index picks the
    piece (a ``Copies`` entry's as ``"axis/blocks"``).  Every rank with
    the same index on those axes holds the same piece.  Only a
    ``Segments`` dim cuts a block: its split segments are picked by its
    axis, its whole ones are not."""
    key, seg = [], None
    for d, entry in enumerate(spec):
        if isinstance(entry, Segments):
            seg = (d, entry)
        elif isinstance(entry, Copies):
            if entry.blocks > 1:
                key.append(f"{entry.axis}/{entry.blocks}")
        else:
            key += [a for a in _axes(entry) if mesh.shape[a] > 1]
    if seg is None:
        return ((None, tuple(sorted(key))),)
    (d, entry), n = seg, mesh.shape[seg[1].axis]
    out, start = [], 0
    for width, split in entry.parts:
        width = width // n if split else width
        out.append(((d, start, width),
                    tuple(sorted(key + [entry.axis] if split else key))))
        start += width
    return tuple(out)


def serve_rules(mesh: Any) -> Dict:
    """Serving shards parameters over "model" only; the batch axes stay
    free for request parallelism."""
    model = "model" if "model" in mesh.shape else None
    return {ax: model for ax in _TP_AXES}


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    """All batch-capable mesh axes, outermost first."""
    return tuple(a for a in _BATCH_AXIS_ORDER if a in mesh.shape)


def fit_batch_axes(mesh: Any, batch: int) -> Tuple[str, ...]:
    """The largest subset of the batch axes (in topology order) whose
    product divides ``batch``; axes that don't fit are dropped."""
    axes = []
    span = 1
    for a in batch_axes(mesh):
        size = mesh.shape[a]
        if size > 1 and batch % (span * size) != 0:
            continue
        axes.append(a)
        span *= size
    return tuple(axes)


def cache_specs(mesh: Any, caches_like: Any) -> Any:
    """Specs for a paged-KV cache tree (the lm layout).

    * KV pools (``*_attn`` tuples): the page dim shards over the batch
      axes, so each data shard owns a contiguous page block; the kv-head
      dim takes "model" when divisible, else stays replicated.
    * Everything else (page_table, lengths, recurrent state) shards its
      batch dim over the batch axes.

    Leaves under ``group`` carry a leading stacked-layer dim, which stays
    replicated."""
    batch = int(caches_like["lengths"].shape[0]) if "lengths" in caches_like \
        else 0
    ba = fit_batch_axes(mesh, batch) if batch else ()
    span = math.prod(mesh.shape[a] for a in ba)
    model_size = mesh.shape.get("model", 1)

    def one(path: tuple, leaf) -> Spec:
        name = "/".join(map(str, path))   # the reference's path names
        stacked = name.startswith(("group", "pools", "cross"))
        base = 1 if stacked else 0          # dim after the layer-stack dim
        if not hasattr(leaf, "ndim") or leaf.ndim <= base:
            return ()
        spec: list = [None] * leaf.ndim
        if ba and leaf.shape[base] % span == 0:
            spec[base] = ba if len(ba) > 1 else ba[0]
        is_pool = "_attn" in name or name.startswith(("pools", "cross"))
        if is_pool and leaf.ndim >= base + 3:
            kv_dim = leaf.ndim - 2          # (.., page_tokens|seq, KV, hd)
            if model_size > 1 and leaf.shape[kv_dim] % model_size == 0:
                spec[kv_dim] = "model"
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return map_with_path(one, caches_like)


@dataclasses.dataclass(frozen=True)
class Copies:
    """A spec's entry for a dim cut into ``blocks`` blocks over ``axis``
    (of a size that ``blocks`` divides), each block held by the ``size /
    blocks`` consecutive ranks of the axis: rank ``r`` holds block ``r //
    (size / blocks)``.  Replicated KV heads: head ``j`` on the ranks whose
    query heads read it."""
    axis: str
    blocks: int


def head_specs(cfg, mesh: Any, param_specs: Any, caches_specs: Any,
               params_like: Any, caches_like: Any) -> Tuple[Any, Any]:
    """The port's head rule over the reference's specs (``partition_specs``
    and ``cache_specs`` of the serving rules): ``model`` must divide the
    query heads; where it divides the KV heads too, the reference's specs
    split whole heads and stand; where the KV heads divide ``model``,
    each KV head is copied onto the ``model / KV`` ranks whose query
    heads read it (rank ``r`` holds head ``r // (model / KV)``: its
    attention's ``wk`` / ``wv`` / ``bk`` / ``bv`` columns and its pools'
    head dim take ``Copies("model", KV)``).  MLA's latent is one head that
    every rank holds whole (``w_dkv`` is not split; ``cache_specs``
    leaves the pool whole).  Anything else raises ``ValueError``.
    ``params_like`` / ``caches_like``: trees of the specs' structure
    (``ParamSpec``s, tensors), walked beside them.  Returns the specs."""
    m = mesh.shape.get("model", 1)
    if m == 1:
        return param_specs, caches_specs
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if H % m:
        raise ValueError(
            f"{cfg.name}: model={m} does not divide its {H} query heads; "
            "the port splits whole heads only (ROADMAP item 7.1)")
    if cfg.mla or KV % m == 0:
        return param_specs, caches_specs
    if m % KV:
        raise ValueError(
            f"{cfg.name}: model={m} neither divides its {KV} KV heads nor "
            "is divided by them; the port splits or copies whole KV heads "
            "only (ROADMAP item 7.1)")
    copies = Copies("model", KV)

    def param(path: tuple, leaf, spec: Spec) -> Spec:
        if "attn" not in path or path[-1] not in ("wk", "wv", "bk", "bv"):
            return spec
        return _with(spec, len(leaf.shape) - 1, copies)

    def cache(path: tuple, leaf, spec: Spec) -> Spec:
        name = "/".join(map(str, path))
        if "_attn" not in name or getattr(leaf, "ndim", 0) < 4:
            return spec
        return _with(spec, leaf.ndim - 2, copies)   # (.., T, KV, hd)

    return (map_with_path(param, params_like, param_specs),
            map_with_path(cache, caches_like, caches_specs))


@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec's entry for a dim made of consecutive segments: ``parts``
    holds each segment's width and whether it is split over ``axis``.  A
    rank holds its block of every split segment and the whole of every
    other, concatenated in order.  Mamba2's ``in_proj`` columns z | x | B
    | C | dt: z, x and dt by whole SSD heads, the one group's B and C
    (read by every head) whole on every rank."""
    axis: str
    parts: Tuple[Tuple[int, bool], ...]


def state_specs(cfg, mesh: Any, param_specs: Any, caches_specs: Any,
                params_like: Any, caches_like: Any) -> Tuple[Any, Any]:
    """The port's state rule over the reference's specs (after
    ``head_specs``): the recurrent layers split by whole SSD heads
    (Mamba2) and by LRU channels (the RG-LRU), their state with them.

      * Mamba2: ``in_proj``'s z, x and dt columns, x's conv channels,
        ``norm_w``, ``A_log``, ``D_skip`` and ``dt_bias`` by heads
        (``Segments`` where a dim holds B and C too, which stay whole),
        ``out_proj`` by rows; the ``ssd`` state on its head dim and the
        ``conv`` state's x channels.
      * RG-LRU: ``proj_x`` / ``proj_gate`` columns, ``conv_*``,
        ``a_param``, ``b_i``, ``b_r``, ``w_i`` / ``w_r`` rows (their
        columns whole, the reference's layout) and ``out_proj`` rows by
        channels; the ``h`` and ``conv`` state on their channel dim.

    The reference keeps the state whole over "model" and cuts
    ``in_proj`` into column blocks that cross its segments, leaving the
    partitioner to reshard; a rank that runs its own program cannot, so
    this is a deliberate difference (ROADMAP queue 3).  A model axis that
    does not divide the heads or the channels raises ``ValueError``."""
    m = mesh.shape.get("model", 1)
    kinds = set(cfg.block_pattern or ())
    if m == 1 or not kinds & {"ssm", "rec"}:
        return param_specs, caches_specs
    model = "model"
    rules: Dict[str, Dict[str, Tuple[int, Any]]] = {"ssm": {}, "rec": {}}
    state: Dict[str, Dict[str, Tuple[int, Any]]] = {"ssm": {}, "rec": {}}
    if "ssm" in kinds:
        di = cfg.ssm_expand * cfg.d_model
        nh, n = di // cfg.ssm_head_dim, cfg.ssm_state
        if nh % m:
            raise ValueError(f"{cfg.name}: model={m} does not divide its "
                             f"{nh} SSD heads; the port splits whole heads "
                             "only")
        xbc = Segments(model, ((di, True), (n, False), (n, False)))
        rules["ssm"] = {    # key -> (dim from the end, entry)
            "in_proj": (1, Segments(model, ((di, True), (di, True),
                                            (n, False), (n, False),
                                            (nh, True)))),
            "conv_w": (2, xbc), "conv_b": (1, xbc),
            "A_log": (1, model), "D_skip": (1, model),
            "dt_bias": (1, model), "norm_w": (1, model),
            "out_proj": (2, model)}
        state["ssm"] = {"ssd": (3, model), "conv": (1, xbc)}
    if "rec" in kinds:
        lru = cfg.lru_width or cfg.d_model
        if lru % m:
            raise ValueError(f"{cfg.name}: model={m} does not divide its "
                             f"{lru} LRU channels")
        rules["rec"] = {k: (d, model) for k, d in (
            ("proj_x", 1), ("proj_gate", 1), ("conv_w", 2), ("conv_b", 1),
            ("a_param", 1), ("b_i", 1), ("b_r", 1), ("w_i", 2), ("w_r", 2),
            ("out_proj", 2))}
        state["rec"] = {"h": (1, model), "conv": (1, model)}

    def entry(table: Dict, path: tuple, leaf, spec: Spec) -> Spec:
        """The rule for a leaf of a block ``b{i}_{kind}`` / ``t{i}_{kind}``
        (its ``kind`` a key of ``table``) named in it, else ``spec``."""
        kind = next((k.rsplit("_", 1)[-1] for k in path if isinstance(k, str)
                     and k.rsplit("_", 1)[-1] in table), None)
        rule = table[kind].get(path[-1]) if kind else None
        if rule is None:
            return spec
        ndim = len(leaf.shape)
        dim, new = rule
        # the reference's split of the dim (if any) gives way to the rule
        out = [None if d == ndim - dim else e for d, e in enumerate(spec)]
        return _with(tuple(out), ndim - dim, new)

    return (map_with_path(lambda *a: entry(rules, *a), params_like,
                          param_specs),
            map_with_path(lambda *a: entry(state, *a), caches_like,
                          caches_specs))


def _with(spec: Spec, dim: int, entry) -> Spec:
    """``spec`` with ``entry`` at ``dim`` (Nones padded, trailing Nones
    dropped)."""
    out = list(spec) + [None] * (dim + 1 - len(spec))
    out[dim] = entry
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))


def _pieces(entry, size: int, shape: Dict[str, int],
            coords: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """A rank's part of a dim of ``size`` under a spec's ``entry``: the
    (start, width) of each piece of the global dim it holds, in the
    order it holds them (one piece, but for ``Segments``)."""
    if isinstance(entry, Segments):
        n, i = shape[entry.axis], coords[entry.axis]
        out, start = [], 0
        for width, split in entry.parts:
            out.append((start + i * (width // n), width // n) if split
                       else (start, width))
            start += width
        if start != size:
            raise ValueError(f"segments {entry.parts} do not make up a dim "
                             f"of {size}")
        return tuple(out)
    if isinstance(entry, Copies):
        n = entry.blocks
        i = coords[entry.axis] // (shape[entry.axis] // entry.blocks)
    else:
        n, i = 1, 0
        for a in _axes(entry):              # the first axis is the major one
            n, i = n * shape[a], i * shape[a] + coords[a]
    if size % n:
        raise ValueError(f"a dim of {size} does not split into {n} blocks")
    return ((i * (size // n), size // n),)


def _layout(spec: Spec, full: Sequence[int], shape: Dict[str, int],
            coords: Dict[str, int]):
    """Per dim of a leaf of shape ``full``, the rank's ``_pieces``."""
    return [_pieces(spec[d] if d < len(spec) else None, size, shape, coords)
            for d, size in enumerate(full)]


def shard_block(shape: Sequence[int], spec: Spec,
                mesh: Any) -> Tuple[Tuple[int, ...], int]:
    """The calling rank's block of a leaf of ``shape`` under ``spec``: its
    shape, and its index among the leaf's blocks (row-major over the
    split dims; a ``Segments`` dim counts by the blocks of its split
    segments)."""
    local, index = [], 0
    for d, pieces in enumerate(_layout(spec, shape, mesh.shape,
                                       mesh.coords)):
        entry = spec[d] if d < len(spec) else None
        local.append(sum(w for _, w in pieces))
        if isinstance(entry, Segments):
            n, i = mesh.shape[entry.axis], mesh.coords[entry.axis]
        else:
            n = shape[d] // pieces[0][1]
            i = pieces[0][0] // pieces[0][1]
        index = index * n + i
    return tuple(local), index


def shard_params(params: Any, specs: Any, mesh: Any) -> Any:
    """Each leaf of ``params`` (or of a cache tree) sliced to the calling
    rank's block under ``specs``: a contiguous copy, so the global leaf can
    be freed."""
    def one(_, leaf: torch.Tensor, spec: Spec) -> torch.Tensor:
        if not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf
        for d, pieces in enumerate(_layout(spec, leaf.shape, mesh.shape,
                                           mesh.coords)):
            if pieces != ((0, leaf.shape[d]),):
                out = torch.cat([out.narrow(d, s, w) for s, w in pieces],
                                dim=d) if len(pieces) > 1 \
                    else out.narrow(d, *pieces[0])
        return out.clone(memory_format=torch.contiguous_format)

    return map_with_path(one, params, specs)


def gather_params(shards: Sequence[Any], specs: Any, mesh: Any) -> Any:
    """The global tree from ``shards[r]``, rank ``r``'s ``shard_params``
    output for every rank of the mesh (row-major over ``mesh.shape``).
    A piece that several ranks hold (a replicated leaf, a ``Copies``
    block, a whole segment of a ``Segments`` dim) is taken once; the
    other copies must equal it bitwise, else ``ValueError``."""
    if len(shards) != math.prod(mesh.shape.values()):
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.shape}")
    coords = [rank_coords(dict(mesh.shape), r) for r in range(len(shards))]

    per_rank = [iter(leaves(s)) for s in shards]

    def one(path, leaf0, spec: Spec):
        blocks = [next(it) for it in per_rank]
        if not isinstance(leaf0, torch.Tensor):
            return leaf0
        full_shape = _global_shape(leaf0.shape, spec, mesh.shape)
        full = leaf0.new_empty(full_shape)
        taken = set()
        for blk, c in zip(blocks, coords):
            layout = _layout(spec, full_shape, mesh.shape, c)
            # each combination of one piece a dim: its place in the
            # global leaf and in the rank's block
            offsets = [list(itertools.accumulate((w for _, w in pieces),
                                                 initial=0))
                       for pieces in layout]
            for combo in itertools.product(*(range(len(p))
                                             for p in layout)):
                src, dst = blk, full
                for d, k in enumerate(combo):
                    start, width = layout[d][k]
                    src = src.narrow(d, offsets[d][k], width)
                    dst = dst.narrow(d, start, width)
                key = tuple(layout[d][k][0] for d, k in enumerate(combo))
                if key not in taken:
                    taken.add(key)
                    dst.copy_(src)
                elif not torch.equal(dst, src):
                    raise ValueError(f"{'/'.join(map(str, path))}: two "
                                     f"ranks' copies of block {key} differ")
        return full

    return map_with_path(one, shards[0], specs)


def _global_shape(local: Sequence[int], spec: Spec,
                  shape: Dict[str, int]) -> Tuple[int, ...]:
    """The whole leaf's shape from a rank's block of ``local``."""
    out = []
    for d, size in enumerate(local):
        entry = spec[d] if d < len(spec) else None
        if isinstance(entry, Segments):
            out.append(sum(w for w, _ in entry.parts))
        elif isinstance(entry, Copies):
            out.append(size * entry.blocks)
        else:
            out.append(size * math.prod(shape[a] for a in _axes(entry)))
    return tuple(out)
