"""The mesh serve step: the port's counterpart of
``repro/serve/step.py``.

The built step is the unified chunked program
``serve_step(params, tokens [B, C], caches, n_new [B])`` of
``models.registry`` (prefill chunks, decode, speculative chunks and mixed
batches in one call), run by every rank of a ("data", "model") mesh
(``launch.mesh``) on its own shards:

  * "model" (tensor and expert parallelism): each rank holds its block of
    whole query heads, of whole KV heads (or a copy of the one KV head
    its query heads read, where the KV heads divide "model"), of whole
    experts (or of every expert's FFN, where "model" does not divide the
    experts), of the FFN and of the vocabulary
    (``dist.sharding.serve_rules``, ``head_specs``), and of each pool's
    KV heads (``cache_specs``; MLA's one latent head stays whole on every
    rank); the model code sums the attention's, the MLP's and the MoE's
    partial products and looks the embedding up vocab-parallel
    (``model_all_reduce``), and gathers the logits' vocab blocks
    (``gather_vocab``) over the model group (``models.shardctx``);
  * "data" (request parallelism): each data shard serves its own rows of
    the batch (``fit_batch_axes``) from its own contiguous block of each
    pool's pages: page ids are made local (``page_table % local_pool``,
    the reference's ``:76-83``), the U-Split-style private staging of the
    reference's ``shard_map`` variant.

``variant``: the reference builds a ``gspmd`` step (one jit over the
whole batch, every gather left to the SPMD partitioner) and a
``shard_map`` step (the batch axes manual: each data shard runs the
model on its own rows, page ids local).  Eager PyTorch has no
partitioner, so both run this page-local program, and each data shard
owns a contiguous page block (the engine's private chains).  The one
computation that is not row by row is the MoE's capacity count
(``layers.moe_route``): under ``gspmd`` its capacity and running count
are the whole batch's (data shard 0's rows first, the earlier shards'
picks of each expert gathered over the data group,
``shardctx.data_prefix``); under ``shard_map`` they are the shard's own.
So both names give their reference variant's logits, which differ once
an expert overflows at data > 1.  ``donate`` has no meaning here: the
step updates the pools in place already (a deliberate difference of the
port's serve step).

Every family is served: the dense and MoE families (GQA and MLA
attention), Mamba2's and the RG-LRU's state split with their whole SSD
heads and LRU channels (``dist.sharding.state_specs``: the recurrences
run on each rank's own heads and channels, and the products that need
the whole model axis, the gated norm's mean of squares, the RG-LRU's
gates and the output projections, are summed once a layer a step, so a
step's collectives do not depend on its chunk), the encoder-decoder
(its self-attention pools and its cross K/V split by KV heads over
"model" and by rows over "data") and the VLM, whose serve step is the
dense one (neither package's serve step takes the patch embeddings).
With model=1 and data=1 the step is ``api.serve_step`` itself.  On a
("pod", "data", "model") mesh "pod" is one more batch axis, outermost,
as in the reference (``fit_batch_axes``): the step serves on the mesh's
``(pod * data, model)`` view (``launch.mesh.Mesh.merged``), whose data
shard ``p * data + d`` holds the rows and pages that the reference's
("pod", "data") split gives it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..dist.sharding import (cache_specs, fit_batch_axes, head_specs,
                             serve_rules, state_specs)
from ..models.registry import ModelAPI
from ..models.shardctx import VARIANTS, serving_mesh
from ..models.spec import partition_specs
from ..tree import map_with_path


def make_serve_step(api: ModelAPI, mesh: Any, caches_like: Any, *,
                    variant: str = "gspmd", donate: bool = True):
    """Returns (serve_step, param_specs, cache_specs).

    ``param_specs`` and ``cache_specs`` stand in for the reference's
    shardings: ``dist.sharding.shard_params(tree, specs, mesh)`` gives the
    calling rank's shards of the global parameters and caches.
    ``serve_step(params, tokens, caches, n_new, impl=None)`` takes and
    returns this rank's: its batch rows of ``tokens`` [B/data, C] and
    ``n_new``, its pools, its page table rows (returned as
    ``page_table % local_pool``) and lengths, and its parameter shards;
    it returns (logits [B/data, C, V], caches), the vocab gathered."""
    del donate                              # the step updates in place
    if "pod" in mesh.shape:
        mesh = mesh.merged
    cfg = api.cfg
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    specs_like = api.init_specs()
    param_specs, specs = head_specs(
        cfg, mesh, partition_specs(specs_like, serve_rules(mesh), mesh),
        cache_specs(mesh, caches_like), specs_like, caches_like)
    param_specs, specs = state_specs(cfg, mesh, param_specs, specs,
                                     specs_like, caches_like)
    if mesh.size == 1:
        return api.serve_step, param_specs, specs
    batch = int(caches_like["lengths"].shape[0])
    data = [a for a in fit_batch_axes(mesh, batch) if mesh.shape[a] > 1]
    model_group = mesh.groups.get("model")
    data_group = mesh.groups.get("data") if data else None

    def serve_step(params, tokens, caches, n_new, impl: Optional[str] = None):
        pages = _local_pool_pages(caches) if data else None
        if pages is not None:
            caches = dict(caches)
            caches["page_table"] = caches["page_table"] % pages
        with serving_mesh(model_group, data_group, variant):
            return api.serve_step(params, tokens, caches, n_new, impl=impl)

    return serve_step, param_specs, specs


def _local_pool_pages(caches: Dict) -> Optional[int]:
    """The local page count: the page dim of the first pool, the
    reference's ``_local_pool_pages``: an ``*_attn`` leaf of the lm layout
    (``[L, P, T, KV, hd]`` under ``group``, ``[P, T, KV, hd]`` under
    ``tail``) or the encoder-decoder's ``pools``.  None where the model
    has no pool (Mamba2: its state carries no page ids)."""
    found = []

    def visit(path: tuple, leaf) -> None:
        name = "/".join(map(str, path))
        if ("_attn" in name or "pools" in name) and leaf.ndim in (4, 5):
            found.append(int(leaf.shape[leaf.ndim - 4]))

    for key in ("group", "tail", "pools"):
        map_with_path(visit, caches.get(key, {}), path=(key,))
    return found[0] if found else None
