"""The mesh serve step: the port's counterpart of
``repro/serve/step.py``.

The built step is the unified chunked program
``serve_step(params, tokens [B, C], caches, n_new [B])`` of
``models.registry`` (prefill chunks, decode, speculative chunks and mixed
batches in one call), run by every rank of a ("data", "model") mesh
(``launch.mesh``) on its own shards:

  * "model" (tensor parallelism): each rank holds its block of whole query
    and KV heads, of the FFN and of the vocabulary
    (``dist.sharding.serve_rules``), and of each pool's KV heads
    (``cache_specs``); the model code sums the attention's and the MLP's
    partial products and looks the embedding up vocab-parallel
    (``model_all_reduce``), and gathers the logits' vocab blocks
    (``gather_vocab``) over the model group (``models.shardctx``);
  * "data" (request parallelism): each data shard serves its own rows of
    the batch (``fit_batch_axes``) from its own contiguous block of each
    pool's pages: page ids are made local (``page_table % local_pool``,
    the reference's ``:76-83``), the U-Split-style private staging of the
    reference's ``shard_map`` variant.  Nothing crosses the data axis.

``variant``: the reference builds a ``gspmd`` step (one jit, every gather
left to the SPMD partitioner) and a ``shard_map`` step (the batch axes
manual, page ids local).  Eager PyTorch has no partitioner, so both names
run this page-local program; since each data shard owns a contiguous page
block (the engine's private chains), both give the reference's logits.
``donate`` has no meaning here: the step updates the pools in place
already (a deliberate difference of the port's serve step).

Only the dense family is served: MoE's expert axis, MLA's latent pool,
SSM and hybrid state and the encoder-decoder's and VLM's caches raise
``ValueError`` (ROADMAP item 7).  With model=1 and data=1 the step is
``api.serve_step`` itself.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..dist.sharding import (cache_specs, check_whole_heads, fit_batch_axes,
                             serve_rules)
from ..models.registry import ModelAPI
from ..models.shardctx import serving_model_group
from ..models.spec import partition_specs

VARIANTS = ("gspmd", "shard_map")


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
    cfg = api.cfg
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if cfg.family != "dense":
        raise ValueError(
            f"{cfg.name}: the mesh serve step serves the dense family only; "
            f"{cfg.family!r} (MoE's expert axis, MLA's latent pool, SSM and "
            "hybrid state, the encoder-decoder's and VLM's caches) waits on "
            "ROADMAP item 7")
    check_whole_heads(cfg, mesh)
    param_specs = partition_specs(api.init_specs(), serve_rules(mesh), mesh)
    specs = cache_specs(mesh, caches_like)
    if mesh.size == 1:
        return api.serve_step, param_specs, specs
    batch = int(caches_like["lengths"].shape[0])
    data = [a for a in fit_batch_axes(mesh, batch) if mesh.shape[a] > 1]
    group = mesh.groups.get("model")

    def serve_step(params, tokens, caches, n_new, impl: Optional[str] = None):
        if data:
            caches = dict(caches)
            caches["page_table"] = caches["page_table"] % _local_pool_pages(
                caches)
        with serving_model_group(group):
            return api.serve_step(params, tokens, caches, n_new, impl=impl)

    return serve_step, param_specs, specs


def _local_pool_pages(caches: Dict) -> int:
    """The local page count: the page dim of a group pool [L, P, T, KV,
    hd] (a dense model's layers are all in the stacked group)."""
    pool = next(iter(caches["group"].values()))[0]
    return int(pool.shape[1])
