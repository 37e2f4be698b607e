"""Distribution substrate of the port: the fault plane, the gradient
codec and the mesh partition rules.

  * ``fault`` (a copy of ``repro.dist.fault``): heartbeat monitoring,
    straggler detection and the steal / remesh planning that the serving
    cluster (``serve.cluster``) and the training loop execute;
  * ``compression``: the int8 and top-k codecs with per-bucket error
    feedback for the slow links between ranks, over a
    ``torch.distributed`` process group (the reference's ``"pod"`` mesh
    axis); ``train.step`` runs it when it is given a group;
  * ``sharding``: the partition rules over a ("data", "model") mesh and
    each rank's shard of a parameter or cache tree, which
    ``serve.step.make_serve_step`` serves from (tensor parallelism over
    "model", expert parallelism over it too, request parallelism over
    "data") and ``train.step.make_train_step(mesh=...)`` trains every
    family on (``train_specs``: FSDP over "data" on the contraction dim,
    tensor and expert parallelism over "model", Mamba2 by whole SSD
    heads and the RG-LRU by channels, the optimizer moments sharded as
    their params, the batch's rows split over "data"; with a "pod" axis,
    each pod's shards reduced with the other pods' through the codec, in
    buckets of each rank's own pieces, ``train.step.shard_buckets``).

Not ported, by design: ``train.step.pod_err_struct`` (dry-run tooling).
"""

from . import compression, fault, sharding
from .compression import (BucketPlan, bucketed_compressed_psum,
                          compressed_psum, dequantize_int8, init_residuals,
                          plan_buckets, quantize_int8,
                          quantize_with_feedback, topk_psum, topk_sparsify)
from .fault import (FaultPolicy, HeartbeatMonitor, RemeshPlan, StealPlan,
                    plan_remesh, plan_steal)
from .sharding import (batch_axes, cache_specs, fit_batch_axes,
                       gather_params, serve_rules, shard_params, train_rules,
                       train_specs)

__all__ = [
    "batch_axes", "BucketPlan", "bucketed_compressed_psum", "cache_specs",
    "compressed_psum", "compression", "dequantize_int8", "fault",
    "FaultPolicy", "fit_batch_axes", "gather_params", "HeartbeatMonitor",
    "init_residuals", "plan_buckets", "plan_remesh", "plan_steal",
    "quantize_int8", "quantize_with_feedback", "RemeshPlan", "serve_rules",
    "shard_params", "sharding", "StealPlan", "topk_psum", "topk_sparsify",
    "train_rules", "train_specs",
]
