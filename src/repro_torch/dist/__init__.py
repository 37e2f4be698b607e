"""Distribution substrate of the port: the fault plane and the gradient
codec.

  * ``fault`` (a copy of ``repro.dist.fault``): heartbeat monitoring,
    straggler detection and the steal / remesh planning that the serving
    cluster (``serve.cluster``) and the training loop execute;
  * ``compression``: the int8 and top-k codecs with per-bucket error
    feedback for the slow links between ranks, over a
    ``torch.distributed`` process group (the reference's ``"pod"`` mesh
    axis); ``train.step`` runs it when it is given a group.

Not ported, by design: ``sharding`` (mesh partition rules: FSDP and TP
over a mesh), ``models/shardctx.py`` (activation sharding hints), the
``gspmd`` / ``shard_map`` variants of ``serve/step.py`` and
``train.step.pod_err_struct`` (dry-run tooling).  Each rank of the port
holds whole, replicated parameters on its own card.
"""

from . import compression, fault
from .compression import (BucketPlan, bucketed_compressed_psum,
                          compressed_psum, dequantize_int8, init_residuals,
                          plan_buckets, quantize_int8,
                          quantize_with_feedback, topk_psum, topk_sparsify)
from .fault import (FaultPolicy, HeartbeatMonitor, RemeshPlan, StealPlan,
                    plan_remesh, plan_steal)

__all__ = [
    "BucketPlan", "bucketed_compressed_psum", "compressed_psum",
    "compression", "dequantize_int8", "fault", "FaultPolicy",
    "HeartbeatMonitor", "init_residuals", "plan_buckets", "plan_remesh",
    "plan_steal", "quantize_int8", "quantize_with_feedback", "RemeshPlan",
    "StealPlan", "topk_psum", "topk_sparsify",
]
