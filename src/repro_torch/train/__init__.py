"""Training, one device a rank: AdamW, the train_step builder (microbatch
accumulation, the compressed gradient reduction across ranks) and the
fault-aware loop (SplitFS checkpoints, heartbeats, the steal / remesh
ladder)."""
from .loop import LoopConfig, LoopResult, run_training
from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        schedule)
from .step import grad_bucket_plan, make_loss_and_grad, make_train_step
