"""Training on one device: AdamW, the train_step builder (microbatch
accumulation) and the loop."""
from .loop import LoopConfig, LoopResult, run_training
from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        schedule)
from .step import make_loss_and_grad, make_train_step
