"""SplitFS-backed checkpointing of torch tensor trees (port of
``repro.checkpoint``): staged appends + relink commits + three consistency
modes, in the reference's on-PM layout."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
