"""The port's data pipeline: a copy of the numpy-only
``repro.data.pipeline`` (deterministic, resumable, reshardable synthetic
token batches)."""
from .pipeline import PipelineState, TokenPipeline
