"""repro_torch.data — the deterministic synthetic-token pipeline that
training reads (a carried copy of the reference's ``repro.data``)."""

from .pipeline import PipelineConfig, TokenPipeline

__all__ = ["TokenPipeline", "PipelineConfig"]
