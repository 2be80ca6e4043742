"""Device/host overlap for the coding paths."""

from compression_tpu_torch.parallel.pipeline import Pipeline, pipeline_map, stream_context

__all__ = ["Pipeline", "pipeline_map", "stream_context"]
