"""Device/host overlap for the coding paths."""

from compression_tpu_torch.parallel.pipeline import Pipeline, stream_context

__all__ = ["Pipeline", "stream_context"]
