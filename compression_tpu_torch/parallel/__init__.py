"""Parallel and pipelined execution: data-parallel training, halo-sharded
convolutions, image-parallel CHARM decode, and the device/host overlap of
the coding paths."""

from compression_tpu_torch.parallel.data_parallel import (
    make_dp_step,
    make_mesh,
    shard_batch,
)
from compression_tpu_torch.parallel.charm_sharded import ShardedCharmCodec
from compression_tpu_torch.parallel.pipeline import Pipeline, pipeline_map, stream_context

__all__ = ["make_dp_step", "make_mesh", "shard_batch", "ShardedCharmCodec",
           "Pipeline", "pipeline_map", "stream_context"]
