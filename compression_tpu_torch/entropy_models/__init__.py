"""Entropy models: the bridge between symbols and range-coded bitstreams."""

from compression_tpu_torch.entropy_models.continuous_base import (
    CdfTables,
    ContinuousEntropyModelBase,
)
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel,
)
from compression_tpu_torch.entropy_models.continuous_indexed import (
    SCALES_LEVELS,
    SCALES_MAX,
    SCALES_MIN,
    ContinuousIndexedEntropyModel,
    LocationScaleIndexedEntropyModel,
    inverse_log_scale_fn,
    log_scale_fn,
)

__all__ = [
    "CdfTables",
    "ContinuousEntropyModelBase",
    "ContinuousBatchedEntropyModel",
    "ContinuousIndexedEntropyModel",
    "LocationScaleIndexedEntropyModel",
    "SCALES_MIN",
    "SCALES_MAX",
    "SCALES_LEVELS",
    "log_scale_fn",
    "inverse_log_scale_fn",
]
