"""Entropy models: the bridge between symbols and range-coded bitstreams
(batched, indexed, universal and power-law)."""

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
from compression_tpu_torch.entropy_models.power_law import PowerLawEntropyModel
from compression_tpu_torch.entropy_models.universal import (
    UniversalBatchedEntropyModel,
    UniversalIndexedEntropyModel,
)

# The v1-era names the JAX package keeps as aliases.
EntropyBottleneck = ContinuousBatchedEntropyModel
GaussianConditional = LocationScaleIndexedEntropyModel

__all__ = [
    "CdfTables",
    "ContinuousEntropyModelBase",
    "ContinuousBatchedEntropyModel",
    "ContinuousIndexedEntropyModel",
    "LocationScaleIndexedEntropyModel",
    "UniversalBatchedEntropyModel",
    "UniversalIndexedEntropyModel",
    "PowerLawEntropyModel",
    "EntropyBottleneck",
    "GaussianConditional",
    "SCALES_MIN",
    "SCALES_MAX",
    "SCALES_LEVELS",
    "log_scale_fn",
    "inverse_log_scale_fn",
]
