"""Host utilities: the .tfci container, padding, numeric and device helpers."""

from compression_tpu_torch.util.packed_tensors import PackedTensors

__all__ = ["PackedTensors"]
