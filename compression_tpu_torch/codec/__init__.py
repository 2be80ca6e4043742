"""Entropy coding: the C++ range coder (cc/, byte-identical to the JAX
package's) behind a ctypes binding, and its NumPy-facing host API; the
device rANS coder is :mod:`compression_tpu_torch.codec.rans` (kernels
K3/K2, with :mod:`~compression_tpu_torch.codec.rans_ref` as its spec)."""

from compression_tpu_torch.codec.host import (
    encode_capacity,
    entropy_decode,
    entropy_encode,
    pmf_to_quantized_cdf,
)

__all__ = [
    "encode_capacity",
    "entropy_encode",
    "entropy_decode",
    "pmf_to_quantized_cdf",
]
