"""Entropy coding: the C++ range coder (cc/, byte-identical to the JAX
package's) behind a ctypes binding, its NumPy-facing host API and its
fixed-capacity buffer form (:mod:`~compression_tpu_torch.codec.buffer_ops`);
the device rANS coder is :mod:`compression_tpu_torch.codec.rans` (kernels
K3/K2, with :mod:`~compression_tpu_torch.codec.rans_ref` as its spec)."""

from compression_tpu_torch.codec.buffer_ops import (
    make_buffer_decoder,
    make_buffer_encoder,
)
from compression_tpu_torch.codec.host import (
    encode_capacity,
    entropy_decode,
    entropy_encode,
    pmf_to_quantized_cdf,
    run_length_gamma_decode,
    run_length_gamma_encode,
)
from compression_tpu_torch.codec.xla_cdf import pmf_to_quantized_cdf_torch

__all__ = [
    "encode_capacity",
    "entropy_encode",
    "entropy_decode",
    "make_buffer_decoder",
    "make_buffer_encoder",
    "pmf_to_quantized_cdf",
    "pmf_to_quantized_cdf_torch",
    "run_length_gamma_encode",
    "run_length_gamma_decode",
]
