"""Layers: SignalConv1D/2D/3D, GDN (with the fused kernels K1 and
fused_gdn_general), the rounding modules, parameterizations and
initializers."""

from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.gdn_kernel import (
    fused_gdn,
    fused_gdn_general,
    fused_gdn_reference,
)
from compression_tpu_torch.layers.initializers import identity_kernel_init
from compression_tpu_torch.layers.parameters import (
    GDNParameter,
    Parameter,
    RDFTParameter,
    nonneg_apply,
    nonneg_init,
    rdft_apply,
    rdft_basis,
    rdft_init,
)
from compression_tpu_torch.layers.signal_conv import (
    SignalConv1D,
    SignalConv2D,
    SignalConv3D,
    signal_conv,
)
from compression_tpu_torch.layers.soft_round import (
    Round,
    SoftRound,
    SoftRoundConditionalMean,
)

__all__ = [
    "GDN",
    "GDNParameter",
    "Parameter",
    "RDFTParameter",
    "identity_kernel_init",
    "nonneg_apply",
    "nonneg_init",
    "rdft_apply",
    "rdft_basis",
    "rdft_init",
    "SignalConv1D",
    "SignalConv2D",
    "SignalConv3D",
    "signal_conv",
    "Round",
    "SoftRound",
    "SoftRoundConditionalMean",
    "fused_gdn",
    "fused_gdn_general",
    "fused_gdn_reference",
]
