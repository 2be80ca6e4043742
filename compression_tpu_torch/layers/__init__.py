"""Layers: SignalConv2D, GDN (with the fused kernel K1) and the prior holder."""

from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.gdn_kernel import fused_gdn, fused_gdn_reference
from compression_tpu_torch.layers.signal_conv import SignalConv2D, signal_conv

__all__ = ["GDN", "SignalConv2D", "signal_conv", "fused_gdn", "fused_gdn_reference"]
