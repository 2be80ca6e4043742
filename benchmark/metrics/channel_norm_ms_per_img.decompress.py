"""Device milliseconds an image that HiFiC's ChannelNorm takes in the traced
decompress phase: the device time of what the port's ``hific/channel_norm``
span launched, over the phase's images. Since the norm became one kernel
it also holds the convolution's bias, the ReLU and the residual add that
kernel applies."""

from benchmark import spans


def read(record):
    return spans.channel_norm_ms_per_img(record, "decompress")
