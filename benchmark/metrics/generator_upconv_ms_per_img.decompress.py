"""Device milliseconds an image that HiFiC's generator up-convolutions on
the hand-written stride-2 3x3 kernel take in the traced decompress phase:
the device time of what the port's ``hific/generator_upconv`` span
launched, over the phase's images. A program without that span (before the
kernel) gives None."""

from benchmark import spans


def read(record):
    t = record.get("traffic", {})
    return spans._per(record, "span_device_s", "decompress", "hific/generator_upconv",
                      t.get("round_batches", 0) * t.get("batch", 0))
