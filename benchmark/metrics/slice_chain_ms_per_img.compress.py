"""Device milliseconds an image that ms2020's slice chain takes in the traced
compress phase: the device time of what the port's ``ms2020/slice_params``
(each slice's mean and scale networks and its CDF rows) and
``ms2020/slice_lrp`` (each slice's latent residual prediction) spans
launched, over the phase's images; the rANS coder's launches are not
counted. A program without those spans gives None."""

from benchmark import spans

CHAIN = ("ms2020/slice_params", "ms2020/slice_lrp")


def read(record):
    t = record.get("traffic", {})
    parts = [spans._per(record, "span_device_s", "compress", name,
                        t.get("round_batches", 0) * t.get("batch", 0)) for name in CHAIN]
    return None if None in parts else sum(parts)
