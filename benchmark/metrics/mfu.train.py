"""The traced train phase's model FLOPs (the transforms' convolutions,
GDN, ChannelNorm and residual sums from their shapes; the backward
counted as twice the forward) over its wall time, against float32's peak."""

from benchmark import readers


def read(record):
    return readers.mfu(record, "train")
