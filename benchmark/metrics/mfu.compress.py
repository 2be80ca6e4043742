"""The traced compress phase's model FLOPs (the transforms' convolutions,
GDN, ChannelNorm and residual sums from their shapes) over its wall time, against float32's peak."""

from benchmark import readers


def read(record):
    return readers.mfu(record, "compress")
