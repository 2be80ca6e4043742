"""The traced compress phase's model FLOPs (the transforms' convolutions, GDN,
ChannelNorm and residual sums from their shapes) over its wall time, against
float32's peak. Read in the host-coder cell, where it moves that cell's own
rate.
"""

from benchmark import readers


def read(record):
    return readers.mfu(record, "compress")
