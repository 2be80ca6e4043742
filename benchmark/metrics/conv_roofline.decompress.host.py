"""The convolutions' share of their roofline in the traced decompress phase:
the least time of every convolution layer (float32 FLOPs over 67 TFLOP/s or
bytes over 3.35 TB/s, the larger) over the convolution kernels' device time.
Read in the host-coder cell, where it moves that cell's own rate.
"""

from benchmark import readers


def read(record):
    return readers.conv_roofline(record, "decompress")
