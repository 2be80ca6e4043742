"""The convolutions' share of their roofline in the traced compress phase:
the least time of every convolution layer (float32 FLOPs over 67 TFLOP/s
or bytes over 3.35 TB/s, the larger) over the convolution kernels' device
time."""

from benchmark import readers


def read(record):
    return readers.conv_roofline(record, "compress")
