"""K1's share of its roofline in the traced compress phase: the least time
of its calls (bytes-bound at these widths) over its device time."""

from benchmark import readers


def read(record):
    return readers.k1_roofline(record, "compress")
