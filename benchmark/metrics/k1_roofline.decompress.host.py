"""K1's share of its roofline in the traced decompress phase: the least time of
its calls (bytes-bound at these widths) over its device time. Read in the
host-coder cell, where it moves that cell's own rate.
"""

from benchmark import readers


def read(record):
    return readers.k1_roofline(record, "decompress")
