"""The device's idle share of the traced compress phase: 1 - busy / wall. Read
in the host-coder cell, where it moves that cell's own rate.
"""

from benchmark import readers


def read(record):
    return readers.idle_share(record, "compress")
