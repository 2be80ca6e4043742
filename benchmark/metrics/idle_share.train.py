"""The device's idle share of the traced train phase: 1 - busy / wall."""

from benchmark import readers


def read(record):
    return readers.idle_share(record, "train")
