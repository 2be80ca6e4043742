"""K2's share of its roofline in the traced decompress phase: the least
time of decoding the round's y words into symbols, over K2's device time
(its serial floor, far above this bound, is not counted)."""

from benchmark import readers


def read(record):
    return readers.rans_roofline(record, "decompress", decode=True)
