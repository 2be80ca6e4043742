"""K3's share of its roofline in the traced compress phase: the least time
of encoding the round's y symbols into the words its blobs hold, over K3's
device time (its serial floor, far above this bound, is not counted)."""

from benchmark import readers


def read(record):
    return readers.rans_roofline(record, "compress", decode=False)
