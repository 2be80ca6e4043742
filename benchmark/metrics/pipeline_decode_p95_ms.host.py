"""The 95th percentile, in ms, over every decode batch of the window of the
time from when the decode pipeline takes its blobs to when it yields its
images: the driver's ``decode_p95_ms``. Read per layer in the host-coder
cell, where it swings with the host's speed over stretches of seconds too
far to hold to an end-to-end bound; it moves that cell's decode rate.
"""


def read(record):
    return record.get("decode_p95_ms")
