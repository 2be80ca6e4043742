"""Milliseconds an image the codec's host stages waited on their batch's
device event (the port's ``wait/device`` span, on any thread) over the
window's compress calls.
"""

from benchmark import spans


def read(record):
    return spans.device_wait_ms_per_img(record, "compress")
