"""Milliseconds an image the dispatching thread waited for the pipeline's
oldest batch (the port's ``pipeline/wait`` span) over the window's compress
calls: time the host's next dispatch stood behind the device or a worker.
Read in the host-coder cell, where it moves that cell's own rate.
"""

from benchmark import spans


def read(record):
    return spans.dispatch_wait_ms_per_img(record, "compress")
