"""Host milliseconds an image in the window's compress phases: the codec's
own stage timer's host totals (enc/*) over the images."""

from benchmark import readers


def read(record):
    return readers.host_ms_per_img(record, "compress")
