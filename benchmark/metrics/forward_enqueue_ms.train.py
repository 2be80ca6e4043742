"""Host milliseconds a training step spends enqueueing its normalisation and
loss (the port's ``train/forward`` span in ``train_step``, which has no host
sync), over the window's steps."""

from benchmark import spans


def read(record):
    return spans.train_span_ms(record, "forward")
