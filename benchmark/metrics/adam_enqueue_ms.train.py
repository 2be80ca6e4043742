"""Host milliseconds a training step spends enqueueing the schedule, the
learning rate and Adam's step (the port's ``train/optimizer`` span in
``train_step``, which has no host sync), over the window's steps."""

from benchmark import spans


def read(record):
    return spans.train_span_ms(record, "optimizer")
