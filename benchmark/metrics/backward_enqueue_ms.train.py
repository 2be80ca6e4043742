"""Host milliseconds a training step spends enqueueing ``zero_grad`` and
``backward`` (the port's ``train/backward`` span in ``train_step``, which has
no host sync), over the window's steps."""

from benchmark import spans


def read(record):
    return spans.train_span_ms(record, "backward")
