"""Host milliseconds a training step spends in the port's train_step call
(the benchmark's span around it, which has no host sync), over the window."""

from benchmark import readers


def read(record):
    return readers.host_enqueue_ms(record)
