"""The device's idle share of the prior cell's traced batch: the time no
kernel runs (the union of the kernels' intervals on the timeline) over the
window's length, the window tracing the device alone."""

from harness import readers


def read(ctx):
    return readers.idle_share(ctx)
