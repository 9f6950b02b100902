"""The device's idle share of the traced window: the time no kernel runs
(the union of the kernels' intervals on the timeline) over the window's
length.  The window traces the device alone, so that the profiler's host
work does not add idle time a host-bound step does not have."""

from harness import readers


def read(ctx):
    return readers.idle_share(ctx)
