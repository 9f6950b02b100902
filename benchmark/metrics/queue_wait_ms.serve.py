"""The service's queue wait a request: the program's span
``service.wait``, from past the queue bound until the service's lock is
held, in milliseconds, averaged over the traced requests."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "service.wait")
