"""The host's milliseconds a traced train step in its forward phase: the
program's span ``train.forward``, averaged over the traced steps."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "train.forward")
