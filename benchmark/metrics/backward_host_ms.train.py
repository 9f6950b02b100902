"""The host's milliseconds a traced train step in its backward phase: the
program's span ``train.backward``, averaged over the traced steps."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "train.backward")
