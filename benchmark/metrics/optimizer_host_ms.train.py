"""The host's milliseconds a traced train step in its optimizer phase: the
program's span ``train.optimizer``, averaged over the traced steps."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "train.optimizer")
