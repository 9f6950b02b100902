"""The device's idle milliseconds a traced train step while the host was
in its forward phase: the idle gaps of the traced window whose midpoint
lies innermost in the program's span ``train.forward``, over the traced
steps."""

from harness import spans


def read(ctx):
    return spans.idle_ms_per(ctx, "train.forward", "train.forward")
