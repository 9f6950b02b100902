"""AdamW's device milliseconds a train step (its multi-tensor kernels) in
the traced steps."""

from harness import readers


def read(ctx):
    return readers.kernel_ms_per_step(ctx, "AdamW")
