"""The device milliseconds a train step of every kernel that is neither
kernel F, a cuBLAS product nor AdamW (norms, activations, dropout,
casts, copies, the loss) in the traced steps."""

from harness import readers


def read(ctx):
    return readers.kernel_ms_per_step(ctx, "the rest")
