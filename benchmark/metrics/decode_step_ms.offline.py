"""The GPT decode loop's milliseconds a step at batch 512: the
benchmark's synchronised span around ``generate_tokens`` over the steps
of a clip, averaged over the window's batches."""

from harness import readers


def read(ctx):
    return readers.span_ms_per(ctx, "generate_tokens", ctx.counters["steps"])
