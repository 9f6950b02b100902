"""The GPT decode loop's milliseconds a step at batch 8: the benchmark's
synchronised span around the pipeline's ``generate_tokens`` over the
steps of a clip, averaged over the window's requests."""

from harness import readers


def read(ctx):
    return readers.span_ms_per(ctx, "generate_tokens", ctx.counters["steps"])
