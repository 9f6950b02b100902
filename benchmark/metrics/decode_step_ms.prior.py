"""The XL decoder's decode loop, milliseconds a step at batch 256: the
benchmark's synchronised span around ``generate_tokens`` (the latents'
draw, the prefill and the 265 captured steps) over the steps of a clip,
averaged over the window's batches."""

from harness import readers


def read(ctx):
    return readers.span_ms_per(ctx, "generate_tokens", ctx.counters["steps"])
