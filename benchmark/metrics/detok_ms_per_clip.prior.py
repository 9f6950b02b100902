"""The pipeline's detok (``decode_specs`` + ``vocode``) milliseconds a
clip in the prior cell: the benchmark's synchronised span over the
batch's clips."""

from harness import readers


def read(ctx):
    return readers.span_ms_per(ctx, "detok", ctx.traffic["batch"])
