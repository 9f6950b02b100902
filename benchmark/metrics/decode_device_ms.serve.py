"""The GPT decode loop's device milliseconds a step at batch 8: the
device's time between the events the program's span
``pipeline.generate_tokens`` records on the stream at its start and end,
over the steps of a clip, averaged over the traced requests.  The
counterpart of ``decode_step_ms.serve`` without the benchmark's
synchronisations; None without CUDA events."""

from harness import spans


def read(ctx):
    n = len(spans.named(ctx, "pipeline.generate_tokens"))
    ms = spans.device_ms(ctx, "pipeline.generate_tokens")
    return None if ms is None else ms / (n * ctx.counters["steps"])
