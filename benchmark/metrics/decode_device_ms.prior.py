"""The XL decoder's decode loop, device milliseconds a step at batch 256:
the device's time between the events the program's span
``pipeline.generate_tokens`` records at its start and end, over the steps
of a clip, averaged over the traced batches -- only the spans whose
``prompt`` attribute is "latent" (a program that records no such
attribute gives None).  The counterpart of ``decode_step_ms.prior``
without the benchmark's synchronisations; None without CUDA events."""

from harness import spans


def read(ctx):
    xs = [s for s in spans.named(ctx, "pipeline.generate_tokens")
          if s.attrs.get("prompt") == "latent"]
    if not xs or any(s.device_ms is None for s in xs):
        return None
    return sum(s.device_ms for s in xs) / (len(xs) * ctx.counters["steps"])
