"""Kernel F's forward share of its roofline over the traced train steps:
each launch's least time from its shape (q, k, v, O and the row
log-sum-exp in float32, the uint8 keep-mask where dropout applies; the
products over the visible pairs at the TF32 rate) over the forward
kernel's device time."""

from harness import counts, readers


def read(ctx):
    launches = [s for s in ctx.counters.get("flash_launches", [])
                if s[0] == "fwd"]
    bound = sum(counts.flash_bound(shape, nu, masked, False)
                for _, shape, nu, masked in launches)
    return readers.roofline(ctx, readers.contains("flash_fwd_kernel"), bound,
                            len(launches))
