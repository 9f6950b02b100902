"""Kernel F's backward share of its roofline over the traced train steps:
each launch (its delta, dQ and dK/dV kernels) bounded from its shape (the
forward's tensors and dO in, dQ, dK, dV out; the products over the
visible pairs at the TF32 rate) over the backward kernels' device time."""

from harness import counts, readers


def read(ctx):
    launches = [s for s in ctx.counters.get("flash_launches", [])
                if s[0] == "bwd"]
    bound = sum(counts.flash_bound(shape, nu, masked, True)
                for _, shape, nu, masked in launches)
    # a backward launch is three kernels
    return readers.roofline(ctx, readers.contains("flash_bwd_"), bound,
                            3 * len(launches))
