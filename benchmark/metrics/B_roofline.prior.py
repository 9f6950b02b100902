"""Kernel B's share of its roofline over the prior cell's traced batch's
vocode: each launch is one upsample stage's resblock stack over one chunk
of the batch's clips (``traced_clips``), bounded by its bfloat16
operations (or bytes) counted from shapes."""

from harness import counts, readers


def read(ctx):
    v, tr = ctx.config["vocoder"], ctx.traffic
    b = ctx.counters.get("traced_clips", 0)
    if not b:
        return None
    chunks = [min(tr["chunk"], b - i) for i in range(0, b, tr["chunk"])]
    frames = ctx.config["vqvae"]["resolution"]
    bound, launches = 0.0, 0
    for c, t in counts.melgan_stages(frames, v["ngf"], v["ratios"]):
        for n in chunks:
            bound += counts.bound_s(
                counts.resblock_stack_bytes(n, c, t, v["n_residual_layers"]),
                counts.resblock_stack_ops(n, c, t, v["n_residual_layers"]),
                "bf16")
            launches += 1
    return readers.roofline(ctx, readers.contains("resblock_stack"), bound,
                            launches)
