"""Kernel E's share of its roofline over the traced batch's decode at 23
heads of 64 and 40 layers: the least time of every launch (one a layer a
step; a step at position p reads the cache's rows 0..p, its bytes
counted from shapes) over E's device time in the trace."""

from harness import counts, readers


def read(ctx):
    m = ctx.config["model"]
    b = ctx.counters.get("traced_clips", 0)
    steps = ctx.counters["steps"]
    hd = m["n_embd"] // m["n_head"]
    bound = counts.decode_attention_bound(b, m["n_head"], hd, m["n_layer"],
                                          range(1, steps + 1),
                                          ctx.config["dtypes"]["cache_dtype"])
    return readers.roofline(ctx, readers.contains("decode_attention_kernel"),
                            bound, m["n_layer"] * steps)
