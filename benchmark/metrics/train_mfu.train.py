"""The train step's share of the card's bfloat16 dense peak: the useful
operations of a step (three times both GPTs' forward: 2 P a token plus
the attention's two products, no remat replay) times the window's steps
a second."""

from harness import counts, readers
from reference import gpt as ref_gpt
from reference import gpt_vae as ref_vae


def read(ctx):
    c = ctx.counters
    if not c.get("window_s"):
        return None
    m, b = ctx.config["model"], ctx.traffic["batch"]
    enc, dec = ref_vae.vae_configs(m)
    fwd = sum(counts.gpt_fwd_flops(
        counts.gpt_param_count(ref_gpt.param_shapes(g)), b, g["block_size"],
        g["n_layer"], g["n_embd"]) for g in (enc, dec))
    return readers.share_of_peak(3.0 * fwd * c["steps"] / c["window_s"])
