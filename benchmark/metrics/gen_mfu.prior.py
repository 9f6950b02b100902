"""The whole round trip's share of the card's bfloat16 dense peak in the
prior cell: the operations of a clip (the XL decoder's products over the
265 positions that choose a token, the VQ-VAE decoder's and MelGAN's
convolutions, from shapes) times the window's clips a second."""

from harness import readers


def read(ctx):
    c = ctx.counters
    if not c.get("window_s"):
        return None
    rate = c["clips"] / c["window_s"]
    return readers.share_of_peak(readers.clip_flops(ctx.config) * rate)
