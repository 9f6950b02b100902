"""The pipeline's detok device milliseconds a clip of the prior cell (the
VGGSound VQ-VAE's decoder and MelGAN): the device's time between the
events of the program's spans ``pipeline.decode_specs`` and
``pipeline.vocode``, over the traced batch's clips; None without CUDA
events."""

from harness import spans


def read(ctx):
    dec = spans.device_ms(ctx, "pipeline.decode_specs")
    voc = spans.device_ms(ctx, "pipeline.vocode")
    if dec is None or voc is None:
        return None
    return (dec + voc) / ctx.counters["traced_clips"]
