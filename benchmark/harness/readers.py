"""What the per-layer metrics' readers share: spans, the traced window's
kernels by class, roofline shares and whole-step shares of the peak.
A reader that finds nothing to read returns None, and the run leaves
that metric out of its line."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from reference import detok as ref_detok

from . import counts

GIB = 2.0 ** 30

# device kernels of a train step by class: (label, substrings of the
# kernel's name, lower case); what matches none is "the rest"
TRAIN_KERNEL_CLASSES = (
    ("F forward", ("flash_fwd_kernel",)),
    ("F backward", ("flash_bwd_",)),
    # cuBLAS's float32 kernels carry "gemm" in their names, its Hopper
    # bfloat16 ones "nvjet"
    ("GEMMs", ("gemm", "cutlass", "cublas", "gemv", "nvjet")),
    ("AdamW", ("multi_tensor_apply", "adam")))


def train_class(name: str) -> str:
    key = name.lower()
    return next((label for label, subs in TRAIN_KERNEL_CLASSES
                 if any(s in key for s in subs)), "the rest")


def contains(sub: str) -> Callable[[str], bool]:
    return lambda name: sub in name


def span_ms_per(ctx, span: str, per: float) -> Optional[float]:
    xs = ctx.spans.get(span) or []
    if not xs:
        return None
    return 1e3 * sum(xs) / (len(xs) * per)


def idle_share(ctx) -> Optional[float]:
    """100 x (1 - the device's busy time, the union of the kernels'
    intervals, over the traced window)."""
    tw = ctx.trace
    if tw is None or not tw.kernels or tw.window_s <= 0:
        return None
    return 100.0 * (1.0 - tw.busy_s / tw.window_s)


def peak_gib(ctx) -> Optional[float]:
    return ctx.peak_bytes / GIB if ctx.peak_bytes else None


def roofline(ctx, match, bound_s: float, launches: int) -> Optional[float]:
    """100 x the least time of the ``launches`` launches the trace should
    hold over their device time in the trace; where the trace lost
    launches, the bound is taken over the share it holds."""
    tw = ctx.trace
    if tw is None or launches <= 0:
        return None
    n = tw.kernel_count(match)
    t = tw.kernel_seconds(match)
    if n == 0 or t <= 0:
        return None
    return 100.0 * bound_s * min(1.0, n / launches) / t


def kernel_ms_per_step(ctx, label: str) -> Optional[float]:
    tw = ctx.trace
    steps = ctx.counters.get("traced_steps", 0)
    if tw is None or not tw.kernels or not steps:
        return None
    ns = sum(k.dur_ns for k in tw.kernels if train_class(k.name) == label)
    return ns / 1e6 / steps


def clip_flops(cfg) -> float:
    """Operations of one clip's round trip: the GPT's products over the
    265 positions that choose a token, the VQ-VAE decoder's and MelGAN's
    convolutions and products, counted from shapes."""
    v, m = cfg["vqvae"], cfg["model"]
    positions = v["code_h"] * v["code_w"]
    with torch.device("meta"):
        vq = ref_detok.VQDecode(v)
        mg = ref_detok.MelGAN(cfg["vocoder"])
        grid = torch.zeros((1, v["code_h"], v["code_w"]), dtype=torch.long)
        mel = torch.zeros((1, cfg["vocoder"]["n_mel_channels"],
                           v["resolution"]))
    return (counts.decode_flops_per_clip(m, positions)
            + counts.conv_flops(vq, grid) + counts.conv_flops(mg, mel))


def share_of_peak(flops_per_s: float, kind: str = "bf16") -> float:
    return 100.0 * flops_per_s / counts.PEAK_OPS_PER_S[kind]
