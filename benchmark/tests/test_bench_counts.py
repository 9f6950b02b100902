"""The operation and byte counts against values worked out by hand."""

import math

import pytest
import torch

from harness import counts, readers
from reference import detok


def test_decode_attention_bytes_at_batch_8():
    # K and V int8 rows 0..265 of one layer, their bf16 scales, q and the
    # new key and value in bf16, the float32 output
    kv = 2 * 266 * 8 * 16 * 64
    scales = 2 * 266 * 8 * 16 * 2
    assert counts.decode_attention_bytes(8, 16, 64, 266) == \
        kv + scales + 3 * 8 * 16 * 64 * 2 + 8 * 16 * 64 * 4 == 4_576_256
    assert counts.decode_attention_ops(8, 16, 64, 266) == 4 * 8 * 16 * 266 * 64


def test_decode_attention_bound_sums_positions():
    one = counts.bound_s(counts.decode_attention_bytes(2, 4, 8, 3),
                         counts.decode_attention_ops(2, 4, 8, 3), "f32")
    two = counts.bound_s(counts.decode_attention_bytes(2, 4, 8, 4),
                         counts.decode_attention_ops(2, 4, 8, 4), "f32")
    assert counts.decode_attention_bound(2, 4, 8, 5, [2, 3]) == \
        pytest.approx(5 * (one + two))
    # int4 holds half the bytes of the values, the same scales
    assert (counts.decode_attention_bytes(1, 1, 64, 10, "int8")
            - counts.decode_attention_bytes(1, 1, 64, 10, "int4")) == 640


def test_resblock_stack_ops_at_batch_8():
    stages = counts.melgan_stages(848, 32, (8, 8, 2, 2))
    assert stages == [(256, 6784), (128, 54272), (64, 108544), (32, 217088)]
    assert sum(counts.resblock_stack_ops(8, c, t) for c, t in stages) == \
        480_163_921_920


def test_resblock_stack_bytes():
    # input and output bf16, three blocks of 5 C^2 weights and 3 C biases
    assert counts.resblock_stack_bytes(2, 32, 100) == \
        (2 * 2 * 32 * 100 + 3 * (5 * 32 * 32 + 3 * 32)) * 2


@pytest.mark.parametrize("t,nu,pairs", [(4, 0, 10), (4, 4, 16), (5, 2, 16),
                                        (265, 265, 265 * 265),
                                        (265, 0, 265 * 266 // 2)])
def test_visible_pairs(t, nu, pairs):
    assert counts.visible_pairs(t, nu) == pairs
    # the reference's mask lets the same pairs through
    from reference.gpt import window_mask
    assert int(window_mask(t, nu, "cpu").sum()) == pairs


def test_flash_counts():
    b, h, t, hd = 24, 16, 265, 64
    qkvo = 4 * b * h * t * hd * 4
    assert counts.flash_fwd_bytes(b, h, t, hd, False) == qkvo + b * h * t * 4
    assert counts.flash_fwd_bytes(b, h, t, hd, True) == \
        qkvo + b * h * t * 4 + b * h * t * t
    assert counts.flash_bwd_bytes(b, h, t, hd, True) == \
        counts.flash_fwd_bytes(b, h, t, hd, True) + qkvo
    assert counts.flash_fwd_ops(b, h, t, hd, 0) == \
        4 * b * h * (t * (t + 1) // 2) * hd
    assert counts.flash_bwd_ops(b, h, t, hd, t) == 10 * b * h * t * t * hd
    # the encoder's forward moves more bytes than 495 TFLOP/s need time for
    bound = counts.flash_bound((b, h, t, hd), t, False, False)
    assert bound == pytest.approx(counts.flash_fwd_bytes(b, h, t, hd, False)
                                  / counts.HBM_BYTES_PER_S)


def test_gpt_flops():
    assert counts.gpt_fwd_flops(100, 2, 3, 4, 5) == \
        2 * 100 * 2 * 3 + 4 * 4 * 2 * 3 * 3 * 5
    m = {"n_embd": 8, "n_layer": 2, "vocab_size": 16}
    per_pos = 2 * (2 * 12 * 64 + 8 * 16)
    attn = sum(4 * 8 * (p + 1) * 2 for p in range(3))
    assert counts.decode_flops_per_clip(m, 3) == per_pos * 3 + attn


def test_conv_flops_counts_melgan_resblocks():
    """The flop counter over MelGAN's stacks alone equals the hand count
    (2 operations a multiply-add, 5 C^2 a sample a block)."""
    cfg = {"n_mel_channels": 80, "ngf": 4, "n_residual_layers": 3,
           "ratios": [8, 8, 2, 2]}
    with torch.device("meta"):
        mg = detok.MelGAN(cfg)
    stages = counts.melgan_stages(10, 4, (8, 8, 2, 2))
    total = counts.conv_flops(mg, torch.zeros((1, 80, 10), device="meta"))
    stacks = sum(counts.resblock_stack_ops(1, c, t) for c, t in stages)
    # the stem, the upsampling convs and the output conv, by hand
    rest = 2 * 80 * 64 * 7 * 10
    mult, t = 16, 10
    for r in (8, 8, 2, 2):
        cin, cout = mult * 4, mult * 4 // 2
        rest += 2 * cin * cout * 2 * r * t     # transposed: every input tap
        t *= r
        mult //= 2
    rest += 2 * 4 * 1 * 7 * t
    assert total == stacks + rest


def test_clip_flops_of_the_served_configuration():
    import json
    from harness.cell import BENCH_DIR
    cfg = json.load(open(BENCH_DIR / "configs" / "vas_gpt.json"))
    f = readers.clip_flops(cfg)
    gpt = counts.decode_flops_per_clip(cfg["model"], 265)
    assert gpt == pytest.approx(2 * 302_120_960 * 265 + sum(
        4 * 1024 * (p + 1) * 24 for p in range(265)))
    assert f > gpt and math.isfinite(f)


def test_peaks_table():
    assert counts.PEAK_OPS_PER_S["bf16"] == 989e12
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert readers.share_of_peak(989e12 / 2) == pytest.approx(50.0)


def test_kernels_a_decode_step_from_the_trace():
    """Two traced requests of 5 steps of 2 layers: a prefill of 3 kernels,
    then 7 kernels a step, two of them E, and 4 of the detok; the reader
    counts the steps between the first and the last, prefill and detok
    left out, and nothing where the trace lost an E launch."""
    import types

    from harness import cell
    from harness.trace import Kernel, TraceWindow
    step = ["ln", "decode_attention_kernel", "mm", "ln",
            "decode_attention_kernel", "mm", "sample"]
    names = (["prefill"] * 3 + step * 5 + ["detok"] * 4) * 2
    tw = TraceWindow([Kernel(n, 10 * i, 5) for i, n in enumerate(names)],
                     1.0)
    ctx = types.SimpleNamespace(
        trace=tw, config={"model": {"n_layer": 2}},
        counters={"steps": 5, "traced_units": 2})
    read = cell.reader("launches_per_token.serve")
    assert read(ctx) == 7
    tw.kernels.pop(4)
    assert read(ctx) is None
