"""PyTorch port: the Python side of the redesigned kernels E and B.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there).  What surrounds them is held here on
the CPU: kernel E's split of one (b, h)'s rows over several CTAs and the
merge of their partial results, as the plain functions
``decode_attend_int8_split`` / ``merge_partials``, against
``decode_attend_int8_xla`` within 1e-5 (float32 sums in another order);
kernel B's packed bfloat16 weight slices, which unpack to the convs'
weights exactly (bfloat16 weights) or to their round-to-nearest-even
(float32 weights), the generator's keeping of the packed weights, and the
tile choice.
"""

import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu_torch.models.gpt import (_quantize_kv,
                                                    _quantize_kv4)
from melspec_gpt_vqvae_tpu_torch.models.vocoder import (MelGANGenerator,
                                                        MelGANResnetBlock)
from melspec_gpt_vqvae_tpu_torch.ops import decode_attention as TDA
from melspec_gpt_vqvae_tpu_torch.ops import vocoder_stack as TVS

torch.set_num_threads(1)


# ------------------------------- kernel E -----------------------------------

def _cache(bits, b, h, t, hd, seed):
    rng = np.random.default_rng(seed)
    quant = _quantize_kv if bits == "int8" else _quantize_kv4
    out = []
    for _ in range(2):
        q, s = quant(torch.from_numpy(
            rng.standard_normal((2, b, h, t, hd)).astype(np.float32)))
        out += [q, s.to(torch.bfloat16)]
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    return (q, *out)


@pytest.mark.parametrize("bits", ["int8", "int4"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("pos", [0, 5, 36])
def test_split_and_merge_equals_the_plain_version(bits, splits, pos):
    """Every split count the wrapper can choose, shares that come out empty
    included (pos 0 with 4 shares), merges to ``decode_attend_int8_xla``."""
    q, k, ks, v, vs = _cache(bits, 2, 3, 37, 32, seed=pos + splits)
    ref = TDA.decode_attend_int8_xla(q, k, v, ks, vs, 1, pos)
    out = TDA.decode_attend_int8_split(q, k, v, ks, vs, 1, pos, splits)
    assert out.shape == ref.shape and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_merge_partials_ignores_empty_shares_and_large_maxima():
    rng = np.random.default_rng(0)
    m = torch.tensor(rng.standard_normal((4, 3)).astype(np.float32)) * 50
    s = torch.tensor(rng.uniform(1, 5, (4, 3)).astype(np.float32))
    o = torch.tensor(rng.standard_normal((4, 3, 8)).astype(np.float32))
    ref = TDA.merge_partials(m, s, o)
    inf = torch.full((4, 1), float("-inf"))
    out = TDA.merge_partials(torch.cat([m, inf], 1),
                             torch.cat([s, torch.zeros(4, 1)], 1),
                             torch.cat([o, torch.zeros(4, 1, 8)], 1))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert torch.isfinite(out).all()
    # one share: the merge is the share's own normalisation
    torch.testing.assert_close(TDA.merge_partials(m[:, :1], s[:, :1],
                                                  o[:, :1]),
                               o[:, 0] / s[:, :1])


@pytest.mark.parametrize("bh, n, want", [
    (128, 266, 1),      # batch 8: the (b, h) pairs fill the card
    (66, 266, 1), (16, 266, 4), (16, 133, 2), (16, 34, 1), (16, 1, 1),
    (32, 266, 4), (48, 200, 2), (8, 1000, 4)])
def test_choose_splits(bh, n, want):
    assert TDA.choose_splits(bh, n) == want
    assert 1 <= TDA.choose_splits(bh, n) <= TDA.MAX_SPLITS


@pytest.mark.parametrize("pairs, want", [
    (8192, True),    # the VAS offline batch: 512 x 16
    (5888, True),    # the XL prior batch: 256 x 23
    (128, False),    # a served batch of 8
    (184, False),    # the XL decoder at batch 8
    (16, False)])    # batch 1: the rows split over a cluster
def test_use_streamed(pairs, want):
    assert TDA.use_streamed(pairs) is want


def _launched(monkeypatch, b, h, **kw):
    """The arguments ``decode_attend_int8`` hands the kernel for a (b, h)
    batch, recorded on the CPU in place of a launch."""
    from melspec_gpt_vqvae_tpu_torch import _build
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: calls.append(args))
    q, k, ks, v, vs = _cache("int8", b, h, 8, 16, seed=b)
    launches, streamed = (TDA.decode_attend_int8.launches,
                          TDA.decode_attend_int8.streamed)
    try:
        TDA.decode_attend_int8(q, k, v, ks, vs, 1, 5, **kw)
        counted = (TDA.decode_attend_int8.launches - launches,
                   TDA.decode_attend_int8.streamed - streamed)
    finally:
        TDA.decode_attend_int8.launches = launches
        TDA.decode_attend_int8.streamed = streamed
    (args,) = calls
    # ..., splits, per_cap, split_bh, streamed
    return {"pairs": args[-2], "streamed": args[-1], "counted": counted}


@pytest.mark.parametrize("b, h, split_pairs", [
    (96, 16, None),       # one card: the whole batch, 96 x 16 = 1,536 pairs
    (48, 16, 96 * 16),    # a data rank's half with the whole batch's count
    (96, 8, 96 * 16)])    # a model rank's heads: given the same count
def test_a_mesh_rank_takes_the_body_one_card_takes(monkeypatch, b, h,
                                                    split_pairs):
    """The body is chosen from ``split_pairs``, the whole batch's pairs
    (models/gpt.py::split_pairs on a mesh), not from the launch's own: a
    rank with half the batch, 768 pairs, streams as one card with 1,536
    does; left to its own count it would not."""
    kw = {} if split_pairs is None else {"split_pairs": split_pairs}
    got = _launched(monkeypatch, b, h, **kw)
    assert TDA.use_streamed(96 * 16) and not TDA.use_streamed(48 * 16)
    assert got == {"pairs": 96 * 16, "streamed": 1, "counted": (1, 1)}


def test_rows_off_16_bytes_are_copied_and_scales_off_4_refused(monkeypatch):
    """The streamed body copies the q, k_new and v_new rows 16 bytes and
    the scales 4 bytes at a time: the wrapper hands the kernel rows that
    start on 16 bytes (a view that does not is copied) and refuses scales
    that are not on 4."""
    from melspec_gpt_vqvae_tpu_torch import _build
    calls = []
    monkeypatch.setattr(_build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: calls.append(args))
    q, k, ks, v, vs = _cache("int8", 4, 2, 8, 16, seed=0)
    q_off = torch.zeros(q.numel() + 1)[1:].view_as(q)   # on 4 bytes only
    q_off.copy_(q)
    ks_off = torch.zeros(ks.numel() + 1, dtype=torch.bfloat16)[1:]
    ks_off = ks_off.view_as(ks)
    ks_off.copy_(ks)
    assert q_off.data_ptr() % 16 and ks_off.data_ptr() % 4
    launches, streamed = (TDA.decode_attend_int8.launches,
                          TDA.decode_attend_int8.streamed)
    try:
        TDA.decode_attend_int8(q_off, k, v, ks, vs, 1, 5, k_new=q_off,
                               v_new=q_off)
        with pytest.raises(ValueError, match="4-byte aligned"):
            TDA.decode_attend_int8(q, k, v, ks_off, vs, 1, 5)
    finally:
        TDA.decode_attend_int8.launches = launches
        TDA.decode_attend_int8.streamed = streamed
    (args,) = calls
    # q, k_new, v_new: the first three pointers, each on 16 bytes
    assert all(p % 16 == 0 for p in args[:3])


def test_a_small_batch_takes_the_split_body(monkeypatch):
    got = _launched(monkeypatch, 8, 16)
    assert got == {"pairs": 128, "streamed": 0, "counted": (1, 0)}
    assert not TDA.use_streamed(48 * 16)
    got = _launched(monkeypatch, 48, 16)
    assert got == {"pairs": 48 * 16, "streamed": 0, "counted": (1, 0)}


@pytest.mark.parametrize("bits", ["int8", "int4"])
@pytest.mark.parametrize("chunk, pos", [
    (32, 0), (32, 31), (32, 32), (32, 33), (32, 64), (32, 69),
    (4, 3), (4, 4), (4, 11), (5, 23)])
@pytest.mark.parametrize("write", [False, True])
def test_streamed_chunks_equal_the_plain_version(bits, chunk, pos, write):
    """The streamed body's arithmetic -- the rows in chunks whose edges
    depend on the position alone, an online softmax folded over them in
    order -- against ``decode_attend_int8_xla`` within 1e-5 (float32 sums
    in another order), at positions on and across chunk edges; with the
    write, both read the cache after ``write_kv_rows`` put this step's
    rows at ``pos``, as the kernel attends the row it quantised."""
    q, k, ks, v, vs = _cache(bits, 2, 3, 70, 32, seed=pos + chunk)
    if write:
        rng = np.random.default_rng(pos)
        kn, vn = (torch.from_numpy(rng.standard_normal((2, 3, 32))
                                   .astype(np.float32)) for _ in range(2))
        TDA.write_kv_rows(k, v, ks, vs, 1, pos, kn, vn)
    ref = TDA.decode_attend_int8_xla(q, k, v, ks, vs, 1, pos)
    out = TDA.decode_attend_int8_streamed(q, k, v, ks, vs, 1, pos, chunk)
    assert out.shape == ref.shape and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # the same chunks' (max, sum, o) merged at once: the same sum
    splits = -(-(pos + 1) // chunk)
    if (pos + 1) % chunk == 0 or splits == 1:
        torch.testing.assert_close(
            out, TDA.decode_attend_int8_split(q, k, v, ks, vs, 1, pos,
                                              splits), rtol=1e-5, atol=1e-5)


# ------------------------------- kernel B -----------------------------------

def _stack(c, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    blocks = [MelGANResnetBlock(c, 3 ** j) for j in range(3)]
    with torch.no_grad():
        for blk in blocks:
            for p in blk.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return [blk.to(dtype) for blk in blocks]


@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pack_bf16_unpacks_to_the_convs_weights(c, dtype):
    """bfloat16 weights pack exactly; float32 weights to their
    round-to-nearest-even bfloat16; biases stay float32 values."""
    blocks = _stack(c, dtype)
    w, bias = TVS.pack_bf16(blocks, torch.device("cpu"))
    assert w.shape == (3, 5 * c // 32, c, 32) and w.dtype == torch.bfloat16
    assert bias.shape == (3, 3, c) and bias.dtype == torch.float32
    assert w.is_contiguous() and bias.is_contiguous()
    for blk, got in zip(blocks, TVS.unpack_bf16(w, bias)):
        want = (blk.block_conv1.weight, blk.block_conv1.bias,
                blk.shortcut.weight, blk.shortcut.bias,
                blk.block_conv2.weight, blk.block_conv2.bias)
        for i, (a, b) in enumerate(zip(got, want)):
            b = b.detach()
            b = b.bfloat16() if i % 2 == 0 else b.float()
            assert a.shape == b.shape
            assert torch.equal(a, b)


def test_pack_bf16_slice_order():
    """Slice s of a block holds, for conv3 tap s // (C/32), shortcut, conv1
    in that order, input channels 32 (s % (C/32)) .. + 32 as
    [c_out][c_in]."""
    c = 64
    blocks = _stack(c, torch.bfloat16, seed=1)
    w, _ = TVS.pack_bf16(blocks, torch.device("cpu"))
    blk = blocks[2]
    assert torch.equal(w[2, 3], blk.block_conv1.weight[:, 32:64, 1])
    assert torch.equal(w[2, 4], blk.block_conv1.weight[:, 0:32, 2])
    assert torch.equal(w[2, 6], blk.shortcut.weight[:, 0:32, 0])
    assert torch.equal(w[2, 9], blk.block_conv2.weight[:, 32:64, 0])


def test_pack_f32_layout():
    c = 32
    blocks = _stack(c, torch.float32, seed=2)
    w = TVS.pack_f32(blocks, torch.device("cpu"))
    per = 5 * c * c + 3 * c
    assert w.shape == (3 * per,) and w.dtype == torch.float32
    blk = blocks[1]
    w3 = w[per:per + 3 * c * c].reshape(3, c, c)      # (tap, c_in, c_out)
    assert torch.equal(w3, blk.block_conv1.weight.permute(2, 1, 0))
    assert torch.equal(w[per + 3 * c * c:per + 3 * c * c + c],
                       blk.block_conv1.bias)


def _generator(dtype, seed=0):
    """A shallow MelGAN (stages of 64 and 32 channels) with seeded weights."""
    from melspec_gpt_vqvae_tpu_torch.configs import VocoderConfig
    gen = MelGANGenerator(VocoderConfig(n_mel_channels=8, ngf=32,
                                        ratios=(2, 2)))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return gen.to(dtype)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_packed_weights_are_cached_until_a_weight_changes(kind):
    """The generator packs a stage's weights once and again after a weight
    was changed in place, a bias too, or replaced outright; the other
    stage's stay."""
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    gen = _generator(dtype)
    blocks = gen.stage_blocks(0)
    first = gen.packed_stage(0)
    assert gen.packed_stage(0) is first and gen.packs == 1
    other = gen.packed_stage(1)
    assert gen.packs == 2

    def same(got):
        want = TVS.pack(blocks, torch.device("cpu"), dtype)
        return all(torch.equal(a, b) for a, b in zip(
            got if kind == "bf16" else [got],
            want if kind == "bf16" else [want]))
    assert same(first)
    with torch.no_grad():                       # in place: _version moves
        blocks[1].shortcut.weight.mul_(2.0)
    rebuilt = gen.packed_stage(0)
    assert gen.packs == 3 and rebuilt is not first and same(rebuilt)
    if kind == "bf16":
        got = TVS.unpack_bf16(*rebuilt)[1][2]
        assert torch.equal(got, blocks[1].shortcut.weight.detach())
    with torch.no_grad():                       # a bias too
        blocks[0].block_conv2.bias.add_(1.0)
    assert same(gen.packed_stage(0)) and gen.packs == 4
    blocks[2].block_conv1.weight = torch.nn.Parameter(  # replaced outright
        torch.zeros_like(blocks[2].block_conv1.weight))
    assert same(gen.packed_stage(0)) and same(gen.packed_stage(0))
    assert gen.packs == 5
    assert gen.packed_stage(1) is other
    blocks[0].shortcut.bias.data.add_(1.0)      # .data: no version moves
    assert not same(gen.packed_stage(0))
    gen.drop_packed()
    assert same(gen.packed_stage(0)) and gen.packs == 6


def test_packed_weights_follow_a_dtype_change_and_a_copy():
    import copy
    gen = _generator(torch.float32)
    assert gen.packed_stage(0).dtype == torch.float32   # pack_f32's block
    clone = copy.deepcopy(gen)           # a copy packs its own weights
    with torch.no_grad():
        clone.stage_blocks(0)[0].shortcut.weight.zero_()
    clone.to(torch.bfloat16)
    w, b = clone.packed_stage(0)         # now pack_bf16's operands
    assert w.dtype == torch.bfloat16
    assert not TVS.unpack_bf16(w, b)[0][2].any()
    assert TVS.unpack_bf16(w, b)[1][2].any()
    assert gen.packs == 1 and gen.packed_stage(0).dtype == torch.float32
    state = {k: torch.ones_like(v) for k, v in gen.state_dict().items()}
    gen.load_state_dict(state)           # copies in place: versions move
    assert torch.equal(gen.packed_stage(0), TVS.pack(
        gen.stage_blocks(0), torch.device("cpu"), torch.float32))
    assert gen.packs == 2


def test_pack_follows_the_dtype():
    """``pack`` makes the bfloat16 kernel's (w, bias) or the float32
    kernel's flat block, whatever dtype the weights have."""
    blocks = _stack(32, torch.float32)
    cpu = torch.device("cpu")
    w, bias = TVS.pack(blocks, cpu, torch.bfloat16)
    assert torch.equal(w, TVS.pack_bf16(blocks, cpu)[0])
    assert w.dtype == torch.bfloat16 and bias.dtype == torch.float32
    assert torch.equal(TVS.pack(blocks, cpu, torch.float32),
                       TVS.pack_f32(blocks, cpu))


@pytest.mark.parametrize("c, t", [(256, 6784), (128, 54272), (64, 108544),
                                  (32, 217088), (32, 40), (256, 10)])
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_bf16_tile_fits_shared_memory(c, t, batch):
    dils = [1, 3, 9]
    tile = TVS.bf16_tile(c, t, batch, dils)
    assert max(dils) <= tile <= t
    chunk = 32 * (8 // max(1, c // 64))
    smem = 2 * (2 * (tile + 26) * (c + 8) + chunk * (c + 8) + 3 * c * 40)
    assert smem <= 232448


def test_fused_stack_on_cpu_is_the_plain_version():
    blocks = _stack(32, torch.float32, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 50)).astype(np.float32))
    n = TVS.fused_resblock_stack.launches
    with torch.no_grad():
        out = TVS.fused_resblock_stack(x, blocks)
        ref = TVS.resblock_stack(x, blocks)
    assert torch.equal(out, ref) and TVS.fused_resblock_stack.launches == n
