"""Kernel F's design on the CPU: the three-term TF32 product, the tile
loops and their bounds, the keep-mask draw.

The Hopper kernel (csrc/flash_attention.cu) runs only on the card, where
chip_smoke.py holds it to the plain versions.  Here the same arithmetic in
plain PyTorch (``split3_matmul``, ``flash_attention_ref_fwd_tiled`` /
``_bwd_tiled``) is held to float64, to the whole-row plain versions and to
the JAX package's interpret-mode ``flash_attention`` and ``jax.grad``, on
numpy-seeded inputs.  Bounds are the JAX package's
(tests/test_flash_attention.py): 3e-5 on O and lse, 5e-5 on gradients.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.ops import flash_attention as JF
from melspec_gpt_vqvae_tpu_torch.ops import flash_attention as TF
from melspec_gpt_vqvae_tpu_torch.ops.attention import window_mask

torch.set_num_threads(1)

TOL_OUT, TOL_GRAD = 3e-5, 5e-5


def _inputs(seed, b, h, t, hd=64, keep_prob=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, hd)).astype(np.float32)
                   for _ in range(4))
    keep = ((rng.uniform(size=(b, h, t, t)) < keep_prob).astype(np.uint8)
            if keep_prob < 1.0 else None)
    return q, k, v, do, keep


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


# --------------------------- (a) the product -------------------------------

def test_tf32_round_keeps_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 37)
    r = TF.tf32_round(x)
    assert torch.equal(r.view(torch.int32) & 0x1fff,
                       torch.zeros_like(r, dtype=torch.int32))
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(TF.tf32_round(r), r)
    cut = TF.tf32_truncate(x)
    assert torch.equal(cut.view(torch.int32) & 0x1fff,
                       torch.zeros_like(r, dtype=torch.int32))
    assert (cut.abs() <= x.abs()).all()
    assert ((cut - x).abs() < x.abs() * 2.0 ** -10).all()
    # ties round away from zero, as cvt.rna
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(TF.tf32_round(tie),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))


def test_split3_matmul_keeps_float32_accuracy():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    three = _err(TF.split3_matmul(a, b), exact)
    one = _err(TF.split3_matmul(a, b, terms=1), exact)
    plain = _err(a @ b, exact)
    assert three <= 4 * plain + 1e-6
    assert one > 100 * three


@pytest.mark.parametrize("keep_prob", [1.0, 0.5])
def test_three_term_product_meets_the_bounds_one_term_does_not(keep_prob):
    """The tile loops with the kernel's product at (2, 2, 265, 64) randn
    against float64: three TF32 terms stay inside 3e-5 / 5e-5, a single
    TF32 product does not."""
    q, k, v, do, keep = _inputs(2, 2, 2, 265, keep_prob=keep_prob)
    q32, k32, v32, do32, keep_t = _t(q, k, v, do, keep)
    q64, k64, v64, do64 = (x.double() for x in (q32, k32, v32, do32))
    o64, lse64 = TF.flash_attention_ref_fwd(q64, k64, v64, keep_t, 0,
                                            keep_prob)
    g64 = TF.flash_attention_ref_bwd(q64, k64, v64, keep_t, lse64, do64, 0,
                                     keep_prob)
    errs = {}
    for terms in (3, 1):
        mm = functools.partial(TF.split3_matmul, terms=terms)
        o, lse = TF.flash_attention_ref_fwd_tiled(q32, k32, v32, keep_t, 0,
                                                  keep_prob, matmul=mm)
        # the gradients from the exact residuals, so that each pass is
        # held on its own
        grads = TF.flash_attention_ref_bwd_tiled(
            q32, k32, v32, keep_t, o64.float(), lse64.float(), do32, 0,
            keep_prob, matmul=mm)
        errs[terms] = (max(_err(o, o64), _err(lse, lse64)),
                       max(_err(a, b) for a, b in zip(grads, g64)))
    assert errs[3][0] <= TOL_OUT and errs[3][1] <= TOL_GRAD, errs
    assert errs[1][0] > TOL_OUT and errs[1][1] > TOL_GRAD, errs


# --------------------------- (b) the tile loops ----------------------------

def _cases():
    for t in (1, 37, 265, 266):
        for nu in sorted({0, min(11, t), t}):
            for with_mask in (False, True):
                yield pytest.param(t, nu, with_mask,
                                   id=f"T{t}-nu{nu}-keep{int(with_mask)}")


@pytest.mark.parametrize("t,n_unmasked,with_mask", list(_cases()))
def test_tiled_equals_whole_row(t, n_unmasked, with_mask):
    """Row tiles, column steps, online softmax and the column kernel's row
    steps give the whole-row plain version's numbers within 2e-6 (relative
    to the largest value of each tensor, at least 1)."""
    keep_prob = 0.5 if with_mask else 1.0
    arrays = _inputs(100 + t + n_unmasked, 1, 2, t, keep_prob=keep_prob)
    q, k, v, do, keep = _t(*arrays)
    args = (n_unmasked, keep_prob)
    o_ref, lse_ref = TF.flash_attention_ref_fwd(q, k, v, keep, *args)
    g_ref = TF.flash_attention_ref_bwd(q, k, v, keep, lse_ref, do, *args)
    o, lse = TF.flash_attention_ref_fwd_tiled(q, k, v, keep, *args)
    grads = TF.flash_attention_ref_bwd_tiled(q, k, v, keep, o, lse, do, *args)
    for ours, ref in zip((o, lse, *grads), (o_ref, lse_ref, *g_ref)):
        assert ours.shape == ref.shape and torch.isfinite(ours).all()
        assert _err(ours, ref) <= 2e-6 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("t,n_unmasked,with_mask", list(_cases()))
def test_tiled_matches_jax(t, n_unmasked, with_mask):
    """The tile loops against the JAX package's flash_attention (Pallas
    interpret mode on the CPU) and jax.grad, within the JAX bounds."""
    keep_prob = 0.5 if with_mask else 1.0
    b, h = (1, 1) if t > 64 else (1, 2)
    q, k, v, do, keep = _inputs(200 + t + n_unmasked, b, h, t,
                                keep_prob=keep_prob)
    jmask = None if keep is None else jnp.asarray(keep, jnp.bfloat16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_ref, lse_ref = JF._flash_fwd_impl(jq, jk, jv, jmask, n_unmasked,
                                        keep_prob)
    g_ref = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(
        q, k, v, jmask, n_unmasked, keep_prob) * do), argnums=(0, 1, 2))(
        jq, jk, jv)
    tq, tk, tv, tdo, tkeep = _t(q, k, v, do, keep)
    args = (n_unmasked, keep_prob)
    o, lse = TF.flash_attention_ref_fwd_tiled(tq, tk, tv, tkeep, *args)
    grads = TF.flash_attention_ref_bwd_tiled(tq, tk, tv, tkeep, o, lse, tdo,
                                             *args)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=TOL_OUT)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               atol=TOL_OUT)
    for ours, ref in zip(grads, g_ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=TOL_GRAD)


def test_tiled_small_tiles_cross_the_window():
    """Tiles smaller than n_unmasked: rows inside the window see column
    steps above the diagonal, and the column tiles inside it start at row
    0."""
    q, k, v, do, keep = _t(*_inputs(7, 1, 1, 29, hd=8, keep_prob=0.7))
    o_ref, lse_ref = TF.flash_attention_ref_fwd(q, k, v, keep, 13, 0.7)
    g_ref = TF.flash_attention_ref_bwd(q, k, v, keep, lse_ref, do, 13, 0.7)
    tiles = dict(tile_m=8, tile_c=4)
    o, lse = TF.flash_attention_ref_fwd_tiled(q, k, v, keep, 13, 0.7,
                                              **tiles)
    grads = TF.flash_attention_ref_bwd_tiled(q, k, v, keep, o, lse, do, 13,
                                             0.7, tile_r=4, **tiles)
    for ours, ref in zip((o, lse, *grads), (o_ref, lse_ref, *g_ref)):
        assert _err(ours, ref) <= 2e-6 * max(1.0, ref.abs().max().item())


# --------------------------- (c) tile visibility ---------------------------

@pytest.mark.parametrize("tile", [64, 32, 8, 5])
def test_tile_bounds_against_window_mask(tile):
    """For every T <= 70 and n_unmasked <= T: a row tile's ``visible_cols``
    is exactly the extent of the columns its rows see, and a column tile's
    ``first_row`` exactly the first row that sees it."""
    for t in range(1, 71):
        for nu in range(0, t + 1):
            mask = window_mask(t, nu)
            for lo in range(0, t, tile):
                hi = min(lo + tile, t) - 1
                seen = np.flatnonzero(mask[lo:hi + 1].any(0))
                assert TF.visible_cols(lo, hi, nu) == seen.max() + 1
                seeing = np.flatnonzero(mask[:, lo:hi + 1].any(1))
                assert TF.first_row(lo, nu) == seeing.min()


# --------------------------- (d) the keep-mask draw ------------------------

PINNED_MASKS = ["85d4dfa04cf17971", "f4e2c589909eaa17", "9ced6a2c2be1a004"]


def test_make_dropout_mask_bits_are_pinned():
    """The bits a seeded CPU generator gives for the keep-mask: the kernel's
    redesign must not change what is drawn or in which order."""
    g = torch.Generator().manual_seed(1234)
    digests = []
    for shape, rate in (((2, 3, 37, 37), 0.5), ((1, 2, 265, 265), 0.5),
                        ((2, 2, 19, 19), 0.3)):
        m = TF.make_dropout_mask(g, shape, rate)
        assert m.dtype == torch.uint8 and tuple(m.shape) == shape
        assert m.is_contiguous() and int(m.max()) <= 1
        digests.append(hashlib.sha256(m.numpy().tobytes()).hexdigest()[:16])
    assert digests == PINNED_MASKS
    assert TF.make_dropout_mask(g, (1, 1, 4, 4), 0.0) is None
    assert TF.make_dropout_mask(None, (1, 1, 4, 4), 0.5) is None


def test_wrapper_takes_long_sequences_and_odd_offsets():
    """The launch checks no longer bound T by a shared-memory formula, and
    a contiguous view at an odd storage offset is re-laid for the kernel's
    16-byte copies."""
    q = torch.zeros(1, 1, 4096, TF.HEAD_DIM)
    assert TF._check(q, q, q, None) is None
    flat = torch.zeros(2 * 8 * 64 + 1)
    view = flat[1:].view(1, 2, 8, 64)
    (fixed,) = TF._rows16(view)
    assert view.data_ptr() % 16 and fixed.data_ptr() % 16 == 0
    assert torch.equal(fixed, view)
