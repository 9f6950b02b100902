"""Kernel A's tile design on the CPU: row tiles, column steps, online
softmax and the bfloat16 rounding order.

The Hopper kernel (csrc/attention.cu::attention_tile_kernel, on the tiles
of csrc/attn_tiles.cuh) runs only on the card, where chip_smoke.py holds it
to ``attend_xla``.  Here the same loops in plain PyTorch
(``attend_ref_tiled``, with ``split3_matmul`` as the float32 product) are
held to the whole-row plain version and to the JAX package's
``attend_pallas`` (interpret mode on the CPU) on numpy-seeded inputs.
Bounds: float32 2e-5, the JAX package's (tests/test_ops.py); bfloat16 1e-2
of max |out| (outputs are rounded to bfloat16, 2^-8 relative).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.ops import attention as JA
from melspec_gpt_vqvae_tpu_torch.ops import attention as TA
from melspec_gpt_vqvae_tpu_torch.ops import flash_attention as TF

torch.set_num_threads(1)

TOL_F32 = 2e-5


def _inputs(seed, b, h, t, hd=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, hd)).astype(np.float32)
            for _ in range(3)]


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


def _cases(lengths):
    for t in lengths:
        for nu in sorted({0, min(11, t), t}):
            yield pytest.param(t, nu, id=f"T{t}-nu{nu}")


# ------------------- (a) against the whole-row plain version ----------------

@pytest.mark.parametrize("t,n_unmasked",
                         list(_cases((1, 16, 17, 37, 64, 65, 265, 266))))
def test_tiled_float32_equals_attend_xla(t, n_unmasked):
    """The tile loops with the kernel's three-term TF32 product stay inside
    the float32 bound of the plain version."""
    q, k, v = map(torch.from_numpy, _inputs(300 + t + n_unmasked, 1, 2, t))
    ref = TA.attend_xla(q, k, v, n_unmasked)
    out = TA.attend_ref_tiled(q, k, v, n_unmasked, matmul=TF.split3_matmul)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert _err(out, ref) <= TOL_F32


@pytest.mark.parametrize("t,n_unmasked",
                         list(_cases((1, 16, 17, 37, 64, 65, 265, 266))))
def test_tiled_bfloat16_equals_attend_xla(t, n_unmasked):
    """bfloat16: the tile kernel rounds the unnormalised probabilities of
    the online softmax where the plain version rounds the normalised ones;
    the outputs agree within 1e-2 of max |out|."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(400 + t + n_unmasked, 2, 2, t))
    ref = TA.attend_xla(q, k, v, n_unmasked)
    out = TA.attend_ref_tiled(q, k, v, n_unmasked)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert _err(out, ref) <= 1e-2 * ref.float().abs().max().item()


def test_one_term_product_misses_the_float32_bound():
    """A single TF32 product is not enough for 2e-5: the three-term split
    is what the float32 kernel needs."""
    q, k, v = map(torch.from_numpy, _inputs(5, 2, 2, 265))
    ref = TA.attend_xla(q.double(), k.double(), v.double(), 0)
    one = TA.attend_ref_tiled(
        q, k, v, 0, matmul=functools.partial(TF.split3_matmul, terms=1))
    three = TA.attend_ref_tiled(q, k, v, 0, matmul=TF.split3_matmul)
    assert _err(three, ref) <= TOL_F32 < _err(one, ref)


@pytest.mark.parametrize("n_unmasked", [0, 13, 29])
def test_tiled_small_tiles_cross_the_window(n_unmasked):
    """Tiles smaller than n_unmasked: rows inside the window see column
    steps above the diagonal."""
    q, k, v = map(torch.from_numpy, _inputs(6, 1, 2, 29, hd=8))
    ref = TA.attend_xla(q, k, v, n_unmasked)
    out = TA.attend_ref_tiled(q, k, v, n_unmasked, tile_m=8, tile_c=4)
    assert _err(out, ref) <= 2e-6


@pytest.mark.parametrize("t,n_unmasked", list(_cases((37, 265))))
def test_float32_tiles_are_kernel_f_forward_at_keep_1(t, n_unmasked):
    """Kernels A (float32) and F (forward, no keep-mask) are two kernels for
    one function on the same tiles: their loops give the same bits."""
    q, k, v = map(torch.from_numpy, _inputs(7 + t, 1, 2, t))
    a = TA.attend_ref_tiled(q, k, v, n_unmasked, matmul=TF.split3_matmul)
    f, _ = TF.flash_attention_ref_fwd_tiled(q, k, v, None, n_unmasked, 1.0,
                                            matmul=TF.split3_matmul)
    assert _err(a, f) <= 2e-7


# ------------------- (b) against the JAX package ----------------------------

@pytest.mark.parametrize("t,n_unmasked", list(_cases((1, 17, 37, 265, 266))))
def test_tiled_matches_jax_pallas_kernel(t, n_unmasked):
    """The tile loops against the JAX package's ``attend_pallas`` (Pallas
    interpret mode on the CPU), float32, within its 2e-5."""
    b, h = (1, 1) if t > 64 else (1, 2)
    q, k, v = _inputs(500 + t + n_unmasked, b, h, t)
    ref = np.asarray(JA.attend_pallas(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), n_unmasked=n_unmasked))
    out = TA.attend_ref_tiled(*map(torch.from_numpy, (q, k, v)), n_unmasked,
                              matmul=TF.split3_matmul)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL_F32)


@pytest.mark.parametrize("t,n_unmasked", list(_cases((17, 266))))
def test_tiled_bfloat16_matches_jax(t, n_unmasked):
    """bfloat16 against the JAX ``attend_xla`` on the same bfloat16 inputs
    (handed over as float32 arrays holding bfloat16 values)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in
               _inputs(600 + t, 1, 2, t))
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                  for a in (q, k, v))
    ref = np.asarray(JA.attend_xla(jq, jk, jv, n_unmasked)
                     .astype(jnp.float32))
    out = TA.attend_ref_tiled(q, k, v, n_unmasked).float().numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


# ------------------- (c) the wrapper's launch checks -------------------------

def test_launch_checks_follow_the_kernel_that_runs():
    """T <= 16 or another head dim goes to the warp-a-row kernel, bounded
    by its shared memory; T > 16 at head dim 64 goes to the tile kernel,
    which takes any T."""
    def z(t, hd=64, dtype=torch.float32):
        return torch.zeros(1, 1, t, hd, dtype=dtype)
    for t in (1, 16):
        assert TA._check(z(t), z(t), z(t)) is False
    for t in (17, 266, 4096):
        assert TA._check(z(t), z(t), z(t)) is True
        assert TA._check(*(z(t, dtype=torch.bfloat16),) * 3) is True
    assert TA._check(z(266, 32), z(266, 32), z(266, 32)) is False
    with pytest.raises(ValueError, match="shared memory"):
        TA._check(z(4096, 32), z(4096, 32), z(4096, 32))
    with pytest.raises(ValueError, match="share one"):
        TA._check(z(17), z(18), z(17))
    with pytest.raises(TypeError):
        TA._check(z(17), z(17, dtype=torch.bfloat16), z(17))
    with pytest.raises(TypeError):
        TA._check(*(z(17, dtype=torch.float16),) * 3)


def test_rows16_relays_odd_offsets():
    flat = torch.zeros(2 * 17 * 64 + 1)
    view = flat[1:].view(1, 2, 17, 64)
    (fixed,) = TA.rows16(view)
    assert view.data_ptr() % 16 and fixed.data_ptr() % 16 == 0
    assert torch.equal(fixed, view)
    (same,) = TA.rows16(fixed)
    assert same.data_ptr() == fixed.data_ptr()


def test_attend_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v = map(torch.from_numpy, _inputs(8, 1, 2, 37))
    before = TA.attend.launches
    assert torch.equal(TA.attend(q, k, v, 11), TA.attend_xla(q, k, v, 11))
    assert TA.attend.launches == before
