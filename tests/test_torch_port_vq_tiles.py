"""PyTorch port, kernel C's tile loops on the CPU.

Kernel C (csrc/vq.cu) cannot run without the card.  Its loops exist in
plain PyTorch (``ops/vq.py::vq_nearest_index_tiled``): a persistent grid of
CTAs over row tiles of the height ``tile_rows`` picks, rows and codes in
chunks of 64 d against 128 codes, each thread's running minimum over its
codes (tx + 16 c, in increasing order) and the merge of the sixteen threads
that share a row, the lower index winning a tie.  Seeded inputs with planted
ties go through it, through the plain version and through the JAX package's
``vq_nearest_index``; the indices must be equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_gpt_vqvae_tpu.ops import vq as JV
from melspec_gpt_vqvae_tpu_torch.ops import vq as TV

torch.set_num_threads(1)


def _inputs(n, k, d, seed):
    """Latents and a codebook with planted ties: duplicated codes (the
    lower index must win, also across the sixteen lanes and across code
    tiles) and rows that sit exactly on a code."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((k, d)).astype(np.float32)
    cb[k - 1] = cb[1]                   # a tie between the ends
    if k > 40:
        cb[33] = cb[17]                 # lanes 1 and 1, columns 1 and 2
        cb[20] = cb[4]                  # the same lane, neighbouring columns
    if k > 130:
        cb[129] = cb[1]                 # across code tiles
    for r, c in ((0, 1), (n // 2, min(17, k - 1)), (n - 1, min(4, k - 1))):
        x[r] = cb[c]
    return x, cb


# K = 7: less than one lane row; 128: the tokenize codebook, one code tile;
# 300: three code tiles, the last ragged (a small stand-in for K = 1024);
# N never a multiple of the tile, D with a ragged last chunk once
@pytest.mark.parametrize("n,k,d,ctas", [(70, 7, 16, 3), (203, 128, 256, 2),
                                        (150, 300, 96, 2), (333, 128, 64, 132),
                                        (45, 260, 72, 1)])
def test_tiled_loops_equal_plain_version_and_jax(n, k, d, ctas):
    x, cb = _inputs(n, k, d, seed=n + k)
    out, stats = TV.vq_nearest_index_tiled(torch.from_numpy(x),
                                           torch.from_numpy(cb), ctas)
    ref = TV.vq_nearest_index_xla(torch.from_numpy(x), torch.from_numpy(cb))
    jref = np.asarray(JV.vq_nearest_index(jnp.asarray(x), jnp.asarray(cb)))
    assert out.dtype == torch.int32 and out.shape == (n,)
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(out.numpy(), jref)
    # the planted ties went to the lower index
    assert int(out[0]) == 1
    assert stats["tiles"] == -(-n // stats["tile_rows"])
    assert stats["busiest"] == -(-stats["tiles"] // ctas)
    assert stats["chunks"] == stats["tiles"] * -(-k // 128) * -(-d // 64)
    assert n % stats["tile_rows"] != 0


def test_tile_height_leaves_the_busiest_cta_the_fewest_rows():
    """``tile_rows`` mirrors the kernel's host rule: among 64 .. 128 rows in
    steps of 16, the height with the fewest rows on the busiest CTA, the
    taller one on a tie."""
    def busy(n, rows, ctas):
        return -(-(-(-n // rows)) // ctas) * rows
    for n, ctas in ((12720, 132), (16960, 132), (135680, 132), (100, 132),
                    (64, 2), (1, 1), (129, 1), (8448, 132), (8449, 132)):
        rows = TV.tile_rows(n, ctas)
        assert rows in (64, 80, 96, 112, 128)
        best = min(busy(n, r, ctas) for r in (64, 80, 96, 112, 128))
        assert busy(n, rows, ctas) == best
        assert all(busy(n, r, ctas) > best for r in (64, 80, 96, 112, 128)
                   if r > rows)
    # the tokenize shape: 114 tiles of 112 rows, one a CTA
    assert TV.tile_rows(12720, 132) == 112
    assert TV.tile_rows(16960, 132) == 80


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    x, cb = _inputs(50, 9, 8, seed=1)
    before = TV.vq_nearest_index.launches
    out = TV.vq_nearest_index(torch.from_numpy(x), torch.from_numpy(cb))
    assert torch.equal(out, TV.vq_nearest_index_xla(torch.from_numpy(x),
                                                    torch.from_numpy(cb)))
    assert TV.vq_nearest_index.launches == before
