"""Code-grid <-> token-sequence ordering.

The port's own copy of melspec_gpt_vqvae_tpu/utils/codes.py (numpy only).
The VQ-VAE emits a (5, 53) = (freq, time) grid of code indices; the GPT
models read a 265-token sequence in time-major (column-major) order
(reference: transformer/minGPT.py:387-394 permute and flatten, :431-456
``make_idx`` / ``code_reader``; the decode reshape at
callbacks/GPT_VAE_callbacks.py:395).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_idx(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(forward, backward) permutations between row-major raster order and
    column-major GPT order (reference: minGPT.py:431-435)."""
    idx = np.arange(h * w).reshape(h, w).T.ravel()
    return idx, np.argsort(idx)


def grid_to_sequence(codes):
    """(..., H, W) -> (..., W*H) column-major tokens
    (reference get_x / get_input: minGPT.py:387-394,
    Lit_GPT_VAE.py:229-240)."""
    codes = np.asarray(codes)
    return np.swapaxes(codes, -1, -2).reshape(*codes.shape[:-2], -1)


def sequence_to_grid(seq, h: int = 5, w: int = 53):
    """(..., W*H) tokens -> (..., H, W) raster grid (the inverse of
    ``grid_to_sequence``; used before the VQ-VAE decode)."""
    seq = np.asarray(seq)
    return np.swapaxes(seq.reshape(*seq.shape[:-1], w, h), -1, -2)


def code_reader(x, h: int = 5, w: int = 53, reverse: bool = False):
    """Permute flat (B, L) sequences between raster and GPT order, with the
    reference's "infinite sampling" width scaling when L is a multiple of
    h*w (reference: minGPT.py:438-456)."""
    x = np.asarray(x)
    L = x.shape[-1]
    base = h * w
    if L > base:
        if L % base != 0:
            raise ValueError(f"L={L} is not a multiple of {base}")
        w = w * (L // base)
    idx, rev = make_idx(h, w)
    return x[..., rev] if reverse else x[..., idx]
