"""Training attention with a dropout keep-mask: kernel F, forward and backward.

Counterpart of melspec_gpt_vqvae_tpu/ops/flash_attention.py.  The JAX
``flash_attention`` is a ``jax.custom_vjp`` whose forward saves (O, the
row logsumexp) and whose backward recomputes the probabilities from them;
here it is a ``torch.autograd.Function`` of the same shape:

  * ``flash_attention_ref_fwd`` / ``flash_attention_ref_bwd`` -- the plain
    PyTorch versions, the formulas of the TPU ``_fwd_kernel`` and
    ``_bwd_kernel`` (flash_attention.py:51-103) written out, including the
    ``n_unmasked`` window and the keep-mask scaling by ``1 / keep_prob`` in
    both passes (applied whenever ``keep_prob < 1``, as there);
  * ``flash_attention_fwd`` / ``flash_attention_bwd`` -- kernel F
    (csrc/flash_attention.cu) for CUDA tensors, the plain versions for CPU
    tensors; each counts its kernel launches in ``.launches``;
  * ``tf32_round`` / ``tf32_truncate`` / ``split3_matmul`` and
    ``flash_attention_ref_fwd_tiled`` / ``flash_attention_ref_bwd_tiled``
    -- kernel F's arithmetic and tile loops in plain PyTorch (the three-term TF32 product, row and column
    tiles, the online softmax, the loop bounds of ``visible_cols`` and
    ``first_row``), for the CPU tests only: nothing on the card's path
    calls them;
  * ``flash_attention`` -- the differentiable op the GPT block calls.

The keep-mask is (B, H, T, T) of {0, 1} as uint8 or bool, or None (all
kept).  The JAX package passes bfloat16 only because Mosaic cannot cast
uint8 inside a kernel (flash_attention.py:231-235).  q, k and v are
float32: the JAX block casts them before the call (gpt.py:155-157).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .attention import (HEAD_DIM, LOG2E as _LOG2E, NEG_INF, TILE_C, TILE_M,
                        bernoulli_u8, rows16 as _rows16, visible_cols,
                        window_mask)

# kernel F's tiles (csrc/attn_tiles.cuh: kBm, kBc; csrc/flash_attention.cu:
# kBr): rows of a forward / dQ CTA and columns of a dK/dV CTA (TILE_M), K/V
# columns a forward / dQ step (TILE_C), Q/dO rows a dK/dV step
TILE_R = 32


def _scale(hd: int) -> float:
    return 1.0 / float(np.sqrt(hd))


def _scores(q, k, n_unmasked):
    t = q.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * _scale(q.shape[-1])
    mask = torch.as_tensor(window_mask(t, n_unmasked), device=q.device)
    return torch.where(mask, s, NEG_INF)


def _keep_scale(x, keep, keep_prob):
    """``x * keep / keep_prob`` (``x / keep_prob`` with no mask), as the TPU
    kernels scale both passes."""
    if keep is not None:
        x = x * keep.to(x.dtype)
    return x / keep_prob


def flash_attention_ref_fwd(q, k, v, keep, n_unmasked: int = 0,
                            keep_prob: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward (_fwd_kernel).  q, k, v (B, H, T, hd) -> (O (B, H, T,
    hd), lse (B, H, T))."""
    s = _scores(q, k, n_unmasked)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(-1, keepdim=True)
    p = e / denom
    lse = (m + torch.log(denom))[..., 0]
    if keep_prob < 1.0:
        p = _keep_scale(p, keep, keep_prob)
    return torch.matmul(p, v), lse


def flash_attention_ref_bwd(q, k, v, keep, lse, do, n_unmasked: int = 0,
                            keep_prob: float = 1.0
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain backward (_bwd_kernel): P recomputed from ``lse``, then
    (dQ, dK, dV)."""
    scale = _scale(q.shape[-1])
    p = torch.exp(_scores(q, k, n_unmasked) - lse[..., None])
    pd = _keep_scale(p, keep, keep_prob) if keep_prob < 1.0 else p
    dv = torch.matmul(pd.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    if keep_prob < 1.0:
        dp = _keep_scale(dp, keep, keep_prob)
    d = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - d)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel F's arithmetic and tile loops in plain PyTorch (CPU tests only)
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` and the kernel's integer rounding)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 cut to TF32: what a tensor core reads of a float32 operand
    (sign, exponent, the first 10 mantissa bits)."""
    return (x.contiguous().view(torch.int32) & ~0x1fff).view(torch.float32)


def split3_matmul(a: torch.Tensor, b: torch.Tensor,
                  terms: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernel's tensor-core product: each float32 operand
    is ``big = tf32_round(x)`` plus ``small = tf32_truncate(x - big)`` and
    the product is ``a_small b_big + a_big b_small + a_big b_big`` summed
    in float32.  ``terms=1`` keeps ``a_big b_big`` alone, a single TF32
    product."""
    ab, bb = tf32_round(a), tf32_round(b)
    if terms == 1:
        return torch.matmul(ab, bb)
    a_s, b_s = tf32_truncate(a - ab), tf32_truncate(b - bb)
    return torch.matmul(a_s, bb) + torch.matmul(ab, b_s) \
        + torch.matmul(ab, bb)


def first_row(c_lo: int, n_unmasked: int) -> int:
    """First row that sees some column >= c_lo (a column tile starting at
    c_lo loops over row steps from it)."""
    return 0 if c_lo < n_unmasked else c_lo


def _tile_mask(t, nu, rows, cols, device):
    m = window_mask(t, nu)[rows.start:rows.stop, cols.start:cols.stop]
    return torch.as_tensor(m, device=device)


def _keep_tile(keep, rows, cols, dtype):
    return keep[:, :, rows, cols].to(dtype)


def flash_attention_ref_fwd_tiled(q, k, v, keep, n_unmasked: int = 0,
                                  keep_prob: float = 1.0,
                                  matmul=torch.matmul, tile_m: int = TILE_M,
                                  tile_c: int = TILE_C):
    """The forward as kernel F loops it: row tiles of ``tile_m``, column
    steps of ``tile_c`` below ``visible_cols``, online softmax in base 2
    with the scale folded into the exponent, the keep-mask after the row
    sum, one reciprocal per row.  Returns (O, lse)."""
    b, h, t, hd = q.shape
    nu = max(0, min(int(n_unmasked), t))
    scale = _scale(hd)
    c = scale * _LOG2E
    masked = keep is not None and keep_prob < 1.0
    inv_kp = 1.0 / keep_prob if keep_prob < 1.0 else 1.0
    o = torch.empty_like(q)
    lse = q.new_empty((b, h, t))
    for row0 in range(0, t, tile_m):
        rows = slice(row0, min(row0 + tile_m, t))
        n = rows.stop - row0
        m = q.new_full((b, h, n), -float("inf"))
        l = q.new_zeros((b, h, n))
        acc = q.new_zeros((b, h, n, hd))
        for c0 in range(0, visible_cols(row0, rows.stop - 1, nu), tile_c):
            cols = slice(c0, min(c0 + tile_c, t))
            s = matmul(q[:, :, rows], k[:, :, cols].transpose(-1, -2))
            s = s.masked_fill(~_tile_mask(t, nu, rows, cols, q.device),
                              -float("inf"))
            m_new = torch.maximum(m, s.amax(-1))
            base = m_new.masked_fill(m_new == -float("inf"), 0.0)
            alpha = torch.exp2((m - base) * c)
            p = torch.exp2((s - base[..., None]) * c)
            l = l * alpha + p.sum(-1)
            if masked:
                p = p * _keep_tile(keep, rows, cols, p.dtype)
            acc = acc * alpha[..., None] + matmul(p, v[:, :, cols])
            m = m_new
        o[:, :, rows] = acc * (inv_kp / l)[..., None]
        lse[:, :, rows] = m * scale + torch.log(l)
    return o, lse


def flash_attention_ref_bwd_tiled(q, k, v, keep, o, lse, do,
                                  n_unmasked: int = 0, keep_prob: float = 1.0,
                                  matmul=torch.matmul, tile_m: int = TILE_M,
                                  tile_c: int = TILE_C, tile_r: int = TILE_R):
    """The backward as kernel F loops it: D = rowsum(dO * O); dQ over row
    tiles and column steps as the forward; dK and dV over column tiles of
    ``tile_m`` and row steps of ``tile_r`` from ``first_row``, with S^T and
    dP^T formed directly.  Returns (dQ, dK, dV)."""
    b, h, t, hd = q.shape
    nu = max(0, min(int(n_unmasked), t))
    scale = _scale(hd)
    c = scale * _LOG2E
    masked = keep is not None and keep_prob < 1.0
    inv_kp = 1.0 / keep_prob if keep_prob < 1.0 else 1.0
    delta = (do * o).sum(-1)
    lse2 = lse * _LOG2E

    def p_and_ds(s, dp, rows, cols):
        """(P * keep / keep_prob, dS) of a (rows, cols) tile."""
        vis = _tile_mask(t, nu, rows, cols, q.device)
        p = torch.exp2(s * c - lse2[:, :, rows, None]).masked_fill(~vis, 0.0)
        pd, dp = p * inv_kp, dp * inv_kp
        if masked:
            kt = _keep_tile(keep, rows, cols, p.dtype)
            pd, dp = pd * kt, dp * kt
        return pd, p * (dp - delta[:, :, rows, None])

    dq = torch.empty_like(q)
    for row0 in range(0, t, tile_m):
        rows = slice(row0, min(row0 + tile_m, t))
        acc = q.new_zeros((b, h, rows.stop - row0, hd))
        for c0 in range(0, visible_cols(row0, rows.stop - 1, nu), tile_c):
            cols = slice(c0, min(c0 + tile_c, t))
            s = matmul(q[:, :, rows], k[:, :, cols].transpose(-1, -2))
            dp = matmul(do[:, :, rows], v[:, :, cols].transpose(-1, -2))
            _, ds = p_and_ds(s, dp, rows, cols)
            acc = acc + matmul(ds, k[:, :, cols])
        dq[:, :, rows] = acc * scale

    dk, dv = torch.empty_like(q), torch.empty_like(q)
    for c0 in range(0, t, tile_m):
        cols = slice(c0, min(c0 + tile_m, t))
        acc_k = q.new_zeros((b, h, cols.stop - c0, hd))
        acc_v = q.new_zeros((b, h, cols.stop - c0, hd))
        for r0 in range(first_row(c0, nu), t, tile_r):
            rows = slice(r0, min(r0 + tile_r, t))
            st = matmul(k[:, :, cols], q[:, :, rows].transpose(-1, -2))
            dpt = matmul(v[:, :, cols], do[:, :, rows].transpose(-1, -2))
            pd, ds = p_and_ds(st.transpose(-1, -2), dpt.transpose(-1, -2),
                              rows, cols)
            acc_v = acc_v + matmul(pd.transpose(-1, -2), do[:, :, rows])
            acc_k = acc_k + matmul(ds.transpose(-1, -2), q[:, :, rows])
        dv[:, :, cols] = acc_v
        dk[:, :, cols] = acc_k * scale
    return dq, dk, dv


def _check(q, k, v, keep):
    """Shape, dtype and size checks of a kernel F launch; returns the keep
    bytes (or None) as a contiguous uint8 (B*H, T, T) tensor."""
    if k.shape != q.shape or v.shape != q.shape or q.ndim != 4:
        raise ValueError(f"flash attention: q, k, v must share one (B, H, T, "
                         f"hd) shape, got {q.shape} {k.shape} {v.shape}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise TypeError(f"flash attention kernel takes float32 q, k, v; got "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    b, h, t, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"flash attention kernel is written for head dim "
                         f"{HEAD_DIM}, got {hd}")
    if b * h * -(-t // TILE_M) >= 2 ** 31:
        raise ValueError(f"flash attention kernel: B*H={b * h} x T={t} is "
                         "more row tiles than one grid dimension holds")
    if keep is None:
        return None
    if keep.shape != (b, h, t, t) or keep.dtype not in (torch.uint8,
                                                         torch.bool):
        raise ValueError(f"keep-mask must be uint8 or bool of shape "
                         f"{(b, h, t, t)}, got {keep.dtype} {tuple(keep.shape)}")
    keep = keep.contiguous()
    return keep.view(torch.uint8) if keep.dtype == torch.bool else keep


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def flash_attention_fwd(q, k, v, keep, n_unmasked: int = 0,
                        keep_prob: float = 1.0):
    """Kernel F forward on CUDA tensors, ``flash_attention_ref_fwd`` on CPU
    tensors.  Returns (O, lse)."""
    if _build.on_cpu(*(x for x in (q, k, v, keep) if x is not None)):
        return flash_attention_ref_fwd(q, k, v, keep, n_unmasked, keep_prob)
    keep8 = _check(q, k, v, keep)
    b, h, t, hd = q.shape
    q, k, v = _rows16(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _build.launch("msgv_flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), _ptr(keep8), o.data_ptr(),
                  lse.data_ptr(), b * h, t, hd, int(n_unmasked),
                  float(keep_prob))
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, keep, o, lse, do, n_unmasked: int = 0,
                        keep_prob: float = 1.0):
    """Kernel F backward on CUDA tensors (``o`` is the forward's output,
    from which the kernel takes rowsum(dO * O)), ``flash_attention_ref_bwd``
    on CPU tensors.  Returns (dQ, dK, dV)."""
    if _build.on_cpu(*(x for x in (q, k, v, keep, o, lse, do)
                       if x is not None)):
        return flash_attention_ref_bwd(q, k, v, keep, lse, do, n_unmasked,
                                       keep_prob)
    keep8 = _check(q, k, v, keep)
    b, h, t, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, t):
        raise ValueError(f"flash attention backward: o {tuple(o.shape)}, "
                         f"dO {tuple(do.shape)}, lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    q, k, v, o, do = _rows16(q, k, v, o, do.float())
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _build.launch("msgv_flash_attention_bwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), _ptr(keep8), o.data_ptr(),
                  lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), delta.data_ptr(), b * h, t, hd,
                  int(n_unmasked), float(keep_prob))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, keep, O, lse) like the JAX ``_fwd`` residuals
    (flash_attention.py:213-215); the backward is kernel F's (or, on the
    CPU, the plain ``flash_attention_ref_bwd``), never autograd's."""

    @staticmethod
    def forward(ctx, q, k, v, keep, n_unmasked, keep_prob):
        q, k, v = (a.contiguous() for a in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, keep, n_unmasked, keep_prob)
        ctx.save_for_backward(q, k, v, keep, o, lse)
        ctx.n_unmasked, ctx.keep_prob = n_unmasked, keep_prob
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, keep, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, keep, o, lse, do,
                                         ctx.n_unmasked, ctx.keep_prob)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keep: Optional[torch.Tensor], n_unmasked: int = 0,
                    keep_prob: float = 1.0) -> torch.Tensor:
    """q, k, v: (B, H, T, hd) float32; keep: (B, H, T, T) {0, 1} or None.
    Returns O (B, H, T, hd), differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, keep, int(n_unmasked),
                                 float(keep_prob))


def make_dropout_mask(generator: Optional[torch.Generator], shape,
                      rate: float) -> Optional[torch.Tensor]:
    """uint8 {0, 1} keep-mask on ``generator``'s device (1 = keep), or None
    when there is no generator or the rate is 0 (flash_attention.py:231)."""
    if generator is None or rate <= 0.0:
        return None
    return bernoulli_u8(generator, 1.0 - rate, shape).view(torch.uint8)
