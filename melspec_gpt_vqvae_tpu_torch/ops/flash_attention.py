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
from .attention import NEG_INF, bernoulli_u8, window_mask

HEAD_DIM = 64                # the head dim kernel F is written for
_SMEM_LIMIT = 227 * 1024     # shared memory one CTA may use on Hopper


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
    tp = t | 1
    smem = max(4 * (hd * tp + t * hd + 8 * t),
               4 * (2 * hd * tp + 8 * t),
               4 * (2 * hd * tp + 2 * t + 16 * t) + 33 * t)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"flash attention kernel: T={t} needs {smem} bytes "
                         "of shared memory (at most 227 KB)")
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
    q, k, v = (a.contiguous() for a in (q, k, v))
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
    q, k, v, o, lse = (a.contiguous() for a in (q, k, v, o, lse))
    do = do.contiguous().float()
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
