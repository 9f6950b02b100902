"""Multi-head self-attention over short fixed-length sequences.

Counterpart of melspec_gpt_vqvae_tpu/ops/attention.py:

  * ``attend_xla`` -- the plain PyTorch version, named after the JAX
    function it mirrors (mask + softmax + PV with float32 accumulation),
    with the post-softmax dropout of the JAX training path: the
    differentiable attention a GPT trains through when
    ``use_flash_train`` is off;
  * ``attend`` -- kernel A (csrc/attention.cu), the counterpart of the
    Pallas ``attend_pallas``, for CUDA tensors; ``attend_xla`` for CPU
    tensors.  Inference only: it has no backward and raises when a
    gradient would have to flow through it;
  * ``bernoulli_u8`` -- the keep-masks of every dropout site.

Mask semantics are minGPT's ``n_unmasked`` window (reference
transformer/minGPT.py:64-69): causal everywhere, except the leading
``n_unmasked x n_unmasked`` block, which is fully visible.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _build

NEG_INF = -1e30


def window_mask(t: int, n_unmasked: int = 0) -> np.ndarray:
    """(T, T) bool mask: True = attend (reference: minGPT.py:64-69)."""
    m = np.tril(np.ones((t, t), dtype=bool))
    if n_unmasked > 0:
        nu = min(n_unmasked, t)
        m[:nu, :nu] = True
    return m


def bernoulli_u8(generator: torch.Generator, keep_prob: float,
                 shape) -> torch.Tensor:
    """Bool Bernoulli(keep_prob) keep-mask on ``generator``'s device from
    the narrowest exact-enough draw (attention.py:47-77): one uniform byte
    per element when keep_prob is a multiple of 1/256 (exact: P(bits < t)
    = t / 256; the GPT presets' 0.5), else 16 uniform bits, P quantised to
    the nearest 1/65536, else a float Bernoulli."""
    dev = generator.device
    t = keep_prob * 256.0
    if 0 <= t < 256 and t == round(t):
        bits = torch.empty(shape, dtype=torch.uint8, device=dev)
        return bits.random_(0, 256, generator=generator) < int(round(t))
    t16 = int(round(keep_prob * 65536.0))
    if not 0 <= t16 < 65536:
        return torch.rand(shape, generator=generator, device=dev) < keep_prob
    bits = torch.empty(shape, dtype=torch.int32, device=dev)
    return bits.random_(0, 65536, generator=generator) < t16


def attend_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               n_unmasked: int = 0, *, dropout_rate: float = 0.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """q, k, v: (B, H, T, hd) -> (B, H, T, hd).  Scores and the PV product
    accumulate in float32; probabilities are rounded to v's dtype and the
    output to q's, as in the JAX ``attend_xla``.  With ``dropout_rate`` and
    a ``generator`` the probabilities are dropped and rescaled by
    ``1 / (1 - rate)`` (attention.py:85-106)."""
    t, hd = q.shape[2], q.shape[3]
    scale = 1.0 / float(np.sqrt(hd))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = torch.as_tensor(window_mask(t, n_unmasked), device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = bernoulli_u8(generator, 1.0 - dropout_rate, attn.shape)
        attn = torch.where(keep, attn / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           n_unmasked: int = 0) -> torch.Tensor:
    """Inference attention: kernel A on CUDA tensors, ``attend_xla`` on CPU
    tensors.  q, k, v: (B, H, T, hd) of one dtype (float32 or bfloat16).
    Kernel A has no backward, so a call that autograd would have to
    differentiate raises, on either device: a training forward goes
    through ``attend_xla`` or ``flash_attention``."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise RuntimeError("attend (kernel A) is inference-only: train "
                           "through attend_xla or ops.flash_attention")
    if _build.on_cpu(q, k, v):
        return attend_xla(q, k, v, n_unmasked)
    b, h, t, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"attend kernel takes float32 or bfloat16 q, k, v; "
                        f"got {q.dtype} {k.dtype} {v.dtype}")
    smem = 4 * (t * (2 * hd + 1) + 16 * hd + 4 * t)
    if smem > 227 * 1024:
        raise ValueError(f"attend kernel: T={t}, hd={hd} needs {smem} bytes "
                         "of shared memory (at most 227 KB)")
    q, k, v = (a.contiguous() for a in (q, k, v))
    o = torch.empty_like(q)
    _build.launch("msgv_attention", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), b * h, t, hd, int(n_unmasked),
                  int(q.dtype == torch.bfloat16))
    attend.launches += 1
    return o


attend.launches = 0
