"""Multi-head self-attention over short fixed-length sequences.

Counterpart of melspec_gpt_vqvae_tpu/ops/attention.py (inference half):

  * ``attend_xla`` -- the plain PyTorch version, named after the JAX
    function it mirrors (mask + softmax + PV with float32 accumulation);
  * ``attend`` -- kernel A (csrc/attention.cu), the counterpart of the
    Pallas ``attend_pallas``, for CUDA tensors; ``attend_xla`` for CPU
    tensors.

Mask semantics are minGPT's ``n_unmasked`` window (reference
transformer/minGPT.py:64-69): causal everywhere, except the leading
``n_unmasked x n_unmasked`` block, which is fully visible.
"""

from __future__ import annotations

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


def attend_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               n_unmasked: int = 0) -> torch.Tensor:
    """q, k, v: (B, H, T, hd) -> (B, H, T, hd).  Scores and the PV product
    accumulate in float32; probabilities are rounded to v's dtype and the
    output to q's, as in the JAX ``attend_xla``."""
    t, hd = q.shape[2], q.shape[3]
    scale = 1.0 / float(np.sqrt(hd))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = torch.as_tensor(window_mask(t, n_unmasked), device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           n_unmasked: int = 0) -> torch.Tensor:
    """Inference attention: kernel A on CUDA tensors, ``attend_xla`` on CPU
    tensors.  q, k, v: (B, H, T, hd) of one dtype (float32 or bfloat16)."""
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
