"""One decode step's attention over the int8 / int4 KV cache.

Counterpart of melspec_gpt_vqvae_tpu/ops/decode_attention.py (the Pallas
``decode_attend_int8``) and of the int8 branch of the JAX decode step
(melspec_gpt_vqvae_tpu/models/gpt.py:519-544), whose math it is:

    scores = (q . k) * k_scale * hd^-1/2        [masked to t <= pos]
    p      = softmax(scores)
    o      = (p * v_scale) . v

  * ``decode_attend_int8_xla`` -- the plain PyTorch version, float32
    accumulation and output;
  * ``decode_attend_int8`` -- kernel E (csrc/decode_attention.cu) on CUDA
    tensors, ``decode_attend_int8_xla`` on CPU tensors.

Both read one layer of the port's stacked cache, layout (L, B, H, T, hd):
int8 values, or int4 packed two to a uint8 (L, B, H, T, hd/2) with even
head dims in the low nibble, and (L, B, H, T) scales.  The TPU kernel's
(L, H, B, hd, T) layout exists for Mosaic's 128-lane tiling and is not
used here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

NEG_INF = -1e30


def unpack4(p: torch.Tensor) -> torch.Tensor:
    """uint8 nibble-packed (..., hd/2) -> int32 values (..., hd) in
    [-7, 7], sign-extended (gpt.py:350-357)."""
    p = p.to(torch.int32)
    v = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        *p.shape[:-1], -1)
    return v - 16 * (v > 7).to(torch.int32)


def decode_attend_int8_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           layer: int, pos: int) -> torch.Tensor:
    """q (B, H, hd); k, v (L, B, H, T, hd) int8 or (..., hd/2) uint8 int4;
    k_scale, v_scale (L, B, H, T).  Returns (B, H, hd) float32."""
    k_l, v_l = k[layer], v[layer]
    if k_l.dtype == torch.uint8:
        k_l, v_l = unpack4(k_l), unpack4(v_l)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k_l.float())
    scores = scores * k_scale[layer].float() * scale
    valid = torch.arange(scores.shape[-1], device=q.device) <= pos
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs * v_scale[layer].float(),
                        v_l.float())


def decode_attend_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       layer: int, pos: int) -> torch.Tensor:
    """Decode attention over the quantised cache: kernel E on CUDA tensors,
    ``decode_attend_int8_xla`` on CPU tensors.  The kernel reads layer
    ``layer`` straight out of the stacked cache, which must be contiguous
    (it is never copied); scales are bfloat16 as the cache stores them."""
    if _build.on_cpu(q, k, v, k_scale, v_scale):
        return decode_attend_int8_xla(q, k, v, k_scale, v_scale, layer, pos)
    b, h, hd = q.shape
    n_layer, t = k.shape[0], k.shape[3]
    int4 = k.dtype == torch.uint8
    if k.dtype not in (torch.int8, torch.uint8) or v.dtype != k.dtype:
        raise TypeError(f"decode attention kernel takes an int8 or uint8 "
                        f"(int4) cache, got {k.dtype} {v.dtype}")
    if k.shape != (n_layer, b, h, t, hd // 2 if int4 else hd) \
            or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)} {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k_scale.shape != k.shape[:4] or v_scale.shape != k.shape[:4] \
            or k_scale.dtype != torch.bfloat16 \
            or v_scale.dtype != torch.bfloat16:
        raise ValueError("scales must be bfloat16 of shape (L, B, H, T)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd % 8 or hd > 128:
        raise ValueError(f"decode attention kernel needs hd % 8 == 0 and "
                         f"hd <= 128, got {hd}")
    if not (0 <= layer < n_layer and 0 <= pos < t):
        raise ValueError(f"layer {layer} / pos {pos} outside the cache "
                         f"({n_layer} layers, {t} positions)")
    if not all(a.is_contiguous() for a in (k, v, k_scale, v_scale)) \
            or k.data_ptr() % 4 or v.data_ptr() % 4:
        raise ValueError("the stacked cache must be contiguous and 4-byte "
                         "aligned (the kernel reads rows as 32-bit words)")
    q = q.contiguous()
    o = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    _build.launch("msgv_decode_attention", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                  v_scale.data_ptr(), o.data_ptr(), b * h, t, hd,
                  int(layer), int(pos), int(q.dtype == torch.bfloat16),
                  int(int4))
    decode_attend_int8.launches += 1
    return o


decode_attend_int8.launches = 0
