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
    tensors, ``decode_attend_int8_xla`` on CPU tensors;
  * ``merge_partials`` / ``decode_attend_int8_split`` -- the plain version
    of the kernel's split over the rows: when B * H is small the kernel
    shares one (b, h)'s rows among the CTAs of a cluster and merges their
    (max, sum, partial o); ``choose_splits`` picks how many.

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


def merge_partials(m: torch.Tensor, s: torch.Tensor,
                   o: torch.Tensor) -> torch.Tensor:
    """Merge softmax-attention results computed over disjoint shares of the
    rows: m (..., S) each share's score maximum (-inf for an empty share),
    s (..., S) its sum of e^(score - m), o (..., S, hd) its unnormalised
    output sum_t e^(score_t - m) v_scale_t v_t.  Returns (..., hd):

        o = sum_i o_i e^(m_i - M) / sum_i s_i e^(m_i - M),  M = max_i m_i

    The plain version of what rank 0 of kernel E's cluster does when the
    rows of one (b, h) are split over several CTAs."""
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    return (o * w[..., None]).sum(dim=-2) / (s * w).sum(dim=-1, keepdim=True)


def decode_attend_int8_split(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, layer: int, pos: int,
                             splits: int) -> torch.Tensor:
    """``decode_attend_int8_xla`` computed the way kernel E computes it with
    ``splits`` CTAs a (b, h): each takes ceil((pos + 1) / splits)
    consecutive rows (the last shares may be empty), and ``merge_partials``
    joins them."""
    k_l, v_l = k[layer], v[layer]
    if k_l.dtype == torch.uint8:
        k_l, v_l = unpack4(k_l), unpack4(v_l)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    n = pos + 1
    per = -(-n // splits)
    ms, ss, os_ = [], [], []
    for i in range(splits):
        t0, t1 = min(i * per, n), min((i + 1) * per, n)
        sc = torch.einsum("bhd,bhtd->bht", q.float(), k_l[:, :, t0:t1].float())
        sc = sc * k_scale[layer][:, :, t0:t1].float() * scale
        m = sc.amax(dim=-1) if t1 > t0 else sc.new_full(sc.shape[:2],
                                                         float("-inf"))
        e = torch.exp(sc - m[..., None])
        ms.append(m)
        ss.append(e.sum(dim=-1))
        os_.append(torch.einsum(
            "bht,bhtd->bhd", e * v_scale[layer][:, :, t0:t1].float(),
            v_l[:, :, t0:t1].float()))
    return merge_partials(torch.stack(ms, -1), torch.stack(ss, -1),
                          torch.stack(os_, -2))


N_SM = 132        # streaming multiprocessors of an H100
MAX_SPLITS = 4    # measured on the card: 8 CTAs a (b, h) are no faster than 4
MIN_SHARE = 64    # rows a CTA should at least get: two passes of the scores


def choose_splits(bh: int, n: int) -> int:
    """CTAs per (b, h) for ``n`` attended rows: 1 when the (b, h) pairs
    alone fill half the card's SMs, else as many as fit the SMs, up to
    MAX_SPLITS, each with at least MIN_SHARE rows."""
    if 2 * bh >= N_SM:
        return 1
    return max(1, min(MAX_SPLITS, N_SM // bh, n // MIN_SHARE))


def decode_attend_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       layer: int, pos: int) -> torch.Tensor:
    """Decode attention over the quantised cache: kernel E on CUDA tensors,
    ``decode_attend_int8_xla`` on CPU tensors.  The kernel reads layer
    ``layer`` straight out of the stacked cache, which must be contiguous
    (it is never copied); scales are bfloat16 as the cache stores them.
    ``choose_splits`` says how many CTAs share one (b, h)'s rows."""
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
    if k.shape[-1] not in (16, 32, 64, 128):
        raise ValueError(f"decode attention kernel needs cache rows of 16, "
                         f"32, 64 or 128 bytes, got hd={hd} "
                         f"({k.shape[-1]} bytes)")
    if not (0 <= layer < n_layer and 0 <= pos < t):
        raise ValueError(f"layer {layer} / pos {pos} outside the cache "
                         f"({n_layer} layers, {t} positions)")
    if not all(a.is_contiguous() for a in (k, v, k_scale, v_scale)) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the stacked cache must be contiguous and 16-byte "
                         "aligned (the kernel copies rows 16 bytes at a "
                         "time)")
    q = q.contiguous()
    o = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    _build.launch("msgv_decode_attention", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                  v_scale.data_ptr(), o.data_ptr(), b * h, t, hd,
                  int(layer), int(pos), int(q.dtype == torch.bfloat16),
                  int(int4), choose_splits(b * h, pos + 1))
    decode_attend_int8.launches += 1
    return o


decode_attend_int8.launches = 0
