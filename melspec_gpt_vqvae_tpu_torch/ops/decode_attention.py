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
    tensors, ``decode_attend_int8_xla`` on CPU tensors.  The position is a
    Python int or a one-element int64 tensor on the cache's device (one
    captured launch then serves every step of a decode); with ``k_new`` and
    ``v_new`` the launch first quantises this step's key and value rows
    into position ``pos`` of the cache (``write_kv_rows`` is the plain
    version of that write, ``quantize_kv`` / ``quantize_kv4`` the
    quantisers);
  * ``merge_partials`` / ``decode_attend_int8_split`` -- the plain version
    of the kernel's split over the rows: when B * H is small the kernel
    shares one (b, h)'s rows among the CTAs of a cluster and merges their
    (max, sum, partial o); ``choose_splits`` picks how many take rows at a
    position, ``kernel_shares`` is the kernel's own arithmetic for a
    cluster launched at the cache's capacity;
  * ``decode_attend_int8_streamed`` -- the plain version of the kernel's
    streamed body, which ``use_streamed`` picks when the batch holds
    thousands of (b, h) pairs: the rows in chunks of ``STREAM_CHUNK``
    positions, folded in order into an online softmax.

Both read one layer of the port's stacked cache, layout (L, B, H, T, hd):
int8 values, or int4 packed two to a uint8 (L, B, H, T, hd/2) with even
head dims in the low nibble, and (L, B, H, T) scales.  The TPU kernel's
(L, H, B, hd, T) layout exists for Mosaic's 128-lane tiling and is not
used here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build

NEG_INF = -1e30


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division also on the card, where PyTorch turns
    division by a Python number into a multiply by its reciprocal (which
    may differ by one bit, and the quantisers must round as JAX does)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_kv(x: torch.Tensor):
    """(..., hd) -> (int8 values, float32 absmax scale over hd)
    (gpt.py:328-334).  Rounds half to even, as jnp.round does."""
    x = x.float()
    scale = torch.clamp_min(true_div(x.abs().amax(-1), 127.0), 1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv4(x: torch.Tensor):
    """(..., hd) -> (uint8 nibble-packed int4 values (..., hd/2), float32
    absmax scale over hd) (gpt.py:337-347): values clip to [-7, 7], even
    head dims go to the low nibble, odd ones to the high nibble."""
    x = x.float()
    scale = torch.clamp_min(true_div(x.abs().amax(-1), 7.0), 1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -7, 7).to(torch.int32)
    packed = (q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)
    return packed.to(torch.uint8), scale


def position_index(pos, device, offset: int = 0) -> torch.Tensor:
    """``pos + offset`` as a (1,) int64 index tensor on ``device``; ``pos``
    is a Python int or a one-element int64 tensor already there."""
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1)
        return idx + offset if offset else idx
    return torch.full((1,), int(pos) + offset, dtype=torch.int64,
                      device=device)


def write_kv_rows(k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor,
                  v_scale: torch.Tensor, layer: int, pos,
                  k_new: torch.Tensor, v_new: torch.Tensor,
                  pos_offset: int = 0) -> None:
    """Quantise this step's key and value rows (B, H, hd) and write them,
    values and bfloat16 scales, to position ``pos + pos_offset`` of layer
    ``layer`` of the stacked quantised cache, in place: the plain version
    of kernel E's write (and, position for position, of
    models/gpt.py::_write_kv)."""
    quant = quantize_kv4 if k.dtype == torch.uint8 else quantize_kv
    idx = position_index(pos, k.device, pos_offset)
    for vals, scales, x in ((k, k_scale, k_new), (v, v_scale, v_new)):
        q, scale = quant(x)
        vals[layer].index_copy_(2, idx, q[:, :, None])
        scales[layer].index_copy_(2, idx,
                                  scale.to(torch.bfloat16)[:, :, None])


def unpack4(p: torch.Tensor) -> torch.Tensor:
    """uint8 nibble-packed (..., hd/2) -> int32 values (..., hd) in
    [-7, 7], sign-extended (gpt.py:350-357)."""
    p = p.to(torch.int32)
    v = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        *p.shape[:-1], -1)
    return v - 16 * (v > 7).to(torch.int32)


def decode_attend_int8_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor,
                           layer: int, pos) -> torch.Tensor:
    """q (B, H, hd); k, v (L, B, H, T, hd) int8 or (..., hd/2) uint8 int4;
    k_scale, v_scale (L, B, H, T); pos a Python int or a one-element
    tensor.  Returns (B, H, hd) float32."""
    k_l, v_l = k[layer], v[layer]
    if k_l.dtype == torch.uint8:
        k_l, v_l = unpack4(k_l), unpack4(v_l)
    scale = 1.0 / math.sqrt(q.shape[-1])
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
                             splits: int, cluster: int = 0) -> torch.Tensor:
    """``decode_attend_int8_xla`` computed the way kernel E computes it with
    ``splits`` CTAs a (b, h): each takes ceil((pos + 1) / splits)
    consecutive rows (the last shares may be empty), and ``merge_partials``
    joins them.  With ``cluster > splits`` the merge also runs over
    ``cluster - splits`` ranks that hold no row at all, as in a cluster
    launched at the cache's capacity."""
    k_l, v_l = k[layer], v[layer]
    if k_l.dtype == torch.uint8:
        k_l, v_l = unpack4(k_l), unpack4(v_l)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    n = pos + 1
    per = -(-n // splits)
    ms, ss, os_ = [], [], []
    for i in range(max(splits, cluster)):
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


STREAM_CHUNK = 32   # rows a chunk of the streamed body (kChunk)


def decode_attend_int8_streamed(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, layer: int, pos: int,
                                chunk: int = STREAM_CHUNK) -> torch.Tensor:
    """``decode_attend_int8_xla`` computed the way kernel E's streamed body
    computes it: the rows t <= pos in chunks [c chunk, (c + 1) chunk), whose
    edges depend on the position alone, folded in order into a running
    maximum m, sum l and unnormalised output o:

        m' = max(m, max of the chunk's scores),  a = e^(m - m')
        l  = l a + sum e^(s - m'),   o = o a + sum e^(s - m') v_scale v

    and o / l after the last chunk (a is 1, and nothing is scaled, when the
    chunk leaves the maximum as it was).  ``merge_partials`` over the chunks'
    (max, sum, o) is the same sum in another order."""
    k_l, v_l = k[layer], v[layer]
    if k_l.dtype == torch.uint8:
        k_l, v_l = unpack4(k_l), unpack4(v_l)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    n = pos + 1
    m = l = o = None
    for t0 in range(0, n, chunk):
        t1 = min(t0 + chunk, n)
        sc = torch.einsum("bhd,bhtd->bht", q.float(), k_l[:, :, t0:t1].float())
        sc = sc * k_scale[layer][:, :, t0:t1].float() * scale
        m_new = sc.amax(dim=-1) if m is None else torch.maximum(
            m, sc.amax(dim=-1))
        e = torch.exp(sc - m_new[..., None])
        part = torch.einsum("bht,bhtd->bhd",
                            e * v_scale[layer][:, :, t0:t1].float(),
                            v_l[:, :, t0:t1].float())
        if m is None:
            l, o = e.sum(dim=-1), part
        else:
            a = torch.exp(m - m_new)
            l, o = l * a + e.sum(dim=-1), o * a[..., None] + part
        m = m_new
    return o / l[..., None]


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


def kernel_shares(bh: int, n: int, cluster: int):
    """[(first row, rows)] of each rank of a cluster of ``cluster`` CTAs
    attending ``n`` rows, by the kernel's own arithmetic: the active count
    is ``choose_splits(bh, n)`` capped at the cluster, a share is
    ceil(n / active) rows, and the ranks beyond hold none."""
    active = min(choose_splits(bh, n), cluster)
    per = -(-n // active)
    return [(r * per, max(0, min(n - r * per, per))) for r in range(cluster)]


STREAM_MIN_PAIRS = 1024   # measured on the card (PERF.md, kernel E)


def use_streamed(pairs: int) -> bool:
    """Whether kernel E takes its streamed body for a batch of ``pairs``
    (b, h) pairs -- the whole batch's and all heads', as the split rule
    reads them, so a rank of a serving mesh chooses as one card does.  The
    split body is for few pairs (a CTA each, the whole slice in flight at
    once, a cluster when they leave SMs idle); the streamed body, a warp a
    pair streaming its rows in chunks, for batches that fill the card's
    SMs many times over."""
    return pairs >= STREAM_MIN_PAIRS


@functools.lru_cache(maxsize=256)
def max_share(bh: int, t_cap: int, cluster: int) -> int:
    """The most rows one CTA of a cluster of ``cluster`` can get at any
    position of a cache of ``t_cap`` positions: what the launch sizes
    shared memory for."""
    return max(kernel_shares(bh, n, cluster)[0][1]
               for n in range(1, t_cap + 1))


def _rows(x: torch.Tensor, hd: int):
    """(B, H, hd) rows as the kernel addresses them: element (b, h, d) at
    b * stride + h * hd + d, each row on 16 bytes (the streamed body copies
    them 16 bytes at a time).  A view of that form (a slice of a projection
    buffer) is taken as it stands, anything else is copied."""
    if x.stride(2) != 1 or x.stride(1) != hd or x.data_ptr() % 16 \
            or x.stride(0) * x.element_size() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def decode_attend_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor,
                       layer: int, pos, *, k_new: torch.Tensor = None,
                       v_new: torch.Tensor = None, pos_offset: int = 0,
                       split_pairs: int = None) -> torch.Tensor:
    """Decode attention over the quantised cache at position ``pos +
    pos_offset``: kernel E on CUDA tensors, the plain versions on CPU
    tensors or with the kernels off (``write_kv_rows`` then
    ``decode_attend_int8_xla``, neither of which reads the position on the
    host, so a captured program takes them as it takes the kernel).
    ``pos`` is a Python int or a one-element int64 tensor on the
    cache's device, which the kernel reads when it runs (a position
    outside the cache then gives NaN and writes nothing).  With ``k_new``
    and ``v_new`` (B, H, hd) the same launch first quantises them into
    that position of the cache, in place (``write_kv_rows``), and attends
    over them too.  The kernel reads and writes layer ``layer`` straight
    in the stacked cache, which must be contiguous (it is never copied);
    scales are bfloat16 as the cache stores them.  ``use_streamed`` picks
    the kernel's body; the split body's cluster is launched at
    ``choose_splits`` of the capacity, and the kernel works out from the
    position how many of its CTAs take rows.  ``split_pairs`` (None: B * H
    of q) is the (b, h) count both rules read: a rank of a serving mesh
    passes the whole batch's and all heads', so that it takes the body and
    splits its rows as one card does and its sums are one card's.
    ``decode_attend_int8.streamed`` counts the launches that took the
    streamed body (``.launches`` counts them all)."""
    if (k_new is None) != (v_new is None):
        raise ValueError("pass both k_new and v_new, or neither")
    tensors = [q, k, v, k_scale, v_scale]
    tensors += [pos] if isinstance(pos, torch.Tensor) else []
    tensors += [k_new, v_new] if k_new is not None else []
    if not _build.use_kernel(*tensors):
        if k_new is not None:
            write_kv_rows(k, v, k_scale, v_scale, layer, pos, k_new, v_new,
                          pos_offset)
        return decode_attend_int8_xla(q, k, v, k_scale, v_scale, layer,
                                      pos + pos_offset)
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
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1:
            raise TypeError("a device position is one int64 element, got "
                            f"{pos.dtype} {tuple(pos.shape)}")
        pos_ptr, pos_host = pos.data_ptr(), int(pos_offset)
    else:
        pos_ptr, pos_host = None, int(pos) + int(pos_offset)
        if not 0 <= pos_host < t:
            raise ValueError(f"pos {pos_host} outside the cache "
                             f"({t} positions)")
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} outside the cache ({n_layer} "
                         "layers)")
    if not all(a.is_contiguous() for a in (k, v, k_scale, v_scale)) \
            or k.data_ptr() % 16 or v.data_ptr() % 16 \
            or k_scale.data_ptr() % 4 or v_scale.data_ptr() % 4:
        raise ValueError("the stacked cache must be contiguous, its values "
                         "16-byte and its scales 4-byte aligned (the kernel "
                         "copies rows 16 bytes and scales two at a time)")
    q = _rows(q, hd)
    new_ptrs = (None, None)
    if k_new is not None:
        if k_new.shape != q.shape or v_new.shape != q.shape \
                or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
            raise ValueError("k_new and v_new must have q's shape and dtype")
        k_new, v_new = _rows(k_new, hd), _rows(v_new, hd)
        if not (k_new.stride(0) == v_new.stride(0) == q.stride(0)):
            q, k_new, v_new = (a.clone(memory_format=torch.contiguous_format)
                               for a in (q, k_new, v_new))
        new_ptrs = (k_new.data_ptr(), v_new.data_ptr())
    o = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    pairs = b * h if split_pairs is None else int(split_pairs)
    if pairs < b * h:
        raise ValueError(f"split_pairs {pairs} < the launch's {b * h} pairs")
    streamed = use_streamed(pairs)
    cluster = 1 if streamed else choose_splits(pairs, t)
    _build.launch("msgv_decode_attention", q.device, q.data_ptr(), *new_ptrs,
                  k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                  v_scale.data_ptr(), o.data_ptr(), pos_ptr, b * h, h, t, hd,
                  int(layer), pos_host, q.stride(0),
                  int(q.dtype == torch.bfloat16), int(int4),
                  cluster, 1 if streamed else max_share(pairs, t, cluster),
                  pairs, int(streamed))
    decode_attend_int8.launches += 1
    decode_attend_int8.streamed += int(streamed)
    return o


decode_attend_int8.launches = 0
decode_attend_int8.streamed = 0
