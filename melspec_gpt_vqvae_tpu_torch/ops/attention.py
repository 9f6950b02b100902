"""Multi-head self-attention over short fixed-length sequences.

Counterpart of melspec_gpt_vqvae_tpu/ops/attention.py:

  * ``attend_xla`` -- the plain PyTorch version, named after the JAX
    function it mirrors (mask + softmax + PV with float32 accumulation),
    with the post-softmax dropout of the JAX training path: the
    differentiable attention a GPT trains through when
    ``use_flash_train`` is off;
  * ``attend`` -- kernel A (csrc/attention.cu), the counterpart of the
    Pallas ``attend_pallas``, for CUDA tensors; ``attend_xla`` for CPU
    tensors and in a scope that turns the kernels off
    (``_build.kernels(False)``, the counterpart of ``use_pallas=False``).
    Inference only: it has no backward and raises when a gradient would
    have to flow through it.  Up to 16 rows (the serving
    prefill) a warp takes a row; longer sequences at head dim 64 go
    through the tensor-core tile kernel;
  * ``attend_ref_tiled`` -- the tile kernel's loops in plain PyTorch (row
    tiles, column steps below ``visible_cols``, online softmax in base 2,
    bfloat16 rounding of the unnormalised probabilities), for the CPU
    tests only: nothing on the card's path calls it;
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
HEAD_DIM = 64     # the head dim the tile kernels are written for
ROW_KERNEL_MAX_T = 16   # csrc/attention.cu: kRowsPerBlock
# the tile kernels' row tile and column step (csrc/attn_tiles.cuh: kBm, kBc)
TILE_M, TILE_C = 64, 32
LOG2E = 1.4426950408889634


def window_mask(t: int, n_unmasked: int = 0) -> np.ndarray:
    """(T, T) bool mask: True = attend (reference: minGPT.py:64-69)."""
    m = np.tril(np.ones((t, t), dtype=bool))
    if n_unmasked > 0:
        nu = min(n_unmasked, t)
        m[:nu, :nu] = True
    return m


def visible_cols(r_lo: int, r_hi: int, n_unmasked: int) -> int:
    """Columns that some row of [r_lo, r_hi] sees under the minGPT mask:
    c < the returned count (a row tile loops over column steps below it)."""
    return max(n_unmasked, r_hi + 1) if r_lo < n_unmasked else r_hi + 1


def rows16(*tensors):
    """Contiguous tensors whose rows a kernel may copy 16 bytes at a time
    (a contiguous view at an odd storage offset is copied)."""
    out = []
    for x in tensors:
        x = x.contiguous()
        out.append(x.clone() if x.data_ptr() % 16 else x)
    return out


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
               generator: Optional[torch.Generator] = None,
               return_attn: bool = False,
               keep: Optional[torch.Tensor] = None):
    """q, k, v: (B, H, T, hd) -> (B, H, T, hd).  Scores and the PV product
    accumulate in float32; probabilities are rounded to v's dtype and the
    output to q's, as in the JAX ``attend_xla``.  With ``dropout_rate`` and
    a ``generator`` the probabilities are dropped and rescaled by
    ``1 / (1 - rate)`` (attention.py:85-106); ``keep``, a bool (B, H, T, T)
    mask the caller drew, takes the generator's place.  ``return_attn``
    also returns the float32 probabilities (B, H, T, T) before dropout."""
    t, hd = q.shape[2], q.shape[3]
    scale = 1.0 / float(np.sqrt(hd))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = torch.as_tensor(window_mask(t, n_unmasked), device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    attn = used = torch.softmax(scores, dim=-1)
    if keep is None and dropout_rate > 0.0 and generator is not None:
        keep = bernoulli_u8(generator, 1.0 - dropout_rate, attn.shape)
    if keep is not None:
        used = torch.where(keep, attn / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(used.to(v.dtype).float(), v.float()).to(q.dtype)
    return (out, attn) if return_attn else out


def attend_ref_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_unmasked: int = 0, *, matmul=torch.matmul,
                     tile_m: int = TILE_M, tile_c: int = TILE_C
                     ) -> torch.Tensor:
    """``attend`` as kernel A's tile kernel loops it: row tiles of
    ``tile_m``, column steps of ``tile_c`` below ``visible_cols``, online
    softmax in base 2 with the scale folded into the exponent, the row sum
    from the unrounded probabilities, the unnormalised probabilities
    rounded to v's dtype before P V (a no-op in float32), one reciprocal a
    row.  ``matmul`` takes the emulated float32 product
    (``flash_attention.split3_matmul``)."""
    b, h, t, hd = q.shape
    nu = max(0, min(int(n_unmasked), t))
    c = LOG2E / float(np.sqrt(hd))
    qf, kf, vf = q.float(), k.float(), v.float()
    mask = torch.as_tensor(window_mask(t, nu), device=q.device)
    o = torch.empty_like(q)
    for row0 in range(0, t, tile_m):
        rows = slice(row0, min(row0 + tile_m, t))
        n = rows.stop - row0
        m = qf.new_full((b, h, n), -float("inf"))
        l = qf.new_zeros((b, h, n))
        acc = qf.new_zeros((b, h, n, hd))
        for c0 in range(0, visible_cols(row0, rows.stop - 1, nu), tile_c):
            cols = slice(c0, min(c0 + tile_c, t))
            s = matmul(qf[:, :, rows], kf[:, :, cols].transpose(-1, -2))
            s = s.masked_fill(~mask[rows, cols], -float("inf"))
            m_new = torch.maximum(m, s.amax(-1))
            base = m_new.masked_fill(m_new == -float("inf"), 0.0)
            alpha = torch.exp2((m - base) * c)
            p = torch.exp2((s - base[..., None]) * c)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] \
                + matmul(p.to(v.dtype).float(), vf[:, :, cols])
            m = m_new
        o[:, :, rows] = (acc * (1.0 / l)[..., None]).to(q.dtype)
    return o


def _check(q, k, v) -> bool:
    """Shape, dtype and size checks of a kernel A launch; True when the
    tile kernel takes it (T > 16 at head dim 64: fixed shared memory
    whatever T), False for the warp-a-row kernel."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, hd) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"attend kernel takes float32 or bfloat16 q, k, v; "
                        f"got {q.dtype} {k.dtype} {v.dtype}")
    b, h, t, hd = q.shape
    if t > ROW_KERNEL_MAX_T and hd == HEAD_DIM:
        if b * h * -(-t // TILE_M) >= 2 ** 31:
            raise ValueError(f"attend kernel: B*H={b * h} x T={t} is more "
                             "row tiles than one grid dimension holds")
        return True
    # a warp a row: K and V of the whole sequence as float, a row of q per
    # warp of the 16-row tile, a row of scores per warp
    smem = 4 * (t * (2 * hd + 1) + 16 * hd + 4 * t)
    if smem > 227 * 1024:
        raise ValueError(f"attend kernel: T={t}, hd={hd} needs {smem} bytes "
                         "of shared memory (at most 227 KB); only head dim "
                         f"{HEAD_DIM} runs at any T")
    return False


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           n_unmasked: int = 0) -> torch.Tensor:
    """Inference attention: kernel A on CUDA tensors, ``attend_xla`` on CPU
    tensors or with the kernels off (``_build.use_kernel``).  q, k,
    v: (B, H, T, hd) of one dtype (float32 or bfloat16).  Kernel A has no
    backward, so a call that autograd would have to differentiate raises,
    on either device: a training forward goes through ``attend_xla`` or
    ``flash_attention``."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise RuntimeError("attend (kernel A) is inference-only: train "
                           "through attend_xla or ops.flash_attention")
    if not _build.use_kernel(q, k, v):
        return attend_xla(q, k, v, n_unmasked)
    b, h, t, hd = q.shape
    if _check(q, k, v):
        q, k, v = rows16(q, k, v)     # the tile kernel copies 16 bytes
    else:
        q, k, v = (a.contiguous() for a in (q, k, v))
    o = torch.empty_like(q)
    _build.launch("msgv_attention", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), b * h, t, hd, int(n_unmasked),
                  int(q.dtype == torch.bfloat16))
    attend.launches += 1
    return o


attend.launches = 0
