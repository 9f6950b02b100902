"""int8 post-training quantisation primitives of the int8 decode stage.

Counterpart of melspec_gpt_vqvae_tpu/ops/quant.py, on the port's layouts
(activations NCHW / NCT, kernels OIHW / OIW, a ConvTranspose1d kernel
(I, O, k)).  The calibrated symmetric scheme of models/quantized.py:

  * weights: per-output-channel symmetric, ``s_w[o] = max|w[o]| / 127``;
  * activations: per-tensor symmetric with a calibration-time absmax,
    ``s_x = absmax / 127``;
  * compute: ``conv(int8, int8) -> int32``, dequantised as
    ``y * (s_x * s_w) + bias`` in float32, cast back to the caller dtype.

``conv_int8`` is ``torch._int_mm`` (cuBLASLt on the card, oneDNN on the
CPU) over the input's unfolded windows: the JAX package measured the int8
stage slower than bfloat16 end to end, so no kernel of the port's own
is owed for it.  Its integer sums equal the JAX package's int32
convolution exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .decode_attention import true_div

IntOrSeq = Union[int, Sequence[int]]


def _tuple(v: Optional[IntOrSeq], n: int) -> Tuple[int, ...]:
    if v is None:
        return (1,) * n
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * n


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantisation of a conv kernel
    with output channels first (OIHW / OIW).  Returns ``(w8 int8, s_w
    float32 (out_ch,))`` with ``w ~= w8 * s_w``."""
    w = w.float()
    s = true_div(w.abs().amax(dim=tuple(range(1, w.ndim))), 127.0)
    s = torch.clamp_min(s, 1e-12)
    w8 = torch.clamp(torch.round(w / s.reshape((-1,) + (1,) * (w.ndim - 1))),
                     -127, 127).to(torch.int8)
    return w8, s


def quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 quantisation with a calibrated scale (a
    0-d float32 tensor); rounds half to even, as jnp.round does."""
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)


def conv_float(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor], *,
               stride: Optional[IntOrSeq] = None, padding: IntOrSeq = 0,
               dilation: Optional[IntOrSeq] = None) -> torch.Tensor:
    """The plain convolution of the mirrors (F.conv1d / F.conv2d by the
    kernel's rank), x and kernel in one dtype."""
    n_sp = kernel.ndim - 2
    conv = {1: F.conv1d, 2: F.conv2d}[n_sp]
    return conv(x, kernel, bias, _tuple(stride, n_sp), _tuple(padding, n_sp),
                _tuple(dilation, n_sp))


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (N, K)^T -> exact int32 sums (M, N) by
    ``torch._int_mm`` (cuBLASLt on the card, oneDNN on the CPU).  On the
    card cuBLASLt takes more than 16 rows and K, N in multiples of 8:
    there the rows are zero-padded to a multiple of 8, at least 32, and K
    and N to multiples of 8 (zeros are exact), and the padding dropped
    again; the weight operand is column-major, as the product takes it
    (a contiguous ``w`` is not copied)."""
    m, k = a.shape
    n = w.shape[0]
    if a.is_cuda:
        mp, kp, np_ = -(-m // 8) * 8, -(-k // 8) * 8, -(-n // 8) * 8
        # not max(32, mp): Dynamo, which traces the exported decode loop's
        # scan body, evaluates that builtin max to mp
        if mp < 32:
            mp = 32
        if mp != m or kp != k:
            a = F.pad(a, (0, kp - k, 0, mp - m))
        if np_ != n or kp != k:
            w = F.pad(w, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:m, :n]


def _conv_int32(x8: torch.Tensor, w8: torch.Tensor, stride, padding,
                dilation) -> torch.Tensor:
    """int8 convolution (no bias) with exact int32 sums: the zero-padded
    input's windows (``Tensor.unfold``) as rows, times the kernel as a
    matrix.  x8 (B, C, *S), w8 (O, C, *k) -> (B, O, *S_out) int32."""
    n_sp = w8.ndim - 2
    b, c = x8.shape[:2]
    stride, padding, dilation = (_tuple(v, n_sp)
                                 for v in (stride, padding, dilation))
    pads = []
    for p in reversed(padding):
        pads += [p, p]
    cols = F.pad(x8, pads) if any(padding) else x8
    for d in range(n_sp):
        span = (w8.shape[2 + d] - 1) * dilation[d] + 1
        cols = cols.unfold(2 + d, span, stride[d])
        if dilation[d] > 1:
            cols = cols[..., ::dilation[d]]
    # (B, C, *S_out, *k) -> rows (B, *S_out), columns (C, *k): w8's order
    out_sp = cols.shape[2:2 + n_sp]
    perm = [0, *range(2, 2 + n_sp), 1, *range(2 + n_sp, 2 + 2 * n_sp)]
    a = cols.permute(perm).reshape(b * math.prod(out_sp), -1)
    acc = int_matmul(a, w8.reshape(w8.shape[0], -1))
    acc = acc.reshape(b, *out_sp, w8.shape[0])
    return acc.permute(0, n_sp + 1, *range(1, n_sp + 1))


def conv_int8(x: torch.Tensor, w8: torch.Tensor, s_w: torch.Tensor,
              bias: Optional[torch.Tensor], s_x: torch.Tensor, *,
              stride: Optional[IntOrSeq] = None, padding: IntOrSeq = 0,
              dilation: Optional[IntOrSeq] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 x int8 -> int32 convolution, dequantised to float: ``x`` (any
    float dtype) is quantised with the calibrated per-tensor ``s_x``,
    ``w8`` / ``s_w`` come from ``quantize_weight``; the bias is added in
    float32 and the result cast to ``out_dtype`` (default x's)."""
    out_dtype = out_dtype or x.dtype
    acc = _conv_int32(quantize_act(x, s_x), w8, stride, padding, dilation)
    shape = (1, -1) + (1,) * (w8.ndim - 2)
    y = acc.float() * (s_x * s_w).reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y.to(out_dtype)


def polyphase_from_transpose(w: torch.Tensor, r: int) -> torch.Tensor:
    """Rewrite a stride-``r`` kernel-``2r`` ConvTranspose1d kernel ``w``
    (C_in, C_out, 2r) as a width-2 regular conv kernel (r * C_out, C_in, 2)
    producing ``r`` interleaved phases: output channel ``q * C_out + o``
    is phase ``q``,

        y_full[u * r + q] = x[u] w[:, :, q] + x[u - 1] w[:, :, r + q],

    over the input zero-padded by 1 on both sides (ops/quant.py:87-107 of
    the JAX package; its (2, C_in, r * C_out) WIO kernel is this one's
    ``permute(2, 1, 0)``)."""
    ci, co, k = w.shape
    if k != 2 * r:
        raise ValueError(f"polyphase form needs kernel 2r, got {k} != 2*{r}")
    pk = torch.stack([w[:, :, r:2 * r], w[:, :, 0:r]], dim=-1)  # (I, O, r, 2)
    return pk.permute(2, 1, 0, 3).reshape(r * co, ci, 2)


def _interleave_phases(y: torch.Tensor, r: int, co: int,
                       t: int) -> torch.Tensor:
    """(B, r * C_out, T + 1) phases -> (B, C_out, T * r) samples, cropped as
    torch's ConvTranspose1d(padding=r // 2 + r % 2, output_padding=r % 2)
    crops the full transpose output."""
    b, _, t1 = y.shape
    y = y.reshape(b, r, co, t1).permute(0, 2, 3, 1).reshape(b, co, t1 * r)
    pad = r // 2 + r % 2
    return y[:, :, pad:pad + t * r]


def conv_transpose_polyphase(x: torch.Tensor, w: torch.Tensor,
                             bias: Optional[torch.Tensor],
                             r: int) -> torch.Tensor:
    """The MelGAN upsample ``ConvTranspose1d(C_in, C_out, 2r, stride=r,
    padding=r // 2 + r % 2, output_padding=r % 2)`` through the exact
    polyphase rewrite: one width-2 stride-1 regular conv.  x (B, C_in, T)
    -> (B, C_out, T * r).  The correctness anchor of the int8 upsample
    (ops/quant.py:110-138 of the JAX package)."""
    co = w.shape[1]
    y = F.conv1d(F.pad(x, (1, 1)), polyphase_from_transpose(w, r).to(x.dtype))
    y = _interleave_phases(y, r, co, x.shape[2])
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None]
    return y
