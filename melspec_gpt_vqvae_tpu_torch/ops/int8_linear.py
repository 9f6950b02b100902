"""The int8 block product of the decode step: quantise the activation rows,
``torch._int_mm``, rescale and add the bias.

The product is models/gpt.py::_int8_mm's (melspec_gpt_vqvae_tpu/models/
gpt.py:441-450, 484-494): per-row absmax int8 activations times
per-channel int8 weights with exact int32 sums, rescaled in float32 as
``acc * xs * ws`` from left to right, cast to the model dtype, plus the
bias in the model dtype.  The JAX package has no kernel here: XLA fuses
what surrounds its int8 dot.  PyTorch runs those lines as some fifteen
small launches a product, 96 products a decode step, so on the card two
hand-written kernels (csrc/int8_linear.cu) take their place around the
cuBLASLt product:

  * ``quantize_rows`` -- x (M, in) -> int8 (Mpad, in) with zero pad rows
    (cuBLASLt needs more than 16 rows: Mpad = max(32, M rounded up to 8))
    and float32 scales (M,); ``quantize_rows_xla`` is the plain version
    (no pad rows: the CPU's product takes any M);
  * ``rescale_bias`` -- int32 (Mpad, out), xs, ws, bias -> (M, out) of the
    model dtype; ``rescale_bias_xla`` the plain version;
  * ``row_scales`` -- the scales (M,) alone (the kernel's scale pass);
    ``quantize_rows(x, xs)`` quantises with scales the caller gives.
    Under tensor parallelism the row-cut products (``attn_proj``,
    ``mlp_down``) see a slice of each row's features: their scale is the
    MAX over the model group of the slices' scales (the division and the
    clamp are monotone, so that is the whole row's scale bit for bit), and
    their int32 sums are summed over the group before ``rescale_bias``;
  * ``int8_linear`` -- the three in a row (``tp``: the row-cut form, four
    with the two all-reduces); with the kernels off
    (``_build.kernels(False)``) the plain versions around the same product
    on either device.

The plain versions are the lines of ``_int8_mm`` / ``_mm`` themselves, and
the kernels' results equal them bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .decode_attention import true_div


def pad_rows(m: int) -> int:
    """Rows of the int8 operand on the card: a multiple of 8, at least 32."""
    return max(32, -(-m // 8) * 8)


def row_scales_xla(x: torch.Tensor) -> torch.Tensor:
    """x (M, in) -> float32 absmax scales (M,): ``max(absmax / 127,
    1e-8)``."""
    return torch.clamp_min(true_div(x.float().abs().amax(-1), 127.0), 1e-8)


def quantize_rows_xla(x: torch.Tensor, xs: torch.Tensor = None):
    """x (M, in) -> (int8 (M, in), float32 absmax scales (M,)); rounds half
    to even.  ``xs`` given: the rows are quantised with it."""
    xf = x.float()
    if xs is None:
        xs = row_scales_xla(x)
    xq = torch.clamp(torch.round(xf / xs[:, None]), -127, 127)
    return xq.to(torch.int8), xs


def _check_rows(name: str, x: torch.Tensor) -> torch.Tensor:
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes a float32 or bfloat16 matrix, "
                        f"got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """``row_scales_xla`` on CPU tensors or with the kernels off; on CUDA
    tensors the quantising kernel's scale pass alone."""
    if not _build.use_kernel(x):
        return row_scales_xla(x)
    x = _check_rows("row_scales", x)
    m, width = x.shape
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    _build.launch("msgv_quantize_rows", x.device, x.data_ptr(), None,
                  xs.data_ptr(), m, m, width,
                  int(x.dtype == torch.bfloat16), 1)
    row_scales.launches += 1
    return xs


row_scales.launches = 0


def quantize_rows(x: torch.Tensor, xs: torch.Tensor = None):
    """``quantize_rows_xla`` on CPU tensors or with the kernels off;
    on CUDA tensors the kernel, whose int8 result has ``pad_rows(M)`` rows,
    the ones past M zero.  With ``xs`` (float32 (M,)) the rows are
    quantised with those scales, which come back as given."""
    if not _build.use_kernel(x):
        return quantize_rows_xla(x, xs)
    x = _check_rows("quantize_rows", x)
    m, width = x.shape
    xq = torch.empty((pad_rows(m), width), dtype=torch.int8, device=x.device)
    mode = 0 if xs is None else 2
    if xs is None:
        xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    elif xs.dtype != torch.float32 or xs.shape != (m,) or not xs.is_cuda:
        raise TypeError(f"quantize_rows: scales float32 ({m},) on the card, "
                        f"got {xs.dtype} {tuple(xs.shape)}")
    xs = xs.contiguous()
    _build.launch("msgv_quantize_rows", x.device, x.data_ptr(),
                  xq.data_ptr(), xs.data_ptr(), m, xq.shape[0], width,
                  int(x.dtype == torch.bfloat16), mode)
    quantize_rows.launches += 1
    return xq, xs


quantize_rows.launches = 0


def rescale_bias_xla(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """int32 sums (>= M, out) of M quantised rows -> (M, out) in the bias's
    dtype: ``acc * xs * ws`` left to right in float32, cast, plus bias."""
    out = acc[:xs.shape[0]].float() * xs[:, None] * ws[None, :]
    return out.to(bias.dtype) + bias


def rescale_bias(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """``rescale_bias_xla`` on CPU tensors or with the kernels off,
    the kernel on CUDA tensors."""
    if not _build.use_kernel(acc, xs, ws, bias):
        return rescale_bias_xla(acc, xs, ws, bias)
    m, width = xs.shape[0], acc.shape[1]
    if acc.dtype != torch.int32 or acc.ndim != 2 or acc.shape[0] < m \
            or not acc.is_contiguous():
        raise TypeError("rescale_bias takes contiguous int32 sums of at "
                        f"least {m} rows, got {acc.dtype} "
                        f"{tuple(acc.shape)}")
    if xs.dtype != torch.float32 or ws.dtype != torch.float32 \
            or ws.shape != (width,) or bias.shape != (width,) \
            or bias.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("rescale_bias: float32 scales (M,) and (out,), a "
                        "float32 or bfloat16 bias (out,)")
    xs, ws, bias = xs.contiguous(), ws.contiguous(), bias.contiguous()
    out = torch.empty((m, width), dtype=bias.dtype, device=acc.device)
    _build.launch("msgv_rescale_bias", acc.device, acc.data_ptr(),
                  xs.data_ptr(), ws.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), m, width,
                  int(bias.dtype == torch.bfloat16))
    rescale_bias.launches += 1
    return out


rescale_bias.launches = 0


def int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias: torch.Tensor, tp=None) -> torch.Tensor:
    """x (M, in) of the model dtype @ int8 weights (in, out) with scales
    (out,), plus bias -> (M, out) of the model dtype.  With the kernels off
    on the card, the plain quantised rows are zero-padded to ``pad_rows``
    for cuBLASLt, as the kernel pads them.

    ``tp`` (a mesh with a ``model`` axis, parallel/mesh.py): the row-cut
    form, x holding this rank's slice of the input features and ``wq``
    its rows.  The scales are all-reduced with MAX and the int32 sums with
    SUM over the model group, and only then rescaled, so the result is the
    single device's bit for bit."""
    if tp is None:
        xq, xs = quantize_rows(x)
    else:
        xs = row_scales(x)
        tp.all_reduce_(xs, "model", op="max")
        xq, xs = quantize_rows(x, xs)
    if xq.is_cuda and xq.shape[0] < pad_rows(xs.shape[0]):
        xq = F.pad(xq, (0, 0, 0, pad_rows(xs.shape[0]) - xq.shape[0]))
    acc = torch._int_mm(xq, wq)
    if tp is not None:
        tp.all_reduce_(acc, "model")
    return rescale_bias(acc, xs, ws, bias)
