"""The int8 block product of the decode step: quantise the activation rows,
take the int8 product, rescale and add the bias.

The product is models/gpt.py::_int8_mm's (melspec_gpt_vqvae_tpu/models/
gpt.py:441-450, 484-494): per-row absmax int8 activations times
per-channel int8 weights with exact int32 sums, rescaled in float32 as
``acc * xs * ws`` from left to right, cast to the model dtype, plus the
bias in the model dtype.  The JAX package has no kernel here: XLA fuses
what surrounds its int8 dot.  PyTorch runs those lines as some fifteen
small launches a product, 96 products a decode step, so on the card
hand-written kernels (csrc/int8_linear.cu) take their place.  Which runs
when (``int8_linear`` chooses by shape; nothing else chooses):

  * ``int8_linear_splitk`` -- at most ``SPLITK_MAX_ROWS`` rows, K a
    multiple of 64, and not the row-cut form of tensor parallelism (the
    served decode at batch 8, batch-1 decodes, speculative drafts and
    verify chunks of at most 16 rows, a served mesh's column-cut
    products): ONE kernel that quantises the rows, streams the int8
    weights over every SM (a CTA an SM, each taking a run of 8-column
    groups, ``splitk_plan``; K split over its warps) and rescales;
    ``int8_linear_splitk_xla`` is the plain version (the chain below);
  * otherwise (the offline decode at M = 512 and its prefill, the row-cut
    ``attn_proj`` / ``mlp_down`` under a model axis) three launches around
    cuBLASLt's int8 GEMM (``int8_linear_chain``):

    - ``quantize_rows`` -- x (M, in) -> int8 (Mpad, in) with zero pad rows
      (cuBLASLt needs more than 16 rows: Mpad = max(32, M rounded up to
      8)) and float32 scales (M,); ``quantize_rows_xla`` is the plain
      version (no pad rows: the CPU's product takes any M);
    - ``rescale_bias`` -- int32 (Mpad, out), xs, ws, bias -> (M, out) of
      the model dtype; ``rescale_bias_xla`` the plain version;
    - ``row_scales`` -- the scales (M,) alone (the kernel's scale pass);
      ``quantize_rows(x, xs)`` quantises with scales the caller gives.
      Under tensor parallelism the row-cut products (``attn_proj``,
      ``mlp_down``) see a slice of each row's features: their scale is the
      MAX over the model group of the slices' scales (the division and the
      clamp are monotone, so that is the whole row's scale bit for bit),
      and their int32 sums are summed over the group before
      ``rescale_bias``.

With the kernels off (``_build.kernels(False)``) each wrapper takes its
plain version on either device.  The plain versions are the lines of
``_int8_mm`` / ``_mm`` themselves, and the kernels' results equal them bit
for bit: integer sums are exact in any order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .decode_attention import true_div
from .quant import int_matmul


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


# The most rows the one-launch kernel takes: past it the three-kernel chain
# is as fast or faster on an H100 (PERF.md, section 6).
SPLITK_MAX_ROWS = 16
# SMs of an H100, the grid's size where the device's own count is not at
# hand (a plan made on the CPU)
_SMS = 132
_SMEM_MAX = 227 * 1024


def splitk_plan(m: int, k: int, n: int, sms: int = _SMS):
    """The column groups of 8 that a CTA of ``int8_splitk_kernel`` takes for
    an (m, k) @ (k, n) product, chosen from the shape: as few as spread the
    groups over the SMs, ceil(groups / sms); None where the kernel does not
    take the shape (more than ``SPLITK_MAX_ROWS`` rows, K not a multiple
    of 64, or the quantised rows and a CTA's weight tiles too large for
    shared memory)."""
    if not 1 <= m <= SPLITK_MAX_ROWS or k < 64 or k % 64 or n < 1:
        return None
    cap = -(-(-(-n // 8)) // sms)
    if _splitk_smem(cap, m, k) > _SMEM_MAX:
        return None
    return cap


def _splitk_smem(cap: int, m: int, k: int) -> int:
    """Shared memory of one CTA (csrc/int8_linear.cu::splitk_smem)."""
    rows = 8 if m <= 8 else 16
    return k * (rows + 8 * cap) + 4 * rows * cap * 8 + 4 * 128


_SM_COUNT: dict = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


def int8_linear_splitk_xla(x: torch.Tensor, wq: torch.Tensor,
                           ws: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The one-launch product's plain version: the chain's plain versions
    in a row (``quantize_rows_xla``, ``int_matmul``, ``rescale_bias_xla``).
    """
    xq, xs = quantize_rows_xla(x)
    return rescale_bias_xla(int_matmul(xq, wq.t()), xs, ws, bias)


def int8_linear_splitk(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """x (M, in) of the model dtype @ int8 weights (in, out) with scales
    (out,), plus bias -> (M, out) of the model dtype, in one launch of
    ``int8_splitk_kernel`` on CUDA tensors (``int8_linear_splitk_xla`` on
    CPU tensors or with the kernels off).  ``wq`` is column-major, as
    ``quantize_block_weight`` stores it."""
    if not _build.use_kernel(x, wq, ws, bias):
        return int8_linear_splitk_xla(x, wq, ws, bias)
    x = _check_rows("int8_linear_splitk", x)
    if x.data_ptr() % 16:
        x = x.clone()
    m, k = x.shape
    n = wq.shape[1]
    cap = splitk_plan(m, k, n, _sms(x.device))
    if cap is None or wq.shape[0] != k or wq.dtype != torch.int8:
        raise TypeError(f"int8_linear_splitk: no tile for ({m}, {k}) @ "
                        f"{wq.dtype} {tuple(wq.shape)}")
    if wq.stride(0) != 1 or wq.stride(1) % 16 or wq.data_ptr() % 16:
        raise TypeError("int8_linear_splitk: the weights must be "
                        "column-major, 16-byte aligned columns, got strides "
                        f"{wq.stride()}")
    if ws.dtype != torch.float32 or ws.shape != (n,) \
            or bias.dtype != x.dtype or bias.shape != (n,):
        raise TypeError("int8_linear_splitk: float32 scales (out,) and a "
                        "bias (out,) of the rows' dtype")
    ws, bias = ws.contiguous(), bias.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.launch("msgv_int8_linear_splitk", x.device, x.data_ptr(),
                  wq.data_ptr(), ws.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), m, k, n, wq.stride(1), cap,
                  int(x.dtype == torch.bfloat16))
    int8_linear_splitk.launches += 1
    return out


int8_linear_splitk.launches = 0


def int8_linear_chain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      bias: torch.Tensor, tp=None) -> torch.Tensor:
    """The product as three launches: ``quantize_rows``, cuBLASLt's
    ``torch._int_mm``, ``rescale_bias``.  With the kernels off on the card,
    the plain quantised rows are zero-padded to ``pad_rows`` for cuBLASLt,
    as the kernel pads them.

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


def int8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias: torch.Tensor, tp=None) -> torch.Tensor:
    """x (M, in) of the model dtype @ int8 weights (in, out) with scales
    (out,), plus bias -> (M, out) of the model dtype: one launch of
    ``int8_linear_splitk`` where ``splitk_plan`` takes the shape and the
    product is not row-cut (``tp`` None), else ``int8_linear_chain``.
    Both equal ``_int8_mm(...).to(dtype) + bias`` bit for bit."""
    sms = _sms(x.device) if x.is_cuda else _SMS
    if tp is None and x.dtype == bias.dtype and splitk_plan(
            x.shape[0], x.shape[1], wq.shape[1], sms) is not None:
        return int8_linear_splitk(x, wq, ws, bias)
    return int8_linear_chain(x, wq, ws, bias, tp)
