// The prologue and the epilogue of the decode step's int8 block product.
//
// The product itself stays cuBLASLt's int8 x int8 -> int32 GEMM
// (torch._int_mm); these two kernels are what surrounds it in
// models/gpt.py::_int8_mm and _mm, where PyTorch runs some fifteen small
// launches a product (float, abs, amax, div, clamp, div, round, clamp,
// cast, pad; float, two multiplies, cast, bias) and a decode step has 96
// products.  They have no TPU kernel of their own: in the JAX package the
// same lines (models/gpt.py:441-450, 484-494) are fused by XLA around its
// int8 dot.
//
//   quantize_rows: x (M, in) -> int8 (Mpad, in), float32 scales (M,)
//     scale = max(absmax(row) / 127, 1e-8)   (true division)
//     q     = clip(rint(x / scale), -127, 127)
//     rows M .. Mpad - 1 are zero (cuBLASLt wants more than 16 rows)
//     Three modes: both passes (0); the scales alone (1); the rows
//     quantised with scales the caller gives (2).  Under tensor
//     parallelism a row-cut product's input holds a slice of each row's
//     features: the scale of the whole row is the MAX over the model
//     group of the slices' scales (division and clamp are monotone), so
//     the caller runs mode 1, all-reduces, then runs mode 2.
//   rescale_bias: int32 (Mpad, out), xs (M,), ws (out,), bias (out,) ->
//     (M, out) of the model dtype: ((acc * xs) * ws) rounded to the model
//     dtype, then + bias in the model dtype.
//
// What bounds them on the card: bytes, a few KB to 100 KB a call, so launch
// latency; the design is one pass each, a CTA a row, nothing kept.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ xs, int m, int width, int mode) {
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  int8_t* out = xq + static_cast<size_t>(row) * width;
  if (row >= m) {   // a pad row
    for (int i = tid; i < width; i += kThreads) out[i] = 0;
    return;
  }
  const T* in = x + static_cast<size_t>(row) * width;
  float scale;
  if (mode == 2) {
    scale = xs[row];
  } else {
    float amax = 0.f;
    for (int i = tid; i < width; i += kThreads)
      amax = fmaxf(amax, fabsf(msgv::to_f(in[i])));
    amax = msgv::warp_max(amax);
    if (tid % 32 == 0) red[tid / 32] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) amax = fmaxf(amax, red[i]);
    scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    if (mode == 1) {
      if (tid == 0) xs[row] = scale;
      return;
    }
  }
  for (int i = tid; i < width; i += kThreads) {
    const float q = rintf(__fdiv_rn(msgv::to_f(in[i]), scale));
    out[i] = static_cast<int8_t>(
        static_cast<int>(fminf(fmaxf(q, -127.f), 127.f)));
  }
  if (tid == 0 && mode == 0) xs[row] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rescale_bias_kernel(const int* __restrict__ acc,
                        const float* __restrict__ xs,
                        const float* __restrict__ ws,
                        const T* __restrict__ bias, T* __restrict__ out,
                        int width) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= width) return;
  const size_t at = static_cast<size_t>(row) * width + col;
  // left to right, each product rounded (no contraction into an fma)
  const float v = __fmul_rn(
      __fmul_rn(static_cast<float>(acc[at]), xs[row]), ws[col]);
  out[at] = msgv::from_f<T>(
      __fadd_rn(msgv::rnd<T>(v), msgv::to_f(bias[col])));
}

}  // namespace

// x (m, width) float32 (bf16 == 0) or bfloat16, contiguous; xq
// (m_pad, width) int8 (unused in mode 1: pass m_pad = m); xs (m,) float32,
// written in modes 0 and 1, read in mode 2.
MSGV_API int msgv_quantize_rows(const void* x, void* xq, void* xs, int m,
                                int m_pad, int width, int bf16, int mode,
                                void* stream) {
  if (m < 1 || m_pad < m || width < 1 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int rows = mode == 1 ? m : m_pad;
  if (bf16)
    quantize_rows_kernel<<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(xs), m, width, mode);
  else
    quantize_rows_kernel<<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(xs), m, width, mode);
  return cudaGetLastError();
}

// acc (>= m, width) int32, contiguous; xs (m,), ws (width,) float32; bias
// (width,) and out (m, width) float32 (bf16 == 0) or bfloat16.
MSGV_API int msgv_rescale_bias(const void* acc, const void* xs,
                               const void* ws, const void* bias, void* out,
                               int m, int width, int bf16, void* stream) {
  if (m < 1 || width < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((width + kThreads - 1) / kThreads, m);
  if (bf16)
    rescale_bias_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(acc), static_cast<const float*>(xs),
        static_cast<const float*>(ws),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), width);
  else
    rescale_bias_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(acc), static_cast<const float*>(xs),
        static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<float*>(out), width);
  return cudaGetLastError();
}
