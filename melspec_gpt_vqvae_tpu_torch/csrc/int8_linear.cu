// The decode step's int8 block product:
//   (M, in) float32 / bfloat16 @ int8 (in, out) + bias -> (M, out)
// with models/gpt.py::_int8_mm's arithmetic (per-row absmax int8
// activations, per-channel int8 weights, exact int32 sums, ``acc * xs * ws``
// left to right in float32, cast, plus the bias in the model dtype).  In a
// decode step PyTorch would run some fifteen small launches a product
// (float, abs, amax, div, clamp, div, round, clamp, cast, pad; float, two
// multiplies, cast, bias) and a step has 96 products.  None of these
// kernels has a TPU kernel of its own: in the JAX package the same lines
// (models/gpt.py:441-450, 484-494) are fused by XLA around its int8 dot.
// Which path runs when (ops/int8_linear.py::int8_linear chooses):
//
//   * at most SPLITK_MAX_ROWS rows (the served decode at batch 8, batch-1
//     media decodes, speculative drafts and verifies), K a multiple of 64,
//     and not the row-cut form of tensor parallelism: ONE launch of
//     int8_splitk_kernel below, quantiser, product and rescale together;
//   * otherwise (the offline decode at M = 512, its prefill, the row-cut
//     attn_proj / mlp_down under a model axis, whose scale and int32 sums
//     are all-reduced between the stages): quantize_rows, cuBLASLt's int8
//     GEMM (torch._int_mm), rescale_bias.
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
// What bounds quantize_rows and rescale_bias on the card: bytes, a few KB
// to 100 KB a call, so launch latency; the design is one pass each, a CTA a
// row, nothing kept.  int8_splitk_kernel's design is with it below.
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

// int8_splitk_kernel: the whole product at small M in one launch.
//
// What bounds it: the weights.  At M = 8 a product reads K x N int8 weight
// bytes (1-4 MB for the VAS GPT's four matrices) and does 16 integer
// operations a weight byte, so it is a stream of the weights over the
// card's 3.35 TB/s; at 1-4 MB the stream is short enough that the launch,
// the latency of its first bytes and every dependent step after them count
// as much.  cuBLASLt's tiles leave most SMs idle here (16-64 CTAs of 64 x
// 64 outputs at 32 padded rows), and its int32 sums and the quantised rows
// make round trips through device memory between three launches.  What the
// design rests on, measured on an H100 (PERF.md, section 6): a thread block
// cluster's barrier costs about a microsecond, as much as a whole small
// product, so no CTA waits on another; every CTA must quantise all of x
// (the absmax spans K), so there is one CTA an SM, and a second CTA on an
// SM costs more than the bandwidth it adds:
//
//   * the N columns are cut into groups of 8, and each CTA takes `cap`
//     consecutive groups, cap = ceil(groups / SMs) (ops/int8_linear.py::
//     splitk_plan);
//   * the CTA's (group, 64-deep step of K) units are split between its 16
//     warps, a contiguous run each (the split-K of the name).  Each warp
//     first requests the rows' values it quantises (16-byte loads, from
//     L2), then its units of the weights -- each column's K bytes
//     contiguous, as quantize_block_weight stores them -- as 16-byte
//     cp.async copies, every one in flight at once, and only then computes;
//   * while the weights fly: each row's absmax (a row is split over 16 / M
//     warps when M < 16, their maxima meeting in shared memory), the scale,
//     and the quantised row written to shared memory -- quantize_rows_
//     kernel's operations.  x / scale is taken as x * (1 / scale), rounded
//     to an integer by adding and taking away 1.5 * 2^23; where that
//     product lies within 1e-4 of half an integer, or is not finite, the
//     value is taken again by true division.  Both are within 2e-5 of the
//     exact quotient at |x / scale| <= 128, so the result is the true
//     division's bit for bit at a fraction of its cost;
//   * the product runs on the tensor cores as mma.sync m16n8k32 s8 with the
//     weights as the A operand (a group's 8 columns, the other 8 rows of the
//     fragment zero) and the quantised rows as B (kMT tiles of 8 rows).  A
//     dot product over K may be taken in any order of K, so both operands
//     sit in shared memory in the order the fragments take them: a
//     lane's 16 bytes of one column at K offset 16 t serve two mma's, and a
//     warp reads 512 contiguous bytes a load.  A warp adds its int32 sums of
//     a group into shared memory (atomic adds, exact in any order) when its
//     run leaves the group;
//   * the epilogue: a thread an output applies rescale_bias_kernel's
//     operations to the sum.  Nothing but the output is written to device
//     memory: no scratch, no counter to reset between the replays of a
//     captured graph.
namespace {

constexpr int kSkThreads = 512;
constexpr int kSkWarps = kSkThreads / 32;
constexpr int kU = 8;   // 16-byte loads of x a lane keeps in flight

// d += a b: m16n8k32, int8 operands, exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a2,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// 16 bytes of x as 16 / sizeof(T) floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void get(const uint4& a, float (&v)[4]) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void get(const uint4& a, float (&v)[8]) {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Four values' low bytes as one word, the first in the low byte.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// x * inv (inv = 1 / sc rounded) and 1 / sc are both within 2e-5 of the
// exact quotient where |x / sc| <= 128, so where x * inv lies further than
// kNear from half an integer both round to the same integer; nearer, or
// not finite, the true division decides.
constexpr float kNear = 1e-4f;
constexpr float kMagic = 12582912.f;   // 1.5 * 2^23

// The 16 bytes of x `raw` quantised, clip(rint(x / sc), -127, 127) packed
// as int8, the values near a rounding boundary by true division: the rare
// vectors quantize_vec's fast path leaves.  By value in and out, so that
// the common path keeps its values in registers.
template <typename T>
__device__ __noinline__ uint2 quantize_exact(uint4 raw, float sc,
                                             float inv) {
  constexpr int kE = Vec<T>::kN;
  float f[kE];
  Vec<T>::get(raw, f);
  uint32_t q[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float r = __fmul_rn(f[e], inv);
    const float t = __fadd_rn(r, kMagic);
    q[e] = __float_as_uint(t);
    if (!(fabsf(__fsub_rn(r, __fsub_rn(t, kMagic))) < 0.5f - kNear))
      q[e] = static_cast<uint32_t>(static_cast<int>(
          fminf(fmaxf(rintf(__fdiv_rn(f[e], sc)), -127.f), 127.f)));
  }
  uint2 out = make_uint2(pack4(q[0], q[1], q[2], q[3]), 0u);
  if constexpr (kE == 8) out.y = pack4(q[4], q[5], q[6], q[7]);
  return out;
}

// The 16 bytes of x `raw` quantised with scale sc (inv = 1 / sc rounded),
// packed as int8 (kE / 4 words).  Fast path: r = x * inv, rounded to an
// integer as (r + 1.5 * 2^23) - 1.5 * 2^23 (half to even), whose low byte
// is the integer's; |r| <= 127 + 1e-4 by the scale, so no clip is needed.
template <typename T>
__device__ __forceinline__ uint2 quantize_vec(const uint4& raw, float sc,
                                              float inv) {
  constexpr int kE = Vec<T>::kN;
  float f[kE];
  Vec<T>::get(raw, f);
  uint32_t q[kE];
  bool near = false;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float r = __fmul_rn(f[e], inv);
    const float t = __fadd_rn(r, kMagic);
    near |= !(fabsf(__fsub_rn(r, __fsub_rn(t, kMagic))) < 0.5f - kNear);
    q[e] = __float_as_uint(t);
  }
  if (__builtin_expect(near, 0)) return quantize_exact<T>(raw, sc, inv);
  uint2 out = make_uint2(pack4(q[0], q[1], q[2], q[3]), 0u);
  if constexpr (kE == 8) out.y = pack4(q[4], q[5], q[6], q[7]);
  return out;
}

// Shared memory of one CTA of `cap` groups, in the kernel's order: the
// quantised rows, the weight tiles, the int32 sums, the warps' row maxima,
// the rows' scales.
__host__ __device__ inline size_t splitk_smem(int cap, int rows, int k) {
  return static_cast<size_t>(k) * (rows + 8 * cap) +
         sizeof(int) * static_cast<size_t>(rows) * cap * 8 +
         sizeof(float) * 128;
}

// x (m, k), w (col * ldw + k), ws, bias, out (m, n); cap column groups of
// 8 a CTA; with m < 16 a row is split over 2^pshift warps, `seg` 16-byte
// vectors each (pshift 0: rows warp, warp + 16, ... whole).
template <typename T, int kMT>
__global__ void __launch_bounds__(kSkThreads)
    int8_splitk_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ ws,
                       const T* __restrict__ bias, T* __restrict__ out, int m,
                       int k, int n, int ldw, int cap, int pshift, int seg) {
  constexpr int kRows = 8 * kMT;     // rows of the B operand, >= m
  constexpr int kE = Vec<T>::kN;     // elements of x in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w8 = cap * 8;
  const int n0 = blockIdx.x * w8;
  const int width = min(w8, n - n0);        // this CTA's columns
  const int steps = k >> 6;
  // (group, step) units of the product, a contiguous run a warp
  const int units = ((width + 7) >> 3) * steps;
  const int u_lo = (warp * units) >> 4, u_hi = ((warp + 1) * units) >> 4;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);        // [steps][kMT][32][16]
  int8_t* wt = xq + static_cast<size_t>(k) * kRows;    // [unit][32][16]
  int* sums = reinterpret_cast<int*>(wt + static_cast<size_t>(k) * w8);
  float* pm = reinterpret_cast<float*>(sums + kRows * w8);   // [warp]
  float* scale = pm + 64;                                    // [m]

  // this thread's first output (row, column): its scale and bias, early
  const int outs = m * width;
  const int r0 = tid / width, c0 = tid - r0 * width;
  float o_ws = 0.f;
  T o_b = T();
  if (tid < outs) {
    o_ws = ws[n0 + c0];
    o_b = bias[n0 + c0];
  }
  for (int i = tid; i < kRows * w8; i += kSkThreads) sums[i] = 0;

  const int part = warp & ((1 << pshift) - 1);
  const int vecs = k / kE;
  const int v_lo = part * seg, v_hi = min(v_lo + seg, vecs);

  // this warp's units of the weights, all in flight at once: unit u is
  // group u / steps, step u % steps
  auto request_weights = [&]() {
    int g = u_lo / steps, st = u_lo - g * steps;
    const int c = lane >> 2;
    const int8_t* src =
        w + static_cast<size_t>(n0 + c) * ldw + (lane & 3) * 16;
    for (int u = u_lo; u < u_hi; ++u) {
      const bool ok = g * 8 + c < width;
      msgv::cp_async16_zfill(
          wt + static_cast<size_t>(u) * 512 + lane * 16,
          ok ? src + static_cast<size_t>(g) * 8 * ldw + st * 64 : w, ok);
      if (++st == steps) {
        st = 0;
        ++g;
      }
    }
    msgv::cp_async_commit();
  };
  // this warp's segment of row r: its absmax, then (after the maxima of a
  // split row meet) the quantised values; a segment of at most 32 kU
  // vectors stays in registers between the two
  uint4 v[kU];
  auto load = [&](const uint4* row, int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < v_hi ? __ldg(row + i) : make_uint4(0, 0, 0, 0);
    }
  };
  bool requested = false;
  auto absmax = [&](const uint4* row) {
    float a = 0.f;
    for (int base = v_lo; base < v_hi; base += 32 * kU) {
      load(row, base);
      if (!requested) {   // after this warp's first loads of x
        request_weights();
        requested = true;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float f[kE];
        Vec<T>::get(v[u], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) a = fmaxf(a, fabsf(f[e]));
      }
    }
    return msgv::warp_max(a);
  };
  auto quantize = [&](const uint4* row, int r, float a) {
    const float sc = fmaxf(__fdiv_rn(a, 127.f), 1e-8f);
    const float inv = __frcp_rn(sc);
    // element kk of row r: byte kk % 16 of lane (r % 8) * 4 + (kk % 64) /
    // 16 of B tile r / 8 of step kk / 64
    int8_t* dst = xq + ((r >> 3) * 32 + (r & 7) * 4) * 16;
    for (int base = v_lo; base < v_hi; base += 32 * kU) {
      if (v_hi - v_lo > 32 * kU) load(row, base);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * 32 + lane;
        if (i >= v_hi) break;
        const uint2 q = quantize_vec<T>(v[u], sc, inv);
        const int kk = i * kE;
        int8_t* at = dst + (kk >> 6) * (kMT * 512) + ((kk >> 4) & 3) * 16 +
                     (kk & 15);
        if constexpr (kE == 8)
          *reinterpret_cast<uint2*>(at) = q;
        else
          *reinterpret_cast<uint32_t*>(at) = q.x;
      }
    }
    if (part == 0 && lane == 0) scale[r] = sc;
  };

  // 1. the rows' absmax and scale, and the quantised rows in shared memory,
  //    while the weights fly
  if (pshift > 0) {
    const int r = warp >> pshift;
    const uint4* row = reinterpret_cast<const uint4*>(
        x + static_cast<size_t>(r) * k);
    if (r < m) {
      const float a = absmax(row);
      if (lane == 0) pm[warp] = a;
    }
    if (!requested) request_weights();
    __syncthreads();
    if (r < m) {
      float a = 0.f;
      for (int p = 0; p < (1 << pshift); ++p)
        a = fmaxf(a, pm[(r << pshift) + p]);
      quantize(row, r, a);
    }
  } else {
    for (int r = warp; r < m; r += kSkWarps) {
      const uint4* row = reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(r) * k);
      quantize(row, r, absmax(row));
    }
    if (!requested) request_weights();
  }
  // zero B rows past m: 16 bytes at (step, tile, g, t) for g + 8 tile >= m
  if (m < kRows) {
    for (int i = tid; i < steps * kRows * 4; i += kSkThreads) {
      const int r = (i >> 2) % kRows;
      if (r < m) continue;
      const int s = i / (kRows * 4), t = i & 3;
      *reinterpret_cast<uint4*>(
          xq + ((static_cast<size_t>(s) * kMT + (r >> 3)) * 32 +
                (r & 7) * 4 + t) * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  // 2. the product over this warp's units, as its weights land (a lane
  //    reads only what its own copies wrote); the sums of a group go to
  //    shared memory by atomic adds when the run leaves the group
  msgv::cp_async_wait<0>();
  {
    int g = u_lo / steps, st = u_lo - g * steps;
    int acc[kMT][4] = {};
    auto flush = [&]() {
      const int c = g * 8 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int r = j * 8 + 2 * (lane & 3);
        if (r < m) atomicAdd(sums + r * w8 + c, acc[j][0]);
        if (r + 1 < m) atomicAdd(sums + (r + 1) * w8 + c, acc[j][1]);
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      }
    };
    for (int u = u_lo; u < u_hi; ++u) {
      const uint4 a = *reinterpret_cast<const uint4*>(
          wt + static_cast<size_t>(u) * 512 + lane * 16);
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const uint4 b = *reinterpret_cast<const uint4*>(
            xq + ((static_cast<size_t>(st) * kMT + j) * 32 + lane) * 16);
        mma_s8(acc[j], a.x, a.y, b.x, b.y);
        mma_s8(acc[j], a.z, a.w, b.z, b.w);
      }
      if (++st == steps || u + 1 == u_hi) {
        flush();
        if (st == steps) {
          st = 0;
          ++g;
        }
      }
    }
  }
  __syncthreads();

  // 3. the epilogue: a thread an output (row, column), the columns fastest
  for (int e = tid; e < outs; e += kSkThreads) {
    const int r = e == tid ? r0 : e / width, c = e - r * width;
    const float wsc = e == tid ? o_ws : ws[n0 + c];
    const float bb = msgv::to_f(e == tid ? o_b : bias[n0 + c]);
    // left to right, each product rounded (no contraction into an fma)
    const float y = __fmul_rn(
        __fmul_rn(static_cast<float>(sums[r * w8 + c]), scale[r]), wsc);
    out[static_cast<size_t>(r) * n + n0 + c] =
        msgv::from_f<T>(__fadd_rn(msgv::rnd<T>(y), bb));
  }
}

template <typename T, int kMT>
int launch_splitk(const void* x, const void* w, const void* ws,
                  const void* bias, void* out, int m, int k, int n, int ldw,
                  int cap, cudaStream_t stream) {
  auto kernel = int8_splitk_kernel<T, kMT>;
  const size_t smem = splitk_smem(cap, 8 * kMT, k);
  // cudaFuncSetAttribute only when this launch needs more than any before
  // it: a captured launch was warmed up at the same shape, so none is made
  // during a stream capture
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = msgv::allow_smem(kernel, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // not left for the next launch to report
      return err;
    }
    granted = smem;
  }
  // a row over 2^pshift warps when m < 16 (2^pshift <= 16 / m)
  int pshift = 0;
  while ((m << (pshift + 1)) <= kSkWarps) ++pshift;
  const int vecs = k / (16 / static_cast<int>(sizeof(T)));
  const int seg = (vecs + (1 << pshift) - 1) >> pshift;
  const int groups = (n + 7) / 8;
  kernel<<<(groups + cap - 1) / cap, kSkThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<const T*>(bias),
      static_cast<T*>(out), m, k, n, ldw, cap, pshift, seg);
  return cudaGetLastError();
}

template <typename T>
int launch_splitk_rows(int m, const void* x, const void* w, const void* ws,
                       const void* bias, void* out, int k, int n, int ldw,
                       int cap, cudaStream_t s) {
  if (m <= 8)
    return launch_splitk<T, 1>(x, w, ws, bias, out, m, k, n, ldw, cap, s);
  return launch_splitk<T, 2>(x, w, ws, bias, out, m, k, n, ldw, cap, s);
}

}  // namespace

// x (m, k) float32 (bf16 == 0) or bfloat16, contiguous, 16-byte aligned;
// w int8, element (k, col) at col * ldw + k (each column's k contiguous),
// 16-byte aligned, ldw a multiple of 16; ws (n,) float32; bias (n,) and out
// (m, n) contiguous in x's type.  k a multiple of 64; 1 <= m <= 16; cap:
// column groups of 8 a CTA (the grid is ceil(n / 8 / cap) CTAs).
MSGV_API int msgv_int8_linear_splitk(const void* x, const void* w,
                                     const void* ws, const void* bias,
                                     void* out, int m, int k, int n, int ldw,
                                     int cap, int bf16, void* stream) {
  if (m < 1 || m > 16 || k < 64 || k % 64 || n < 1 || ldw < k || ldw % 16 ||
      cap < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_splitk_rows<__nv_bfloat16>(m, x, w, ws, bias, out, k, n,
                                             ldw, cap, s);
  return launch_splitk_rows<float>(m, x, w, ws, bias, out, k, n, ldw, cap,
                                   s);
}
