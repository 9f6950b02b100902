// Kernel E: one decode step's attention over the int8 or int4 KV cache.
//
// Replaces melspec_gpt_vqvae_tpu/ops/decode_attention.py::_kernel (the
// Pallas TPU kernel behind decode_attend_int8), whose math is the int8
// branch of the JAX decode step (models/gpt.py:519-544):
//
//   scores = (q . k) * k_scale * rsqrt(hd)   for t <= pos
//   p      = softmax(scores)
//   o      = (p * v_scale) . v              (float32)
//
// for one layer of the stacked cache, layout (L, B, H, T, hd): int8 values,
// or int4 packed two to a byte (even head dims in the low nibble,
// sign-extended as v - 16 (v > 7)), with bfloat16 scales (L, B, H, T).
// Like the TPU kernel with its scalar-prefetched layer index, it reads the
// layer's slice straight out of the stacked cache; it keeps the port's
// (L, B, H, T, hd) layout, not the TPU's (L, H, B, hd, T), which exists for
// Mosaic's 128-lane tiling.
//
// What bounds it on the card: one decode step reads the (b, h) rows of the
// cache once, pos + 1 rows of hd bytes (hd / 2 for int4) for K and for V,
// and does ~4 flops per byte, so it is bound by memory and, at decode's
// small batches, by launch latency.  The design: one CTA of 128 threads per
// (b, h); only t <= pos is scored, so no -1e30 fill is needed; each thread
// scores whole cache rows read as 32-bit words; block max and sum
// reductions; then each thread accumulates its own head-dim lane of P.V
// over a strided share of the rows, the shares summed in a fixed order.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// q[0..3] . four int8 values in w (little-endian: byte i is dim i), or
// q[0..7] . eight int4 values (nibble i is dim i), accumulated into s.
template <bool kInt4>
__device__ __forceinline__ float dot_word(uint32_t w, const float* q,
                                          float s) {
  if (kInt4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nib = (w >> (4 * i)) & 0xF;
      s = fmaf(q[i], static_cast<float>(nib - 16 * (nib > 7)), s);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s = fmaf(q[i], static_cast<float>(static_cast<int8_t>(w >> (8 * i))),
               s);
  }
  return s;
}

// value of head dim d in one cache row
template <bool kInt4>
__device__ __forceinline__ float cache_val(const uint8_t* row, int d) {
  if (kInt4) {
    const int byte = row[d >> 1];
    const int nib = (d & 1) ? (byte >> 4) : (byte & 0xF);
    return static_cast<float>(nib - 16 * (nib > 7));
  }
  return static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]);
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32;
  v = kMax ? msgv::warp_max(v) : msgv::warp_sum(v);
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename Q, bool kInt4>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Q* __restrict__ q,
                            const uint8_t* __restrict__ k,
                            const uint8_t* __restrict__ v,
                            const __nv_bfloat16* __restrict__ k_scale,
                            const __nv_bfloat16* __restrict__ v_scale,
                            float* __restrict__ o, int bh, int t_cap, int hd,
                            int layer, int pos, float scale) {
  extern __shared__ float smem[];
  const int n = pos + 1;                 // rows attended: t <= pos
  float* qs = smem;                      // [hd]
  float* ps = qs + hd;                   // [n] scores, then p * v_scale
  float* part = ps + n;                  // [kThreads] P.V partial sums
  float* red = part + kThreads;          // [kWarps]

  const int row = blockIdx.x;            // b * H + h
  const int hdp = kInt4 ? hd / 2 : hd;   // bytes per cache row
  const size_t lrow = static_cast<size_t>(layer) * bh + row;
  const uint8_t* kr = k + lrow * t_cap * hdp;
  const uint8_t* vr = v + lrow * t_cap * hdp;
  const __nv_bfloat16* ks = k_scale + lrow * t_cap;
  const __nv_bfloat16* vs = v_scale + lrow * t_cap;

  for (int d = threadIdx.x; d < hd; d += kThreads)
    qs[d] = msgv::to_f(q[static_cast<size_t>(row) * hd + d]);
  __syncthreads();

  constexpr int kPerWord = kInt4 ? 8 : 4;
  float mx = -CUDART_INF_F;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(kr + static_cast<size_t>(t) * hdp);
    float s = 0.f;
    for (int j = 0; j < hdp / 4; ++j) s = dot_word<kInt4>(w[j], qs + j * kPerWord, s);
    s = s * __bfloat162float(ks[t]) * scale;
    ps[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float e = expf(ps[t] - mx);
    ps[t] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int t = threadIdx.x; t < n; t += kThreads)
    ps[t] = ps[t] / sum * __bfloat162float(vs[t]);
  __syncthreads();

  // thread (g, d) sums rows t = g, g + groups, ... of head dim d
  const int groups = kThreads / hd;
  const int d = threadIdx.x % hd;
  const int g = threadIdx.x / hd;
  float acc = 0.f;
  if (g < groups)
    for (int t = g; t < n; t += groups)
      acc = fmaf(ps[t], cache_val<kInt4>(vr + static_cast<size_t>(t) * hdp, d),
                 acc);
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < hd) {
    float r = 0.f;
    for (int i = 0; i < groups; ++i) r += part[i * hd + threadIdx.x];
    o[static_cast<size_t>(row) * hd + threadIdx.x] = r;
  }
}

template <typename Q, bool kInt4>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, void* o, int bh, int t_cap, int hd, int layer,
           int pos, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(hd) + pos + 1 + kThreads + kWarps);
  cudaError_t err = msgv::allow_smem(decode_attention_kernel<Q, kInt4>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<Q, kInt4><<<bh, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<float*>(o), bh,
      t_cap, hd, layer, pos, 1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

}  // namespace

// q: contiguous (bh, hd), float32 (q_bf16 == 0) or bfloat16.  k, v:
// contiguous (L, bh, t_cap, hd) int8, or (L, bh, t_cap, hd / 2) packed int4
// (int4 != 0).  k_scale, v_scale: contiguous (L, bh, t_cap) bfloat16.
// o: (bh, hd) float32.  Needs hd % 8 == 0, hd <= 128, 0 <= pos < t_cap.
MSGV_API int msgv_decode_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, void* o, int bh,
                                   int t_cap, int hd, int layer, int pos,
                                   int q_bf16, int int4, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return int4 ? launch<__nv_bfloat16, true>(q, k, v, k_scale, v_scale, o,
                                              bh, t_cap, hd, layer, pos, s)
                : launch<__nv_bfloat16, false>(q, k, v, k_scale, v_scale, o,
                                               bh, t_cap, hd, layer, pos, s);
  return int4 ? launch<float, true>(q, k, v, k_scale, v_scale, o, bh, t_cap,
                                    hd, layer, pos, s)
              : launch<float, false>(q, k, v, k_scale, v_scale, o, bh, t_cap,
                                     hd, layer, pos, s);
}
