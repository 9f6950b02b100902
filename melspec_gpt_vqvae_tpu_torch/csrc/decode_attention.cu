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
// small batches (a few MB, 16 to 128 (b, h) pairs), by the latency of its
// dependent steps, not by arithmetic.  The design pays the memory latency
// once and keeps every later step in shared memory and registers:
//
//   * a CTA of 128 threads owns one (b, h) and a contiguous share of the
//     rows t <= pos.  It requests its whole K and V slice (at most
//     266 x 64 B x 2 = 34 KB) as 16-byte cp.async copies up front, and the
//     scales and q as plain loads that fly beside them;
//   * scores: a row is hd bytes = kLPR lanes of 16 bytes; each lane keeps
//     its 16 (int8) or 32 (int4) dims of q in registers, reads its 16 bytes
//     of the row with one shared load and the lanes of a row add up with
//     warp shuffles; one pass covers 128 / kLPR rows;
//   * softmax: warp shuffles, then one merge of the four warps through
//     shared memory for the max and one for the sum;
//   * P.V: each lane owns the same 16 consecutive bytes (16 or 32 head
//     dims) of its rows, accumulates them in registers from 16-byte shared
//     loads, and the partial sums merge in a fixed order (shuffles over the
//     rows of a warp, then the four warps), so the result is deterministic;
//   * when B * H is well under the 132 SMs (batch 1: 16 pairs) the rows are
//     split over the CTAs of a thread block cluster along grid y.  Each CTA
//     leaves (max, sum, unnormalised o) in its shared memory, and rank 0
//     reads them through distributed shared memory and merges
//     o = sum_i o_i e^(m_i - M) / sum_i s_i e^(m_i - M): one launch, no
//     scratch in device memory.  ops/decode_attention.py::merge_partials is
//     the plain version of that merge;
//   * the position comes from device memory (or from the host, when no
//     pointer is given), so that one captured launch serves every step of a
//     decode: the cluster is launched at the most CTAs the cache's capacity
//     can need and shared memory at its largest share, and the kernel works
//     out from pos how many ranks take rows (the rule of
//     ops/decode_attention.py::choose_splits) and which; the ranks beyond
//     have an empty share, which the merge passes over exactly.  The rule
//     reads ``split_bh`` (B * H of the whole batch and all heads), not the
//     launch's own pairs: a rank of a serving mesh that holds a share of
//     the batch or of the heads splits its rows as one card does, so its
//     sums are one card's bit for bit;
//   * with k_new / v_new the launch first quantises this step's key and value
//     row (absmax over hd, true division, round half to even, the scale
//     stored as bfloat16 but the values taken from the float32 scale, as
//     models/gpt.py::_quantize_kv / _quantize_kv4), writes it to position
//     pos of the layer, and attends over t <= pos including it: rank 0
//     writes device memory, the CTA whose share ends at pos puts the row
//     straight into its shared-memory slice.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// The 16 bytes a lane holds of a cache row, dequantised: 16 int8 values, or
// 32 int4 values (byte j holds dims 2j in the low and 2j + 1 in the high
// nibble).
template <bool kInt4>
__device__ __forceinline__ void unpack16(const uint4& w,
                                         float (&x)[kInt4 ? 32 : 16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kInt4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nib = (words[j] >> (4 * i)) & 0xF;
        x[8 * j + i] = static_cast<float>(nib - 16 * (nib > 7));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[4 * j + i] =
            static_cast<float>(static_cast<int8_t>(words[j] >> (8 * i)));
    }
  }
}

// The split rule of ops/decode_attention.py::choose_splits.
constexpr int kSms = 132;
constexpr int kMaxSplits = 4;
constexpr int kMinShare = 64;

// One warp quantises a row of kHd floats as the cache stores it: scale =
// max(absmax / lim, 1e-8) (true division), values = clip(rint(x / scale)),
// int4 two to a byte with the even head dim in the low nibble; the scale is
// kept as bfloat16, the values come from the float32 scale.  Writes the
// bytes and the scale to shared memory (as the float the cached bfloat16
// reads back as) and / or to device memory; a null pointer skips one.
template <bool kInt4, int kHd>
__device__ __forceinline__ void quantise_row(const float* x, int lane,
                                             uint8_t* s_row, float* s_scale,
                                             uint8_t* g_row,
                                             __nv_bfloat16* g_scale) {
  constexpr float kLim = kInt4 ? 7.f : 127.f;
  float amax = 0.f;
  for (int d = lane; d < kHd; d += 32) amax = fmaxf(amax, fabsf(x[d]));
  amax = msgv::warp_max(amax);
  const float scale = fmaxf(__fdiv_rn(amax, kLim), 1e-8f);
  for (int j = lane; j < kHd / 2; j += 32) {   // head dims 2j and 2j + 1
    const int a = static_cast<int>(
        fminf(fmaxf(rintf(__fdiv_rn(x[2 * j], scale)), -kLim), kLim));
    const int b = static_cast<int>(
        fminf(fmaxf(rintf(__fdiv_rn(x[2 * j + 1], scale)), -kLim), kLim));
    if (kInt4) {
      const uint8_t byte = static_cast<uint8_t>((a & 0xF) | ((b & 0xF) << 4));
      if (s_row) s_row[j] = byte;
      if (g_row) g_row[j] = byte;
    } else {
      const uint8_t lo = static_cast<uint8_t>(static_cast<int8_t>(a));
      const uint8_t hi = static_cast<uint8_t>(static_cast<int8_t>(b));
      if (s_row) {
        s_row[2 * j] = lo;
        s_row[2 * j + 1] = hi;
      }
      if (g_row) {
        g_row[2 * j] = lo;
        g_row[2 * j + 1] = hi;
      }
    }
  }
  if (lane == 0) {
    const __nv_bfloat16 stored = __float2bfloat16(scale);
    if (s_scale) *s_scale = __bfloat162float(stored);
    if (g_scale) *g_scale = stored;
  }
}

// kLPR lanes of 16 bytes make one cache row: hd = kLPR * (16 or 32).
template <typename Q, bool kInt4, int kLPR>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Q* __restrict__ q,
                            const Q* __restrict__ k_new,
                            const Q* __restrict__ v_new, uint8_t* k,
                            uint8_t* v, __nv_bfloat16* k_scale,
                            __nv_bfloat16* v_scale, float* __restrict__ o,
                            const long long* __restrict__ pos_ptr, int bh,
                            int heads, int t_cap, int layer, int pos_off,
                            int row_stride, int per_cap, int split_bh,
                            float scale) {
  constexpr int kDPL = kInt4 ? 32 : 16;    // head dims per lane
  constexpr int kHd = kLPR * kDPL;
  constexpr int kRowBytes = kLPR * 16;
  constexpr int kGroups = kThreads / kLPR;  // rows per pass
  extern __shared__ __align__(16) unsigned char smem[];
  // laid out for the largest share the capacity can give a CTA (per_cap)
  uint8_t* sk = smem;                                  // [per_cap][kRowBytes]
  uint8_t* sv = sk + static_cast<size_t>(per_cap) * kRowBytes;
  float* ps = reinterpret_cast<float*>(sv + static_cast<size_t>(per_cap) *
                                                kRowBytes);  // [per_cap]
  float* sks = ps + per_cap;                           // [per_cap] k scales
  float* svs = sks + per_cap;                          // [per_cap] v scales
  float* qs = svs + per_cap;                           // [kHd]
  float* part = qs + kHd;                              // [kWarps][kHd]
  float* red = part + kWarps * kHd;                    // [2][kWarps]
  float* mine = red + 2 * kWarps;                      // [kHd + 2]
  float* fresh = mine + kHd + 2;                       // [2][kHd] new k, v

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.x;                          // b * H + h
  const int pos = (pos_ptr ? static_cast<int>(*pos_ptr) : 0) + pos_off;
  const int n = pos + 1;                               // rows t <= pos
  // how many ranks of the cluster take rows: choose_splits(split_bh, n)
  int active = 1;
  if (2 * split_bh < kSms)
    active = max(1, min(min(kMaxSplits, kSms / split_bh), n / kMinShare));
  active = min(active, static_cast<int>(gridDim.y));
  const int per = (max(n, 1) + active - 1) / active;
  // a position outside the cache, or a share the launch left no room for
  // (the same for the whole cluster): NaN out, nothing else touched
  if (pos < 0 || pos >= t_cap || per > per_cap) {
    if (blockIdx.y == 0 && tid < kHd)
      o[static_cast<size_t>(row) * kHd + tid] = CUDART_NAN_F;
    return;
  }
  const int t0 = blockIdx.y * per;                     // this CTA's share
  const int rows = max(0, min(n - t0, per));
  const size_t lrow = static_cast<size_t>(layer) * bh + row;
  const size_t first = lrow * t_cap + t0;
  const bool write = k_new != nullptr;
  // the share that ends at pos takes the new row from this launch's
  // quantiser, not from device memory
  const bool owns_new = write && rows > 0 && t0 + rows == n;
  const int staged = rows - (owns_new ? 1 : 0);

  {  // the whole slice, 16 bytes a copy, all in flight at once
    const uint8_t* kg = k + first * kRowBytes;
    const uint8_t* vg = v + first * kRowBytes;
    for (int c = tid; c < staged * kLPR; c += kThreads) {
      msgv::cp_async16(sk + 16 * c, kg + 16 * c);
      msgv::cp_async16(sv + 16 * c, vg + 16 * c);
    }
    msgv::cp_async_commit();
  }
  for (int t = tid; t < staged; t += kThreads) {
    sks[t] = __bfloat162float(k_scale[first + t]);
    svs[t] = __bfloat162float(v_scale[first + t]);
  }
  const size_t qoff = static_cast<size_t>(row / heads) * row_stride +
                      static_cast<size_t>(row % heads) * kHd;
  for (int d = tid; d < kHd; d += kThreads) qs[d] = msgv::to_f(q[qoff + d]);
  if (write && (owns_new || blockIdx.y == 0)) {
    for (int d = tid; d < kHd; d += kThreads) {
      fresh[d] = msgv::to_f(k_new[qoff + d]);
      fresh[kHd + d] = msgv::to_f(v_new[qoff + d]);
    }
    __syncthreads();
    if (warp < 2) {   // warp 0 the key row, warp 1 the value row
      const size_t at = lrow * t_cap + pos;
      quantise_row<kInt4, kHd>(
          fresh + warp * kHd, lane,
          owns_new ? (warp ? sv : sk) + (rows - 1) * kRowBytes : nullptr,
          owns_new ? (warp ? svs : sks) + rows - 1 : nullptr,
          blockIdx.y == 0 ? (warp ? v : k) + at * kRowBytes : nullptr,
          blockIdx.y == 0 ? (warp ? v_scale : k_scale) + at : nullptr);
    }
  }
  msgv::cp_async_wait<0>();
  __syncthreads();

  const int li = tid % kLPR;   // which 16 bytes of a row
  const int g = tid / kLPR;    // which row of a pass
  float mx = -CUDART_INF_F;
  {
    float qr[kDPL];
#pragma unroll
    for (int i = 0; i < kDPL; ++i) qr[i] = qs[li * kDPL + i];
    // every lane runs every pass (the shuffles need the whole warp)
    for (int tb = 0; tb < rows; tb += kGroups) {
      const int t = tb + g;
      float s = 0.f;
      if (t < rows) {
        float x[kDPL];
        unpack16<kInt4>(
            *reinterpret_cast<const uint4*>(sk + t * kRowBytes + 16 * li), x);
        float s4[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, fixed order
#pragma unroll
        for (int i = 0; i < kDPL; ++i)
          s4[i % 4] = fmaf(qr[i], x[i], s4[i % 4]);
        s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      }
#pragma unroll
      for (int off = kLPR / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (t < rows) {
        s = s * sks[t] * scale;
        if (li == 0) ps[t] = s;
        mx = fmaxf(mx, s);
      }
    }
  }
  mx = msgv::warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();   // also publishes ps
  mx = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, red[i]);

  float sum = 0.f;
  for (int t = tid; t < rows; t += kThreads) {
    const float e = expf(ps[t] - mx);
    ps[t] = e * svs[t];
    sum += e;
  }
  sum = msgv::warp_sum(sum);
  if (lane == 0) red[kWarps + warp] = sum;
  __syncthreads();   // also publishes ps = e * v_scale
  sum = red[kWarps];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) sum += red[kWarps + i];

  {
    float acc[kDPL];
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[i] = 0.f;
    for (int t = g; t < rows; t += kGroups) {
      float x[kDPL];
      unpack16<kInt4>(
          *reinterpret_cast<const uint4*>(sv + t * kRowBytes + 16 * li), x);
      const float p = ps[t];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[i] = fmaf(p, x[i], acc[i]);
    }
    // the rows of one warp, then the warps, always in this order
#pragma unroll
    for (int off = kLPR; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kDPL; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    if (lane < kLPR) {
#pragma unroll
      for (int i = 0; i < kDPL; ++i)
        part[warp * kHd + lane * kDPL + i] = acc[i];
    }
  }
  __syncthreads();
  float r = 0.f;
  if (tid < kHd) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) r += part[i * kHd + tid];
  }
  if (gridDim.y == 1) {
    if (tid < kHd) o[static_cast<size_t>(row) * kHd + tid] = r / sum;
    return;
  }

  // split rows: merge the cluster's partial results in rank 0
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < kHd) mine[tid] = r;
  if (tid == 0) {
    mine[kHd] = mx;     // -inf for an empty share
    mine[kHd + 1] = sum;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < kHd) {
    const int ranks = static_cast<int>(cluster.num_blocks());
    float big = -CUDART_INF_F;
    for (int i = 0; i < ranks; ++i)
      big = fmaxf(big, cluster.map_shared_rank(mine, i)[kHd]);
    float num = 0.f, den = 0.f;
    for (int i = 0; i < ranks; ++i) {
      const float* theirs = cluster.map_shared_rank(mine, i);
      const float w = expf(theirs[kHd] - big);   // rank 0 is never empty
      num = fmaf(theirs[tid], w, num);
      den = fmaf(theirs[kHd + 1], w, den);
    }
    o[static_cast<size_t>(row) * kHd + tid] = num / den;
  }
  cluster.sync();   // nobody leaves while rank 0 reads its shared memory
}

struct Args {
  const void *q, *k_new, *v_new;
  void *k, *v, *k_scale, *v_scale, *o;
  const void* pos_ptr;
  int bh, heads, t_cap, layer, pos_off, row_stride, splits, per_cap,
      split_bh;
  cudaStream_t stream;
};

template <typename Q, bool kInt4, int kLPR>
int launch(const Args& a) {
  constexpr int kHd = kLPR * (kInt4 ? 32 : 16);
  auto kernel = decode_attention_kernel<Q, kInt4, kLPR>;
  const size_t smem = static_cast<size_t>(a.per_cap) * (2 * kLPR * 16 + 12) +
                      sizeof(float) * (kHd + kWarps * kHd + 2 * kWarps +
                                       kHd + 2 + 2 * kHd);
  // cudaFuncSetAttribute only when this launch needs more than any before
  // it: a captured launch was warmed up at the same capacity, so none is
  // made during a stream capture
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err = msgv::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.bh, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Q*>(a.q),
      static_cast<const Q*>(a.k_new), static_cast<const Q*>(a.v_new),
      static_cast<uint8_t*>(a.k), static_cast<uint8_t*>(a.v),
      static_cast<__nv_bfloat16*>(a.k_scale),
      static_cast<__nv_bfloat16*>(a.v_scale), static_cast<float*>(a.o),
      static_cast<const long long*>(a.pos_ptr), a.bh, a.heads, a.t_cap,
      a.layer, a.pos_off, a.row_stride, a.per_cap, a.split_bh,
      1.0f / sqrtf(static_cast<float>(kHd)));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename Q, bool kInt4>
int launch_hd(int lanes, const Args& a) {
  switch (lanes) {
    case 1:
      return launch<Q, kInt4, 1>(a);
    case 2:
      return launch<Q, kInt4, 2>(a);
    case 4:
      return launch<Q, kInt4, 4>(a);
    case 8:
      return launch<Q, kInt4, 8>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k_new, v_new: this step's query, key and value rows, float32
// (q_bf16 == 0) or bfloat16, element (b, h, d) at b * row_stride + h * hd +
// d of each pointer (the three may be slices of one projection buffer);
// k_new and v_new null: nothing is written.  k, v: contiguous, 16-byte
// aligned (L, bh, t_cap, hd) int8, or (L, bh, t_cap, hd / 2) packed int4
// (int4 != 0).  k_scale, v_scale: contiguous (L, bh, t_cap) bfloat16.
// o: (bh, hd) float32.  The position is *pos_ptr + pos_off (an int64 in
// device memory), or pos_off alone when pos_ptr is null; outside
// [0, t_cap) the launch writes NaN and touches no cache.  A cache row must
// be 16, 32, 64 or 128 bytes.  ``splits`` (1..4) is the cluster's size, the
// most CTAs a (b, h) can need at this capacity, and ``per_cap`` the largest
// share of rows one of them can get; ``split_bh`` (>= bh) the pairs the
// split rule reads.
MSGV_API int msgv_decode_attention(const void* q, const void* k_new,
                                   const void* v_new, void* k, void* v,
                                   void* k_scale, void* v_scale, void* o,
                                   const void* pos_ptr, int bh, int heads,
                                   int t_cap, int hd, int layer, int pos_off,
                                   int row_stride, int q_bf16, int int4,
                                   int splits, int per_cap, int split_bh,
                                   void* stream) {
  const int row_bytes = int4 ? hd / 2 : hd;
  if (row_bytes % 16 || splits < 1 || splits > 4 || per_cap < 1 ||
      split_bh < bh ||
      per_cap > t_cap || heads < 1 || bh % heads ||
      (k_new == nullptr) != (v_new == nullptr) ||
      (pos_ptr == nullptr && (pos_off < 0 || pos_off >= t_cap)))
    return cudaErrorInvalidValue;
  const Args a = {q, k_new, v_new, k, v, k_scale, v_scale, o, pos_ptr,
                  bh, heads, t_cap, layer, pos_off, row_stride, splits,
                  per_cap, split_bh, static_cast<cudaStream_t>(stream)};
  const int lanes = row_bytes / 16;
  if (q_bf16)
    return int4 ? launch_hd<__nv_bfloat16, true>(lanes, a)
                : launch_hd<__nv_bfloat16, false>(lanes, a);
  return int4 ? launch_hd<float, true>(lanes, a)
              : launch_hd<float, false>(lanes, a);
}
