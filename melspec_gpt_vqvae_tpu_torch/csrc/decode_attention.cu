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
// dependent steps, not by arithmetic.  The two regimes want two bodies,
// and ops/decode_attention.py::use_streamed picks one from the batch's
// (b, h) count: the split body below for few pairs, the streamed body
// (further down) for the thousands of pairs of a bulk decode, which keeps
// the card's memory busy while it computes.  Both take every cached value
// as a float without the conversion unit (unpack16).
//
// The split body pays the memory latency once and keeps every later step
// in shared memory and registers:
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
// nibble).  Every value comes out exactly, without the conversion unit
// (which issues 16 a cycle an SM, about what the cache's bytes arrive at):
// the value biased to a non-negative integer u (v + 128 for int8, v + 8 for
// int4, an exclusive or) goes into the mantissa of 2^23, a byte permute or a
// mask, and 2^23 plus the bias comes off in one exact subtraction.
template <bool kInt4>
__device__ __forceinline__ void unpack16(const uint4& w,
                                         float (&x)[kInt4 ? 32 : 16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kInt4) {
      const uint32_t u = words[j] ^ 0x88888888u;   // each nibble v + 8
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[8 * j + i] =
            __uint_as_float(((u >> (4 * i)) & 0xFu) | 0x4B000000u) -
            8388616.f;
    } else {
      const uint32_t u = words[j] ^ 0x80808080u;   // each byte v + 128
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[4 * j + i] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) -
            8388736.f;
    }
  }
}

// The split rule of ops/decode_attention.py::choose_splits.
constexpr int kSms = 132;
constexpr int kMaxSplits = 4;
constexpr int kMinShare = 64;

// A row of kHd values as a warp holds it for the quantiser: lane l keeps
// head dims 2j and 2j + 1 for j = l, l + 32, ... below kHd / 2 (zeros past).
__host__ __device__ constexpr int held_per_lane(int hd) {
  return 2 * ((hd / 2 + 31) / 32);
}

template <int kHd, typename X, int kN>
__device__ __forceinline__ void hold_row(const X* x, int lane,
                                         float (&h)[kN]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int j = lane + 32 * i;
    h[2 * i] = j < kHd / 2 ? msgv::to_f(x[2 * j]) : 0.f;
    h[2 * i + 1] = j < kHd / 2 ? msgv::to_f(x[2 * j + 1]) : 0.f;
  }
}

// One warp quantises a held row as the cache stores it: scale =
// max(absmax / lim, 1e-8) (true division), values = clip(rint(x / scale)),
// int4 two to a byte with the even head dim in the low nibble; the scale is
// kept as bfloat16, the values come from the float32 scale.  Writes the
// bytes and the scale to shared memory (as the float the cached bfloat16
// reads back as) and / or to device memory; a null pointer skips one.
template <bool kInt4, int kHd, int kN>
__device__ __forceinline__ void quantise_row(const float (&h)[kN], int lane,
                                             uint8_t* s_row, float* s_scale,
                                             uint8_t* g_row,
                                             __nv_bfloat16* g_scale) {
  constexpr float kLim = kInt4 ? 7.f : 127.f;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) amax = fmaxf(amax, fabsf(h[i]));
  amax = msgv::warp_max(amax);
  const float scale = fmaxf(__fdiv_rn(amax, kLim), 1e-8f);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const int j = lane + 32 * i;   // head dims 2j and 2j + 1
    if (j >= kHd / 2) break;
    const int a = static_cast<int>(
        fminf(fmaxf(rintf(__fdiv_rn(h[2 * i], scale)), -kLim), kLim));
    const int b = static_cast<int>(
        fminf(fmaxf(rintf(__fdiv_rn(h[2 * i + 1], scale)), -kLim), kLim));
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
  if (write && (owns_new || blockIdx.y == 0) && warp < 2) {
    // warp 0 the key row, warp 1 the value row
    float h[held_per_lane(kHd)];
    hold_row<kHd>((warp ? v_new : k_new) + qoff, lane, h);
    const size_t at = lrow * t_cap + pos;
    quantise_row<kInt4, kHd>(
        h, lane, owns_new ? (warp ? sv : sk) + (rows - 1) * kRowBytes : nullptr,
        owns_new ? (warp ? svs : sks) + rows - 1 : nullptr,
        blockIdx.y == 0 ? (warp ? v : k) + at * kRowBytes : nullptr,
        blockIdx.y == 0 ? (warp ? v_scale : k_scale) + at : nullptr);
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

// The streamed body, for thousands of (b, h) pairs (the bulk decodes:
// 256 x 23, 512 x 16).  A persistent grid, as many CTAs as fit the card at
// once; each warp owns the pairs first, first + W, first + 2W, ... (W the
// grid's warps) and streams their rows t <= pos, pair after pair, in chunks
// of kChunk positions, [c kChunk, (c + 1) kChunk): the edges depend on the
// position alone.  A ring of kStages slots in shared memory keeps the next
// chunk in flight while the warp computes the current one, across the end
// of a pair too, so the card's memory stays busy.  Everything a chunk needs
// comes through the ring by cp.async: its K and V rows (16-byte copies),
// the 4-byte words that hold its bfloat16 scales, and with a pair's first
// chunk the pair's q row and new k and v rows; no plain load from device
// memory stalls a warp.  Shared memory is the ring's, whatever the
// capacity, and the warps of a CTA never wait for each other.  The softmax
// runs online over a pair's chunks, in their order: a running maximum m,
// the sum l and the output o are scaled by e^(m - m') when a chunk raises
// the maximum to m', and o / l is taken as o * (1 / l)
// (ops/decode_attention.py::decode_attend_int8_streamed is the plain
// version).  Within a chunk a lane takes kLPR rows, the same for the
// scores and for P.V, so the weights stay in its registers, and the sums
// merge in a fixed order at the pair's end: nothing depends on how many
// pairs the launch holds or which warp takes a pair, so a rank of a serving
// mesh gets one card's sums.  With k_new / v_new the warp quantises a
// pair's rows when the pair starts (device memory and a staging row of its
// own) and puts them into the pair's last chunk in place of a copy.
constexpr int kStreamWarps = 4;   // warps a CTA
constexpr int kChunk = 32;        // rows a chunk
constexpr int kStages = 2;        // slots in a warp's ring
constexpr int kScaleBytes = 80;   // kChunk / 2 + 1 words of two scales

// a slot of the ring: K rows, V rows, K and V scale words, the q, k_new and
// v_new rows of a pair that starts with it
template <typename Q, bool kInt4, int kLPR>
__host__ __device__ constexpr int stream_slot_bytes() {
  return 2 * kChunk * kLPR * 16 + 2 * kScaleBytes +
         3 * kLPR * (kInt4 ? 32 : 16) * static_cast<int>(sizeof(Q));
}

// a warp's shared memory: the ring, the staged new rows and their scales
template <typename Q, bool kInt4, int kLPR>
__host__ __device__ constexpr int stream_warp_bytes() {
  return kStages * stream_slot_bytes<Q, kInt4, kLPR>() + 2 * kLPR * 16 + 16;
}

template <typename Q, bool kInt4, int kLPR>
__global__ void __launch_bounds__(kStreamWarps * 32)
    streamed_decode_attention_kernel(
        const Q* __restrict__ q, const Q* __restrict__ k_new,
        const Q* __restrict__ v_new, uint8_t* k, uint8_t* v,
        __nv_bfloat16* k_scale, __nv_bfloat16* v_scale, float* __restrict__ o,
        const long long* __restrict__ pos_ptr, int bh, int heads, int t_cap,
        int layer, int pos_off, int row_stride, float scale) {
  constexpr int kDPL = kInt4 ? 32 : 16;    // head dims per lane
  constexpr int kHd = kLPR * kDPL;
  constexpr int kRowBytes = kLPR * 16;
  constexpr int kGroups = 32 / kLPR;       // rows a pass of the warp
  constexpr int kRows = kChunk / kGroups;  // rows of a chunk a lane takes
  constexpr int kQBytes = kHd * static_cast<int>(sizeof(Q));
  constexpr int kSlot = stream_slot_bytes<Q, kInt4, kLPR>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int first_pair = blockIdx.x * kStreamWarps + warp;   // b * H + h
  const int stride = gridDim.x * kStreamWarps;
  if (first_pair >= bh) return;
  const int pos = (pos_ptr ? static_cast<int>(*pos_ptr) : 0) + pos_off;
  if (pos < 0 || pos >= t_cap) {   // NaN out, nothing else touched
    for (int p = first_pair; p < bh; p += stride)
      for (int d = lane; d < kHd; d += 32)
        o[static_cast<size_t>(p) * kHd + d] = CUDART_NAN_F;
    return;
  }
  unsigned char* ring = smem + warp * stream_warp_bytes<Q, kInt4, kLPR>();
  uint8_t* fresh = ring + kStages * kSlot;             // [2][kRowBytes]
  float* fresh_s = reinterpret_cast<float*>(fresh + 2 * kRowBytes);  // [2]
  const int n = pos + 1;                       // rows t <= pos
  const bool write = k_new != nullptr;
  const int cached = write ? pos : n;          // rows read from the cache
  const int chunks = (n + kChunk - 1) / kChunk;
  // the warp's chunks, pair after pair: step i is chunk i % chunks of pair
  // first_pair + (i / chunks) stride
  const int steps = ((bh - 1 - first_pair) / stride + 1) * chunks;
  auto pair_of = [&](int i) { return first_pair + (i / chunks) * stride; };
  auto row0 = [&](int pair) {   // the pair's first cache row
    return (static_cast<size_t>(layer) * bh + pair) * t_cap;
  };
  auto q_off = [&](int pair) {
    return static_cast<size_t>(pair / heads) * row_stride +
           static_cast<size_t>(pair % heads) * kHd;
  };

  auto issue = [&](int i) {   // step i into its slot; one group
    if (i < steps) {
      const int c = i % chunks, pair = pair_of(i);
      unsigned char* sk = ring + (i % kStages) * kSlot;
      const size_t e0 = row0(pair) + c * kChunk;   // the chunk's first row
      const int rows = min(kChunk, cached - c * kChunk);
      for (int j = lane; j < rows * kLPR; j += 32) {
        msgv::cp_async16(sk + 16 * j, k + e0 * kRowBytes + 16 * j);
        msgv::cp_async16(sk + kChunk * kRowBytes + 16 * j,
                         v + e0 * kRowBytes + 16 * j);
      }
      // the words that hold those rows' scales, from row e0 & ~1
      if (lane < (static_cast<int>(e0 & 1) + rows + 1) / 2) {
        unsigned char* ss = sk + 2 * kChunk * kRowBytes;
        msgv::cp_async4(ss + 4 * lane, k_scale + (e0 & ~size_t(1)) + 2 * lane);
        msgv::cp_async4(ss + kScaleBytes + 4 * lane,
                        v_scale + (e0 & ~size_t(1)) + 2 * lane);
      }
      if (c == 0) {   // the pair's q and new k, v rows
        unsigned char* head = sk + 2 * kChunk * kRowBytes + 2 * kScaleBytes;
        const size_t at = q_off(pair);
        for (int j = lane; j < kQBytes / 16; j += 32) {
          msgv::cp_async16(head + 16 * j,
                           reinterpret_cast<const unsigned char*>(q + at) +
                               16 * j);
          if (write) {
            msgv::cp_async16(head + kQBytes + 16 * j,
                             reinterpret_cast<const unsigned char*>(
                                 k_new + at) + 16 * j);
            msgv::cp_async16(head + 2 * kQBytes + 16 * j,
                             reinterpret_cast<const unsigned char*>(
                                 v_new + at) + 16 * j);
          }
        }
      }
    }
    msgv::cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  const int li = lane % kLPR;   // which 16 bytes of a row
  const int g = lane / kLPR;    // which row of a pass
  float qr[kDPL], acc[kDPL];
  float m = -CUDART_INF_F, l = 0.f;   // l: this lane's rows' share
  for (int i = 0; i < steps; ++i) {
    const int c = i % chunks, pair = pair_of(i);
    issue(i + kStages - 1);              // into the slot step i - 1 left
    msgv::cp_async_wait<kStages - 1>();  // step i has landed
    __syncwarp();
    uint8_t* sk = ring + (i % kStages) * kSlot;
    uint8_t* sv = sk + kChunk * kRowBytes;
    // scale of row r of the chunk: sks[shift + r] (the words start at an
    // even row)
    __nv_bfloat16* sks = reinterpret_cast<__nv_bfloat16*>(
        sv + kChunk * kRowBytes);
    __nv_bfloat16* svs = sks + kScaleBytes / 2;
    const int shift = static_cast<int>(row0(pair) & 1);
    if (c == 0) {   // a pair starts: its query, its new rows, fresh sums
      const Q* head = reinterpret_cast<const Q*>(svs + kScaleBytes / 2);
#pragma unroll
      for (int d = 0; d < kDPL; ++d) qr[d] = msgv::to_f(head[li * kDPL + d]);
      if (write) {
        float hk[held_per_lane(kHd)], hv[held_per_lane(kHd)];
        hold_row<kHd>(head + kHd, lane, hk);
        hold_row<kHd>(head + 2 * kHd, lane, hv);
        quantise_row<kInt4, kHd>(hk, lane, fresh, fresh_s, nullptr, nullptr);
        quantise_row<kInt4, kHd>(hv, lane, fresh + kRowBytes, fresh_s + 1,
                                 nullptr, nullptr);
        __syncwarp();   // the staged rows, then into the cache
        const size_t at = row0(pair) + pos;
        if (lane < 2 * kLPR) {   // 16 bytes a store
          const int half = lane / kLPR, piece = lane % kLPR;
          *reinterpret_cast<uint4*>((half ? v : k) + at * kRowBytes +
                                    16 * piece) =
              *reinterpret_cast<const uint4*>(fresh + half * kRowBytes +
                                              16 * piece);
        } else if (lane < 2 * kLPR + 2) {
          (lane % 2 ? v_scale : k_scale)[at] =
              __float2bfloat16(fresh_s[lane % 2]);   // exact
        }
      }
      m = -CUDART_INF_F;
      l = 0.f;
#pragma unroll
      for (int d = 0; d < kDPL; ++d) acc[d] = 0.f;
    }
    if (write && c == chunks - 1) {   // row pos from the quantiser
      const int r = pos - c * kChunk;
      if (lane < 2 * kLPR) {
        const int half = lane / kLPR, piece = lane % kLPR;
        *reinterpret_cast<uint4*>((half ? sv : sk) + r * kRowBytes +
                                  16 * piece) =
            *reinterpret_cast<const uint4*>(fresh + half * kRowBytes +
                                            16 * piece);
      }
      if (lane == 0) {
        sks[shift + r] = __float2bfloat16(fresh_s[0]);   // exact
        svs[shift + r] = __float2bfloat16(fresh_s[1]);
      }
    }
    __syncwarp();

    // a pass j holds rows kGroups j .. kGroups (j + 1) - 1 of the chunk:
    // one whose first row lies past pos is skipped, by the whole warp
    float s[kRows], cmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      s[j] = -CUDART_INF_F;
      if (c * kChunk + kGroups * j >= n) continue;
      const int r = g + kGroups * j;
      float x[kDPL];
      unpack16<kInt4>(
          *reinterpret_cast<const uint4*>(sk + r * kRowBytes + 16 * li), x);
      float s4[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, fixed order
#pragma unroll
      for (int d = 0; d < kDPL; ++d)
        s4[d % 4] = fmaf(qr[d], x[d], s4[d % 4]);
      float sc = (s4[0] + s4[1]) + (s4[2] + s4[3]);
#pragma unroll
      for (int off = kLPR / 2; off > 0; off >>= 1)
        sc += __shfl_xor_sync(0xffffffffu, sc, off);
      // past pos the slot holds an older chunk's bytes and scales
      s[j] = c * kChunk + r < n
                 ? sc * __bfloat162float(sks[shift + r]) * scale
                 : -CUDART_INF_F;
      cmax = fmaxf(cmax, s[j]);
    }
#pragma unroll
    for (int off = kLPR; off < 32; off <<= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    const float m_new = fmaxf(m, cmax);   // a chunk holds a row t <= pos
    if (m_new != m) {
      const float alpha = expf(m - m_new);   // 0 for a pair's first chunk
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kDPL; ++d) acc[d] *= alpha;
      m = m_new;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (c * kChunk + kGroups * j >= n) continue;
      const int r = g + kGroups * j;
      const float e = expf(s[j] - m);   // 0 past pos
      l += e;
      float x[kDPL];
      unpack16<kInt4>(
          *reinterpret_cast<const uint4*>(sv + r * kRowBytes + 16 * li), x);
      const float p = c * kChunk + r < n
                          ? e * __bfloat162float(svs[shift + r]) : 0.f;
#pragma unroll
      for (int d = 0; d < kDPL; ++d) acc[d] = fmaf(p, x[d], acc[d]);
    }
    __syncwarp();   // the slot is free for step i + kStages
    if (c == chunks - 1) {   // the pair's rows, always in this order
      float lt = l;
#pragma unroll
      for (int off = kLPR; off < 32; off <<= 1) {
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
#pragma unroll
        for (int d = 0; d < kDPL; ++d)
          acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
      }
      if (lane < kLPR) {
        const float inv = 1.f / lt;
        float4* dst = reinterpret_cast<float4*>(
            o + static_cast<size_t>(pair) * kHd + lane * kDPL);
#pragma unroll
        for (int d = 0; d < kDPL / 4; ++d)
          dst[d] = make_float4(acc[4 * d] * inv, acc[4 * d + 1] * inv,
                               acc[4 * d + 2] * inv, acc[4 * d + 3] * inv);
      }
    }
  }
}

struct Args {
  const void *q, *k_new, *v_new;
  void *k, *v, *k_scale, *v_scale, *o;
  const void* pos_ptr;
  int bh, heads, t_cap, layer, pos_off, row_stride, splits, per_cap,
      split_bh, streamed;
  cudaStream_t stream;
};

template <typename Q, bool kInt4, int kLPR>
int launch(const Args& a) {
  constexpr int kHd = kLPR * (kInt4 ? 32 : 16);
  auto kernel = decode_attention_kernel<Q, kInt4, kLPR>;
  const size_t smem = static_cast<size_t>(a.per_cap) * (2 * kLPR * 16 + 12) +
                      sizeof(float) * (kHd + kWarps * kHd + 2 * kWarps +
                                       kHd + 2);
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

template <typename Q, bool kInt4, int kLPR>
int launch_streamed(const Args& a) {
  constexpr int kHd = kLPR * (kInt4 ? 32 : 16);
  auto kernel = streamed_decode_attention_kernel<Q, kInt4, kLPR>;
  constexpr size_t smem =
      kStreamWarps * stream_warp_bytes<Q, kInt4, kLPR>();
  // once, before any capture: the size is the same at every launch
  static const cudaError_t granted = msgv::allow_smem(kernel, smem);
  if (granted != cudaSuccess) return granted;
  // a persistent grid: as many CTAs as the card holds at once, or fewer
  static const int resident = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kStreamWarps * 32, smem);
    return sms * per_sm;
  }();
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int needed = (a.bh + kStreamWarps - 1) / kStreamWarps;
  const int ctas = needed < resident ? needed : resident;
  kernel<<<ctas, kStreamWarps * 32, smem, a.stream>>>(
      static_cast<const Q*>(a.q), static_cast<const Q*>(a.k_new),
      static_cast<const Q*>(a.v_new), static_cast<uint8_t*>(a.k),
      static_cast<uint8_t*>(a.v), static_cast<__nv_bfloat16*>(a.k_scale),
      static_cast<__nv_bfloat16*>(a.v_scale), static_cast<float*>(a.o),
      static_cast<const long long*>(a.pos_ptr), a.bh, a.heads, a.t_cap,
      a.layer, a.pos_off, a.row_stride, 1.0f / sqrtf(static_cast<float>(kHd)));
  return cudaGetLastError();
}

template <typename Q, bool kInt4, int kLPR>
int launch_body(const Args& a) {
  return a.streamed ? launch_streamed<Q, kInt4, kLPR>(a)
                    : launch<Q, kInt4, kLPR>(a);
}

template <typename Q, bool kInt4>
int launch_hd(int lanes, const Args& a) {
  switch (lanes) {
    case 1:
      return launch_body<Q, kInt4, 1>(a);
    case 2:
      return launch_body<Q, kInt4, 2>(a);
    case 4:
      return launch_body<Q, kInt4, 4>(a);
    case 8:
      return launch_body<Q, kInt4, 8>(a);
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
// be 16, 32, 64 or 128 bytes.  ``streamed`` != 0 takes the streamed body
// (ops/decode_attention.py::use_streamed), which reads neither ``splits``
// nor ``per_cap``; else ``splits`` (1..4) is the cluster's size, the most
// CTAs a (b, h) can need at this capacity, and ``per_cap`` the largest
// share of rows one of them can get; ``split_bh`` (>= bh) the pairs the
// split rule reads.
MSGV_API int msgv_decode_attention(const void* q, const void* k_new,
                                   const void* v_new, void* k, void* v,
                                   void* k_scale, void* v_scale, void* o,
                                   const void* pos_ptr, int bh, int heads,
                                   int t_cap, int hd, int layer, int pos_off,
                                   int row_stride, int q_bf16, int int4,
                                   int splits, int per_cap, int split_bh,
                                   int streamed, void* stream) {
  const int row_bytes = int4 ? hd / 2 : hd;
  if (row_bytes % 16 || split_bh < bh || heads < 1 || bh % heads ||
      (!streamed && (splits < 1 || splits > 4 || per_cap < 1 ||
                     per_cap > t_cap)) ||
      (k_new == nullptr) != (v_new == nullptr) ||
      (pos_ptr == nullptr && (pos_off < 0 || pos_off >= t_cap)))
    return cudaErrorInvalidValue;
  const Args a = {q, k_new, v_new, k, v, k_scale, v_scale, o, pos_ptr,
                  bh, heads, t_cap, layer, pos_off, row_stride, splits,
                  per_cap, split_bh, streamed,
                  static_cast<cudaStream_t>(stream)};
  const int lanes = row_bytes / 16;
  if (q_bf16)
    return int4 ? launch_hd<__nv_bfloat16, true>(lanes, a)
                : launch_hd<__nv_bfloat16, false>(lanes, a);
  return int4 ? launch_hd<float, true>(lanes, a)
              : launch_hd<float, false>(lanes, a);
}
