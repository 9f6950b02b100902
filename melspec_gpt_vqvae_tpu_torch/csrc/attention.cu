// Kernel A: masked multi-head attention over a whole short sequence,
// inference only (no backward, no dropout).
//
// Replaces melspec_gpt_vqvae_tpu/ops/attention.py::_attn_kernel (the Pallas
// TPU kernel behind attend_pallas).  Per (batch*head) it computes
// softmax(mask(Q K^T / sqrt(hd))) V with the minGPT mask: causal, or inside
// the leading n_unmasked x n_unmasked block, and never past the sequence
// end.  float32 or bfloat16 in and out, float32 arithmetic between.
//
// What bounds it on the card: bytes, and far from them.  At the longest
// sequence (B*H = 128, T = 266, hd = 64) q, k, v and o are 17 MB in
// bfloat16 (0.005 ms at the memory rate) and the two products over the
// causal half 1.2 GFLOP (0.001 ms on the tensor cores); at the serving
// prefill (T = 1, the class prompt) the work is nothing and the launch is
// all.  What a kernel loses it loses to instruction slots, shared-memory
// reads and latency, so there are two kernels:
//
//   * T <= 16 or hd != 64, attention_kernel: a CTA of 4 warps takes 16
//     query rows, one warp a row at a time; K and V of the columns the
//     tile can see sit in shared memory as float, a row's scores too, so
//     no online softmax is needed; float32 FMA.  The normalised
//     probabilities are rounded to the input dtype before P V, as the
//     plain version (attend_xla) rounds them.  At T = 1 this is one short
//     CTA a head and nothing is faster.
//   * T > 16 and hd = 64, attention_tile_kernel: kernel F's forward tiles
//     (attn_tiles.cuh) without lse and keep-mask.  A CTA of 4 warps takes
//     64 query rows, a warp 16, and walks 32-column K / V steps up to the
//     tile's last visible column; K of the next step loads by cp.async
//     behind the softmax and P V, V behind Q K^T; a warp skips the
//     8-column blocks none of its rows can see; the heaviest tiles are
//     scheduled first; any T runs (35 KB of shared memory in float32, 18
//     KB in bfloat16, whatever T).  float32: each product is three TF32
//     mma.sync terms, sums outside the accumulators, as in F.  bfloat16:
//     operands are staged as they are (no float copy), fragments come by
//     ldmatrix, one m16n8k16 mma.sync a product, float32 accumulators.
//     Softmax order: online (running max and sum per row, one pass over
//     K), so bfloat16 rounds the unnormalised probabilities exp(s - m) in
//     (0, 1] before P V where the plain version rounds the normalised
//     ones.  Either rounding is 2^-9 relative per probability and the
//     row sum is taken from the unrounded values in both, so the outputs
//     agree to the same few bfloat16 ulps (measured: see chip_smoke.py,
//     tolerance 1e-2 of max |out|); the two-pass form that would copy the
//     plain version's order costs a second Q K^T for no gain in accuracy.
#include "attn_tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerBlock = 16;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int t_len,
                     int hd, int n_unmasked, float scale) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;  // pad: lanes read different K rows, same column
  float* ks = smem;                          // [t_len][hd + 1]
  float* vs = ks + t_len * ldk;              // [t_len][hd]
  float* qs = vs + t_len * hd;               // [kRowsPerBlock][hd]
  float* ps = qs + kRowsPerBlock * hd;       // [kWarps][t_len]

  const size_t base = static_cast<size_t>(blockIdx.y) * t_len * hd;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, t_len);
  const int nu = min(n_unmasked, t_len);
  // columns any row of this tile attends to
  const int ncols = (row0 < nu) ? max(row_end, nu) : row_end;

  for (int i = threadIdx.x; i < ncols * hd; i += blockDim.x) {
    ks[(i / hd) * ldk + i % hd] = msgv::to_f(k[base + i]);
    vs[i] = msgv::to_f(v[base + i]);
  }
  const size_t qbase = base + static_cast<size_t>(row0) * hd;
  for (int i = threadIdx.x; i < (row_end - row0) * hd; i += blockDim.x)
    qs[i] = msgv::to_f(q[qbase + i]);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * t_len;
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const float* qr = qs + (r - row0) * hd;
    // mask: c <= r, or (r < nu and c < nu); always c < t_len
    const int rcols = (r < nu) ? nu : r + 1;
    float mx = -CUDART_INF_F;
    for (int c = lane; c < rcols; c += 32) {
      const float* kr = ks + c * ldk;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      p[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = msgv::warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < rcols; c += 32) {
      const float e = expf(p[c] - mx);
      p[c] = e;
      sum += e;
    }
    sum = msgv::warp_sum(sum);
    for (int c = lane; c < rcols; c += 32) p[c] = msgv::rnd<T>(p[c] / sum);
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int c = 0; c < rcols; ++c) acc = fmaf(p[c], vs[c * hd + d], acc);
      o[base + static_cast<size_t>(r) * hd + d] = msgv::from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int t_len, int hd, int n_unmasked, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      (static_cast<size_t>(t_len) * (2 * hd + 1) +
                       kRowsPerBlock * hd + kWarps * t_len);
  cudaError_t err = msgv::allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, hd, n_unmasked,
      1.0f / sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

using namespace msgv::tiles;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid (row tiles * B*H); q, k, v, o (B*H, t_len, kHd), 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          int bh_count, int t_len, int nu, float scale) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  constexpr int ld = kRowLd<T>;
  T* qs = reinterpret_cast<T*>(tile_smem);   // [kBm][ld]
  T* ks = qs + kBm * ld;                     // [kBc][ld]
  T* vs = ks + kBc * ld;                     // [kBc][ld]
  constexpr int NB = kBc / 8;
  const RowTile rt = row_tile(bh_count, t_len, nu);
  const size_t base = static_cast<size_t>(rt.bh) * t_len * kHd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;

  stage_rows(qs, q + base, rt.row0, kBm, t_len);
  stage_rows(ks, k + base, 0, kBc, t_len);
  msgv::cp_async_commit();
  stage_rows(vs, v + base, 0, kBc, t_len);
  msgv::cp_async_commit();

  const float c = scale * kLog2e;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};      // this thread's share of the row sums
  float acc[kHd / 8][4] = {};

  for (int j = 0; j < rt.n_steps; ++j) {
    const int c0 = j * kBc;
    const int hi = clampi((rt.warp_cols - c0 + 7) / 8, 0, NB);
    msgv::cp_async_wait<1>();   // K of this step (and Q)
    __syncthreads();
    float s[NB][4] = {};
    if (hi > 0) mma_abt<NB>(s, qs + 16 * warp * ld, ks, 0, hi, lane);
    __syncthreads();            // every warp is done with K
    if (j + 1 < rt.n_steps) stage_rows(ks, k + base, c0 + kBc, kBc, t_len);
    msgv::cp_async_commit();

    if (hi > 0) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * nb + 2 * t + (e & 1);
            const int row = e < 2 ? rt.ra : rt.rb;
            if (!(col < t_len && visible(row, col, nu)))
              s[nb][e] = -CUDART_INF_F;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
          }
        }
      }
      float base_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        base_m[h] = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float alpha = exp2f((m[h] - base_m[h]) * c);
        m[h] = m_new;
        l[h] *= alpha;
#pragma unroll
        for (int nb = 0; nb < kHd / 8; ++nb) {
          acc[nb][2 * h] *= alpha;
          acc[nb][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a block past hi may hold the scores of a pair's other half
          const float p =
              nb < hi ? exp2f((s[nb][e] - base_m[e >> 1]) * c) : 0.f;
          sum[e >> 1] += p;
          s[nb][e] = p;
        }
      }
      l[0] += sum[0];
      l[1] += sum[1];
    }

    msgv::cp_async_wait<1>();   // V of this step
    __syncthreads();
    if (hi > 0) mma_pb<NB>(acc, s, vs, 0, hi, lane);
    __syncthreads();            // every warp is done with V
    if (j + 1 < rt.n_steps) stage_rows(vs, v + base, c0 + kBc, kBc, t_len);
    msgv::cp_async_commit();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h == 0 ? rt.ra : rt.rb;
    const float sum = quad_sum(l[h]);
    if (row >= t_len) continue;
    const float inv = 1.f / sum;
    T* orow = o + base + static_cast<size_t>(row) * kHd + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kHd / 8; ++nb)
      store2(orow + 8 * nb, acc[nb][2 * h] * inv, acc[nb][2 * h + 1] * inv);
  }
}

template <typename T>
int launch_tiles(const void* q, const void* k, const void* v, void* o, int bh,
                 int t_len, int n_unmasked, cudaStream_t stream) {
  const int tiles = (t_len + kBm - 1) / kBm;
  // one grid dimension holds tiles * bh CTAs
  if (static_cast<long long>(tiles) * bh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(T) * (kBm + 2 * kBc) * kRowLd<T>;
  attention_tile_kernel<T><<<tiles * bh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, t_len,
      max(0, min(n_unmasked, t_len)), 1.0f / sqrtf(static_cast<float>(kHd)));
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (bh, t_len, hd), float32 (bf16 == 0) or bfloat16;
// 16-byte aligned when the tile kernel takes them (t_len > 16, hd == 64).
MSGV_API int msgv_attention(const void* q, const void* k, const void* v,
                            void* o, int bh, int t_len, int hd,
                            int n_unmasked, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (t_len < 1 || bh < 1) return cudaErrorInvalidValue;
  if (t_len > kRowsPerBlock && hd == kHd)
    return bf16 ? launch_tiles<__nv_bfloat16>(q, k, v, o, bh, t_len,
                                              n_unmasked, s)
                : launch_tiles<float>(q, k, v, o, bh, t_len, n_unmasked, s);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, t_len, hd, n_unmasked, s)
              : launch<float>(q, k, v, o, bh, t_len, hd, n_unmasked, s);
}
