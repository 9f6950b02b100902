// Kernel F: fused training attention with a dropout keep-mask, forward and
// backward, on the tensor cores at float32 accuracy.
//
// Replaces melspec_gpt_vqvae_tpu/ops/flash_attention.py::_fwd_kernel and
// ::_bwd_kernel (the Pallas TPU kernels behind the jax.custom_vjp
// flash_attention).  Per (batch*head), with the minGPT mask (causal, or
// inside the leading n_unmasked x n_unmasked block):
//   forward   P = softmax(mask(Q K^T * scale)),  lse = logsumexp of a row,
//             O = (P * keep / keep_prob) V
//   backward  P = exp(S - lse) recomputed,  D_i = rowsum(dO_i * O_i)
//             (equal to the TPU kernel's rowsum(dP * P): O already carries
//             the mask),  dS = P * (dP - D),  dQ = dS K * scale,
//             dK = dS^T Q * scale,  dV = (P * keep / keep_prob)^T dO.
// The keep-mask (B*H, T, T) of {0, 1} bytes is applied only when
// keep_prob < 1, as in the TPU kernels; it may be null (all kept).
//
// What bounds it on the card: at the GPT training shape (B*H = 128,
// T = 265, hd = 64, float32) the function moves 36 MB forward and 79 MB
// backward (0.011 / 0.024 ms at the memory rate) and its 2 / 5 products
// over the causal half are 1.2 / 2.9 GFLOP, far below both the float32
// FMA pipes and the tensor cores: it is bound by bytes, and what a kernel
// loses it loses to instruction slots, shared-memory reads and latency.
//
// The design.
//   * Every product runs on the tensor cores as mma.sync m16n8k8 with TF32
//     operands and float32 accumulators.  A float32 operand x is split
//     into big = tf32(x) and small = x - big (its first 10 mantissa bits
//     are what the tensor core reads); a product is
//     a_big b_big + a_big b_small + a_small b_big, which keeps ~21
//     mantissa bits (one TF32 product keeps 10 and misses the bounds).
//     Operands are split after the shared-memory read; probabilities and
//     dS are split in registers.  The tensor cores truncate when they add
//     into an accumulator, so running sums are kept outside them: the
//     three mma of a k-block go into a fresh accumulator that is added in
//     float32.
//   * Tiles in the FlashAttention-2 shape.  Forward and dQ: a CTA of 4
//     warps takes 64 query rows, a warp 16 of them, and loops over
//     32-column K/V tiles up to the tile's last visible column with an
//     online softmax (running max and sum per row in registers).  dK/dV: a
//     CTA owns 64 columns, a warp 16 of them, and loops over 32-row Q/dO
//     tiles from the first row that sees them; it forms S^T = K Q^T and
//     dP^T = V dO^T directly, so P^T and dS^T arrive in the accumulator
//     layout.  No float atomics: every sum has a fixed order, so the
//     gradients are deterministic.
//   * Accumulator -> next product's A operand without shared memory: an
//     m16n8 accumulator holds columns 2t, 2t+1 of rows g, g+8 where the
//     m16k8 A fragment wants contraction indices t, t+4.  The contraction
//     index is permuted (k = t <-> column 2t, k = t+4 <-> column 2t+1) and
//     the B operand's rows are read in the same order.
//   * Shared-memory tiles are [row][68 floats]: rows stay 16-byte aligned
//     for cp.async and both B-operand read patterns (row g, float t; row
//     2t, float g) touch 32 distinct banks.  Rows past T are zero-filled.
//   * Keep-mask rows are T bytes apart and so not even 4-byte aligned: a
//     tile's rows are staged with 4-byte cp.async from the aligned word
//     that holds the row's first byte, and read at that byte's offset.
//   * Staging overlaps the products: in the forward the next K tile loads
//     behind softmax and P V, the next V tile behind Q K^T; 37-55 KB of
//     shared memory a CTA and 128-168 registers a thread let 3-4 CTAs
//     share an SM.
//   * A warp skips the 8-column blocks none of its rows can see, and
//     warps whose rows lie past T only help staging.
#include "attn_tiles.cuh"

namespace {

using namespace msgv::tiles;

constexpr int kBr = 32;        // Q/dO rows a step (dK/dV)
constexpr int kKwF = kBc / 4 + 1;  // staged keep words a row (forward, dQ)
constexpr int kKwT = kBm / 4 + 1;  // the same for dK/dV

// Keep bytes of rows [r0, r0 + n) x columns [c0, c0 + ncols) of one
// (t_len, t_len) mask into dst[n][W words]: each row is copied from the
// aligned word that holds its first byte, so column c0 + j of row r lies
// at byte keep_off(row) + j of the staged row.
template <int W>
__device__ __forceinline__ void stage_keep(uint8_t* dst,
                                           const uint8_t* __restrict__ keep,
                                           int r0, int n, int c0, int ncols,
                                           int t_len) {
  const int cend = min(c0 + ncols, t_len);
  for (int i = threadIdx.x; i < n * W; i += kThreads) {
    const int r = i / W, w = i % W;
    if (r0 + r >= t_len) continue;
    const uint8_t* row = keep + static_cast<size_t>(r0 + r) * t_len;
    const uintptr_t a =
        (reinterpret_cast<uintptr_t>(row + c0) & ~uintptr_t(3)) + 4 * w;
    if (a < reinterpret_cast<uintptr_t>(row + cend))
      msgv::cp_async4(dst + (r * W + w) * 4, reinterpret_cast<const void*>(a));
  }
}

__device__ __forceinline__ int keep_off(const uint8_t* keep, int row, int c0,
                                        int t_len) {
  return static_cast<int>(
      reinterpret_cast<uintptr_t>(keep + static_cast<size_t>(row) * t_len +
                                  c0) & 3);
}


// ---------------------------------------------------------------------------
// forward: grid (row tiles * B*H)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ keep, float* __restrict__ o,
                     float* __restrict__ lse, int bh_count, int t_len, int nu,
                     float scale, float keep_prob) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [kBm][kLd]
  float* ks = qs + kBm * kLd;                   // [kBc][kLd]
  float* vs = ks + kBc * kLd;                   // [kBc][kLd]
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(vs + kBc * kLd);
                                                // [kBm][kKwF] words
  constexpr int NB = kBc / 8;
  const RowTile rt = row_tile(bh_count, t_len, nu);
  const size_t base = static_cast<size_t>(rt.bh) * t_len * kHd;
  const bool masked = keep != nullptr && keep_prob < 1.f;
  const uint8_t* keep_bh =
      masked ? keep + static_cast<size_t>(rt.bh) * t_len * t_len : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  stage_rows(qs, q + base, rt.row0, kBm, t_len);
  stage_rows(ks, k + base, 0, kBc, t_len);
  msgv::cp_async_commit();
  stage_rows(vs, v + base, 0, kBc, t_len);
  if (masked) stage_keep<kKwF>(keep_s, keep_bh, rt.row0, kBm, 0, kBc, t_len);
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
    if (hi > 0) mma_abt<NB>(s, qs + 16 * warp * kLd, ks, 0, hi, lane);
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
        if (nb < hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f((s[nb][e] - base_m[e >> 1]) * c);
            sum[e >> 1] += p;
            s[nb][e] = p;
          }
        }
      }
      l[0] += sum[0];
      l[1] += sum[1];
    }

    msgv::cp_async_wait<1>();   // V and the keep bytes of this step
    __syncthreads();
    if (hi > 0) {
      if (masked) {
        const uint8_t* ka = keep_s + (16 * warp + g) * (kKwF * 4) +
                            keep_off(keep_bh, min(rt.ra, t_len - 1), c0, t_len);
        const uint8_t* kb = keep_s + (16 * warp + g + 8) * (kKwF * 4) +
                            keep_off(keep_bh, min(rt.rb, t_len - 1), c0, t_len);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (nb < hi) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint8_t* kr = e < 2 ? ka : kb;
              if (kr[8 * nb + 2 * t + (e & 1)] == 0) s[nb][e] = 0.f;
            }
          }
        }
      }
      mma_pb<NB>(acc, s, vs, 0, hi, lane);
    }
    __syncthreads();            // every warp is done with V and keep
    if (j + 1 < rt.n_steps) {
      stage_rows(vs, v + base, c0 + kBc, kBc, t_len);
      if (masked)
        stage_keep<kKwF>(keep_s, keep_bh, rt.row0, kBm, c0 + kBc, kBc, t_len);
    }
    msgv::cp_async_commit();
  }

  const float inv_kp = keep_prob < 1.f ? 1.f / keep_prob : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h == 0 ? rt.ra : rt.rb;
    const float sum = quad_sum(l[h]);
    if (row >= t_len) continue;
    const float inv = inv_kp / sum;
    float* orow = o + base + static_cast<size_t>(row) * kHd + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kHd / 8; ++nb)
      *reinterpret_cast<float2*>(orow + 8 * nb) =
          make_float2(acc[nb][2 * h] * inv, acc[nb][2 * h + 1] * inv);
    if (t == 0)
      lse[static_cast<size_t>(rt.bh) * t_len + row] =
          m[h] * scale + logf(sum);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kDeltaWarps = 8;

// delta[i] = dO_i . O_i, one warp per row.
__global__ void __launch_bounds__(kDeltaWarps * 32)
    flash_bwd_delta_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t b = static_cast<size_t>(row) * kHd;
  float s = o[b + lane] * dout[b + lane];
  s = fmaf(o[b + lane + 32], dout[b + lane + 32], s);
  s = msgv::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// dQ over row tiles: grid (row tiles * B*H).
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ keep,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int bh_count, int t_len,
                        int nu, float scale, float keep_prob) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [kBm][kLd]
  float* dos = qs + kBm * kLd;                  // [kBm][kLd]
  float* ks = dos + kBm * kLd;                  // [kBc][kLd]
  float* vs = ks + kBc * kLd;                   // [kBc][kLd]
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(vs + kBc * kLd);
  constexpr int NB = kBc / 8;
  const RowTile rt = row_tile(bh_count, t_len, nu);
  const size_t base = static_cast<size_t>(rt.bh) * t_len * kHd;
  const bool masked = keep != nullptr && keep_prob < 1.f;
  const uint8_t* keep_bh =
      masked ? keep + static_cast<size_t>(rt.bh) * t_len * t_len : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  stage_rows(qs, q + base, rt.row0, kBm, t_len);
  stage_rows(dos, dout + base, rt.row0, kBm, t_len);
  stage_rows(ks, k + base, 0, kBc, t_len);
  msgv::cp_async_commit();
  stage_rows(vs, v + base, 0, kBc, t_len);
  if (masked) stage_keep<kKwF>(keep_s, keep_bh, rt.row0, kBm, 0, kBc, t_len);
  msgv::cp_async_commit();

  const float c = scale * kLog2e;
  const float inv_kp = keep_prob < 1.f ? 1.f / keep_prob : 1.f;
  float lse2[2], dl[2];   // lse in log2 units and delta of rows ra, rb
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h == 0 ? rt.ra : rt.rb;
    const size_t i = static_cast<size_t>(rt.bh) * t_len + min(row, t_len - 1);
    lse2[h] = lse[i] * kLog2e;
    dl[h] = delta[i];
  }
  float acc[kHd / 8][4] = {};

  for (int j = 0; j < rt.n_steps; ++j) {
    const int c0 = j * kBc;
    const int hi = clampi((rt.warp_cols - c0 + 7) / 8, 0, NB);
    msgv::cp_async_wait<0>();   // K, V and keep of this step (and Q, dO)
    __syncthreads();
    float s[NB][4] = {}, dp[NB][4] = {};
    if (hi > 0) {
      mma_abt<NB>(s, qs + 16 * warp * kLd, ks, 0, hi, lane);
      mma_abt<NB>(dp, dos + 16 * warp * kLd, vs, 0, hi, lane);
    }
    __syncthreads();            // every warp is done with V
    if (j + 1 < rt.n_steps) stage_rows(vs, v + base, c0 + kBc, kBc, t_len);
    msgv::cp_async_commit();
    if (hi > 0) {
      const uint8_t* ka = nullptr;
      const uint8_t* kb = nullptr;
      if (masked) {
        ka = keep_s + (16 * warp + g) * (kKwF * 4) +
             keep_off(keep_bh, min(rt.ra, t_len - 1), c0, t_len);
        kb = keep_s + (16 * warp + g + 8) * (kKwF * 4) +
             keep_off(keep_bh, min(rt.rb, t_len - 1), c0, t_len);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cc = 8 * nb + 2 * t + (e & 1);
            const int row = e < 2 ? rt.ra : rt.rb;
            float ds = 0.f;
            if (c0 + cc < t_len && visible(row, c0 + cc, nu)) {
              const float p = exp2f(fmaf(s[nb][e], c, -lse2[e >> 1]));
              float d = dp[nb][e] * inv_kp;
              if (masked && (e < 2 ? ka : kb)[cc] == 0) d = 0.f;
              ds = p * (d - dl[e >> 1]);
            }
            s[nb][e] = ds;
          }
        }
      }
      mma_pb<NB>(acc, s, ks, 0, hi, lane);
    }
    __syncthreads();            // every warp is done with K and keep
    if (j + 1 < rt.n_steps) {
      stage_rows(ks, k + base, c0 + kBc, kBc, t_len);
      if (masked)
        stage_keep<kKwF>(keep_s, keep_bh, rt.row0, kBm, c0 + kBc, kBc, t_len);
    }
    msgv::cp_async_commit();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h == 0 ? rt.ra : rt.rb;
    if (row >= t_len) continue;
    float* drow = dq + base + static_cast<size_t>(row) * kHd + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kHd / 8; ++nb)
      *reinterpret_cast<float2*>(drow + 8 * nb) =
          make_float2(acc[nb][2 * h] * scale, acc[nb][2 * h + 1] * scale);
  }
}

// dK and dV over column tiles: grid (column tiles * B*H).  Column c is seen
// by rows [c < nu ? 0 : c, t_len).
__global__ void __launch_bounds__(kThreads, 3)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ keep,
                         const float* __restrict__ lse,
                         const float* __restrict__ dout,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int bh_count, int t_len, int nu, float scale,
                         float keep_prob) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);   // [kBm][kLd]
  float* vs = ks + kBm * kLd;                   // [kBm][kLd]
  float* qs = vs + kBm * kLd;                   // [kBr][kLd]
  float* dos = qs + kBr * kLd;                  // [kBr][kLd]
  float* lse_s = dos + kBr * kLd;               // [kBr], log2 units
  float* dl_s = lse_s + kBr;                    // [kBr]
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(dl_s + kBr);
                                                // [kBr][kKwT] words
  constexpr int NB = kBr / 8;
  const int bh = blockIdx.x % bh_count;
  const int c0 = (blockIdx.x / bh_count) * kBm;   // low tiles see most rows
  const int r_first = c0 < nu ? 0 : c0;
  const size_t base = static_cast<size_t>(bh) * t_len * kHd;
  const bool masked = keep != nullptr && keep_prob < 1.f;
  const uint8_t* keep_bh =
      masked ? keep + static_cast<size_t>(bh) * t_len * t_len : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cw0 = c0 + 16 * warp;       // the warp's first column
  const int ca = cw0 + g, cb = ca + 8;  // this thread's two columns

  stage_rows(ks, k + base, c0, kBm, t_len);
  stage_rows(vs, v + base, c0, kBm, t_len);

  const float c = scale * kLog2e;
  const float inv_kp = keep_prob < 1.f ? 1.f / keep_prob : 1.f;
  float acc_k[kHd / 8][4] = {}, acc_v[kHd / 8][4] = {};

  for (int r0 = r_first; r0 < t_len; r0 += kBr) {
    stage_rows(qs, q + base, r0, kBr, t_len);
    stage_rows(dos, dout + base, r0, kBr, t_len);
    if (masked) stage_keep<kKwT>(keep_s, keep_bh, r0, kBr, c0, kBm, t_len);
    msgv::cp_async_commit();
    if (threadIdx.x < kBr) {
      const int r = r0 + threadIdx.x;
      const size_t i = static_cast<size_t>(bh) * t_len + min(r, t_len - 1);
      lse_s[threadIdx.x] = lse[i] * kLog2e;
      dl_s[threadIdx.x] = delta[i];
    }
    msgv::cp_async_wait<0>();
    __syncthreads();

    // the 8-row blocks of this step that see some column of the warp
    const int lo = cw0 < nu ? 0 : clampi((cw0 - r0) / 8, 0, NB);
    const int hi = cw0 < t_len ? clampi((t_len - r0 + 7) / 8, 0, NB) : 0;
    if (lo < hi) {
      float st[NB][4] = {}, dpt[NB][4] = {};
      mma_abt<NB>(st, ks + 16 * warp * kLd, qs, lo, hi, lane);
      mma_abt<NB>(dpt, vs + 16 * warp * kLd, dos, lo, hi, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb >= lo && nb < hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = 8 * nb + 2 * t + (e & 1);
            const int col = e < 2 ? ca : cb;
            float pd = 0.f, ds = 0.f;
            if (r0 + rr < t_len && col < t_len &&
                visible(r0 + rr, col, nu)) {
              const float p = exp2f(fmaf(st[nb][e], c, -lse_s[rr]));
              pd = p * inv_kp;
              float d = dpt[nb][e] * inv_kp;
              if (masked &&
                  keep_s[rr * (kKwT * 4) +
                         keep_off(keep_bh, r0 + rr, c0, t_len) + col - c0] ==
                      0) {
                pd = 0.f;
                d = 0.f;
              }
              ds = p * (d - dl_s[rr]);
            }
            st[nb][e] = pd;
            dpt[nb][e] = ds;
          }
        }
      }
      mma_pb<NB>(acc_v, st, dos, lo, hi, lane);
      mma_pb<NB>(acc_k, dpt, qs, lo, hi, lane);
    }
    __syncthreads();   // every warp is done with this step's tiles
  }
  msgv::cp_async_wait<0>();   // a tile with no step still staged K and V

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = h == 0 ? ca : cb;
    if (col >= t_len) continue;
    const size_t out = base + static_cast<size_t>(col) * kHd + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kHd / 8; ++nb) {
      *reinterpret_cast<float2*>(dv + out + 8 * nb) =
          make_float2(acc_v[nb][2 * h], acc_v[nb][2 * h + 1]);
      *reinterpret_cast<float2*>(dk + out + 8 * nb) = make_float2(
          acc_k[nb][2 * h] * scale, acc_k[nb][2 * h + 1] * scale);
    }
  }
}

constexpr size_t kFwdSmem =
    sizeof(float) * (kBm + 2 * kBc) * kLd + kBm * kKwF * 4;
constexpr size_t kDqSmem =
    sizeof(float) * (2 * kBm + 2 * kBc) * kLd + kBm * kKwF * 4;
constexpr size_t kDkvSmem =
    sizeof(float) * ((2 * kBm + 2 * kBr) * kLd + 2 * kBr) + kBr * kKwT * 4;

int tiles(int t_len) { return (t_len + kBm - 1) / kBm; }

bool bad_shape(int bh, int t_len, int hd) {
  // one grid dimension holds tiles * bh CTAs
  return hd != kHd || t_len < 1 || bh < 1 ||
         static_cast<long long>(tiles(t_len)) * bh > 0x7fffffffLL;
}

}  // namespace

// q, k, v, o: contiguous float32 (bh, t_len, hd), 16-byte aligned; keep:
// (bh, t_len, t_len) bytes (any alignment) or null; lse: float32
// (bh, t_len).  hd must be 64.
MSGV_API int msgv_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* keep, void* o,
                                      void* lse, int bh, int t_len, int hd,
                                      int n_unmasked, float keep_prob,
                                      void* stream) {
  if (bad_shape(bh, t_len, hd)) return cudaErrorInvalidValue;
  cudaError_t err = msgv::allow_smem(flash_fwd_kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  const int nu = max(0, min(n_unmasked, t_len));
  flash_fwd_kernel<<<tiles(t_len) * bh, kThreads, kFwdSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(keep),
      static_cast<float*>(o), static_cast<float*>(lse), bh, t_len, nu,
      1.0f / sqrtf(static_cast<float>(hd)), keep_prob);
  return cudaGetLastError();
}

// As the forward, plus o (the forward's output), dout (dO), the float32
// (bh, t_len) scratch delta, and the outputs dq, dk, dv (bh, t_len, hd).
MSGV_API int msgv_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* keep,
                                      const void* o, const void* lse,
                                      const void* dout, void* dq, void* dk,
                                      void* dv, void* delta, int bh,
                                      int t_len, int hd, int n_unmasked,
                                      float keep_prob, void* stream) {
  if (bad_shape(bh, t_len, hd)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int nu = max(0, min(n_unmasked, t_len));
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* keep8 = static_cast<const uint8_t*>(keep);
  const auto* lsef = static_cast<const float*>(lse);
  const auto* dof = static_cast<const float*>(dout);
  auto* deltaf = static_cast<float*>(delta);

  const long long rows = static_cast<long long>(bh) * t_len;
  flash_bwd_delta_kernel<<<static_cast<unsigned>(
                               (rows + kDeltaWarps - 1) / kDeltaWarps),
                           kDeltaWarps * 32, 0, s>>>(
      static_cast<const float*>(o), dof, deltaf, static_cast<int>(rows));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = msgv::allow_smem(flash_bwd_dq_kernel, kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<tiles(t_len) * bh, kThreads, kDqSmem, s>>>(
      qf, kf, vf, keep8, lsef, dof, deltaf, static_cast<float*>(dq), bh, t_len,
      nu, scale, keep_prob);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = msgv::allow_smem(flash_bwd_dkv_kernel, kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<<<tiles(t_len) * bh, kThreads, kDkvSmem, s>>>(
      qf, kf, vf, keep8, lsef, dof, deltaf, static_cast<float*>(dk),
      static_cast<float*>(dv), bh, t_len, nu, scale, keep_prob);
  return cudaGetLastError();
}
