// Kernel F: fused training attention with a dropout keep-mask, forward and
// backward.
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
// T = 265, hd = 64, float32) a layer's attention is ~2.3 GFLOP forward and
// ~2.5x that backward, and the only large read is the 9 MB keep-mask; it
// is bound by float32 FMA issue and shared-memory reads, not by device
// memory.  The design: a sequence is at most ~400 long, so one CTA stages
// everything a tile of 32 rows (or columns) can see in shared memory --
// K and V for the forward and dQ, Q and dO for dK/dV -- transposed with an
// odd leading dimension, so that lanes walking columns and lanes walking
// the head dim both read conflict-free.  Each warp holds its row's q (and
// dO) in registers, lanes take columns, and each dot product runs four
// independent FMA chains.  Every row's visible columns are one range
// (rcols = r < nu ? nu : r + 1), so nothing is filled with -inf.  The
// backward has no atomics: dQ runs over row tiles, dK/dV over column tiles
// (each column loops over the rows that see it), and every sum is taken
// in a fixed order, so the gradients are deterministic.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kHd = 64;      // head dim the kernels are written for
constexpr int kWarps = 8;
constexpr int kTile = 32;    // rows (forward, dQ) or columns (dK/dV) a CTA
constexpr int kKeepLd = kTile + 1;  // bytes per staged keep-mask row

// Rows [0, n) of a row-major (n, kHd) matrix into smem as dst[d * ld + i].
__device__ __forceinline__ void stage_transposed(float* dst, int ld,
                                                 const float* __restrict__ src,
                                                 int n) {
  for (int i = threadIdx.x; i < n * kHd; i += blockDim.x)
    dst[(i % kHd) * ld + i / kHd] = src[i];
}

__device__ __forceinline__ void load_row(float (&dst)[kHd],
                                         const float* __restrict__ src) {
#pragma unroll
  for (int d = 0; d < kHd; ++d) dst[d] = __ldg(src + d);
}

// a . column i of a transposed smem matrix, in four FMA chains.
__device__ __forceinline__ float dot_col(const float (&a)[kHd],
                                         const float* bt, int ld, int i) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < kHd; d += 4) {
    s0 = fmaf(a[d], bt[d * ld + i], s0);
    s1 = fmaf(a[d + 1], bt[(d + 1) * ld + i], s1);
    s2 = fmaf(a[d + 2], bt[(d + 2) * ld + i], s2);
    s3 = fmaf(a[d + 3], bt[(d + 3) * ld + i], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// Columns a query row sees: c < rcols.
__device__ __forceinline__ int visible_cols(int r, int nu) {
  return r < nu ? nu : r + 1;
}

// ---------------------------------------------------------------------------
// forward: grid (row tiles, B*H)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ keep, float* __restrict__ o,
                     float* __restrict__ lse, int t_len, int nu, float scale,
                     float keep_prob) {
  extern __shared__ float smem[];
  const int ldmax = t_len | 1;
  const int row0 = blockIdx.x * kTile;
  const int row_end = min(row0 + kTile, t_len);
  const int ncols = row0 < nu ? max(row_end, nu) : row_end;
  const int ld = ncols | 1;
  float* kt = smem;                 // [kHd][ld]
  float* vs = kt + kHd * ldmax;     // [ncols][kHd]
  float* ps = vs + t_len * kHd;     // [kWarps][t_len]

  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * kHd;
  stage_transposed(kt, ld, k + base, ncols);
  for (int i = threadIdx.x; i < ncols * kHd; i += blockDim.x)
    vs[i] = v[base + i];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * t_len;
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    float qr[kHd];
    load_row(qr, q + base + static_cast<size_t>(r) * kHd);
    const int rcols = visible_cols(r, nu);
    float mx = -CUDART_INF_F;
    for (int c = lane; c < rcols; c += 32) {
      const float s = dot_col(qr, kt, ld, c) * scale;
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
    if (lane == 0) lse[bh * t_len + r] = mx + logf(sum);
    const uint8_t* keep_r =
        keep ? keep + (bh * t_len + r) * static_cast<size_t>(t_len) : nullptr;
    for (int c = lane; c < rcols; c += 32) {
      float pc = p[c] / sum;
      if (keep_prob < 1.f)
        pc = pc * (keep_r ? static_cast<float>(keep_r[c]) : 1.f) / keep_prob;
      p[c] = pc;
    }
    __syncwarp();
    // O row: lane owns head dims lane and lane + 32, two chains each
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    int c = 0;
    for (; c + 1 < rcols; c += 2) {
      const float p0 = p[c], p1 = p[c + 1];
      a0 = fmaf(p0, vs[c * kHd + lane], a0);
      b0 = fmaf(p0, vs[c * kHd + lane + 32], b0);
      a1 = fmaf(p1, vs[(c + 1) * kHd + lane], a1);
      b1 = fmaf(p1, vs[(c + 1) * kHd + lane + 32], b1);
    }
    if (c < rcols) {
      a0 = fmaf(p[c], vs[c * kHd + lane], a0);
      b0 = fmaf(p[c], vs[c * kHd + lane + 32], b0);
    }
    float* orow = o + base + static_cast<size_t>(r) * kHd;
    orow[lane] = a0 + a1;
    orow[lane + 32] = b0 + b1;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta[i] = dO_i . O_i, one warp per row.
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_delta_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t b = static_cast<size_t>(row) * kHd;
  float s = o[b + lane] * dout[b + lane];
  s = fmaf(o[b + lane + 32], dout[b + lane + 32], s);
  s = msgv::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// dQ over row tiles: grid (row tiles, B*H).
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ keep,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int t_len, int nu,
                        float scale, float keep_prob) {
  extern __shared__ float smem[];
  const int ldmax = t_len | 1;
  const int row0 = blockIdx.x * kTile;
  const int row_end = min(row0 + kTile, t_len);
  const int ncols = row0 < nu ? max(row_end, nu) : row_end;
  const int ld = ncols | 1;
  float* kt = smem;                 // [kHd][ld]
  float* vt = kt + kHd * ldmax;     // [kHd][ld]
  float* dss = vt + kHd * ldmax;    // [kWarps][t_len]

  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * kHd;
  stage_transposed(kt, ld, k + base, ncols);
  stage_transposed(vt, ld, v + base, ncols);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ds = dss + warp * t_len;
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    float qr[kHd], dor[kHd];
    load_row(qr, q + base + static_cast<size_t>(r) * kHd);
    load_row(dor, dout + base + static_cast<size_t>(r) * kHd);
    const float lse_r = lse[bh * t_len + r];
    const float d_r = delta[bh * t_len + r];
    const uint8_t* keep_r =
        keep ? keep + (bh * t_len + r) * static_cast<size_t>(t_len) : nullptr;
    const int rcols = visible_cols(r, nu);
    for (int c = lane; c < rcols; c += 32) {
      const float p = expf(dot_col(qr, kt, ld, c) * scale - lse_r);
      float dp = dot_col(dor, vt, ld, c);
      if (keep_prob < 1.f)
        dp = dp * (keep_r ? static_cast<float>(keep_r[c]) : 1.f) / keep_prob;
      ds[c] = p * (dp - d_r);
    }
    __syncwarp();
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
    int c = 0;
    for (; c + 1 < rcols; c += 2) {
      const float s0 = ds[c], s1 = ds[c + 1];
      a0 = fmaf(s0, kt[lane * ld + c], a0);
      b0 = fmaf(s0, kt[(lane + 32) * ld + c], b0);
      a1 = fmaf(s1, kt[lane * ld + c + 1], a1);
      b1 = fmaf(s1, kt[(lane + 32) * ld + c + 1], b1);
    }
    if (c < rcols) {
      a0 = fmaf(ds[c], kt[lane * ld + c], a0);
      b0 = fmaf(ds[c], kt[(lane + 32) * ld + c], b0);
    }
    float* dqrow = dq + base + static_cast<size_t>(r) * kHd;
    dqrow[lane] = (a0 + a1) * scale;
    dqrow[lane + 32] = (b0 + b1) * scale;
    __syncwarp();
  }
}

// dK and dV over column tiles: grid (column tiles, B*H).  Column c is seen
// by rows [c < nu ? 0 : c, t_len).
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const uint8_t* __restrict__ keep,
                         const float* __restrict__ lse,
                         const float* __restrict__ dout,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int t_len, int nu, float scale, float keep_prob) {
  extern __shared__ float smem[];
  const int ldmax = t_len | 1;
  const int c0 = blockIdx.x * kTile;
  const int c_end = min(c0 + kTile, t_len);
  const int r0 = c0 < nu ? 0 : c0;  // first row that sees the tile
  const int nrows = t_len - r0;
  const int ld = nrows | 1;
  float* qt = smem;                     // [kHd][ld], rows r0..
  float* dout_t = qt + kHd * ldmax;     // [kHd][ld]
  float* lse_s = dout_t + kHd * ldmax;     // [nrows]
  float* d_s = lse_s + t_len;           // [nrows]
  float* bufs = d_s + t_len;            // [kWarps][2][t_len]
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(bufs + 2 * kWarps * t_len);
                                        // [nrows][kKeepLd]

  const size_t bh = blockIdx.y;
  const size_t base = bh * t_len * kHd;
  const size_t rbase = base + static_cast<size_t>(r0) * kHd;
  stage_transposed(qt, ld, q + rbase, nrows);
  stage_transposed(dout_t, ld, dout + rbase, nrows);
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    lse_s[i] = lse[bh * t_len + r0 + i];
    d_s[i] = delta[bh * t_len + r0 + i];
  }
  if (keep_prob < 1.f) {
    for (int i = threadIdx.x; i < nrows * kTile; i += blockDim.x) {
      const int r = i / kTile, cc = i % kTile;
      keep_s[r * kKeepLd + cc] =
          (keep && c0 + cc < t_len)
              ? keep[(bh * t_len + r0 + r) * static_cast<size_t>(t_len) + c0 +
                     cc]
              : 1;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* bpd = bufs + 2 * warp * t_len;
  float* bds = bpd + t_len;
  for (int c = c0 + warp; c < c_end; c += kWarps) {
    float kc[kHd], vc[kHd];
    load_row(kc, k + base + static_cast<size_t>(c) * kHd);
    load_row(vc, v + base + static_cast<size_t>(c) * kHd);
    const int i0 = (c < nu ? 0 : c) - r0;  // first staged row that sees c
    for (int i = i0 + lane; i < nrows; i += 32) {
      const float p = expf(dot_col(kc, qt, ld, i) * scale - lse_s[i]);
      float dp = dot_col(vc, dout_t, ld, i);
      float pd = p;
      if (keep_prob < 1.f) {
        const float kf = static_cast<float>(keep_s[i * kKeepLd + c - c0]);
        pd = p * kf / keep_prob;
        dp = dp * kf / keep_prob;
      }
      bpd[i] = pd;
      bds[i] = p * (dp - d_s[i]);
    }
    __syncwarp();
    float v0 = 0.f, v1 = 0.f, k0 = 0.f, k1 = 0.f;
    for (int i = i0; i < nrows; ++i) {
      const float pd = bpd[i], s = bds[i];
      v0 = fmaf(pd, dout_t[lane * ld + i], v0);
      v1 = fmaf(pd, dout_t[(lane + 32) * ld + i], v1);
      k0 = fmaf(s, qt[lane * ld + i], k0);
      k1 = fmaf(s, qt[(lane + 32) * ld + i], k1);
    }
    const size_t out = base + static_cast<size_t>(c) * kHd;
    dv[out + lane] = v0;
    dv[out + lane + 32] = v1;
    dk[out + lane] = k0 * scale;
    dk[out + lane + 32] = k1 * scale;
    __syncwarp();
  }
}

size_t fwd_smem(int t_len) {
  return sizeof(float) * (static_cast<size_t>(kHd) * (t_len | 1) +
                          static_cast<size_t>(t_len) * kHd +
                          static_cast<size_t>(kWarps) * t_len);
}

size_t dq_smem(int t_len) {
  return sizeof(float) * (2 * static_cast<size_t>(kHd) * (t_len | 1) +
                          static_cast<size_t>(kWarps) * t_len);
}

size_t dkv_smem(int t_len) {
  return sizeof(float) * (2 * static_cast<size_t>(kHd) * (t_len | 1) +
                          2 * static_cast<size_t>(t_len) +
                          2 * static_cast<size_t>(kWarps) * t_len) +
         static_cast<size_t>(t_len) * kKeepLd;
}

int tiles(int t_len) { return (t_len + kTile - 1) / kTile; }

}  // namespace

// q, k, v, o: contiguous float32 (bh, t_len, hd); keep: (bh, t_len, t_len)
// bytes or null; lse: float32 (bh, t_len).  hd must be 64.
MSGV_API int msgv_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* keep, void* o,
                                      void* lse, int bh, int t_len, int hd,
                                      int n_unmasked, float keep_prob,
                                      void* stream) {
  if (hd != kHd || t_len < 1 || bh < 1) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem(t_len);
  cudaError_t err = msgv::allow_smem(flash_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const int nu = max(0, min(n_unmasked, t_len));
  flash_fwd_kernel<<<dim3(tiles(t_len), bh), kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(keep),
      static_cast<float*>(o), static_cast<float*>(lse), t_len, nu,
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
  if (hd != kHd || t_len < 1 || bh < 1) return cudaErrorInvalidValue;
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

  const int rows = bh * t_len;
  flash_bwd_delta_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const float*>(o), dof, deltaf, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  size_t smem = dq_smem(t_len);
  err = msgv::allow_smem(flash_bwd_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<dim3(tiles(t_len), bh), kWarps * 32, smem, s>>>(
      qf, kf, vf, keep8, lsef, dof, deltaf, static_cast<float*>(dq), t_len, nu,
      scale, keep_prob);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  smem = dkv_smem(t_len);
  err = msgv::allow_smem(flash_bwd_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<<<dim3(tiles(t_len), bh), kWarps * 32, smem, s>>>(
      qf, kf, vf, keep8, lsef, dof, deltaf, static_cast<float*>(dk),
      static_cast<float*>(dv), t_len, nu, scale, keep_prob);
  return cudaGetLastError();
}
