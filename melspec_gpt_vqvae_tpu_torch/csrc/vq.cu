// Kernel C: nearest codebook entry for each latent row.
//
// Replaces melspec_gpt_vqvae_tpu/ops/vq.py::_vq_kernel (the Pallas TPU
// kernel behind vq_nearest_index_pallas).  For each row x_n of (N, D) it
// returns argmin_k |e_k|^2 - 2 x_n . e_k (|x_n|^2 is constant per row and
// dropped), in full float32, ties to the lower index, as int32.
//
// What bounds it on the card: N * K * D multiply-adds (16960 x 1024 x 256
// = 4.4 GFLOP at the largest slice shape) in float32 FMA; TF32 would flip
// indices near decision boundaries, so the tensor cores are not used.  The
// K = 1024 codebook (1 MB) does not fit in shared memory, so a block keeps
// 64 latent rows resident and streams the codebook through shared memory
// 32 codes at a time; each thread holds a 2 x 4 register tile of dot
// products and a running (min, argmin) for its two rows, and the eight
// threads that share a row reduce with warp shuffles.  The (N, K) distance
// matrix never leaves the chip.
#include "common.cuh"

namespace {

constexpr int kRows = 64;
constexpr int kCodes = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(kThreads)
    vq_nearest_kernel(const float* __restrict__ x,
                      const float* __restrict__ cb,
                      const float* __restrict__ e2, int* __restrict__ out,
                      int n, int k, int d) {
  extern __shared__ float smem[];
  const int ld = d + 1;  // pad: lanes read different rows, same column
  float* xs = smem;              // [kRows][d + 1]
  float* cs = xs + kRows * ld;   // [kCodes][d + 1]
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    xs[r * ld + i % d] =
        (row0 + r < n) ? x[static_cast<size_t>(row0) * d + i] : 0.f;
  }
  const int tx = tid % 8;  // codes tx + 8 j of each tile
  const int ty = tid / 8;  // rows ty and ty + 32
  float best[2] = {CUDART_INF_F, CUDART_INF_F};
  int bidx[2] = {0, 0};
  for (int k0 = 0; k0 < k; k0 += kCodes) {
    __syncthreads();
    for (int i = tid; i < kCodes * d; i += kThreads) {
      const int r = i / d;
      cs[r * ld + i % d] =
          (k0 + r < k) ? cb[static_cast<size_t>(k0) * d + i] : 0.f;
    }
    __syncthreads();
    float acc[2][4] = {};
    const float* x0 = xs + ty * ld;
    const float* x1 = xs + (ty + 32) * ld;
    for (int c = 0; c < d; ++c) {
      const float a0 = x0[c];
      const float a1 = x1[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = cs[(tx + 8 * j) * ld + c];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    // codes are visited in increasing order, so strict < keeps the lower
    // index on a tie within a thread
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + tx + 8 * j;
      if (kk >= k) continue;
      const float ek = e2[kk];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float dist = ek - 2.f * acc[i][j];
        if (dist < best[i]) {
          best[i] = dist;
          bidx[i] = kk;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    for (int off = 1; off < 8; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (better(od, oi, best[i], bidx[i])) {
        best[i] = od;
        bidx[i] = oi;
      }
    }
    const int r = row0 + ty + 32 * i;
    if (tx == 0 && r < n) out[r] = bidx[i];
  }
}

}  // namespace

// x (n, d) float32, cb (k, d) float32, e2 (k,) float32 = |e_k|^2,
// out (n,) int32; all contiguous.
MSGV_API int msgv_vq_nearest(const void* x, const void* cb, const void* e2,
                             void* out, int n, int k, int d, void* stream) {
  const size_t smem = sizeof(float) * (kRows + kCodes) * (d + 1);
  cudaError_t err = msgv::allow_smem(vq_nearest_kernel, smem);
  if (err != cudaSuccess) return err;
  vq_nearest_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const float*>(e2), static_cast<int*>(out), n, k, d);
  return cudaGetLastError();
}
