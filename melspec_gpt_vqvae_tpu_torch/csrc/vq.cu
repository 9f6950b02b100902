// Kernel C: nearest codebook entry for each latent row.
//
// Replaces melspec_gpt_vqvae_tpu/ops/vq.py::_vq_kernel (the Pallas TPU
// kernel behind vq_nearest_index_pallas).  For each row x_n of (N, D) it
// returns argmin_k |e_k|^2 - 2 x_n . e_k (|x_n|^2 is constant per row and
// dropped), in full float32, ties to the lower index, as int32.
//
// What bounds it on the card: N * K * D multiply-adds in float32 FMA
// (12720 x 128 x 256 = 0.42 G at the tokenize shape, 16960 x 1024 x 256 =
// 4.4 G at the widest codebook); TF32 would flip indices near decision
// boundaries, so the tensor cores are not used, and each dot product is one
// chain of FMAs over d = 0 .. D - 1 in order, whatever the tiling, so the
// distances do not depend on it.  The design keeps the FMA pipe fed:
//
//   * a CTA of 256 threads takes a tile of 16 R rows (R = 4 .. 8) against
//     128 codes; a thread holds an R x 8 register tile (rows ty + 16 i,
//     codes tx + 16 c) and reads both operands as float4 along d: at R = 8,
//     16 vector loads from shared memory for 256 FMAs.  Rows and codes lie
//     row-major in shared memory with a pitch of 4 floats more than their
//     width, so the eight lanes of a quarter-warp, which read eight
//     consecutive codes at one d, hit eight different 16-byte bank groups,
//     and lanes that read the same row share one broadcast;
//   * rows and codes move together through a ring of stages of ((rows +
//     128 codes) x 64 d), filled by cp.async two or three chunks ahead of
//     the FMAs, one barrier a chunk; the codebook comes from L2 again for
//     every row tile (128 KB a tile at K = 128), which costs less than a
//     resident copy that leaves room for only 64 rows;
//   * the grid is persistent, one CTA an SM, each walking over row tiles
//     blockIdx.x, + gridDim.x, ...; the host picks the tile height that
//     leaves the busiest CTA the fewest rows (12,720 rows on 132 SMs: 114
//     tiles of 112; at 128 a tile the busiest CTA would hold 128, at 64
//     two tiles);
//   * each thread keeps a running (min, argmin) for its rows, visiting its
//     codes in increasing order, and the sixteen threads that share a row
//     merge with warp shuffles, the lower index winning a tie.  The (N, K)
//     distance matrix never leaves the chip.
//
// ops/vq.py::vq_nearest_index_tiled walks the same tiles in plain PyTorch.
#include "common.cuh"

namespace {

constexpr int kCodes = 128;    // codes of a ring stage
constexpr int kDc = 64;        // d of a ring stage
constexpr int kThreads = 256;
constexpr int kPitch = kDc + 4;                  // floats, stage rows

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// kTR rows a thread: a row tile has 16 kTR rows.
template <int kTR>
struct Shape {
  static constexpr int kRows = 16 * kTR;
  static constexpr int kStageFloats = (kRows + kCodes) * kPitch;
  // as many stages as 227 KB hold, four at most
  static constexpr int kFit = 232448 / (4 * kStageFloats);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats;
};

template <int kTR>
__global__ void __launch_bounds__(kThreads, 1)
    vq_nearest_kernel(const float* __restrict__ x,
                      const float* __restrict__ cb,
                      const float* __restrict__ e2, int* __restrict__ out,
                      int n, int k, int d) {
  using S = Shape<kTR>;
  constexpr int kRows = S::kRows, kStages = S::kStages;
  extern __shared__ __align__(16) float smem[];   // [kStages][rows|codes][kPitch]
  const int tid = threadIdx.x;
  const int tx = tid % 16;                 // codes tx + 16 c of a stage
  const int ty = tid / 16;                 // rows ty + 16 i of a row tile
  const int dcs = (d + kDc - 1) / kDc;     // d chunks of a code tile
  const int nchunk = ((k + kCodes - 1) / kCodes) * dcs;
  const int ntiles = (n + kRows - 1) / kRows;
  const int mine = blockIdx.x < ntiles
                       ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * nchunk;

  // chunk g of this CTA's sequence: row tile blockIdx.x + (g / nchunk)
  // gridDim.x, codes of tile (g % nchunk) / dcs, d of chunk (g % nchunk) %
  // dcs, into stage g % kStages: the tile's rows first, then the codes
  auto load_chunk = [&](int g) {
    if (g < total) {
      const int j = g % nchunk;
      const int row0 = (blockIdx.x + (g / nchunk) * gridDim.x) * kRows;
      const int k0 = (j / dcs) * kCodes, d0 = (j % dcs) * kDc;
      const int w4 = min(kDc, d - d0) / 4;         // float4 a row
      float* st = smem + (g % kStages) * S::kStageFloats;
      for (int c = tid; c < (kRows + kCodes) * w4; c += kThreads) {
        const int r = c / w4, q = c % w4;
        const bool rows = r < kRows;
        const int at = rows ? row0 + r : k0 + r - kRows;
        const bool valid = at < (rows ? n : k);
        const float* src = (rows ? x : cb) +
            (valid ? static_cast<size_t>(at) * d + d0 + 4 * q : 0);
        msgv::cp_async16_zfill(st + r * kPitch + 4 * q, src, valid);
      }
    }
    msgv::cp_async_commit();   // always: the waits count groups
  };

  if (mine == 0) return;
  for (int g = 0; g < kStages - 1; ++g) load_chunk(g);

  float acc[kTR][8];
  float best[kTR];
  int bidx[kTR];
  int g = 0;
  for (int t = 0; t < mine; ++t) {
    const int tile = blockIdx.x + t * gridDim.x;
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      best[i] = CUDART_INF_F;
      bidx[i] = 0;
    }
    for (int j = 0; j < nchunk; ++j, ++g) {
      msgv::cp_async_wait<kStages - 2>();   // chunk g has landed
      __syncthreads();   // for everyone; and chunk g - 1 is done with
      load_chunk(g + kStages - 1);   // into the stage chunk g - 1 left
      const int kt = j / dcs, dc = j % dcs;
      if (dc == 0) {
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
      }
      const float* xr = smem + (g % kStages) * S::kStageFloats + ty * kPitch;
      const float* st = xr + (kRows - ty + tx) * kPitch;
      const int w4 = min(kDc, d - dc * kDc) / 4;
#pragma unroll 1
      for (int q = 0; q < w4; ++q) {
        float4 b[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          b[c] = *reinterpret_cast<const float4*>(st + 16 * c * kPitch + 4 * q);
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(xr + 16 * i * kPitch + 4 * q);
#pragma unroll
          for (int c = 0; c < 8; ++c) fma4(acc[i][c], a, b[c]);
        }
      }
      if (dc == dcs - 1) {
        // codes are visited in increasing order, so strict < keeps the
        // lower index on a tie within a thread
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int kk = kt * kCodes + tx + 16 * c;
          if (kk >= k) continue;
          const float ek = e2[kk];
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            const float dist = ek - 2.f * acc[i][c];
            if (dist < best[i]) {
              best[i] = dist;
              bidx[i] = kk;
            }
          }
        }
      }
    }
    // the sixteen lanes of a row (one half-warp)
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
        if (better(od, oi, best[i], bidx[i])) {
          best[i] = od;
          bidx[i] = oi;
        }
      }
      const int r = tile * kRows + ty + 16 * i;
      if (tx == 0 && r < n) out[r] = bidx[i];
    }
  }
  msgv::cp_async_wait<0>();
}

template <int kTR>
int launch(const float* x, const float* cb, const float* e2, int* out, int n,
           int k, int d, int ctas, cudaStream_t stream) {
  using S = Shape<kTR>;
  cudaError_t err = msgv::allow_smem(vq_nearest_kernel<kTR>, S::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + S::kRows - 1) / S::kRows;
  vq_nearest_kernel<kTR><<<(tiles < ctas ? tiles : ctas), kThreads, S::kSmem,
                           stream>>>(x, cb, e2, out, n, k, d);
  return cudaGetLastError();
}

}  // namespace

// x (n, d) float32, cb (k, d) float32, e2 (k,) float32 = |e_k|^2,
// out (n,) int32; all contiguous and 16-byte aligned, d a multiple of 4.
// ``ctas`` is the size of the persistent grid (the card's SMs).
MSGV_API int msgv_vq_nearest(const void* x, const void* cb, const void* e2,
                             void* out, int n, int k, int d, int ctas,
                             void* stream) {
  if (n < 1 || k < 1 || d < 4 || d % 4 || ctas < 1)
    return cudaErrorInvalidValue;
  // the tile height (16 rows a thread's row) that leaves the busiest CTA
  // the fewest rows to walk over; the taller tile on a tie
  int tr = 4, fewest = 0;
  for (int t = 4; t <= 8; ++t) {
    const int busy = ((n + 16 * t - 1) / (16 * t) + ctas - 1) / ctas * 16 * t;
    if (t == 4 || busy <= fewest) {
      tr = t;
      fewest = busy;
    }
  }
  auto xf = static_cast<const float*>(x);
  auto cf = static_cast<const float*>(cb);
  auto ef = static_cast<const float*>(e2);
  auto of = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tr) {
    case 4: return launch<4>(xf, cf, ef, of, n, k, d, ctas, s);
    case 5: return launch<5>(xf, cf, ef, of, n, k, d, ctas, s);
    case 6: return launch<6>(xf, cf, ef, of, n, k, d, ctas, s);
    case 7: return launch<7>(xf, cf, ef, of, n, k, d, ctas, s);
  }
  return launch<8>(xf, cf, ef, of, n, k, d, ctas, s);
}
