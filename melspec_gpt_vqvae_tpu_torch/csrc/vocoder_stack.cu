// Kernel B: one MelGAN upsample stage's stack of dilated ResnetBlocks.
//
// Replaces melspec_gpt_vqvae_tpu/ops/vocoder_pallas.py::_stack_kernel (the
// Pallas TPU kernel behind fused_resblock_stack).  For each block j with
// dilation d_j (1, 3, 9) and x of layout (B, C, T):
//   h  = leaky(x)                       (slope 0.2)
//   h  = conv3_d(reflect_pad_d(h)) + b3 (3 taps, C -> C)
//   h  = conv1(leaky(h)) + b2           (1x1)
//   x  = (shortcut1(x) + bs) + h        (1x1)
// Each intermediate is rounded to the working dtype where the plain
// PyTorch version (one conv at a time) rounds it, so both agree to the
// order of summation.
//
// What bounds it on the card: the unfused stage reads and writes the
// activation about 18 times (8 x 32 x 217088 bf16 = 111 MB per pass at the
// last stage of a batch-8 request), while its products are 15 C^2 MACs per
// sample.  The kernel reads its time tile plus a halo of
// sum(d_j) = 13 samples per side once, runs all blocks in shared memory
// (three C x (tile + 26) buffers: block input, its leaky copy, the
// conv3 output) and writes the stage output once.  Each block reflect-pads
// its own input at the two sequence ends by reading mirrored columns, so
// the first and last 13 samples are exact too.  The products are plain
// float FMA with each thread holding a 2-channel x 8-sample register tile:
// the tile sizes of the four stages (C = 32..256) are too small and too
// varied for the tensor cores to pay in a first version, and FMA keeps the
// float32 path exact to 1e-4 and the bf16 path's rounding identical to the
// plain version's.  Weights (float32, (tap, c_in, c_out) order, about 4 MB
// for the C = 256 stage) are read through the L1/L2 caches.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRC = 2;  // output channels per thread: co0 + tx + 16 r
constexpr int kRP = 8;  // samples per thread: p0 + ty + 16 s
constexpr int kMaxBlocks = 3;

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : 0.2f * v; }

__device__ __forceinline__ int reflect(int q, int len) {
  if (q < 0) return -q;
  if (q >= len) return 2 * (len - 1) - q;
  return q;
}

struct Dilations {
  int n;
  int d[kMaxBlocks];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    resblock_stack_kernel(const T* __restrict__ x, T* __restrict__ out,
                          const float* __restrict__ wp, int C, int L,
                          int tile, Dilations dil) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int halo = 0;
  for (int j = 0; j < dil.n; ++j) halo += dil.d[j];
  const int W = tile + 2 * halo;
  T* y = reinterpret_cast<T*>(smem_raw);   // block input      [C][W]
  T* hl = y + C * W;                       // leaky(input)     [C][W]
  T* h1 = hl + C * W;                      // conv3 output     [C][W]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, L);
  const int base = t0 - halo;  // global sample of buffer column 0
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* xb = x + static_cast<size_t>(b) * C * L;

  int e = halo;  // the valid input range reaches e samples past [t0, t1)
  {
    const int lo = max(0, t0 - e), n = min(L, t1 + e) - lo;
    for (int i = tid; i < C * n; i += kThreads) {
      const int c = i / n, p = lo + i % n;
      y[c * W + p - base] = xb[static_cast<size_t>(c) * L + p];
    }
  }
  const size_t wstride = 5 * static_cast<size_t>(C) * C + 3 * C;
  for (int j = 0; j < dil.n; ++j) {
    const int d = dil.d[j];
    const int ilo = max(0, t0 - e), ihi = min(L, t1 + e);
    e -= d;
    const int olo = max(0, t0 - e), ohi = min(L, t1 + e);
    const float* w3 = wp + j * wstride;  // [3][C][C]  (tap, c_in, c_out)
    const float* b3 = w3 + 3 * C * C;
    const float* w2 = b3 + C;            // [C][C]     (c_in, c_out)
    const float* b2 = w2 + C * C;
    const float* ws = b2 + C;            // [C][C]     (c_in, c_out)
    const float* bs = ws + C * C;

    __syncthreads();
    {
      const int n = ihi - ilo;
      for (int i = tid; i < C * n; i += kThreads) {
        const int idx = (i / n) * W + ilo + i % n - base;
        hl[idx] = msgv::from_f<T>(leaky(msgv::to_f(y[idx])));
      }
    }
    __syncthreads();

    // h1 = leaky(conv3_d(reflect_pad(hl)) + b3) on [olo, ohi)
    for (int co0 = 0; co0 < C; co0 += 16 * kRC) {
      for (int p0 = olo; p0 < ohi; p0 += 16 * kRP) {
        int col[3][kRP];
#pragma unroll
        for (int s = 0; s < kRP; ++s) {
          const int p = min(p0 + ty + 16 * s, ohi - 1);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            col[k][s] = reflect(p + (k - 1) * d, L) - base;
        }
        float acc[kRC][kRP] = {};
        for (int ci = 0; ci < C; ++ci) {
          const T* hrow = hl + ci * W;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float* wrow =
                w3 + (static_cast<size_t>(k) * C + ci) * C + co0 + tx;
            float wv[kRC];
#pragma unroll
            for (int r = 0; r < kRC; ++r) wv[r] = __ldg(wrow + 16 * r);
#pragma unroll
            for (int s = 0; s < kRP; ++s) {
              const float hv = msgv::to_f(hrow[col[k][s]]);
#pragma unroll
              for (int r = 0; r < kRC; ++r)
                acc[r][s] = fmaf(wv[r], hv, acc[r][s]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRC; ++r) {
          const int co = co0 + tx + 16 * r;
          const float bias = b3[co];
#pragma unroll
          for (int s = 0; s < kRP; ++s) {
            const int p = p0 + ty + 16 * s;
            if (p < ohi)
              h1[co * W + p - base] = msgv::from_f<T>(
                  leaky(msgv::rnd<T>(acc[r][s] + bias)));
          }
        }
      }
    }
    __syncthreads();

    // block output = (ws . y + bs) + (w2 . h1 + b2) on [olo, ohi), into hl
    for (int co0 = 0; co0 < C; co0 += 16 * kRC) {
      for (int p0 = olo; p0 < ohi; p0 += 16 * kRP) {
        int col[kRP];
#pragma unroll
        for (int s = 0; s < kRP; ++s)
          col[s] = min(p0 + ty + 16 * s, ohi - 1) - base;
        float as[kRC][kRP] = {}, ah[kRC][kRP] = {};
        for (int ci = 0; ci < C; ++ci) {
          float wsv[kRC], w2v[kRC];
#pragma unroll
          for (int r = 0; r < kRC; ++r) {
            wsv[r] = __ldg(ws + static_cast<size_t>(ci) * C + co0 + tx + 16 * r);
            w2v[r] = __ldg(w2 + static_cast<size_t>(ci) * C + co0 + tx + 16 * r);
          }
          const T* yrow = y + ci * W;
          const T* hrow = h1 + ci * W;
#pragma unroll
          for (int s = 0; s < kRP; ++s) {
            const float yv = msgv::to_f(yrow[col[s]]);
            const float hv = msgv::to_f(hrow[col[s]]);
#pragma unroll
            for (int r = 0; r < kRC; ++r) {
              as[r][s] = fmaf(wsv[r], yv, as[r][s]);
              ah[r][s] = fmaf(w2v[r], hv, ah[r][s]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRC; ++r) {
          const int co = co0 + tx + 16 * r;
          const float sb = bs[co], hb = b2[co];
#pragma unroll
          for (int s = 0; s < kRP; ++s) {
            const int p = p0 + ty + 16 * s;
            if (p < ohi)
              hl[co * W + p - base] = msgv::from_f<T>(
                  msgv::rnd<T>(as[r][s] + sb) + msgv::rnd<T>(ah[r][s] + hb));
          }
        }
      }
    }
    __syncthreads();
    T* tmp = y;  // the block output becomes the next block's input
    y = hl;
    hl = tmp;
  }

  T* ob = out + static_cast<size_t>(b) * C * L;
  const int n = t1 - t0;
  for (int i = tid; i < C * n; i += kThreads) {
    const int c = i / n, p = t0 + i % n;
    ob[static_cast<size_t>(c) * L + p] = y[c * W + p - base];
  }
}

template <typename T>
int launch(const void* x, void* out, const void* w, int batch, int C, int L,
           int tile, Dilations dil, cudaStream_t stream) {
  int halo = 0;
  for (int j = 0; j < dil.n; ++j) halo += dil.d[j];
  const size_t smem = 3 * sizeof(T) * static_cast<size_t>(C) * (tile + 2 * halo);
  cudaError_t err = msgv::allow_smem(resblock_stack_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + tile - 1) / tile, batch);
  resblock_stack_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const float*>(w), C, L, tile, dil);
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous (batch, C, L), float32 (bf16 == 0) or bfloat16; C a
// multiple of 32, L > max dilation.  w: float32, per block
// [w3 (3, C, C) | b3 (C) | w2 (C, C) | b2 (C) | ws (C, C) | bs (C)] with
// the 2-D matrices as (c_in, c_out).  n_blocks <= 3 dilations d0, d1, d2.
MSGV_API int msgv_resblock_stack(const void* x, void* out, const void* w,
                                 int batch, int C, int L, int tile,
                                 int n_blocks, int d0, int d1, int d2,
                                 int bf16, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || C % (16 * kRC) != 0)
    return cudaErrorInvalidValue;
  const Dilations dil{n_blocks, {d0, d1, d2}};
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, out, w, batch, C, L, tile, dil, s)
              : launch<float>(x, out, w, batch, C, L, tile, dil, s);
}
