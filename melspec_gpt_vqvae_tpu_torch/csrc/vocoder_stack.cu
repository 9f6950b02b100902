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
// sample: 480 GFLOP for the four stages of a batch-8 request against
// 0.72 GB in and out, so with the stack fused it is bound by operations,
// and in bfloat16 that means by the tensor cores.  Both kernels read a time
// tile plus a halo of sum(d_j) = 13 samples per side once, run all blocks
// in shared memory and write the stage output once; the work of block j
// shrinks with the halo it still needs (tile + 24, + 18, + 0 samples).
//
// bfloat16 (the serving path), resblock_stack_bf16_kernel<C>: every conv is
// a product D[time][c_out] += A[time][c_in] . W[c_in][c_out] on the tensor
// cores (mma.sync m16n8k16, bfloat16 in, float32 accumulators; the three
// taps are three accumulating products whose A operand is the same buffer
// shifted by the dilation).
//   * Activations live time-major in shared memory, [column][C + 8]: a
//     row of A is then contiguous and 16-byte aligned for ldmatrix at ANY
//     time shift, and the 8-element pad makes the eight rows of an
//     ldmatrix tile hit distinct banks.  Two full buffers (the block input
//     y, updated in place, and leaky(y)) and one chunk-sized buffer (the
//     conv3 output of the chunk in flight).
//   * The sequence ends: the mirrored columns reflect-padding needs are
//     materialised in the leaky buffer's halo columns, so the product reads
//     contiguous rows everywhere and the first and last 13 samples are
//     exact.
//   * 8 warps as kWM x kWN; a warp owns 32 time rows x 64 (C = 32: 32)
//     output channels, the CTA a chunk of kMc = 32 kWM rows x all C
//     channels in registers.  Per chunk one pass over 5 C / 32 weight
//     slices: conv3 (3 C / 32), epilogue (bias, round, leaky, round) into
//     the chunk buffer; shortcut (C / 32), rounded into packed registers;
//     conv1 (C / 32), epilogue (bias, round, add, round) in place into y.
//     The per-slice barrier of the weight pipeline orders those reads and
//     writes, so the chunk loop needs no barrier of its own.
//   * Weights are pre-packed once (ops/vocoder_stack.py) to bfloat16 slices
//     [block][slice][c_out][32 c_in] in the order the pass consumes them
//     (the C = 256 block's 5 C^2 weights are 655 KB and cannot sit in
//     shared memory) and stream from L2 through a 3-stage cp.async ring of
//     [C][32 + 8] slices that runs on across chunks and blocks (a fourth
//     stage bought nothing measurable).
//   * The input window comes in with 16-byte cp.async copies, all in
//     flight at once, channel-major as it lies in device memory, into the
//     space of the two buffers the first block does not need yet, and is
//     transposed from there; the output goes back through registers as
//     16-byte stores.
//   * Tiles (ops/vocoder_stack.py::bf16_tile picks them: one CTA per SM,
//     the full 227 KB, whole chunks, whole waves of CTAs).  For a batch-8
//     request: C = 256: 103 samples in a window of 129, the three blocks
//     compute 127 + 121 + 103 samples in 2 chunks of 64 rows each (384
//     rows for 309 useful: 24% halo and padding); C = 128: 232 samples,
//     768 rows for 696 (10%); C = 64: 487, 1536 for 1461 (5%); C = 32: 744,
//     2304 for 2232 (3%).
//
// float32 (reference checks, tolerance 1e-4), resblock_stack_kernel<float>:
// plain float FMA with each thread holding a 2-channel x 8-sample register
// tile, channel-major buffers, reflect padding by reading mirrored columns,
// float32 weights in (tap, c_in, c_out) order through the L1/L2 caches.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRC = 2;  // output channels per thread: co0 + tx + 16 r
constexpr int kRP = 8;  // samples per thread: p0 + ty + 16 s
constexpr int kMaxBlocks = 3;

__device__ __forceinline__ float leaky(float v) {
  return fmaxf(v, 0.2f * v);  // slope 0.2 < 1: the larger of the two
}

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


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kStages = 3;          // weight slices in flight
constexpr int kSlice = 32;          // input channels per weight slice
constexpr int kWLd = kSlice + 8;    // slice row stride in shared memory
constexpr int kMF = 2;              // 16-row A fragments per warp

template <int C>
struct Geo {
  static constexpr int kWN = C >= 64 ? C / 64 : 1;  // warps along c_out
  static constexpr int kWM = 8 / kWN;               // warps along time
  static constexpr int kWarpN = C / kWN;            // 64, or 32 for C = 32
  static constexpr int kNF = kWarpN / 8;            // 8-wide B fragments
  static constexpr int kMc = kWM * 16 * kMF;        // rows per chunk
  static constexpr int kLd = C + 8;                 // activation row stride
  static constexpr int kS = C / kSlice;             // slices per C inputs
  static constexpr int kStageElems = C * kWLd;
};

using msgv::ldsm_x4;
using msgv::mma_bf16;
using msgv::pack_bf;

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float rnd_bf(float v) {
  return msgv::rnd<__nv_bfloat16>(v);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_stack_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                               __nv_bfloat16* __restrict__ out,
                               const __nv_bfloat16* __restrict__ wp,
                               const float* __restrict__ bias, int L,
                               int tile, int vec, Dilations dil) {
  using G = Geo<C>;
  constexpr int kLd = G::kLd, kLdW = G::kLd / 2, kS = G::kS, kMc = G::kMc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int halo = 0;
  for (int j = 0; j < dil.n; ++j) halo += dil.d[j];
  const int W = tile + 2 * halo;
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [W][kLd]
  __nv_bfloat16* hl = y + W * kLd;       // leaky(y) + mirrored columns
  __nv_bfloat16* h1c = hl + W * kLd;     // conv3 output of a chunk [kMc][kLd]
  __nv_bfloat16* wst = h1c + kMc * kLd;  // [kStages][C][kWLd]
  uint32_t* y32 = reinterpret_cast<uint32_t*>(y);
  uint32_t* hl32 = reinterpret_cast<uint32_t*>(hl);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(t0 + tile, L);
  const int base = t0 - halo;  // global sample of buffer row 0
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / G::kWN, wn = warp % G::kWN;
  const int g = lane / 4, tq = lane % 4;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * C * L;

  // chunks of each block's output range, for the weight stream
  int chunks0 = 0, chunks1 = 0, chunks2 = 0;
  {
    int e = halo;
    for (int j = 0; j < dil.n; ++j) {
      e -= dil.d[j];
      const int n = min(L, t1 + e) - max(0, t0 - e);
      const int c = (n + kMc - 1) / kMc;
      if (j == 0) chunks0 = c;
      if (j == 1) chunks1 = c;
      if (j == 2) chunks2 = c;
    }
  }
  // the weight stream: slice ps of chunk pc of block pj is the next to fetch
  int pj = 0, pc = 0, ps = 0;
  auto fetch = [&](int stage) {
    if (pj < dil.n) {
      const __nv_bfloat16* src =
          wp + static_cast<size_t>(pj * 5 * kS + ps) * C * kSlice;
      __nv_bfloat16* dst = wst + stage * G::kStageElems;
      for (int c = tid; c < C * 4; c += kThreads)
        msgv::cp_async16(dst + (c / 4) * kWLd + (c % 4) * 8, src + c * 8);
      if (++ps == 5 * kS) {
        ps = 0;
        const int nc = pj == 0 ? chunks0 : (pj == 1 ? chunks1 : chunks2);
        if (++pc == nc) {
          pc = 0;
          ++pj;
        }
      }
    }
    msgv::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) fetch(st);

  // stage the input window, transposed to time-major
  {
    const int lo = max(0, t0 - halo), hi = min(L, t1 + halo);
    if (vec) {
      // all of it in flight at once, channel-major as it lies in device
      // memory, into the space of hl and h1c (free until the first block);
      // then transposed out of shared memory.  The staging rows are an odd
      // number of 16-byte units apart, so the two-row stride of the
      // transposing reads conflicts two ways, not eight.
      const int g0 = lo / 8, ng = (hi + 7) / 8 - g0;
      const int sp = (ng + 1 + (ng & 1)) * 8;
      __nv_bfloat16* stg = hl;
      for (int i = tid; i < C * ng; i += kThreads) {
        const int c = i / ng, gq = i % ng;
        msgv::cp_async16(stg + c * sp + gq * 8,
                         xb + static_cast<size_t>(c) * L + (g0 + gq) * 8);
      }
      msgv::cp_async_commit();
      msgv::cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < (C / 2) * ng; i += kThreads) {
        const int cp = i % (C / 2), gq = i / (C / 2), p0 = (g0 + gq) * 8;
        const uint4 va = *reinterpret_cast<const uint4*>(
            stg + (2 * cp) * sp + gq * 8);
        const uint4 vb = *reinterpret_cast<const uint4*>(
            stg + (2 * cp + 1) * sp + gq * 8);
        const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
        const uint32_t wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int p = p0 + e;
          const uint32_t a = (wa[e / 2] >> (16 * (e % 2))) & 0xffffu;
          const uint32_t c = (wb[e / 2] >> (16 * (e % 2))) & 0xffffu;
          if (p >= lo && p < hi) y32[(p - base) * kLdW + cp] = a | (c << 16);
        }
      }
    } else {
      const int n = hi - lo;
      for (int i = tid; i < C * n; i += kThreads) {
        const int c = i / n, p = lo + i % n;
        y[(p - base) * kLd + c] = xb[static_cast<size_t>(c) * L + p];
      }
    }
  }

  int it = 0;    // weight slices consumed so far
  int e = halo;  // the valid input range reaches e samples past [t0, t1)
  for (int j = 0; j < dil.n; ++j) {
    const int d = dil.d[j];
    const int ilo = max(0, t0 - e), ihi = min(L, t1 + e);
    e -= d;
    const int olo = max(0, t0 - e), ohi = min(L, t1 + e);
    const float* b3 = bias + (j * 3) * C;
    const float* bs = b3 + C;
    const float* b2 = bs + C;

    __syncthreads();
    {  // hl = leaky(y) on the input range, and its mirror images past the
       // sequence ends, as far as the window holds them
      const int plo = max(base, ilo == 0 ? -d : ilo);
      const int phi = min(base + W, ihi == L ? L + d : ihi);
      const int n = phi - plo;
      for (int i = tid; i < n * (C / 2); i += kThreads) {
        const int p = plo + i / (C / 2), cw = i % (C / 2);
        const uint32_t w = y32[(reflect(p, L) - base) * kLdW + cw];
        hl32[(p - base) * kLdW + cw] =
            pack_bf(leaky(bf_lo(w)), leaky(bf_hi(w)));
      }
    }
    __syncthreads();

    const int nchunks = (ohi - olo + kMc - 1) / kMc;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int row0 = olo - base + ch * kMc;  // buffer row of chunk row 0
      float acc[kMF][G::kNF][4];
      uint32_t sc[kMF][G::kNF][2];             // the shortcut, rounded
#pragma unroll
      for (int f = 0; f < kMF; ++f)
#pragma unroll
        for (int nf = 0; nf < G::kNF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[f][nf][i] = 0.f;

      for (int s = 0; s < 5 * kS; ++s) {
        msgv::cp_async_wait<kStages - 2>();
        __syncthreads();  // slice `it` has landed; slice it - 1 is done with
        fetch((it + kStages - 1) % kStages);
        const __nv_bfloat16* wbuf = wst + (it % kStages) * G::kStageElems;
        ++it;

        // the A operand of this slice: buffer, first row, last legal row
        const __nv_bfloat16* abuf;
        int arow, amax, ci0;
        if (s < 3 * kS) {
          abuf = hl;
          arow = row0 + (s / kS - 1) * d;
          amax = W - 1;
          ci0 = (s % kS) * kSlice;
        } else if (s < 4 * kS) {
          abuf = y;
          arow = row0;
          amax = W - 1;
          ci0 = (s - 3 * kS) * kSlice;
        } else {
          abuf = h1c;
          arow = 0;
          amax = kMc - 1;
          ci0 = (s - 4 * kS) * kSlice;
        }
        uint32_t a_addr[kMF];
#pragma unroll
        for (int f = 0; f < kMF; ++f) {
          const int r = min(max(arow + wm * 16 * kMF + f * 16 + lane % 16, 0),
                            amax);  // rows past the range are masked below
          a_addr[f] =
              msgv::smem_addr(abuf + r * kLd + ci0 + (lane / 16) * 8);
        }
        const uint32_t b_addr = msgv::smem_addr(
            wbuf + (wn * G::kWarpN + lane % 8 + (lane / 16) * 8) * kWLd +
            ((lane / 8) % 2) * 8);
#pragma unroll
        for (int kk = 0; kk < kSlice / 16; ++kk) {
          uint32_t a[kMF][4];
#pragma unroll
          for (int f = 0; f < kMF; ++f) ldsm_x4(a[f], a_addr[f] + kk * 32);
#pragma unroll
          for (int n2 = 0; n2 < G::kNF / 2; ++n2) {
            uint32_t bb[4];
            ldsm_x4(bb, b_addr + (n2 * 16 * kWLd + kk * 16) * 2);
#pragma unroll
            for (int f = 0; f < kMF; ++f) {
              mma_bf16(acc[f][2 * n2], a[f], bb[0], bb[1]);
              mma_bf16(acc[f][2 * n2 + 1], a[f], bb[2], bb[3]);
            }
          }
        }

        // the thread's accumulators: rows rl, rl + 8 of fragment f, columns
        // c, c + 1 of fragment nf
        const int rl0 = wm * 16 * kMF + g, c0 = wn * G::kWarpN + 2 * tq;
        if (s == 3 * kS - 1) {
          // h1 = leaky(conv3 + b3), this chunk's rows
          uint32_t* h1w = reinterpret_cast<uint32_t*>(h1c);
#pragma unroll
          for (int nf = 0; nf < G::kNF; ++nf) {
            const float2 bv = *reinterpret_cast<const float2*>(
                b3 + c0 + nf * 8);
#pragma unroll
            for (int f = 0; f < kMF; ++f) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float v0 = rnd_bf(acc[f][nf][2 * h] + bv.x);
                const float v1 = rnd_bf(acc[f][nf][2 * h + 1] + bv.y);
                h1w[(rl0 + f * 16 + 8 * h) * kLdW + (c0 + nf * 8) / 2] =
                    pack_bf(leaky(v0), leaky(v1));
                acc[f][nf][2 * h] = acc[f][nf][2 * h + 1] = 0.f;
              }
            }
          }
        } else if (s == 4 * kS - 1) {
          // shortcut(y) + bs, rounded, kept for the block's output
#pragma unroll
          for (int nf = 0; nf < G::kNF; ++nf) {
            const float2 bv = *reinterpret_cast<const float2*>(
                bs + c0 + nf * 8);
#pragma unroll
            for (int f = 0; f < kMF; ++f) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                sc[f][nf][h] = pack_bf(acc[f][nf][2 * h] + bv.x,
                                       acc[f][nf][2 * h + 1] + bv.y);
                acc[f][nf][2 * h] = acc[f][nf][2 * h + 1] = 0.f;
              }
            }
          }
        } else if (s == 5 * kS - 1) {
          // block output = shortcut + (conv1 + b2), in place into y
#pragma unroll
          for (int nf = 0; nf < G::kNF; ++nf) {
            const float2 bv = *reinterpret_cast<const float2*>(
                b2 + c0 + nf * 8);
#pragma unroll
            for (int f = 0; f < kMF; ++f) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int rl = rl0 + f * 16 + 8 * h;
                const float v0 = rnd_bf(acc[f][nf][2 * h] + bv.x);
                const float v1 = rnd_bf(acc[f][nf][2 * h + 1] + bv.y);
                if (olo + ch * kMc + rl < ohi)
                  y32[(row0 + rl) * kLdW + (c0 + nf * 8) / 2] =
                      pack_bf(bf_lo(sc[f][nf][h]) + v0,
                              bf_hi(sc[f][nf][h]) + v1);
                acc[f][nf][2 * h] = acc[f][nf][2 * h + 1] = 0.f;
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // write [t0, t1) back channel-major
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * C * L;
  if (vec) {
    const int g0 = t0 / 8, ng = (t1 + 7) / 8 - g0;
    for (int i = tid; i < (C / 2) * ng; i += kThreads) {
      const int cp = i % (C / 2), p0 = (g0 + i / (C / 2)) * 8;
      uint32_t wa[4] = {0, 0, 0, 0}, wb[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e2 = 0; e2 < 8; ++e2) {
        const int p = min(max(p0 + e2, t0), t1 - 1);
        const uint32_t w = y32[(p - base) * kLdW + cp];
        wa[e2 / 2] |= (w & 0xffffu) << (16 * (e2 % 2));
        wb[e2 / 2] |= (w >> 16) << (16 * (e2 % 2));
      }
      __nv_bfloat16* ra = ob + static_cast<size_t>(2 * cp) * L + p0;
      __nv_bfloat16* rb = ob + static_cast<size_t>(2 * cp + 1) * L + p0;
      if (p0 >= t0 && p0 + 8 <= t1) {
        *reinterpret_cast<uint4*>(ra) =
            make_uint4(wa[0], wa[1], wa[2], wa[3]);
        *reinterpret_cast<uint4*>(rb) =
            make_uint4(wb[0], wb[1], wb[2], wb[3]);
      } else {
        const uint16_t* ha = reinterpret_cast<const uint16_t*>(wa);
        const uint16_t* hb = reinterpret_cast<const uint16_t*>(wb);
        for (int e2 = 0; e2 < 8; ++e2) {
          if (p0 + e2 >= t0 && p0 + e2 < t1) {
            reinterpret_cast<uint16_t*>(ra)[e2] = ha[e2];
            reinterpret_cast<uint16_t*>(rb)[e2] = hb[e2];
          }
        }
      }
    }
  } else {
    const int n = t1 - t0;
    for (int i = tid; i < C * n; i += kThreads) {
      const int c = i / n, p = t0 + i % n;
      ob[static_cast<size_t>(c) * L + p] = y[(p - base) * kLd + c];
    }
  }
}

template <int C>
int launch_bf16(const void* x, void* out, const void* wp, const void* bias,
                int batch, int L, int tile, Dilations dil,
                cudaStream_t stream) {
  using G = Geo<C>;
  int halo = 0;
  for (int j = 0; j < dil.n; ++j) halo += dil.d[j];
  const size_t smem =
      sizeof(__nv_bfloat16) *
      (2 * static_cast<size_t>(tile + 2 * halo) * G::kLd + G::kMc * G::kLd +
       kStages * G::kStageElems);
  cudaError_t err = msgv::allow_smem(resblock_stack_bf16_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  const int vec = L % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((L + tile - 1) / tile, batch);
  resblock_stack_bf16_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(bias),
      L, tile, vec, dil);
  return cudaGetLastError();
}

}  // namespace

// float32: x, out contiguous (batch, C, L); C a multiple of 32, L > max
// dilation.  w: float32, per block
// [w3 (3, C, C) | b3 (C) | w2 (C, C) | b2 (C) | ws (C, C) | bs (C)] with
// the 2-D matrices as (c_in, c_out).  n_blocks <= 3 dilations d0, d1, d2.
MSGV_API int msgv_resblock_stack(const void* x, void* out, const void* w,
                                 int batch, int C, int L, int tile,
                                 int n_blocks, int d0, int d1, int d2,
                                 void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || C % (16 * kRC) != 0)
    return cudaErrorInvalidValue;
  const Dilations dil{n_blocks, {d0, d1, d2}};
  return launch<float>(x, out, w, batch, C, L, tile, dil,
                       static_cast<cudaStream_t>(stream));
}

// bfloat16: x, out contiguous (batch, C, L), C in (32, 64, 128, 256),
// L > max dilation, tile >= every dilation.  w: bfloat16 slices
// [block][5 C / 32][C c_out][32 c_in] in the order conv3 tap 0, 1, 2,
// shortcut, conv1, each over c_in in steps of 32; 16-byte aligned.
// bias: float32 [block][b3 | bs | b2][C].
MSGV_API int msgv_resblock_stack_bf16(const void* x, void* out, const void* w,
                                      const void* bias, int batch, int C,
                                      int L, int tile, int n_blocks, int d0,
                                      int d1, int d2, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  const Dilations dil{n_blocks, {d0, d1, d2}};
  auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32:
      return launch_bf16<32>(x, out, w, bias, batch, L, tile, dil, s);
    case 64:
      return launch_bf16<64>(x, out, w, bias, batch, L, tile, dil, s);
    case 128:
      return launch_bf16<128>(x, out, w, bias, batch, L, tile, dil, s);
    case 256:
      return launch_bf16<256>(x, out, w, bias, batch, L, tile, dil, s);
  }
  return cudaErrorInvalidValue;
}
