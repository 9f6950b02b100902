// Kernel D: fused log-mel frontend, waveform -> normalised mel (B, M, F).
//
// Replaces melspec_gpt_vqvae_tpu/ops/mel_pallas.py::_mel_kernel (the Pallas
// TPU kernel behind waveform_to_mel_pallas).  For each frame f of a clip it
// computes, with the reflect padding of n_fft / 2 done by indexing:
//   X      = DFT(frame * Hann)                  (bins 0 .. n_fft / 2)
//   mag    = |X| [^ power]
//   mel    = Slaney filterbank . mag            (M rows, each one band)
//   out    = clip((20 log10(max(mel, lo)) - 20 + 100) / 100, 0, 1)
// and writes (B, M, n_frames) once.  Full float32 throughout: the mel feeds
// the VQ argmin, and lower precision flips code indices.
//
// What bounds it on the card: the function needs a real FFT a frame
// (~2.5 n log2 n operations), three operations a bin for the magnitude and
// a multiply-add per non-zero of the triangular filterbank, ~1.2 GFLOP for
// the 48-clip tokenize batch (0.018 ms on the float32 pipes), and moves
// 55 MB (0.017 ms).  The TPU kernel and the first port took the DFT as a
// dense product with precomputed bases, 80x the arithmetic; here it is an
// FFT, and what is left is instruction slots and shared-memory traffic.
//
// The design.
//   * A CTA takes kFrames consecutive frames of one clip.  Frames overlap
//     (hop < n_fft), so their samples are one contiguous reflect-padded
//     segment, read into shared memory once.
//   * Two real frames a and b, windowed, are the real and imaginary part
//     of ONE complex FFT of n_fft points: z = w (a + i b).  Their spectra
//     come apart afterwards: X_a[k] = (Z[k] + conj Z[n - k]) / 2,
//     X_b[k] = (Z[k] - conj Z[n - k]) / 2i.  A frame past the last is
//     zeros (its samples lie past the padded clip).
//   * A group of kGroup threads does one FFT in shared memory: Stockham
//     autosort passes of radix 4 (five for 1024 points), and one last pass
//     of radix 2 when log2 n_fft is odd, ping-pong between two buffers, a
//     named barrier of the group between passes; the first pass reads the
//     segment and the window directly.  Twiddles come from a float32 table
//     (computed in float64 by the wrapper), laid out per pass so that
//     neighbouring threads read neighbouring entries.
//   * The buffers are plain arrays.  A pass reads neighbouring elements;
//     the first two radix-4 passes write with strides 4 and 16 and so
//     conflict in shared memory, but the kernel is bound by instruction
//     slots, not by the shared-memory pipe: an XOR swizzle that made every
//     pass conflict-free cost 3-5% more than the conflicts do (PERF.md).
//   * The magnitudes of both frames go into the buffer the FFT left free;
//     a thread then sums one (frame, mel row) over the row's band of
//     non-zero weights (start, packed weights), applies the log chain and
//     writes the value.  Neither frames nor spectra reach device memory.
//   * 2 groups of 128 threads a CTA, 8 frames: 55 KB of shared memory,
//     four CTAs an SM, so one CTA's loads of its segment and tables and its
//     barriers hide behind the others' passes (32 frames and two CTAs an
//     SM took 9% longer).
#include "common.cuh"

namespace {

constexpr int kFrames = 8;       // frames a CTA
constexpr int kGroup = 128;      // threads an FFT
constexpr int kGroups = 2;       // FFTs in flight a CTA
constexpr int kCtas = 4;         // CTAs an SM the kernel is built for
constexpr int kThreads = kGroup * kGroups;
constexpr int kPairs = kFrames / 2 / kGroups;   // frame pairs a group

struct Chain {
  float power, lower, multiply, subtract, add, divide, clip_min, clip_max;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kGroup) : "memory");
}

// The 4-point DFT of v (forward sign) written to y[j0 + r ns], r = 0..3.
__device__ __forceinline__ void butterfly4(float2 v0, float2 v1, float2 v2,
                                           float2 v3, float2* y, int j0,
                                           int ns) {
  const float2 t0 = make_float2(v0.x + v2.x, v0.y + v2.y);
  const float2 t1 = make_float2(v0.x - v2.x, v0.y - v2.y);
  const float2 t2 = make_float2(v1.x + v3.x, v1.y + v3.y);
  // -i (v1 - v3)
  const float2 t3 = make_float2(v1.y - v3.y, v3.x - v1.x);
  y[j0] = make_float2(t0.x + t2.x, t0.y + t2.y);
  y[j0 + ns] = make_float2(t1.x + t3.x, t1.y + t3.y);
  y[j0 + 2 * ns] = make_float2(t0.x - t2.x, t0.y - t2.y);
  y[j0 + 3 * ns] = make_float2(t1.x - t3.x, t1.y - t3.y);
}

__global__ void __launch_bounds__(kThreads, kCtas)
    mel_kernel(const float* __restrict__ wav, const float* __restrict__ window,
               const float2* __restrict__ twiddle,
               const int* __restrict__ band_start,
               const int* __restrict__ band_off,
               const float* __restrict__ band_w, float* __restrict__ out,
               int len, int n, int hop, int n_frames, int n_mels, int nnz,
               Chain ch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seg_len = (kFrames - 1) * hop + n;
  float2* bufs = reinterpret_cast<float2*>(smem);      // [kGroups][2][n]
  float2* tw = bufs + kGroups * 2 * n;                 // [n - 1]
  float* seg = reinterpret_cast<float*>(tw + n);       // [seg_len]
  float* bw = seg + seg_len;                           // [nnz]
  int* bstart = reinterpret_cast<int*>(bw + nnz);      // [n_mels]
  int* boff = bstart + n_mels;                         // [n_mels + 1]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int pad = n / 2;
  const float* w = wav + static_cast<size_t>(b) * len;
  for (int i = tid; i < seg_len; i += kThreads) {
    const int pj = f0 * hop + i;  // index into the reflect-padded clip
    float val = 0.f;
    if (pj < len + 2 * pad) {
      int j = pj - pad;
      if (j < 0) j = -j;
      if (j >= len) j = 2 * (len - 1) - j;
      val = w[j];
    }
    seg[i] = val;
  }
  for (int i = tid; i < n - 1; i += kThreads) tw[i] = twiddle[i];
  for (int i = tid; i < nnz; i += kThreads) bw[i] = band_w[i];
  for (int i = tid; i < n_mels; i += kThreads) bstart[i] = band_start[i];
  for (int i = tid; i <= n_mels; i += kThreads) boff[i] = band_off[i];
  __syncthreads();

  const int group = tid / kGroup, tg = tid % kGroup;
  float2* bufa = bufs + group * 2 * n;
  float2* bufb = bufa + n;
  const int bins = n / 2 + 1;

  for (int pi = 0; pi < kPairs; ++pi) {
    const int fa = 2 * (group * kPairs + pi);   // the pair's first frame
    if (f0 + fa >= n_frames) break;             // the whole group leaves
    const float* sa = seg + fa * hop;
    const float* sb = sa + hop;

    // pass 0 (ns = 1, no twiddles): z = window * (a + i b) -> bufa
    for (int j = tg; j < n / 4; j += kGroup) {
      float2 v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = j + r * (n / 4);
        const float wi = __ldg(window + i);
        v[r] = make_float2(wi * sa[i], wi * sb[i]);
      }
      butterfly4(v[0], v[1], v[2], v[3], bufa, 4 * j, 1);
    }
    group_sync(group);

    float2* x = bufa;
    float2* y = bufb;
    int ns = 4;
    for (; ns * 4 <= n; ns *= 4) {
      const float2* t = tw + (ns - 1);   // [3][ns]: exp(-2 pi i r k / 4 ns)
      for (int j = tg; j < n / 4; j += kGroup) {
        const int k = j & (ns - 1);
        const float2 v0 = x[j];
        const float2 v1 = cmul(x[j + n / 4], t[k]);
        const float2 v2 = cmul(x[j + n / 2], t[ns + k]);
        const float2 v3 = cmul(x[j + 3 * (n / 4)], t[2 * ns + k]);
        butterfly4(v0, v1, v2, v3, y, ((j - k) << 2) + k, ns);
      }
      group_sync(group);
      float2* s = x;
      x = y;
      y = s;
    }
    if (ns < n) {   // log2 n odd: one radix-2 pass, ns = n / 2
      const float2* t = tw + (ns - 1);   // [ns]: exp(-2 pi i j / n)
      for (int j = tg; j < n / 2; j += kGroup) {
        const float2 v0 = x[j];
        const float2 v1 = cmul(x[j + n / 2], t[j]);
        y[j] = make_float2(v0.x + v1.x, v0.y + v1.y);
        y[j + n / 2] = make_float2(v0.x - v1.x, v0.y - v1.y);
      }
      group_sync(group);
      float2* s = x;
      x = y;
      y = s;
    }

    // Z is in x; |X_a| and |X_b| into y as floats, [2][bins]
    float* mag = reinterpret_cast<float*>(y);
    for (int k = tg; k < bins; k += kGroup) {
      const float2 zk = x[k];
      const float2 zn = x[(n - k) & (n - 1)];
      const float ar = zk.x + zn.x, ai = zk.y - zn.y;   // 2 X_a
      const float br = zk.x - zn.x, bi = zk.y + zn.y;   // 2 i X_b
      float ma = 0.5f * sqrtf(ar * ar + ai * ai);
      float mb = 0.5f * sqrtf(br * br + bi * bi);
      if (ch.power != 1.f) {
        ma = powf(ma, ch.power);
        mb = powf(mb, ch.power);
      }
      mag[k] = ma;
      mag[bins + k] = mb;
    }
    group_sync(group);

    for (int o = tg; o < 2 * n_mels; o += kGroup) {
      const int fr = o & 1, ml = o >> 1;
      const int f = f0 + fa + fr;
      if (f >= n_frames) continue;
      const float* mrow = mag + fr * bins + bstart[ml];
      const int w0 = boff[ml], w1 = boff[ml + 1];
      float acc = 0.f;
      for (int i = w0; i < w1; ++i) acc = fmaf(bw[i], mrow[i - w0], acc);
      float v = log10f(fmaxf(ch.lower, acc));
      v = (v * ch.multiply - ch.subtract + ch.add) / ch.divide;
      v = fminf(fmaxf(v, ch.clip_min), ch.clip_max);
      out[(static_cast<size_t>(b) * n_mels + ml) * n_frames + f] = v;
    }
    group_sync(group);   // the next pair writes both buffers again
  }
}

}  // namespace

// wav (batch, len) float32; window (n_fft) float32; twiddle (n_fft - 1)
// complex as float pairs, laid out per pass (ops/mel_kernel.py::fft_tables);
// band_start (n_mels), band_off (n_mels + 1) int32 and band_w (nnz) float32:
// row m of the filterbank is band_w[band_off[m] : band_off[m + 1]] from bin
// band_start[m]; out (batch, n_mels, n_frames) float32.  n_fft a power of
// two >= 64, hop > 0, n_fft / 2 < len.
MSGV_API int msgv_mel(const void* wav, const void* window,
                      const void* twiddle, const void* band_start,
                      const void* band_off, const void* band_w, void* out,
                      int batch, int len, int n_fft, int hop, int n_frames,
                      int n_mels, int nnz, float power, float lower,
                      float multiply, float subtract, float add, float divide,
                      float clip_min, float clip_max, void* stream) {
  if (n_fft < 64 || (n_fft & (n_fft - 1)) || hop < 1 || batch < 1 ||
      n_frames < 1 || n_mels < 1 || nnz < 0 || n_fft / 2 >= len)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float2) * (kGroups * 2 + 1) * n_fft +
                      sizeof(float) * ((kFrames - 1) * hop + n_fft + nnz) +
                      sizeof(int) * (2 * n_mels + 1);
  cudaError_t err = msgv::allow_smem(mel_kernel, smem);
  if (err != cudaSuccess) return err;
  const Chain ch{power, lower, multiply, subtract, add, divide, clip_min,
                 clip_max};
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<const int*>(band_start),
      static_cast<const int*>(band_off), static_cast<const float*>(band_w),
      static_cast<float*>(out), len, n_fft, hop, n_frames, n_mels, nnz, ch);
  return cudaGetLastError();
}
