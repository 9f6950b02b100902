// Kernel D: fused log-mel frontend, waveform -> normalised mel (B, M, F).
//
// Replaces melspec_gpt_vqvae_tpu/ops/mel_pallas.py::_mel_kernel (the Pallas
// TPU kernel behind waveform_to_mel_pallas).  For each frame f of a clip it
// computes, with the reflect padding of n_fft / 2 done by indexing:
//   re, im = frame . (Hann-folded cos, -sin DFT bases)   (n_fft x F_pad)
//   mag    = sqrt(re^2 + im^2) [^ power]
//   mel    = mag . Slaney filterbank                      (F_pad x M)
//   out    = clip((20 log10(max(mel, lo)) - 20 + 100) / 100, 0, 1)
// and writes (B, M, n_frames) once.  Full float32 throughout: the mel feeds
// the VQ argmin, and lower precision flips code indices.
//
// What bounds it on the card: the windowed DFT as a product is
// 2 * n_fft * F_pad multiply-adds per frame (1.2 M at 1024 x 576), about
// 0.1 TFLOP for the 48-clip tokenize batch, in float32 FMA.  A block takes
// 32 consecutive frames of one clip; since frames overlap (hop 256) their
// samples are one contiguous 8960-sample segment, read once into shared
// memory.  The DFT bases stream through shared memory 32 taps x 64
// frequencies at a time; each thread keeps a 2 x 4 tile of (re, im), turns
// it into magnitudes, and the 64-frequency magnitude slab is folded into
// the mel accumulators (registers) before the next slab.  Neither frames
// nor the spectrogram ever reach device memory.
#include "common.cuh"

namespace {

constexpr int kFrames = 32;
constexpr int kFreqs = 64;
constexpr int kTaps = 32;
constexpr int kThreads = 256;
constexpr int kMelPerThread = 16;  // kFrames * n_mels / kThreads, n_mels <= 128

struct Chain {
  float power, lower, multiply, subtract, add, divide, clip_min, clip_max;
};

__global__ void __launch_bounds__(kThreads)
    mel_kernel(const float* __restrict__ wav, const float* __restrict__ cosw,
               const float* __restrict__ sinw, const float* __restrict__ melw,
               float* __restrict__ out, int len, int n_fft, int hop,
               int n_frames, int f_pad, int n_mels, Chain ch) {
  extern __shared__ float smem[];
  const int seg_len = (kFrames - 1) * hop + n_fft;
  float* seg = smem;                       // [seg_len]
  float* bc = seg + seg_len;               // [kTaps][kFreqs]
  float* bs = bc + kTaps * kFreqs;         // [kTaps][kFreqs]
  float* mag = bs + kTaps * kFreqs;        // [kFrames][kFreqs + 1]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int pad = n_fft / 2;
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

  const int tx = tid % 16;  // frequencies tx + 16 m of each slab
  const int ty = tid / 16;  // frames ty and ty + 16
  const int n_out = kFrames * n_mels;
  float macc[kMelPerThread] = {};
  for (int k0 = 0; k0 < f_pad; k0 += kFreqs) {
    float re[2][4] = {}, im[2][4] = {};
    for (int n0 = 0; n0 < n_fft; n0 += kTaps) {
      __syncthreads();
      for (int i = tid; i < kTaps * kFreqs; i += kThreads) {
        const size_t g = static_cast<size_t>(n0 + i / kFreqs) * f_pad + k0 +
                         i % kFreqs;
        bc[i] = cosw[g];
        bs[i] = sinw[g];
      }
      __syncthreads();
      const float* s0 = seg + ty * hop + n0;
      const float* s1 = seg + (ty + 16) * hop + n0;
#pragma unroll 4
      for (int n = 0; n < kTaps; ++n) {
        const float a0 = s0[n];
        const float a1 = s1[n];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float c = bc[n * kFreqs + tx + 16 * m];
          const float s = bs[n * kFreqs + tx + 16 * m];
          re[0][m] = fmaf(a0, c, re[0][m]);
          im[0][m] = fmaf(a0, s, im[0][m]);
          re[1][m] = fmaf(a1, c, re[1][m]);
          im[1][m] = fmaf(a1, s, im[1][m]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float mg = sqrtf(re[i][m] * re[i][m] + im[i][m] * im[i][m]);
        if (ch.power != 1.f) mg = powf(mg, ch.power);
        mag[(ty + 16 * i) * (kFreqs + 1) + tx + 16 * m] = mg;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMelPerThread; ++u) {
      const int idx = tid + kThreads * u;
      if (idx >= n_out) break;
      const int fr = idx % kFrames;
      const int ml = idx / kFrames;
      const float* mrow = mag + fr * (kFreqs + 1);
      const float* wcol = melw + static_cast<size_t>(k0) * n_mels + ml;
      float acc = macc[u];
      for (int kk = 0; kk < kFreqs; ++kk)
        acc = fmaf(mrow[kk], wcol[static_cast<size_t>(kk) * n_mels], acc);
      macc[u] = acc;
    }
  }
#pragma unroll
  for (int u = 0; u < kMelPerThread; ++u) {
    const int idx = tid + kThreads * u;
    if (idx >= n_out) break;
    const int f = f0 + idx % kFrames;
    const int ml = idx / kFrames;
    if (f >= n_frames) continue;
    float x = log10f(fmaxf(ch.lower, macc[u]));
    x = (x * ch.multiply - ch.subtract + ch.add) / ch.divide;
    x = fminf(fmaxf(x, ch.clip_min), ch.clip_max);
    out[(static_cast<size_t>(b) * n_mels + ml) * n_frames + f] = x;
  }
}

}  // namespace

// wav (batch, len) float32; cosw, sinw (n_fft, f_pad) float32 with f_pad a
// multiple of 64; melw (f_pad, n_mels) float32, n_mels <= 128; out
// (batch, n_mels, n_frames) float32.  n_fft a multiple of 32, pad < len.
MSGV_API int msgv_mel(const void* wav, const void* cosw, const void* sinw,
                      const void* melw, void* out, int batch, int len,
                      int n_fft, int hop, int n_frames, int f_pad, int n_mels,
                      float power, float lower, float multiply,
                      float subtract, float add, float divide, float clip_min,
                      float clip_max, void* stream) {
  const size_t smem =
      sizeof(float) * ((kFrames - 1) * hop + n_fft + 2 * kTaps * kFreqs +
                       kFrames * (kFreqs + 1));
  cudaError_t err = msgv::allow_smem(mel_kernel, smem);
  if (err != cudaSuccess) return err;
  const Chain ch{power, lower, multiply, subtract, add, divide, clip_min,
                 clip_max};
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(cosw),
      static_cast<const float*>(sinw), static_cast<const float*>(melw),
      static_cast<float*>(out), len, n_fft, hop, n_frames, f_pad, n_mels, ch);
  return cudaGetLastError();
}
