// Kernel A: masked multi-head attention over a whole short sequence.
//
// Replaces melspec_gpt_vqvae_tpu/ops/attention.py::_attn_kernel (the Pallas
// TPU kernel behind attend_pallas).  Per (batch*head) and per tile of 16
// query rows it computes softmax(mask(Q K^T / sqrt(hd))) V with the
// minGPT mask: causal, or inside the leading n_unmasked x n_unmasked block,
// and never past the sequence end.  The sequence is at most block_size
// (266) long, so a row's scores fit in shared memory and no online softmax
// is needed.
//
// What bounds it on the card: at GPT prefill (T = 1 for the class prompt,
// up to 266 with a prompt) the work is tiny and the kernel is bound by
// launch latency and by reading K and V once per row tile.  The design
// keeps K and V of the columns the tile can see (the causal prefix) in
// shared memory as float, one warp per query row, scores in shared memory,
// f32 accumulation, and writes the output once in the input dtype.  The
// probabilities are rounded to the input dtype before the PV product, as
// the plain version (attend_xla) does.
#include "common.cuh"

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

}  // namespace

// q, k, v, o: contiguous (bh, t_len, hd), float32 (bf16 == 0) or bfloat16.
MSGV_API int msgv_attention(const void* q, const void* k, const void* v,
                            void* o, int bh, int t_len, int hd,
                            int n_unmasked, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, t_len, hd, n_unmasked, s)
              : launch<float>(q, k, v, o, bh, t_len, hd, n_unmasked, s);
}
