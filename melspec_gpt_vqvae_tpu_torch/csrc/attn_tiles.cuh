// Tensor-core tiles shared by the attention kernels: kernel F
// (flash_attention.cu, float32, training) and kernel A's tile kernel
// (attention.cu, float32 and bfloat16, inference).
//
// A CTA of 4 warps takes 64 query rows, a warp 16 of them, against staged
// K / V tiles of 32 rows.  The device functions are overloaded on the
// element type of the staged tiles:
//   * float: every product is mma.sync m16n8k8 TF32 in three split terms
//     at float32 accuracy (see flash_attention.cu); staged rows are 68
//     floats apart;
//   * __nv_bfloat16: one mma.sync m16n8k16 a product with float32
//     accumulators, fragments read by ldmatrix; staged rows are 72
//     elements (144 bytes) apart, so the eight 16-byte rows of an ldmatrix
//     tile fall in distinct banks.
#pragma once

#include "common.cuh"

namespace msgv {
namespace tiles {

constexpr int kHd = 64;        // head dim the kernels are written for
constexpr int kLd = 68;        // floats per staged row
constexpr int kThreads = 128;  // 4 warps
constexpr int kBm = 64;        // rows (forward, dQ) or columns (dK/dV) a CTA
constexpr int kBc = 32;        // K/V columns a step (forward, dQ)
constexpr int kLdH = 72;       // bfloat16 elements per staged row
template <typename T>
constexpr int kRowLd = sizeof(T) == 4 ? kLd : kLdH;
constexpr float kLog2e = 1.4426950408889634f;

// x = big + small with big = x rounded to TF32 (nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds) and small the exact remainder, of which
// the tensor core reads the sign, the exponent and the first 10 mantissa
// bits.  Integer rounding instead of two cvt: with conversions the
// kernels took a fifth longer.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at float32 accuracy: three TF32 products, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t b0b, b0s, b1b, b1s;
  split(b0, b0b, b0s);
  split(b1, b1b, b1s);
  mma_tf32(d, as, b0b, b1b);
  mma_tf32(d, ab, b0s, b1s);
  mma_tf32(d, ab, b0b, b1b);
}

// The tensor cores add into their accumulator with truncation, and an error
// that always points towards zero grows with the number of additions into
// one running sum (a 265-row dK column came out 10x further from the plain
// version than the float32 FMA kernel did).  So no running sum lives in an
// mma accumulator: the three mma of a k-block go into a fresh one, which is
// then added to the running sum in float32 with round-to-nearest.
__device__ __forceinline__ void mma3_add(float (&acc)[4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], float b0,
                                         float b1) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(part, ab, as, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// acc[nb] += A B^T for the 8-column blocks nb in [lo, hi): A is the warp's
// 16 rows of a staged tile (a points at its first row), B a staged tile
// whose row n is output column n; both (rows, kHd).
template <int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const float* a,
                                        const float* b, int lo, int hi,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < kHd / 8; ++kb) {
    uint32_t ab[4], as[4];
    const float* ar = a + g * kLd + 8 * kb + t;
    split(ar[0], ab[0], as[0]);
    split(ar[8 * kLd], ab[1], as[1]);
    split(ar[4], ab[2], as[2]);
    split(ar[8 * kLd + 4], ab[3], as[3]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (nb >= lo && nb < hi) {
        const float* br = b + (8 * nb + g) * kLd + 8 * kb + t;
        mma3_add(acc[nb], ab, as, br[0], br[4]);
      }
    }
  }
}

// acc (16 x kHd) += P B for P's 8-column blocks kb in [lo, hi): P is held
// as accumulator fragments p[kb], B is a staged tile whose row k belongs to
// P's column k.  The contraction index is permuted to fit the fragments:
// k = t is column 2t, k = t + 4 is column 2t + 1.
template <int KB>
__device__ __forceinline__ void mma_pb(float (&acc)[kHd / 8][4],
                                       const float (&p)[KB][4], const float* b,
                                       int lo, int hi, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    if (kb >= lo && kb < hi) {
      uint32_t ab[4], as[4];
      split(p[kb][0], ab[0], as[0]);
      split(p[kb][2], ab[1], as[1]);
      split(p[kb][1], ab[2], as[2]);
      split(p[kb][3], ab[3], as[3]);
      const float* br = b + (8 * kb + 2 * t) * kLd + g;
#pragma unroll
      for (int nb = 0; nb < kHd / 8; ++nb)
        mma3_add(acc[nb], ab, as, br[8 * nb], br[kLd + 8 * nb]);
    }
  }
}

// The same two products for bfloat16 tiles.  An ldmatrix.x4 reads four
// 8 x 8 tiles; lane l addresses row l % 8 of tile l / 8.  Blocks come in
// pairs: a pair runs when any of its two blocks lies in [lo, hi).
template <int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lo, int hi,
                                        int lane) {
  static_assert(NB % 2 == 0, "8-column blocks are taken in pairs");
  const int r8 = lane & 7, s1 = (lane >> 3) & 1, s2 = lane >> 4;
#pragma unroll
  for (int kb = 0; kb < kHd / 16; ++kb) {
    // A: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
    // (rows 8-15, k 8-15)
    uint32_t af[4];
    ldsm_x4(af, smem_addr(a + (r8 + 8 * s1) * kLdH + 16 * kb + 8 * s2));
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      if (2 * np + 1 >= lo && 2 * np < hi) {
        // B rows are output columns: (block 2np, k 0-7), (2np, k 8-15),
        // (2np + 1, k 0-7), (2np + 1, k 8-15)
        uint32_t bf[4];
        ldsm_x4(bf, smem_addr(b + (8 * (2 * np + s2) + r8) * kLdH + 16 * kb +
                              8 * s1));
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// P is rounded to bfloat16 here; two accumulator blocks of 8 columns are
// one 16-deep A fragment as they stand (no permutation).  P's blocks
// outside [lo, hi) of a pair that runs must hold zeros.
template <int KB>
__device__ __forceinline__ void mma_pb(float (&acc)[kHd / 8][4],
                                       const float (&p)[KB][4],
                                       const __nv_bfloat16* b, int lo, int hi,
                                       int lane) {
  static_assert(KB % 2 == 0, "8-column blocks are taken in pairs");
  const int r8 = lane & 7, s1 = (lane >> 3) & 1, s2 = lane >> 4;
#pragma unroll
  for (int kp = 0; kp < KB / 2; ++kp) {
    if (2 * kp + 1 >= lo && 2 * kp < hi) {
      const uint32_t af[4] = {pack_bf(p[2 * kp][0], p[2 * kp][1]),
                              pack_bf(p[2 * kp][2], p[2 * kp][3]),
                              pack_bf(p[2 * kp + 1][0], p[2 * kp + 1][1]),
                              pack_bf(p[2 * kp + 1][2], p[2 * kp + 1][3])};
#pragma unroll
      for (int np = 0; np < kHd / 16; ++np) {
        // B transposed on the way in: (k 0-7, dims block 2np), (k 8-15,
        // 2np), (k 0-7, 2np + 1), (k 8-15, 2np + 1)
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_addr(b + (16 * kp + r8 + 8 * s1) * kLdH +
                                    8 * (2 * np + s2)));
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// Rows [r0, r0 + n) of a row-major (t_len, kHd) matrix into
// dst[n][kRowLd<T>] by 16-byte copies; rows past t_len become zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int r0, int n, int t_len) {
  constexpr int kPer = 16 / sizeof(T);   // elements a copy
  constexpr int kCopies = kHd / kPer;    // copies a row
  for (int i = threadIdx.x; i < n * kCopies; i += kThreads) {
    const int r = i / kCopies, c = (i % kCopies) * kPer;
    const bool ok = r0 + r < t_len;
    msgv::cp_async16_zfill(dst + r * kRowLd<T> + c,
                           src + static_cast<size_t>(ok ? r0 + r : 0) * kHd + c,
                           ok);
  }
}

// The minGPT mask.
__device__ __forceinline__ bool visible(int r, int c, int nu) {
  return c <= r || (r < nu && c < nu);
}

// Columns that some row of [r_lo, r_hi] sees: c < the returned count.
__device__ __forceinline__ int visible_cols(int r_lo, int r_hi, int nu) {
  return r_lo < nu ? max(nu, r_hi + 1) : r_hi + 1;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// What a CTA of the forward and of dQ works on: row tile `tile` (heaviest
// first) of (b, h) `bh`.
struct RowTile {
  int bh, row0, n_steps;   // column steps of kBc up to the last visible one
  int ra, rb;              // this thread's two rows (g and g + 8 of the warp)
  int warp_cols;           // columns some row of the warp sees; 0: no rows
};

__device__ __forceinline__ RowTile row_tile(int bh_count, int t_len, int nu) {
  RowTile rt;
  const int tiles = gridDim.x / bh_count;
  rt.bh = blockIdx.x % bh_count;
  rt.row0 = (tiles - 1 - blockIdx.x / bh_count) * kBm;
  const int row_end = min(rt.row0 + kBm, t_len);
  rt.n_steps = (visible_cols(rt.row0, row_end - 1, nu) + kBc - 1) / kBc;
  const int rw0 = rt.row0 + 16 * (threadIdx.x / 32);
  rt.ra = rw0 + (threadIdx.x % 32) / 4;
  rt.rb = rt.ra + 8;
  rt.warp_cols =
      rw0 < t_len ? visible_cols(rw0, min(rw0 + 15, t_len - 1), nu) : 0;
  return rt;
}

}  // namespace tiles
}  // namespace msgv
