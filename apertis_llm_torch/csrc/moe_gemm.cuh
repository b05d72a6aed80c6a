// The int8 tensor-core block product and the first expert GEMM shared by the
// MoE kernels (moe_ffn.cu, moe_grouped.cu).
//
// block_gemm_i8 computes one 64 x 128 tile of an int8 x int8 -> int32
// product with WMMA fragments (m16n16k16, signed char, exact int32
// accumulation: the `dot_general(int8, int8) -> int32` of the TPU kernels).
// Each of the 8 warps owns one 16-column strip and all four 16-row strips.
// K advances in chunks of 64 staged in shared memory. WMMA wants fragment
// pointers 32-byte aligned, which a row-major int8 tile cannot give at
// 16-element steps, so both operands are staged as panels 16 bytes wide:
// A as four (64 rows x 16 k) panels and B as eight (64 k x 16 columns)
// panels, each loaded with ldm = 16. Rows and columns past the operands'
// edges are staged as zeros. A may be f32 rows that are quantized while they
// are staged (level(h / hs[row])), which is how the second GEMM reads the
// hidden without writing an int8 copy of it.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kGemmM = 64;                  // rows per block
constexpr int kGemmN = 128;                 // columns per block (8 warps x 16)
constexpr int kGemmK = 64;                  // K chunk staged in shared memory
constexpr int kPanelA = kGemmM * 16;        // bytes of one 16-deep A panel
constexpr int kPanelB = kGemmK * 16 + 32;   // bytes of one 16-wide B panel (padded)
constexpr int kGroupRows = 128;             // rows of one expert tile (grouped layout)

struct GemmSmem {
  int8_t a[(kGemmK / 16) * kPanelA];   // 4 KB
  int8_t b[(kGemmN / 16) * kPanelB];   // 8.25 KB
  int c[kGemmM * kGemmN];              // 32 KB, the int32 result
};

// Four int4-packed bytes (one per column) unpacked to four int8 values of
// one contraction row: the low or the high nibble of each byte times the
// byte's shift.
__device__ __forceinline__ int unpack_int4_word(int packed, int shifts, bool high) {
  int w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = (packed << (24 - 8 * i)) >> 24;   // sign-extended byte i
    const int s = (shifts << (24 - 8 * i)) >> 24;
    w |= ((int4_nibble(p, high) * s) & 0xff) << (8 * i);
  }
  return w;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> FragA8;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> FragB8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC32;

// sm.c[r * kGemmN + j] = sum_{k < k_len} A[r][k] * B[k][j] for r < 64, j < 128.
// A row r is at a + r * lda (int8, or f32 when kF32A, then divided by hs[r]
// and rounded to an int8 level) for r < a_rows, else zero; B row k at
// b + k * ldb, columns [0, b_cols), else zero. k_len, b_cols, lda and ldb are
// multiples of 16 and a, b 16-byte aligned. With kI4, B is the packed
// matrix whose contraction row k_base + k sits in byte row
// 64 ((k_base + k) / 128) + (k_base + k) % 64, low nibble for the first 64
// rows of its group, high for the others, with its shifts in row
// (k_base + k) / 128 of sh (same ldb); k_base is a multiple of 64. Called by
// all kBlock threads; ends synchronised.
template <bool kF32A, bool kI4 = false>
__device__ void block_gemm_i8(const void* __restrict__ a, int lda, int a_rows,
                              const float* hs, const int8_t* __restrict__ b, int ldb,
                              int b_cols, int k_len, GemmSmem& sm,
                              const int8_t* __restrict__ sh = nullptr, int k_base = 0) {
  const int warp = threadIdx.x >> 5;
  const int row_tiles = (min(a_rows, kGemmM) + 15) / 16;
  FragC32 acc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[t], 0);
  for (int k0 = 0; k0 < k_len; k0 += kGemmK) {
    __syncthreads();  // the previous chunk has been consumed
    {
      // A: thread -> (row, panel); a warp writes 512 contiguous bytes.
      const int r = threadIdx.x & (kGemmM - 1);
      const int p = threadIdx.x / kGemmM;
      const int k = k0 + p * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (r < a_rows && k < k_len) {
        if constexpr (kF32A) {
          const float4* src =
              reinterpret_cast<const float4*>(static_cast<const float*>(a) + (size_t)r * lda + k);
          const float s = hs[r];
          int w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 f = src[j];
            w[j] = (int)(uint8_t)quant_level(__fdiv_rn(f.x, s)) |
                   (int)(uint8_t)quant_level(__fdiv_rn(f.y, s)) << 8 |
                   (int)(uint8_t)quant_level(__fdiv_rn(f.z, s)) << 16 |
                   (int)(uint8_t)quant_level(__fdiv_rn(f.w, s)) << 24;
          }
          v = make_int4(w[0], w[1], w[2], w[3]);
        } else {
          v = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(a) + (size_t)r * lda + k);
        }
      }
      *reinterpret_cast<int4*>(sm.a + p * kPanelA + r * 16) = v;
    }
    // B: eight threads read one 128-byte row run; two items per thread.
    for (int i = threadIdx.x; i < kGemmK * (kGemmN / 16); i += kBlock) {
      const int kk = i >> 3;
      const int p = i & 7;
      int4 v = make_int4(0, 0, 0, 0);
      if (k0 + kk < k_len && p * 16 < b_cols) {
        if constexpr (kI4) {
          const int kg = k_base + k0 + kk;
          const int4 raw = *reinterpret_cast<const int4*>(
              b + ((size_t)(kg >> 7) * 64 + (kg & 63)) * ldb + p * 16);
          const int4 shv =
              *reinterpret_cast<const int4*>(sh + (size_t)(kg >> 7) * ldb + p * 16);
          const bool high = (kg >> 6) & 1;
          v = make_int4(unpack_int4_word(raw.x, shv.x, high), unpack_int4_word(raw.y, shv.y, high),
                        unpack_int4_word(raw.z, shv.z, high), unpack_int4_word(raw.w, shv.w, high));
        } else {
          v = *reinterpret_cast<const int4*>(b + (size_t)(k0 + kk) * ldb + p * 16);
        }
      }
      *reinterpret_cast<int4*>(sm.b + p * kPanelB + kk * 16) = v;
    }
    __syncthreads();
    const int steps = min(kGemmK, k_len - k0) / 16;
#pragma unroll
    for (int s = 0; s < kGemmK / 16; ++s) {
      if (s >= steps) break;
      FragB8 fb;
      wmma::load_matrix_sync(fb, sm.b + warp * kPanelB + s * 256, 16);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t >= row_tiles) break;
        FragA8 fa;
        wmma::load_matrix_sync(fa, sm.a + s * kPanelA + t * 256, 16);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    wmma::store_matrix_sync(sm.c + t * 16 * kGemmN + warp * 16, acc[t], kGemmN,
                            wmma::mem_row_major);
  __syncthreads();
}

// The first expert GEMM with its epilogue, for one (128 columns, 64 rows)
// block:
//   hidden[r][j] = act(acc1 * x_s[r] * w1_s[base + j] + b1[base + j])
// over `ncols` columns, and each row's max |hidden| over each tile of `bn`
// columns into absmax (rows, ncols / bn), zeroed before the launch, by an
// integer atomicMax on the bits of the non-negative f32 values (exact and
// order-free). The fat layout (emap == nullptr) reads columns [0, E*I) of
// W1 and skips a block when no row of it routes to the experts of its
// columns (comb == 0 there: those rows' terms are multiplied by 0 later).
// The grouped layout reads expert emap[row / 128]'s I columns (base = e * I)
// and skips the tiles whose emap is -1. kI4: W1 is int4-packed (D / 2, E*I)
// with its shifts w1sh (D / 128, E*I).
template <bool kI4>
__global__ void __launch_bounds__(kBlock) moe_gemm1_kernel(
    const int8_t* __restrict__ xq,     // (rows, D)
    const float* __restrict__ xs,      // (rows, 1)
    const float* __restrict__ comb,    // (rows, E), fat layout only
    const int* __restrict__ emap,      // (rows / 128,), grouped layout only
    const int8_t* __restrict__ w1,     // (D, E*I), int4: (D / 2, E*I)
    const int8_t* __restrict__ w1sh,   // int4 only: (D / 128, E*I)
    const float* __restrict__ w1s,     // (E*I,)
    const float* __restrict__ b1,      // (E*I,)
    float* __restrict__ hidden,        // (rows, ncols)
    float* __restrict__ absmax,        // (rows, ncols / bn)
    int rows, int d_model, int ldw, int ncols, int bn, int tiles_per_expert,
    int num_experts, int act) {
  __shared__ __align__(128) GemmSmem sm;
  const int row0 = blockIdx.y * kGemmM;
  const int col0 = blockIdx.x * kGemmN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (emap != nullptr) {
    const int e = emap[row0 / kGroupRows];
    if (e < 0) return;
    base = e * ncols;
  } else {
    const int e_lo = col0 / bn / tiles_per_expert;
    const int e_hi = (min(col0 + kGemmN, ncols) - 1) / bn / tiles_per_expert;
    int live = 0;
    for (int i = threadIdx.x; i < kGemmM * (e_hi - e_lo + 1); i += kBlock) {
      const int r = row0 + i % kGemmM;
      if (r < rows && comb[(size_t)r * num_experts + e_lo + i / kGemmM] != 0.f) live = 1;
    }
    if (!__syncthreads_or(live)) return;
  }
  const int live_rows = min(kGemmM, rows - row0);
  block_gemm_i8<false, kI4>(xq + (size_t)row0 * d_model, d_model, live_rows, nullptr,
                            w1 + base + col0, ldw, min(kGemmN, ncols - col0), d_model, sm,
                            kI4 ? w1sh + base + col0 : nullptr);
  const int tiles = ncols / bn;
  for (int rr = warp; rr < live_rows; rr += kWarps) {
    const size_t r = row0 + rr;
    const float xsr = xs[r];
    for (int q = 0; q < kGemmN / 32; ++q) {
      const int jb = col0 + 32 * q;
      if (jb >= ncols) break;
      const int j = jb + lane;
      float mag = 0.f;
      if (j < ncols) {
        const float pre = __fadd_rn(
            __fmul_rn(__fmul_rn((float)sm.c[rr * kGemmN + 32 * q + lane], xsr), w1s[base + j]),
            b1[base + j]);
        const float hv = activate(pre, act);
        hidden[r * ncols + j] = hv;
        mag = fabsf(hv);
      }
      const int t_last = min(jb + 31, ncols - 1) / bn;
      for (int t = jb / bn; t <= t_last; ++t) {
        const float m = warp_max(j < ncols && j / bn == t ? mag : 0.f);
        if (lane == 0) atomicMax(reinterpret_cast<int*>(absmax) + r * tiles + t, __float_as_int(m));
      }
    }
  }
}

}  // namespace
