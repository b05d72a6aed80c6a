// The int8 tensor-core block product of the per-expert and grouped MoE
// kernels (moe_dense.cu, moe_grouped.cu) and the grouped layout's first
// expert GEMM.
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

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> FragA8;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> FragB8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC32;

// sm.c[r * kGemmN + j] = sum_{k < k_len} A[r][k] * B[k][j] for r < 64, j < 128.
// A row r is at a + r * lda (int8, or f32 when kF32A, then divided by hs[r]
// and rounded to an int8 level) for r < a_rows, else zero; B row k at
// b + k * ldb, columns [0, b_cols), else zero. k_len, b_cols, lda and ldb are
// multiples of 16 and a, b 16-byte aligned. Called by all kBlock threads;
// ends synchronised.
template <bool kF32A>
__device__ void block_gemm_i8(const void* __restrict__ a, int lda, int a_rows,
                              const float* hs, const int8_t* __restrict__ b, int ldb,
                              int b_cols, int k_len, GemmSmem& sm) {
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
      if (k0 + kk < k_len && p * 16 < b_cols)
        v = *reinterpret_cast<const int4*>(b + (size_t)(k0 + kk) * ldb + p * 16);
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

// The first expert GEMM of the grouped layout with its epilogue, for one
// (128 columns, 64 rows) block of expert emap[row / 128]'s I columns (base
// = e * I; a tile whose emap is -1 is skipped):
//   hidden[r][j] = act(acc1 * x_s[r] * w1_s[base + j] + b1[base + j])
// over the I columns, and each row's max |hidden| into absmax (rows,),
// zeroed before the launch, by an integer atomicMax on the bits of the
// non-negative f32 values (exact and order-free).
__global__ void __launch_bounds__(kBlock) moe_gemm1_kernel(
    const int8_t* __restrict__ xq,     // (rows, D)
    const float* __restrict__ xs,      // (rows, 1)
    const int* __restrict__ emap,      // (rows / 128,)
    const int8_t* __restrict__ w1,     // (D, E*I)
    const float* __restrict__ w1s,     // (E*I,)
    const float* __restrict__ b1,      // (E*I,)
    float* __restrict__ hidden,        // (rows, I)
    float* __restrict__ absmax,        // (rows,)
    int rows, int d_model, int ldw, int ncols, int act) {
  __shared__ __align__(128) GemmSmem sm;
  const int row0 = blockIdx.y * kGemmM;
  const int col0 = blockIdx.x * kGemmN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = emap[row0 / kGroupRows];
  if (e < 0) return;
  const int base = e * ncols;
  const int live_rows = min(kGemmM, rows - row0);
  block_gemm_i8<false>(xq + (size_t)row0 * d_model, d_model, live_rows, nullptr,
                       w1 + base + col0, ldw, min(kGemmN, ncols - col0), d_model, sm);
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
      const float m = warp_max(mag);
      if (lane == 0) atomicMax(reinterpret_cast<int*>(absmax) + r, __float_as_int(m));
    }
  }
}

}  // namespace
