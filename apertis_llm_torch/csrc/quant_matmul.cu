// The int8-weight products of serving, three modes of one tile loop. The
// weight is int8 W_q (K, N) in the row-major (in, out) layout of the JAX tree
// with f32 column scales w_s (1, N); the bias b (N,) is added in the output
// type after its one rounding, as the JAX package's `_linear` adds it.
//
// quant_matmul_dyn (#7): the w8a8 product with its dequantizing epilogue,
//   out = out_dtype((float)(x_q . W_q) * x_s[m] * w_s[n])  (+ b[n])
// for int8 x_q (M, K) with f32 row scales x_s (M, 1).
// Replaces: apertis_llm_tpu/ops/pallas/quant_matmul.py::quant_matmul_dyn
// (_quant_matmul_dyn_impl, _dyn_kernel:94-110), whose arithmetic is also the
// JAX package's default w8a8 linear (quant_matmul_dyn_xla, used by
// models/apertis.py::_linear under APERTIS_QUANT_MATMUL=dyn). The int32 sums
// are exact; the epilogue multiplies in the order acc * x_s * w_s with
// separate roundings (the _rn intrinsics keep nvcc from contracting them), so
// the result is bit-equal to the plain PyTorch version and to the TPU kernel.
//
// quant_matmul (#6, APERTIS_QUANT_MATMUL=pallas): the weight-only product
//   out = x.dtype((x . float(W_q)) * w_s[n])  (+ b[n])
// for bf16 or f32 x (M, K), f32 accumulation.
// Replaces: quant_matmul.py::quant_matmul (_quant_matmul_impl:59, _kernel:32-47).
// bf16 x: each staged int8 weight tile is converted to bf16 in shared memory
// (exact: |q| <= 127) and multiplied on the tensor cores by bf16 WMMA with
// f32 accumulators, so every product is exact and only the order of the f32
// sums differs from the TPU kernel. f32 x: TF32 would round x to 10 mantissa
// bits, so the f32 form is a SIMT loop of f32 fused multiply-adds (64 x 64
// tiles, 4 x 4 outputs a thread), not a tensor-core product.
//
// quant_matmul_dyn_fused (#8, APERTIS_QUANT_MATMUL=fused): the w8a8 product
// that quantizes x inside the kernel, per row and per 512-wide K block
// [512 j, 512 j + 512) (one block when K <= 512):
//   s_j = max(max|x[m, block j]|, 1e-8) * (1/127)   (a multiply, not / 127)
//   q   = clip(rint(x / s_j), -127, 127)             (a true division)
//   acc = sum_j float(q_j . W_q[block j]) * s_j      (j increasing, each
//                                                     product and sum rounded)
//   out = x.dtype(acc * w_s[n])  (+ b[n])
// Replaces: quant_matmul.py::quant_matmul_dyn_fused
// (_quant_matmul_dyn_fused_impl:262, _dyn_fused_kernel:231-259). The int32
// block sums are exact and the f32 steps are the TPU kernel's in its order,
// so the result is bit-equal to the plain version.
//
// Bound on the H100: operations (2 M N K at 1,979 TOP/s int8, 989 TFLOP/s
// bf16, 67 TFLOP/s f32) from a few hundred rows up, e.g. the 1.5B model's
// prefill FFN at M = 2048; bytes (the int8 weight, K N bytes at 3.35 TB/s)
// at decode row counts, e.g. the int8 LM head (2432 x 32000) at every decode
// step.
//
// Design: one block of 8 warps per (128 rows, 128 columns) tile of the
// output. #7 and #8: K in chunks of 64, WMMA int8 fragments (m16n16k16, int32
// accumulators); each warp owns a 32 x 64 sub-tile (2 x 4 fragments). WMMA
// wants 32-byte aligned fragment pointers, which a row-major int8 tile gives
// only at 32-element steps, so both operands are staged in shared memory as
// panels 16 bytes wide (A: four 128-row x 16-k panels, B: eight 64-k x
// 16-column panels), each read with ldm = 16. The next chunk's global loads
// are issued into registers before the current chunk's products, so they
// overlap. #8 first reads its 128 rows of each 512-column block once for the
// row scales (one warp a row, 16 rows a warp), then quantizes x as it stages
// the A panels, and at the end of the block folds the int32 fragments into
// f32 accumulators in registers (through the warp's 16 x 16 staging tile, a
// lane owning 8 columns of one row of each fragment). #6 (bf16) takes K in
// chunks of 32 with row-major bf16 tiles padded to 40 and 136 elements a row
// (fragment pointers stay 32-byte aligned). Any M, N and K is taken: rows,
// columns and k past the operands' edges are staged as zeros (16-byte loads
// where the row length is a multiple of 16 bytes and the base is aligned,
// element by element otherwise). The epilogue goes through a 16 x 16
// staging tile per warp. No atomics, no split K: a repeated call gives the
// same bits. These are the simple tensor-core kernels; wgmma and TMA are
// later work.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128;                 // rows per block
constexpr int kBN = 128;                 // columns per block
constexpr int kBK = 64;                  // K chunk
constexpr int kPanelA = kBM * 16;        // bytes of one 16-deep A panel
constexpr int kPanelB = kBK * 16;        // bytes of one 16-wide B panel

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC;

// 16 bytes of row `row` of a (rows, cols) int8 matrix with leading dimension
// `ld`, from column `col`; zeros past the edges. `vec`: cols is a multiple of
// 16 and the base 16-byte aligned, so a 16-byte load is in bounds and aligned.
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ base, int row, int col,
                                       int rows, int cols, size_t ld, bool vec) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  const int8_t* src = base + (size_t)row * ld + col;
  if (vec) return *reinterpret_cast<const int4*>(src);
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (col + j < cols) w[j >> 2] |= (int)(uint8_t)src[j] << (8 * (j & 3));
  return make_int4(w[0], w[1], w[2], w[3]);
}

template <typename OutT>
__global__ void __launch_bounds__(kBlock, 2) quant_matmul_dyn_kernel(
    const int8_t* __restrict__ xq,  // (M, K)
    const float* __restrict__ xs,   // (M,)
    const int8_t* __restrict__ wq,  // (K, N)
    const float* __restrict__ ws,   // (N,)
    const OutT* __restrict__ bias,  // (N,) or nullptr
    OutT* __restrict__ out,         // (M, N)
    int m, int n, int k, bool vec_a, bool vec_b) {
  __shared__ __align__(128) int8_t sa[(kBK / 16) * kPanelA];   // 8 KB
  __shared__ __align__(128) int8_t sb[(kBN / 16) * kPanelB];   // 8 KB
  __shared__ __align__(128) int sc[kWarps][16 * 16];          // 8 KB
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;          // 32-row strip
  const int wn = warp >> 2;         // 64-column strip
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool live = m0 + wm * 32 < m;
  const int row_frags = live ? min(2, (m - m0 - wm * 32 + 15) / 16) : 0;

  FragC acc[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[t][j], 0);

  // Thread i of the block stages items i and i + kBlock of each operand:
  // A item -> (row r, panel p): four threads read a row's 64 bytes;
  // B item -> (k row kk, panel p): eight threads read a row's 128 bytes.
  int4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = threadIdx.x + it * kBlock;
      ra[it] = load16(xq, m0 + (i >> 2), k0 + (i & 3) * 16, m, k, (size_t)k, vec_a);
      rb[it] = load16(wq, k0 + (i >> 3), n0 + (i & 7) * 16, k, n, (size_t)n, vec_b);
    }
  };
  const int chunks = (k + kBK - 1) / kBK;
  fetch(0);
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // the previous chunk has been consumed
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = threadIdx.x + it * kBlock;
      *reinterpret_cast<int4*>(sa + (i & 3) * kPanelA + (i >> 2) * 16) = ra[it];
      *reinterpret_cast<int4*>(sb + (i & 7) * kPanelB + (i >> 3) * 16) = rb[it];
    }
    __syncthreads();
    if (c + 1 < chunks) fetch((c + 1) * kBK);
    if (row_frags == 0) continue;
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], sb + (wn * 4 + j) * kPanelB + s * 256, 16);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t >= row_frags) break;
        FragA fa;
        wmma::load_matrix_sync(fa, sa + s * kPanelA + (wm * 32 + t * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[t][j], fa, fb[j], acc[t][j]);
      }
    }
  }

  // Epilogue: lane owns 8 consecutive columns of one row of each fragment.
  int* stage = sc[warp];
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t >= row_frags) break;
    const int row = m0 + wm * 32 + t * 16 + er;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[t][j], 16, wmma::mem_row_major);
      __syncwarp();
      if (row < m) {
        const float xsr = xs[row];
        const int col0 = n0 + wn * 64 + j * 16 + ec;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = col0 + q;
          if (col >= n) break;
          float y = __fmul_rn(__fmul_rn((float)stage[er * 16 + ec + q], xsr), ws[col]);
          OutT o = from_f32<OutT>(y);
          if (bias != nullptr) o = from_f32<OutT>(__fadd_rn(to_f32(o), to_f32(bias[col])));
          out[(size_t)row * n + col] = o;
        }
      }
      __syncwarp();
    }
  }
}

template <typename OutT>
cudaError_t launch(const void* xq, const void* xs, const void* wq, const void* ws,
                   const void* bias, void* out, int m, int n, int k, cudaStream_t s) {
  const bool vec_a = k % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  const bool vec_b = n % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  quant_matmul_dyn_kernel<OutT><<<dim3((n + kBN - 1) / kBN, (m + kBM - 1) / kBM), kBlock, 0,
                                   s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const OutT*>(bias), static_cast<OutT*>(out), m, n, k, vec_a, vec_b);
  return cudaGetLastError();
}

// ---- #6, the weight-only product ---------------------------------------------

constexpr int kWoK = 32;                 // K chunk of the bf16 form
constexpr int kWoLdA = kWoK + 8;         // row of the bf16 A tile (elements), padded
constexpr int kWoLdB = kBN + 8;          // row of the bf16 B tile, padded
constexpr int kSt = 64;                  // output tile of the f32 form (rows and columns)
constexpr int kSk = 16;                  // K chunk of the f32 form

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragABf;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBBf;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragCF;

// 8 bf16 of row `row` of a (rows, cols) bf16 matrix with leading dimension
// `ld`, from column `col`; zeros past the edges. `vec`: cols is a multiple of
// 8 and the base 16-byte aligned.
__device__ __forceinline__ int4 load8_bf16(const bf16* __restrict__ base, int row, int col,
                                           int rows, int cols, size_t ld, bool vec) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  const bf16* src = base + (size_t)row * ld + col;
  if (vec) return *reinterpret_cast<const int4*>(src);
  const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (col + j < cols) w[j >> 1] |= (uint32_t)h[j] << (16 * (j & 1));
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// 16 int8 values (one int4) as 16 bf16 (two int4), exactly.
__device__ __forceinline__ void int8x16_to_bf16(int4 v, int4& lo, int4& hi) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b0 = (int)(int8_t)((w[i >> 1] >> (16 * (i & 1))) & 0xff);
    const int b1 = (int)(int8_t)((w[i >> 1] >> (16 * (i & 1) + 8)) & 0xff);
    o[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16((float)b0)) |
           (uint32_t)__bfloat16_as_ushort(__float2bfloat16((float)b1)) << 16;
  }
  lo = make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
  hi = make_int4((int)o[4], (int)o[5], (int)o[6], (int)o[7]);
}

// #6 with bf16 x: bf16 WMMA on the converted weight tile, f32 accumulators.
__global__ void __launch_bounds__(kBlock, 2) quant_matmul_bf16_kernel(
    const bf16* __restrict__ x,      // (M, K)
    const int8_t* __restrict__ wq,   // (K, N)
    const float* __restrict__ ws,    // (N,)
    const bf16* __restrict__ bias,   // (N,) or nullptr
    bf16* __restrict__ out,          // (M, N)
    int m, int n, int k, bool vec_a, bool vec_b) {
  __shared__ __align__(128) bf16 sa[kBM * kWoLdA];      // 10 KB
  __shared__ __align__(128) bf16 sb[kWoK * kWoLdB];     // 8.5 KB
  __shared__ __align__(128) float sc[kWarps][16 * 16];  // 8 KB
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;          // 32-row strip
  const int wn = warp >> 2;         // 64-column strip
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool live = m0 + wm * 32 < m;
  const int row_frags = live ? min(2, (m - m0 - wm * 32 + 15) / 16) : 0;

  FragCF acc[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[t][j], 0.f);

  // Thread i stages A items i and i + kBlock (row i / 4, eight k from
  // 8 (i % 4)) and B item i (k row i / 8, sixteen columns from 16 (i % 8)).
  int4 ra[2], rb;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = threadIdx.x + it * kBlock;
      ra[it] = load8_bf16(x, m0 + (i >> 2), k0 + (i & 3) * 8, m, k, (size_t)k, vec_a);
    }
    rb = load16(wq, k0 + (threadIdx.x >> 3), n0 + (threadIdx.x & 7) * 16, k, n, (size_t)n, vec_b);
  };
  const int chunks = (k + kWoK - 1) / kWoK;
  fetch(0);
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();  // the previous chunk has been consumed
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = threadIdx.x + it * kBlock;
      *reinterpret_cast<int4*>(sa + (i >> 2) * kWoLdA + (i & 3) * 8) = ra[it];
    }
    {
      int4 lo, hi;
      int8x16_to_bf16(rb, lo, hi);
      bf16* dst = sb + (threadIdx.x >> 3) * kWoLdB + (threadIdx.x & 7) * 16;
      *reinterpret_cast<int4*>(dst) = lo;
      *reinterpret_cast<int4*>(dst + 8) = hi;
    }
    __syncthreads();
    if (c + 1 < chunks) fetch((c + 1) * kWoK);
    if (row_frags == 0) continue;
#pragma unroll
    for (int s = 0; s < kWoK / 16; ++s) {
      FragBBf fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], sb + s * 16 * kWoLdB + wn * 64 + j * 16, kWoLdB);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t >= row_frags) break;
        FragABf fa;
        wmma::load_matrix_sync(fa, sa + (wm * 32 + t * 16) * kWoLdA + s * 16, kWoLdA);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[t][j], fa, fb[j], acc[t][j]);
      }
    }
  }

  // Epilogue: lane owns 8 consecutive columns of one row of each fragment.
  float* stage = sc[warp];
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t >= row_frags) break;
    const int row = m0 + wm * 32 + t * 16 + er;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[t][j], 16, wmma::mem_row_major);
      __syncwarp();
      if (row < m) {
        const int col0 = n0 + wn * 64 + j * 16 + ec;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = col0 + q;
          if (col >= n) break;
          bf16 o = __float2bfloat16(__fmul_rn(stage[er * 16 + ec + q], ws[col]));
          if (bias != nullptr) o = __float2bfloat16(__fadd_rn(to_f32(o), to_f32(bias[col])));
          out[(size_t)row * n + col] = o;
        }
      }
      __syncwarp();
    }
  }
}

// #6 with f32 x: a SIMT loop of f32 fused multiply-adds (no TF32), one
// 64 x 64 output tile a block, 4 x 4 outputs a thread, K in chunks of 16.
__global__ void __launch_bounds__(kBlock) quant_matmul_f32_kernel(
    const float* __restrict__ x,     // (M, K)
    const int8_t* __restrict__ wq,   // (K, N)
    const float* __restrict__ ws,    // (N,)
    const float* __restrict__ bias,  // (N,) or nullptr
    float* __restrict__ out,         // (M, N)
    int m, int n, int k) {
  __shared__ float sa[kSk][kSt + 4];   // the x tile, k-major
  __shared__ float sb[kSk][kSt];       // the weight tile as f32
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kSt;
  const int n0 = blockIdx.x * kSt;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kSk) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = threadIdx.x + it * kBlock;
      const int r = i >> 4, kk = i & 15;            // 16 threads read 16 k of a row
      const int row = m0 + r, kc = k0 + kk;
      sa[kk][r] = (row < m && kc < k) ? x[(size_t)row * k + kc] : 0.f;
      const int kr = k0 + (i >> 6), col = n0 + (i & 63);
      sb[i >> 6][i & 63] = (kr < k && col < n) ? (float)wq[(size_t)kr * n + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[kk][ty * 4 + i];
        b[i] = sb[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (row < m && col < n) {
        float y = __fmul_rn(acc[i][j], ws[col]);
        if (bias != nullptr) y = __fadd_rn(y, bias[col]);
        out[(size_t)row * n + col] = y;
      }
    }
  }
}

// ---- #8, the w8a8 product that quantizes x per 512-wide K block ---------------

constexpr int kQBlock = 512;   // the TPU kernel's K block (quant_matmul.py BLOCK_K)

__device__ __forceinline__ float elem_f32(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float elem_f32(const float* p) { return *p; }

// 16 values of row `row` of a (rows, ld) matrix from column `col` as f32,
// zeros at or past column `col_end` and past the rows. `vec`: 16-byte loads
// are aligned (the row length is a multiple of 16 bytes, the base aligned).
template <typename T>
__device__ __forceinline__ void load16_f32(const T* __restrict__ base, int row, int col,
                                           int rows, int col_end, size_t ld, bool vec,
                                           float (&v)[16]) {
  if (row >= rows) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.f;
    return;
  }
  const T* src = base + (size_t)row * ld + col;
  if (vec && col + 16 <= col_end) {
    __align__(16) T buf[16];
#pragma unroll
    for (int q = 0; q < (int)(16 * sizeof(T) / 16); ++q)
      reinterpret_cast<int4*>(buf)[q] = reinterpret_cast<const int4*>(src)[q];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = elem_f32(buf + j);
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = col + j < col_end ? elem_f32(src + j) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1) quant_matmul_dyn_fused_kernel(
    const T* __restrict__ x,         // (M, K) bf16 or f32
    const int8_t* __restrict__ wq,   // (K, N)
    const float* __restrict__ ws,    // (N,)
    const T* __restrict__ bias,      // (N,) or nullptr
    T* __restrict__ out,             // (M, N)
    int m, int n, int k, bool vec_a, bool vec_b) {
  __shared__ __align__(128) int8_t sa[(kBK / 16) * kPanelA];   // 8 KB
  __shared__ __align__(128) int8_t sb[(kBN / 16) * kPanelB];   // 8 KB
  __shared__ __align__(128) int sc[kWarps][16 * 16];          // 8 KB
  __shared__ float srow[kBM];                                 // the block's row scales
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool live = m0 + wm * 32 < m;
  const int row_frags = live ? min(2, (m - m0 - wm * 32 + 15) / 16) : 0;
  int* stage = sc[warp];
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;

  FragC acc[2][4];
  float facc[2][4][8];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) facc[t][j][q] = 0.f;

  int g_end = 0;
  int4 ra[2], rb[2];
  // A items are quantized as they are fetched, with the block's row scales.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = threadIdx.x + it * kBlock;
      const int r = i >> 2;
      float v[16];
      load16_f32(x, m0 + r, k0 + (i & 3) * 16, m, g_end, (size_t)k, vec_a, v);
      const float s = srow[r];
      int w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j >> 2] |= (int)(uint8_t)quant_level(__fdiv_rn(v[j], s)) << (8 * (j & 3));
      ra[it] = make_int4(w[0], w[1], w[2], w[3]);
      rb[it] = load16(wq, k0 + (i >> 3), n0 + (i & 7) * 16, k, n, (size_t)n, vec_b);
    }
  };
  for (int g0 = 0; g0 < k; g0 += kQBlock) {
    g_end = min(k, g0 + kQBlock);
    __syncthreads();  // the previous block's fold has read srow
    // Row scales: one warp a row, lanes over the block's columns.
    for (int rr = 0; rr < kBM / kWarps; ++rr) {
      const int r = warp * (kBM / kWarps) + rr;
      const int row = m0 + r;
      float mx = 0.f;
      if (row < m)
        for (int col = g0 + lane; col < g_end; col += 32)
          mx = fmaxf(mx, fabsf(elem_f32(x + (size_t)row * k + col)));
      mx = warp_max(mx);
      if (lane == 0) srow[r] = row < m ? __fmul_rn(fmaxf(mx, 1e-8f), 1.f / 127.f) : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[t][j], 0);
    const int c1 = (g_end + kBK - 1) / kBK;
    fetch(g0);
    for (int c = g0 / kBK; c < c1; ++c) {
      __syncthreads();  // the previous chunk has been consumed
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int i = threadIdx.x + it * kBlock;
        *reinterpret_cast<int4*>(sa + (i & 3) * kPanelA + (i >> 2) * 16) = ra[it];
        *reinterpret_cast<int4*>(sb + (i & 7) * kPanelB + (i >> 3) * 16) = rb[it];
      }
      __syncthreads();
      if (c + 1 < c1) fetch((c + 1) * kBK);
      if (row_frags == 0) continue;
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        FragB fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], sb + (wn * 4 + j) * kPanelB + s * 256, 16);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t >= row_frags) break;
          FragA fa;
          wmma::load_matrix_sync(fa, sa + s * kPanelA + (wm * 32 + t * 16) * 16, 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[t][j], fa, fb[j], acc[t][j]);
        }
      }
    }
    // acc += float(block sum) * s_row, each product and sum rounded.
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < row_frags) {
        const float s = srow[wm * 32 + t * 16 + er];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(stage, acc[t][j], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int q = 0; q < 8; ++q)
            facc[t][j][q] = __fadd_rn(facc[t][j][q],
                                      __fmul_rn((float)stage[er * 16 + ec + q], s));
          __syncwarp();
        }
      }
    }
  }

  // Epilogue: out = x.dtype(acc * w_s) (+ b).
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int row = m0 + wm * 32 + t * 16 + er;
    if (t < row_frags && row < m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col0 = n0 + wn * 64 + j * 16 + ec;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = col0 + q;
          if (col < n) {
            T o = from_f32<T>(__fmul_rn(facc[t][j][q], ws[col]));
            if (bias != nullptr) o = from_f32<T>(__fadd_rn(to_f32(o), to_f32(bias[col])));
            out[(size_t)row * n + col] = o;
          }
        }
      }
    }
  }
}

}  // namespace

// out (M, N) = round(acc * x_s * w_s) (+ b) in bf16 (out_bf16 = 1) or f32;
// `bias` is nullptr or (N,) of the output's type. Any M, N, K >= 1; the row
// count is at most 65535 * 128. Returns cudaGetLastError().
extern "C" int apertis_quant_matmul_dyn(const void* xq, const void* xs, const void* wq,
                                        const void* ws, const void* bias, void* out, int m,
                                        int n, int k, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = out_bf16 ? launch<bf16>(xq, xs, wq, ws, bias, out, m, n, k, s)
                                   : launch<float>(xq, xs, wq, ws, bias, out, m, n, k, s);
  return static_cast<int>(err);
}

// out (M, N) = x.dtype((x . float(W_q)) * w_s) (+ b) for bf16 (x_bf16 = 1)
// or f32 x and out; `bias` is nullptr or (N,) of x's type. Any M, N, K >= 1;
// the row count is at most 65535 * 128 (bf16) or 65535 * 64 (f32). Returns
// cudaGetLastError().
extern "C" int apertis_quant_matmul(const void* x, const void* wq, const void* ws,
                                    const void* bias, void* out, int m, int n, int k, int x_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = x_bf16 ? kBM : kSt;
  if (m <= 0 || n <= 0 || k <= 0 || (m + tile - 1) / tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16) {
    const bool vec_a = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vec_b = n % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
    quant_matmul_bf16_kernel<<<dim3((n + kBN - 1) / kBN, (m + kBM - 1) / kBM), kBlock, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(ws), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
        m, n, k, vec_a, vec_b);
  } else {
    quant_matmul_f32_kernel<<<dim3((n + kSt - 1) / kSt, (m + kSt - 1) / kSt), kBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<float*>(out), m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = x.dtype(sum_j float(q_j . W_q[block j]) * s_j * w_s) (+ b), x
// quantized per row and 512-wide K block in the kernel; bf16 (x_bf16 = 1) or
// f32 x and out, `bias` nullptr or (N,) of x's type. Any M, N, K >= 1; the
// row count is at most 65535 * 128. Returns cudaGetLastError().
extern "C" int apertis_quant_matmul_dyn_fused(const void* x, const void* wq, const void* ws,
                                              const void* bias, void* out, int m, int n, int k,
                                              int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = n % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  if (x_bf16)
    quant_matmul_dyn_fused_kernel<bf16><<<grid, kBlock, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(ws), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
        m, n, k, aligned && k % 8 == 0, vec_b);
  else
    quant_matmul_dyn_fused_kernel<float><<<grid, kBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<float*>(out), m, n, k, aligned && k % 4 == 0, vec_b);
  return static_cast<int>(cudaGetLastError());
}
