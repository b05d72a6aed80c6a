// quant_matmul_dyn: the w8a8 product with its dequantizing epilogue,
//   out = out_dtype((float)(x_q . W_q) * x_s[m] * w_s[n])  (+ b[n] in out_dtype)
// for int8 x_q (M, K) with f32 row scales x_s (M, 1), int8 W_q (K, N) in the
// row-major (in, out) layout of the JAX tree and f32 column scales w_s (1, N).
//
// Replaces: apertis_llm_tpu/ops/pallas/quant_matmul.py::quant_matmul_dyn
// (_quant_matmul_dyn_impl, _dyn_kernel:94-110), whose arithmetic is also the
// JAX package's default w8a8 linear (quant_matmul_dyn_xla, used by
// models/apertis.py::_linear under APERTIS_QUANT_MATMUL=dyn). The int32 sums
// are exact; the epilogue multiplies in the order acc * x_s * w_s with
// separate roundings (the _rn intrinsics keep nvcc from contracting them), so
// the result is bit-equal to the plain PyTorch version and to the TPU kernel.
//
// Bound on the H100: operations (2 M N K int8 ops at 1,979 TOP/s) from a few
// hundred rows up, e.g. the 1.5B model's prefill FFN at M = 2048; bytes (the
// int8 weight, K N bytes at 3.35 TB/s) at decode row counts, e.g. the int8 LM
// head (2432 x 32000) at every decode step.
//
// Design: one block of 8 warps per (128 rows, 128 columns) tile of the
// output, K in chunks of 64. WMMA int8 fragments (m16n16k16, int32
// accumulators); each warp owns a 32 x 64 sub-tile (2 x 4 fragments). WMMA
// wants 32-byte aligned fragment pointers, which a row-major int8 tile gives
// only at 32-element steps, so both operands are staged in shared memory as
// panels 16 bytes wide (A: four 128-row x 16-k panels, B: eight 64-k x
// 16-column panels), each read with ldm = 16. The next chunk's global loads
// are issued into registers before the current chunk's products, so they
// overlap. Any M, N and K is taken: rows, columns and k past the operands'
// edges are staged as zeros (16-byte loads where K, resp. N, is a multiple of
// 16 and the base is aligned, bytewise otherwise). The epilogue goes through
// a 16 x 16 int32 staging tile per warp. No atomics, no split K: a repeated
// call gives the same bits. This is the simple tensor-core kernel; wgmma and
// TMA are later work.

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
