// expert_ffn_dense: every expert's int8 FFN over every row, (E, S, H) out.
//
// Replaces: apertis_llm_tpu/ops/pallas/moe_ffn.py::expert_ffn_dense
// (pallas_call :423, _kernel:376-396), the per-expert kernel the JAX package
// serves under APERTIS_MOE_FUSED=kernel (ops/moe.py::moe_dense_fused) with the
// per-expert stack of models/moe_fuse.py::fuse_moe_decode_params.
//
// Semantics, for expert e and row r (all f32, each step rounded):
//   h    = act(acc1_i32(x_q[r] . W1_q[e]) * x_s[r] * w1_s[e] + b1[e])    (I,)
//   hs   = max(max|h|, 1e-8) * (1/127)          (over the whole of I)
//   hq   = clip(rint(h / hs), -127, 127)
//   out  = out_dtype(acc2_i32(hq . W2_q[e]) * hs * w2_s[e] + b2[e])      (H,)
// Inputs: x_q (S, H) int8 with x_s (S, 1), W1_q (E, H, I) int8 with the
// LayerNorm affine folded in, w1_s (E, 1, I), b1 (E, I), W2_q (E, I, H) int8
// with w2_s (E, 1, H), b2 (E, H); the combine is applied by the caller.
//
// Bound on the H100: bytes at decode (the 31.7 MB of int8 expert weights a
// layer of the 1.5B MoE model, read once); operations (4 E S H I int8) from a
// few hundred rows up.
//
// Design: the requantization over the whole of I means no row's GEMM2 can
// start before its GEMM1 has finished all I columns, and at the 1.5B widths
// (I = 2816) the f32 hidden of 16 rows would take 180 KB of shared memory. So
// GEMM1 and GEMM2 are separate launches, each spread over the card, with the
// f32 hidden (E * S * I * 4 bytes, 5.8 MB at S = 64) passed through device
// memory, where the second launch mostly finds it in L2:
//   1. moe_dense_gemm1_kernel: one block per (128 columns of I, 64 rows,
//      expert): GEMM1 on the int8 tensor cores (moe_gemm.cuh), the
//      dequantization, bias and activation, the f32 hidden out, and each
//      (expert, row)'s absmax over I by an integer atomicMax on the bits of
//      the non-negative f32 values (exact and order-free);
//   2. moe_dense_gemm2_kernel: one block per (128 output columns, part of I,
//      64 rows of one expert) quantizes its hidden rows as it stages them
//      (hq = level(h / hs)) and writes the exact int32 partial product;
//   3. moe_dense_reduce_kernel: per output element, adds the int32 parts
//      (exact, in any order) and applies hs, w2_s and b2 in the TPU kernel's
//      order.
// No float atomics: repeated calls give the same bits.

#include "moe_gemm.cuh"

namespace {

__global__ void __launch_bounds__(kBlock) moe_dense_gemm1_kernel(
    const int8_t* __restrict__ xq,     // (S, H)
    const float* __restrict__ xs,      // (S, 1)
    const int8_t* __restrict__ w1,     // (E, H, I)
    const float* __restrict__ w1s,     // (E, I)
    const float* __restrict__ b1,      // (E, I)
    float* __restrict__ hidden,        // (E, S, I)
    float* __restrict__ absmax,        // (E, S)
    int rows, int d_model, int inter, int act) {
  __shared__ __align__(128) GemmSmem sm;
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kGemmM;
  const int col0 = blockIdx.x * kGemmN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int live_rows = min(kGemmM, rows - row0);
  const size_t eoff = (size_t)e * inter;
  block_gemm_i8<false>(xq + (size_t)row0 * d_model, d_model, live_rows, nullptr,
                       w1 + (size_t)e * d_model * inter + col0, inter,
                       min(kGemmN, inter - col0), d_model, sm);
  for (int rr = warp; rr < live_rows; rr += kWarps) {
    const size_t r = row0 + rr;
    const float xsr = xs[r];
    float mag = 0.f;
#pragma unroll
    for (int q = 0; q < kGemmN / 32; ++q) {
      const int j = col0 + 32 * q + lane;
      if (j < inter) {
        const float pre = __fadd_rn(
            __fmul_rn(__fmul_rn((float)sm.c[rr * kGemmN + 32 * q + lane], xsr), w1s[eoff + j]),
            b1[eoff + j]);
        const float hv = activate(pre, act);
        hidden[((size_t)e * rows + r) * inter + j] = hv;
        mag = fmaxf(mag, fabsf(hv));
      }
    }
    mag = warp_max(mag);
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(absmax) + (size_t)e * rows + r, __float_as_int(mag));
  }
}

__global__ void __launch_bounds__(kBlock) moe_dense_gemm2_kernel(
    const float* __restrict__ hidden,  // (E, S, I)
    const float* __restrict__ absmax,  // (E, S)
    const int8_t* __restrict__ w2,     // (E, I, H)
    int* __restrict__ partial,         // (ksplit, E, S, H)
    int rows, int d_model, int inter, int num_experts, int ksplit, int row_tiles) {
  __shared__ __align__(128) GemmSmem sm;
  __shared__ float hs[kGemmM];
  const int e = blockIdx.z / row_tiles;
  const int row0 = (blockIdx.z - e * row_tiles) * kGemmM;
  const int part = blockIdx.y;
  const int col0 = blockIdx.x * kGemmN;
  const int live_rows = min(kGemmM, rows - row0);
  for (int i = threadIdx.x; i < kGemmM; i += kBlock)
    hs[i] = i < live_rows ? fmaxf(absmax[(size_t)e * rows + row0 + i], 1e-8f) * (1.f / 127.f)
                          : 1.f;
  __syncthreads();
  const int chunks = (inter + kGemmK - 1) / kGemmK;
  const int per_part = (chunks + ksplit - 1) / ksplit;
  const int k_begin = min(inter, part * per_part * kGemmK);
  const int k_end = min(inter, (part + 1) * per_part * kGemmK);
  // An empty part (k_end == k_begin) writes zeros.
  block_gemm_i8<true>(hidden + ((size_t)e * rows + row0) * inter + k_begin, inter, live_rows,
                      hs, w2 + ((size_t)e * inter + k_begin) * d_model + col0, d_model,
                      min(kGemmN, d_model - col0), k_end - k_begin, sm);
  int* dst = partial + (((size_t)part * num_experts + e) * rows + row0) * d_model;
  for (int i = threadIdx.x; i < kGemmM * kGemmN; i += kBlock) {
    const int r = i / kGemmN;
    const int j = col0 + (i - r * kGemmN);
    if (r < live_rows && j < d_model) dst[(size_t)r * d_model + j] = sm.c[i];
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kBlock) moe_dense_reduce_kernel(
    const int* __restrict__ partial,   // (ksplit, E, S, H)
    const float* __restrict__ absmax,  // (E, S)
    const float* __restrict__ w2s,     // (E, H)
    const float* __restrict__ b2,      // (E, H)
    OutT* __restrict__ out,            // (E, S, H)
    int rows, int d_model, int num_experts, int ksplit) {
  const size_t n = (size_t)num_experts * rows * d_model;
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const size_t er = i / d_model;               // e * S + r
  const size_t c = i - er * d_model;
  const size_t we = er / rows * d_model + c;   // (e, c)
  int a = 0;
  for (int j = 0; j < ksplit; ++j) a += partial[(size_t)j * n + i];
  const float hs = fmaxf(absmax[er], 1e-8f) * (1.f / 127.f);
  out[i] = from_f32<OutT>(__fadd_rn(__fmul_rn(__fmul_rn((float)a, hs), w2s[we]), b2[we]));
}

}  // namespace

// The per-expert MoE FFN for S rows and E experts: out (E, S, H) in bf16
// (out_bf16 = 1) or f32. H and I multiples of 16, pointers 16-byte aligned.
// hidden (E, S, I) f32, absmax (E, S) f32 and partial (ksplit, E, S, H) int32
// are scratch the caller allocates; absmax is zeroed here. act: 1 relu,
// 2 silu, else exact GELU. Returns cudaGetLastError().
extern "C" int apertis_expert_ffn_dense(const void* xq, const void* xs, const void* w1q,
                                        const void* w1s, const void* b1, const void* w2q,
                                        const void* w2s, const void* b2, void* out,
                                        void* hidden, void* absmax, void* partial, int rows,
                                        int d_model, int inter, int num_experts, int ksplit,
                                        int act, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (rows + kGemmM - 1) / kGemmM;
  if (rows <= 0 || num_experts <= 0 || d_model % 16 || inter % 16 || d_model <= 0 ||
      inter <= 0 || ksplit < 1 || ksplit > 65535 || row_tiles > 65535 ||
      (long long)num_experts * row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(absmax, 0, (size_t)num_experts * rows * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_dense_gemm1_kernel<<<dim3((inter + kGemmN - 1) / kGemmN, row_tiles, num_experts), kBlock,
                           0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w1q), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<float*>(hidden), static_cast<float*>(absmax),
      rows, d_model, inter, act);
  moe_dense_gemm2_kernel<<<dim3((d_model + kGemmN - 1) / kGemmN, ksplit,
                                num_experts * row_tiles), kBlock, 0, s>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(absmax),
      static_cast<const int8_t*>(w2q), static_cast<int*>(partial), rows, d_model, inter,
      num_experts, ksplit, row_tiles);
  const size_t n = (size_t)num_experts * rows * d_model;
  const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
  if (out_bf16)
    moe_dense_reduce_kernel<bf16><<<blocks, kBlock, 0, s>>>(
        static_cast<const int*>(partial), static_cast<const float*>(absmax),
        static_cast<const float*>(w2s), static_cast<const float*>(b2), static_cast<bf16*>(out),
        rows, d_model, num_experts, ksplit);
  else
    moe_dense_reduce_kernel<float><<<blocks, kBlock, 0, s>>>(
        static_cast<const int*>(partial), static_cast<const float*>(absmax),
        static_cast<const float*>(w2s), static_cast<const float*>(b2), static_cast<float*>(out),
        rows, d_model, num_experts, ksplit);
  return static_cast<int>(cudaGetLastError());
}
