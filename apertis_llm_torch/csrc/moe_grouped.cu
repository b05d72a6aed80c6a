// expert_ffn_grouped: the MoE FFN over expert-sorted rows, for prefill.
//
// Replaces: apertis_llm_tpu/ops/pallas/moe_grouped.py::expert_ffn_grouped.
//
// Semantics: the rows come in tiles of 128 (ops/moe.py grouped_dispatch pads
// each expert's rows to whole tiles); tile t belongs to expert e = emap[t],
// or to none when emap[t] is -1 (the tiles past the last expert's, which the
// TPU kernel computes for expert E-1 and nobody reads: here their rows are
// 0). Per row of expert e, over the expert's I hidden columns of the fat
// stack (models/moe_fuse.py):
//   h   = act(acc1_i32(x_q . W1t_q[:, e*I : (e+1)*I]) * x_s * w1t_s + b1t)   (f32)
//   hs  = max(max|h|, 1e-8) * (1/127)      one scale per row over the whole I
//   out = bf16(acc2_i32(rint(h / hs) . W2t_q[e*I : (e+1)*I, :]) * hs * w2t_s)
// Rows are independent; the caller gathers and combines them.
//
// Bound on the H100: operations. At the smoke's 64 x 32 prefill of the 1.5B
// MoE model (P = 5120 rows) a layer does 2 * 2 * 5120 * 704 * 2816 = 40.6 G
// int8 operations against 31.7 MB of weights.
//
// Design: two launches over (128 columns, 64 rows) blocks with exact int32
// sums on the tensor cores (moe_gemm.cuh). moe_gemm1_kernel writes the f32
// hidden (P, I) and each row's absmax over the whole I (atomicMax);
// moe_grouped_gemm2_kernel quantizes the hidden rows as it stages them and
// applies the epilogue. A block's rows are one expert's, so it streams that
// expert's weights only; the 64-row blocks of one expert re-read them from
// L2 (the int8 fat stack of a layer is 31.7 MB, inside the 50 MB L2).

#include "moe_gemm.cuh"

namespace {

__global__ void __launch_bounds__(kBlock) moe_grouped_gemm2_kernel(
    const float* __restrict__ hidden,  // (P, I)
    const float* __restrict__ absmax,  // (P,)
    const int* __restrict__ emap,      // (P / 128,)
    const int8_t* __restrict__ w2,     // (E*I, H)
    const float* __restrict__ w2s,     // (H,)
    bf16* __restrict__ out,            // (P, H)
    int rows, int d_model, int inter) {
  __shared__ __align__(128) GemmSmem sm;
  __shared__ float hs[kGemmM];
  const int row0 = blockIdx.y * kGemmM;
  const int col0 = blockIdx.x * kGemmN;
  const int e = emap[row0 / kGroupRows];
  if (e < 0) {
    for (int i = threadIdx.x; i < kGemmM * kGemmN; i += kBlock) {
      const int r = i / kGemmN;
      const int j = col0 + (i - r * kGemmN);
      if (j < d_model) out[(size_t)(row0 + r) * d_model + j] = __float2bfloat16(0.f);
    }
    return;
  }
  for (int i = threadIdx.x; i < kGemmM; i += kBlock)
    hs[i] = fmaxf(absmax[row0 + i], 1e-8f) * (1.f / 127.f);
  __syncthreads();
  block_gemm_i8<true>(hidden + (size_t)row0 * inter, inter, kGemmM, hs,
                      w2 + (size_t)e * inter * d_model + col0, d_model,
                      min(kGemmN, d_model - col0), inter, sm);
  for (int i = threadIdx.x; i < kGemmM * kGemmN; i += kBlock) {
    const int r = i / kGemmN;
    const int j = col0 + (i - r * kGemmN);
    if (j < d_model)
      out[(size_t)(row0 + r) * d_model + j] =
          __float2bfloat16(__fmul_rn(__fmul_rn((float)sm.c[i], hs[r]), w2s[j]));
  }
}

}  // namespace

// The grouped MoE FFN over P expert-sorted rows (P a multiple of 128). H and
// I multiples of 16, pointers 16-byte aligned. hidden (P, I) and absmax
// (P, 1) are f32 scratch the caller allocates; absmax is zeroed here. act:
// 1 relu, 2 silu, else exact GELU. Returns cudaGetLastError().
extern "C" int apertis_expert_ffn_grouped(const void* xq, const void* xs, const void* emap,
                                          const void* w1q, const void* w1s, const void* b1,
                                          const void* w2q, const void* w2s, void* out,
                                          void* hidden, void* absmax, int rows, int d_model,
                                          int ei, int num_experts, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows % kGroupRows != 0 || num_experts <= 0 || ei % num_experts != 0 ||
      d_model % 16 != 0 || (ei / num_experts) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int inter = ei / num_experts;
  cudaError_t err = cudaMemsetAsync(absmax, 0, (size_t)rows * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_gemm1_kernel<<<dim3((inter + kGemmN - 1) / kGemmN, rows / kGemmM), kBlock, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int*>(emap), static_cast<const int8_t*>(w1q),
      static_cast<const float*>(w1s), static_cast<const float*>(b1),
      static_cast<float*>(hidden), static_cast<float*>(absmax), rows, d_model, ei, inter, act);
  moe_grouped_gemm2_kernel<<<dim3((d_model + kGemmN - 1) / kGemmN, rows / kGemmM), kBlock, 0,
                             s>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(absmax),
      static_cast<const int*>(emap), static_cast<const int8_t*>(w2q),
      static_cast<const float*>(w2s), static_cast<bf16*>(out), rows, d_model, inter);
  return static_cast<int>(cudaGetLastError());
}
