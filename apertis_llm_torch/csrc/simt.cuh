// SIMT building blocks of the decode kernels' f32 forms (ssm_step.cu,
// ffn_fused.cu): the forms that serve a tree the Hopper products do not take,
// an f32 tree (float weights, or int8 weights beside f32 norms, biases and
// activations), or one whose tensors mix f32 and bf16.
//
// Each float operand carries a dtype code, 0 for f32 and 1 for bf16, so one
// instance serves every mix of the two. Every sum is an f32 FMA chain (no
// TF32: these are f32 products), int8 products sum exactly in int32.
//
// Bound on the H100: bytes. At decode batch sizes a product reads its weight
// once per row tile for 2 operations a weight and row; an f32 weight holds
// twice the bytes of the bf16 layout's. These forms are simple and correct
// first: a block of 32 columns and kSimtSlices warps, each warp one slice of
// K, so a warp's 32 lanes read 32 consecutive weights of one row (128 bytes
// in f32) and share the input value of that row (a broadcast), and each
// thread holds 1, 4 or 16 rows' sums; the warps' partial sums are added in
// warp order in shared memory, so results repeat from run to run.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSimtSlices = 16;                 // warps a block: slices of K
constexpr int kSimtThreads = 32 * kSimtSlices;

// Element i of a float tensor of dtype code bf (1 bf16, 0 f32), as f32.
__device__ __forceinline__ float ldv(const void* p, size_t i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// Store v as element i of a float tensor of dtype code bf.
__device__ __forceinline__ void stv(void* p, size_t i, float v, int bf) {
  if (bf) {
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Block sum or max of one value a thread over a block of nwarps warps, in
// every thread: the warps' results in warp order. `red` holds nwarps floats.
__device__ __forceinline__ float simt_reduce(float v, float* red, int nwarps, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < nwarps; ++w) t = is_max ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

// Per-row int8 of the n f32 values v of a row in shared memory (any of the
// block's threads wrote them), ssm_step.py:39-43: s = max(absmax, 1e-8) *
// (1/127), q = rint(v * (1/s)); `div` divides by s instead (the FFN
// kernel's tile requantization, ffn_fused.py:96).
__device__ __forceinline__ void simt_quant_row(const float* v, int n, float* red, int nwarps,
                                               int8_t* q, float* scale, bool div = false) {
  float m = 0.f;
  for (int k = threadIdx.x; k < n; k += 32 * nwarps) m = fmaxf(m, fabsf(v[k]));
  const float s = fmaxf(simt_reduce(m, red, nwarps, true), 1e-8f) * (1.f / 127.f);
  const float inv = 1.f / s;
  for (int k = threadIdx.x; k < n; k += 32 * nwarps)
    q[k] = quant_level(div ? __fdiv_rn(v[k], s) : __fmul_rn(v[k], inv));
  if (threadIdx.x == 0) *scale = s;
}

// The partial sums of one thread: its rows' products over its slice of K.
// The dtype branches are hoisted out of the loop (AT, WT), so the compiler
// can issue several iterations' loads before their products.
template <bool Q, int RT, typename AT, typename WT>
__device__ __forceinline__ void simt_partial(const void* a_, int lda, const void* w_, int ldw,
                                             int K, int n, int r0, int rows, int slice,
                                             float (&facc)[RT], int (&iacc)[RT]) {
  const AT* a = static_cast<const AT*>(a_);
  const WT* w = static_cast<const WT*>(w_);
#pragma unroll 4
  for (int k = slice; k < K; k += kSimtSlices) {
    if constexpr (Q) {
      const int wv = w[(size_t)k * ldw + n];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r < rows) iacc[r] += wv * (int)a[(size_t)(r0 + r) * lda + k];
    } else {
      const float wv = to_f32(w[(size_t)k * ldw + n]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < rows) {
          float av = to_f32(a[(size_t)(r0 + r) * lda + k]);
          if constexpr (std::is_same<WT, bf16>::value) av = round_bf16(av);
          facc[r] = fmaf(av, wv, facc[r]);
        }
      }
    }
  }
}

// The row product of one decode stage, for rows r < B and columns n < N:
//   float weights (Q false): acc = sum_k a'[r, k] * W[k, n] in f32, with a'
//     the input rounded to W's dtype (x.astype(w.dtype));
//   int8 weights (Q true): acc = f32(int32 sum_k a_q[r, k] * W_q[k, n]) *
//     a_s[r] * w_s[n];
// then v = acc + bias[n] (if bias), activate(v) (if act >= 0), resid[r, n] +
// v (if resid), stored in out's dtype and, if out2, in out2's too. A block
// takes RT rows.
template <bool Q, int RT>
__global__ void __launch_bounds__(kSimtThreads) simt_rowmat_kernel(
    const void* __restrict__ a, int abf, const float* __restrict__ a_s, int lda,
    const void* __restrict__ w, int wbf, const float* __restrict__ w_s, int ldw,
    int B, int K, int N,
    const void* __restrict__ bias, int bbf, int act,
    const void* __restrict__ resid, int rbf, int ldr,
    void* __restrict__ out, int obf, int ldo, void* __restrict__ out2, int o2bf) {
  __shared__ float part[kSimtSlices][RT][32];    // f32 sums, or int32 sums' bits
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * RT;
  const bool col = n < N;
  const int rows = min(RT, B - r0);
  float facc[RT];
  int iacc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    facc[r] = 0.f;
    iacc[r] = 0;
  }
  if (col) {
    if constexpr (Q) {
      simt_partial<true, RT, int8_t, int8_t>(a, lda, w, ldw, K, n, r0, rows, slice, facc, iacc);
    } else if (wbf) {
      if (abf) {
        simt_partial<false, RT, bf16, bf16>(a, lda, w, ldw, K, n, r0, rows, slice, facc, iacc);
      } else {
        simt_partial<false, RT, float, bf16>(a, lda, w, ldw, K, n, r0, rows, slice, facc, iacc);
      }
    } else if (abf) {
      simt_partial<false, RT, bf16, float>(a, lda, w, ldw, K, n, r0, rows, slice, facc, iacc);
    } else {
      simt_partial<false, RT, float, float>(a, lda, w, ldw, K, n, r0, rows, slice, facc, iacc);
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) part[slice][r][lane] = Q ? __int_as_float(iacc[r]) : facc[r];
  __syncthreads();
  if (!col) return;
  for (int r = slice; r < rows; r += kSimtSlices) {   // warp `slice` finishes these rows
    float v;
    if constexpr (Q) {
      int t = 0;
      for (int s = 0; s < kSimtSlices; ++s) t += __float_as_int(part[s][r][lane]);
      v = __fmul_rn(__fmul_rn((float)t, a_s[r0 + r]), w_s[n]);
    } else {
      v = part[0][r][lane];
      for (int s = 1; s < kSimtSlices; ++s) v = __fadd_rn(v, part[s][r][lane]);
    }
    if (bias != nullptr) v = __fadd_rn(v, ldv(bias, n, bbf));
    if (act >= 0) v = activate(v, act);
    if (resid != nullptr) v = __fadd_rn(ldv(resid, (size_t)(r0 + r) * ldr + n, rbf), v);
    stv(out, (size_t)(r0 + r) * ldo + n, v, obf);
    if (out2 != nullptr) stv(out2, (size_t)(r0 + r) * ldo + n, v, o2bf);
  }
}

template <bool Q, int RT>
void simt_rowmat_launch(const void* a, int abf, const float* a_s, int lda, const void* w,
                        int wbf, const float* w_s, int ldw, int B, int K, int N,
                        const void* bias, int bbf, int act, const void* resid, int rbf, int ldr,
                        void* out, int obf, int ldo, void* out2, int o2bf, cudaStream_t stream) {
  const dim3 grid((N + 31) / 32, (B + RT - 1) / RT);
  simt_rowmat_kernel<Q, RT><<<grid, kSimtThreads, 0, stream>>>(
      a, abf, a_s, lda, w, wbf, w_s, ldw, B, K, N, bias, bbf, act, resid, rbf, ldr, out, obf,
      ldo, out2, o2bf);
}

// Launch simt_rowmat_kernel over B rows and N columns: one row a block for a
// single row, else 4, and 16 from 5 rows for float weights (each weight is
// read once per block row; on the H100, 16 rows sped the f32 products up at
// 64 rows and slowed the int8 ones).
template <bool Q>
cudaError_t simt_rowmat(const void* a, int abf, const float* a_s, int lda, const void* w, int wbf,
                        const float* w_s, int ldw, int B, int K, int N, const void* bias, int bbf,
                        int act, const void* resid, int rbf, int ldr, void* out, int obf, int ldo,
                        void* out2, int o2bf, cudaStream_t stream) {
  if (B <= 1) {
    simt_rowmat_launch<Q, 1>(a, abf, a_s, lda, w, wbf, w_s, ldw, B, K, N, bias, bbf, act, resid,
                             rbf, ldr, out, obf, ldo, out2, o2bf, stream);
  } else if (B <= 4 || Q) {
    simt_rowmat_launch<Q, 4>(a, abf, a_s, lda, w, wbf, w_s, ldw, B, K, N, bias, bbf, act, resid,
                             rbf, ldr, out, obf, ldo, out2, o2bf, stream);
  } else {
    simt_rowmat_launch<Q, 16>(a, abf, a_s, lda, w, wbf, w_s, ldw, B, K, N, bias, bbf, act, resid,
                              rbf, ldr, out, obf, ldo, out2, o2bf, stream);
  }
  return cudaGetLastError();
}

}  // namespace
