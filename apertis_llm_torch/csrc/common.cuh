// Device helpers shared by the port's hand-written Hopper kernels.
//
// Everything here is header-only and lives in an anonymous namespace, so each
// translation unit gets its own copy and the shared library exports only the
// extern "C" entry points of the .cu files.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// Threads per block of the row-tile kernels: 8 warps.
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
// Output columns per block of tile_matvec: each lane owns two of them.
constexpr int kTileN = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Round an f32 value through bf16 (round to nearest even), as `astype(bf16)`.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// The int8 level clip(rint(v), -127, 127) of a value already divided by its
// scale: rintf rounds half to even, as jnp.round does.
__device__ __forceinline__ int8_t quant_level(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
}

// Overflow-safe log(1 + e^x): above the knee it is x to f32 precision.
__device__ __forceinline__ float softplusf(float x) {
  return x > 20.f ? x : logf(1.f + expf(fminf(x, 20.f)));
}

// Activation by code: 1 relu, 2 silu, anything else exact-erf GELU.
__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return fmaxf(x, 0.f);
  if (act == 2) return x * sigmoidf(x);
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// Pre-norm of one row of `d` f32 values, computed by one warp in place:
// RMSNorm (eps on the RMS, zero inverse on all-zero rows) when `rms`, else
// LayerNorm (zero inverse on constant rows). `bias` is unused for RMSNorm.
// When `round_out`, the result is rounded through bf16.
__device__ void warp_norm_row(float* x, int d, const bf16* __restrict__ weight,
                              const bf16* __restrict__ bias, int rms, float eps,
                              bool round_out) {
  const int lane = threadIdx.x & 31;
  if (rms) {
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) ss += x[k] * x[k];
    ss = warp_sum(ss);
    const float r = (ss > 0.f ? sqrtf(ss) : 0.f) * rsqrtf((float)d);
    const float inv = ss > 0.f ? 1.f / (r + eps) : 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = x[k] * inv * to_f32(weight[k]);
      x[k] = round_out ? round_bf16(v) : v;
    }
    return;
  }
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += x[k];
  const float mean = warp_sum(s) / (float)d;
  float v2 = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float c = x[k] - mean;
    v2 += c * c;
  }
  const float var = warp_sum(v2) / (float)d;
  const float inv = var > 0.f ? rsqrtf(var + eps) : 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = (x[k] - mean) * inv * to_f32(weight[k]) + to_f32(bias[k]);
    x[k] = round_out ? round_bf16(v) : v;
  }
}

// Row-tile matrix-vector products against a bf16 (in, out) weight:
//   out[r * kTileN + j] = sum_k xs[r * ldx + k] * W[k * ldw + col0 + j]
// for r < RB and j < kTileN, with columns at or past `ncols` left 0.
//
// The eight warps split the K axis; each lane owns columns col0 + lane and
// col0 + 32 + lane, so a warp reads two 64-byte runs of one weight row per
// step and the reads coalesce in the weight's natural layout. `xs` is in
// shared memory and every lane of a warp reads the same element (a
// broadcast). Partial sums go through `red` (kWarps * RB * kTileN floats) and
// are added in warp order, so the result is the same from run to run.
// Must be called by all kBlock threads of the block; ends synchronised.
template <int RB>
__device__ void tile_matvec(const float* xs, int ldx, const bf16* __restrict__ w,
                            int ldw, int k_total, int col0, int ncols, float* red,
                            float* out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kper = (k_total + kWarps - 1) / kWarps;
  const int k0 = warp * kper;
  const int k1 = min(k_total, k0 + kper);
  const int ja = col0 + lane;
  const int jb = col0 + 32 + lane;
  const bool va = ja < ncols;
  const bool vb = jb < ncols;
  float acc_a[RB], acc_b[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    acc_a[r] = 0.f;
    acc_b[r] = 0.f;
  }
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const bf16* wr = w + (size_t)k * ldw;
    const float wa = va ? to_f32(wr[ja]) : 0.f;
    const float wb = vb ? to_f32(wr[jb]) : 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float xv = xs[r * ldx + k];
      acc_a[r] = fmaf(xv, wa, acc_a[r]);
      acc_b[r] = fmaf(xv, wb, acc_b[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    red[(warp * RB + r) * kTileN + lane] = acc_a[r];
    red[(warp * RB + r) * kTileN + 32 + lane] = acc_b[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RB * kTileN; i += kBlock) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * RB * kTileN + i];
    out[i] = s;
  }
  __syncthreads();
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
