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

// Threads per block of the row kernels: 8 warps.
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;

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

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
