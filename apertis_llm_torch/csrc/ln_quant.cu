// ln_quantize: pre-norm fused with the per-row int8 quantization that the
// int8 projections after it consume (the int8 prefill's two pre-norms per
// layer).
//
// Replaces: apertis_llm_tpu/ops/pallas/ln_quant.py::ln_quantize.
//
// Semantics (ln_quant.py:32-57), per row of H values, in f32:
//   RMSNorm:   ss = sum x^2;  rms = sqrt(ss) * H^-1/2;  inv = 1 / (rms + eps)
//              (0 when ss == 0);  v = x * inv * w
//   LayerNorm: mean = sum x / H;  var = sum (x - mean)^2 / H;
//              inv = 1 / sqrt(var + eps) (0 when var == 0);
//              v = (x - mean) * inv * w + b
//   v is rounded through bf16 (the input dtype); s = max(max|v|, 1e-8) *
//   (1/127);  q = clip(rint(v / s), -127, 127)  (a true division here).
// The multiplies and adds use the _rn intrinsics so that nvcc does not
// contract them into fused multiply-adds the reference does not have.
//
// Bound on the H100: bytes. The kernel reads x once (bf16) and writes q
// (int8) and one f32 scale per row: at the 2048 x 2432 prefill of the 1.5B
// model 10 MB read and 5 MB written, about 4.5 us at 3.35 TB/s. Its FLOPs
// (about 10 per element) are negligible.
//
// Design: one warp per row, eight rows per block of 256 threads. The row is
// staged once into shared memory as f32; every lane then reads back only the
// elements it wrote (k = lane, lane + 32, ...), so the statistics, the
// normed row, its absmax and the quantization need no barrier beyond the
// warp reductions. The TPU kernel's 256-row VMEM blocks and row padding have
// no counterpart: a warp handles a ragged last row like any other.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kRows = 8;  // rows per block, one warp each

__global__ void __launch_bounds__(kBlock) ln_quant_kernel(
    const bf16* __restrict__ x,   // (M, H)
    const bf16* __restrict__ w,   // (H,) LayerNorm weight or RMSNorm scale
    const bf16* __restrict__ b,   // (H,) LayerNorm bias; unused for RMSNorm
    int8_t* __restrict__ q,       // (M, H)
    float* __restrict__ scale,    // (M, 1)
    int rows, int h, int rms, float eps, float inv_sqrt_h) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + warp;
  if (row >= rows) return;
  float* v = smem + (size_t)warp * h;
  const bf16* xr = x + (size_t)row * h;
  for (int k = lane; k < h; k += 32) v[k] = to_f32(xr[k]);

  if (rms) {
    float ss = 0.f;
    for (int k = lane; k < h; k += 32) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
    ss = warp_sum(ss);
    const float r = __fmul_rn(ss > 0.f ? sqrtf(ss) : 0.f, inv_sqrt_h);
    const float inv = ss > 0.f ? 1.f / __fadd_rn(r, eps) : 0.f;
    for (int k = lane; k < h; k += 32)
      v[k] = round_bf16(__fmul_rn(__fmul_rn(v[k], inv), to_f32(w[k])));
  } else {
    float s = 0.f;
    for (int k = lane; k < h; k += 32) s = __fadd_rn(s, v[k]);
    const float mean = warp_sum(s) / (float)h;
    float v2 = 0.f;
    for (int k = lane; k < h; k += 32) {
      const float c = __fsub_rn(v[k], mean);
      v2 = __fadd_rn(v2, __fmul_rn(c, c));
    }
    const float var = warp_sum(v2) / (float)h;
    const float inv = var > 0.f ? 1.f / sqrtf(__fadd_rn(var, eps)) : 0.f;
    for (int k = lane; k < h; k += 32) {
      const float c = __fmul_rn(__fmul_rn(__fsub_rn(v[k], mean), inv), to_f32(w[k]));
      v[k] = round_bf16(__fadd_rn(c, to_f32(b[k])));
    }
  }

  float m = 0.f;
  for (int k = lane; k < h; k += 32) m = fmaxf(m, fabsf(v[k]));
  const float s = fmaxf(warp_max(m), 1e-8f) * (1.f / 127.f);
  int8_t* qr = q + (size_t)row * h;
  for (int k = lane; k < h; k += 32) qr[k] = quant_level(__fdiv_rn(v[k], s));
  if (lane == 0) scale[row] = s;
}

}  // namespace

// Norm + quantize of `rows` rows of `h` bf16 values; rms != 0 selects
// RMSNorm (b unused, may be null). Shared memory is 8 * h floats, so h is at
// most 7,264. Returns cudaGetLastError().
extern "C" int apertis_ln_quantize(const void* x, const void* w, const void* b, void* q,
                                   void* scale, int rows, int h, int rms, float eps,
                                   void* stream) {
  const size_t smem = (size_t)kRows * h * sizeof(float);
  if (rows <= 0 || h <= 0 || smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ln_quant_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // H^-1/2 as Python's h ** -0.5 gives it, rounded to f32.
  const float inv_sqrt_h = (float)std::pow((double)h, -0.5);
  ln_quant_kernel<<<(rows + kRows - 1) / kRows, kBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<int8_t*>(q), static_cast<float*>(scale),
      rows, h, rms, eps, inv_sqrt_h);
  return static_cast<int>(cudaGetLastError());
}
