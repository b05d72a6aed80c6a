// ln_quantize: pre-norm fused with the per-row int8 quantization that the
// int8 projections after it consume (the int8 prefill's pre-norms, and the
// int8 ViT's ln1 / ln2).
//
// Replaces: apertis_llm_tpu/ops/pallas/ln_quant.py::ln_quantize.
//
// Semantics (ln_quant.py:32-57), per row of H values, in f32:
//   RMSNorm:   ss = sum x^2;  rms = sqrt(ss) * H^-1/2;  inv = 1 / (rms + eps)
//              (0 when ss == 0);  v = x * inv * w
//   LayerNorm: mean = sum x * (1/H);  var = sum (x - mean)^2 * (1/H);
//              inv = 1 / sqrt(var + eps) (0 when var == 0);
//              v = (x - mean) * inv * w + b
//   v is rounded through bf16 (the input dtype); s = max(max|v|, 1e-8) *
//   (1/127);  q = clip(rint(v / s), -127, 127)  (a true division here).
// Each row sum is taken as the plain version (ops/kernels/ln_quant.py) takes
// it: the f32 sums of VEC consecutive values, in order, added in f64 and
// rounded to f32 once. An f64 sum of at most 4,096 such parts moves by about
// 1e-16 of its terms with their order, which changes its f32 rounding with a
// probability of about 1e-6 a row, so the kernel's statistics, normed row,
// scale and levels equal the plain version's bit for bit, whatever the plan
// (summed in f32, a sum's order moved a row's largest normed value across a
// bf16 rounding boundary about once in 60,000 rows, and its scale by a bf16
// step). The multiplies and adds use the _rn intrinsics so that nvcc does
// not contract them into fused multiply-adds the plain version does not
// have; 1/H is 1.0 / H in double rounded to f32, as torch multiplies by a
// Python float.
//
// Bound on the H100: bytes. The kernel reads x once (bf16) and writes q
// (int8) and one f32 scale per row: at the 2048 x 2432 prefill of the 1.5B
// model 10 MB read and 5 MB written, about 4.5 us at 3.35 TB/s; at the int8
// ViT's 12,608 x 768 rows 29 MB, 8.7 us. A row's work is a chain of
// dependent phases (its loads, the mean, the variance, the normed row, the
// absmax, the levels), each ending in a reduction over the row's threads,
// and all of a wave's rows reach each phase together: what sets its time is
// that chain's latency, which the plan shortens by spreading a row over
// more threads, and the warps an SM holds (fewer instructions an element,
// and the norm's weight and bias prefetched into L1, each cost registers
// and blocks an SM and were slower on the card).
//
// Design for this card (not the TPU kernel's 256-row VMEM blocks): each row
// is spread over `tpr` threads (a power of two from 8 to 1024; a warp holds
// 32 / tpr rows when tpr < 32), and each thread keeps its share of the row in
// registers as f32: NV vectors of VEC bf16 values (16-byte loads where H is
// a multiple of 8, else 8, 4 or 2 bytes), vector j = t + i * tpr for thread
// t, so a warp's lanes read neighbouring 16-byte units. All NV loads are
// issued before the first use, and each vector's partial sums are
// independent of the others'. The statistics, the normed row (kept in the
// same registers), its absmax and the quantization then read registers only:
// the row is read from memory once and nothing is staged in shared memory,
// which holds only the cross-warp partial sums of a row wider than a warp
// (one __syncthreads a reduction). q goes out VEC bytes a lane (8 where H is
// a multiple of 8), the scale once a row. ops/kernels/ln_quant.py::ln_plan
// picks the plan (VEC, tpr, NV): few values a thread, and more threads a row
// where there are too few rows to fill the card.
//
// The f32 form (apertis_ln_quantize_f32, at the end of this file) takes the
// f32 rows of an f32 tree (int8 weights beside f32 norms and activations),
// which the TPU kernel takes as any dtype: the normed row is rounded to the
// input's dtype, so not at all. It is a simple SIMT kernel, one block of
// 256 threads a row, the row's statistics summed as the plain version sums
// them (each group of vec values in f32 in order, the groups in f64), the
// normed row held in shared memory for its absmax and levels.

#include <cmath>

#include "common.cuh"

namespace {

// Raw storage of VEC bf16 values, loaded and stored in one access.
template <int VEC> struct Raw;
template <> struct Raw<8> { typedef uint4 T; typedef uint2 Q; };
template <> struct Raw<4> { typedef uint2 T; typedef uint32_t Q; };
template <> struct Raw<2> { typedef uint32_t T; typedef uint16_t Q; };
template <> struct Raw<1> { typedef uint16_t T; typedef uint8_t Q; };

__device__ __forceinline__ void unpack2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void unpack(const typename Raw<VEC>::T& r, float* out) {
  if constexpr (VEC == 8) {
    unpack2(r.x, out); unpack2(r.y, out + 2); unpack2(r.z, out + 4); unpack2(r.w, out + 6);
  } else if constexpr (VEC == 4) {
    unpack2(r.x, out); unpack2(r.y, out + 2);
  } else if constexpr (VEC == 2) {
    unpack2(r, out);
  } else {
    out[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const bf16* p, float* out) {
  typename Raw<VEC>::T r = __ldg(reinterpret_cast<const typename Raw<VEC>::T*>(p));
  unpack<VEC>(r, out);
}

__device__ __forceinline__ uint32_t pack4(const int* l) {
  return (static_cast<uint32_t>(l[0]) & 0xffu) | ((static_cast<uint32_t>(l[1]) & 0xffu) << 8) |
         ((static_cast<uint32_t>(l[2]) & 0xffu) << 16) |
         (static_cast<uint32_t>(l[3]) << 24);
}

template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const int* l) {
  typedef typename Raw<VEC>::Q Q;
  Q out;
  if constexpr (VEC == 8) {
    out.x = pack4(l);
    out.y = pack4(l + 4);
  } else if constexpr (VEC == 4) {
    out = pack4(l);
  } else if constexpr (VEC == 2) {
    out = static_cast<uint16_t>((static_cast<uint32_t>(l[0]) & 0xffu) |
                                ((static_cast<uint32_t>(l[1]) & 0xffu) << 8));
  } else {
    out = static_cast<uint8_t>(l[0]);
  }
  *reinterpret_cast<Q*>(p) = out;
}

template <bool MAX, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (MAX) {
    return fmaxf(a, b);
  } else {
    return a + b;
  }
}

// The sum (or max) of v over the row's tpr threads: a butterfly over the
// row's lanes, then, for a row of several warps, the warps' partials in
// order through red (one slot a warp of the block).
template <bool MAX, typename T>
__device__ __forceinline__ T row_reduce(T v, int tpr, T* red) {
  const int lanes = tpr < 32 ? tpr : 32;
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v = combine<MAX>(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = warp & ~((tpr >> 5) - 1);
  T r = red[first];
  for (int k = 1; k < (tpr >> 5); ++k) r = combine<MAX>(r, red[first + k]);
  return r;
}

// The row sum of f(v) as the plain version takes it: each vector's VEC
// values summed in f32 in order, the vectors' sums in f64, rounded to f32.
template <int VEC, int NV, typename F>
__device__ __forceinline__ float row_sum(const float (&v)[NV][VEC], int t, int tpr, int units,
                                         double* red, F f) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (t + i * tpr < units) {
      float p = f(v[i][0]);
#pragma unroll
      for (int e = 1; e < VEC; ++e) p = __fadd_rn(p, f(v[i][e]));
      acc += static_cast<double>(p);
    }
  }
  return __double2float_rn(row_reduce<false>(acc, tpr, red));
}

template <int VEC, int NV, int MAXT>
__global__ void __launch_bounds__(MAXT) ln_quant_kernel(
    const bf16* __restrict__ x,   // (M, H)
    const bf16* __restrict__ w,   // (H,) LayerNorm weight or RMSNorm scale
    const bf16* __restrict__ b,   // (H,) LayerNorm bias; unused for RMSNorm
    int8_t* __restrict__ q,       // (M, H)
    float* __restrict__ scale,    // (M, 1)
    int rows, int h, int tpr, int rms, float eps, float inv_h, float inv_sqrt_h) {
  __shared__ double red[2][32];
  __shared__ float red_max[32];
  const int units = h / VEC;                 // vectors a row
  const int t = threadIdx.x & (tpr - 1);     // this thread's place in its row
  const int row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const bf16* xr = x + (size_t)row * h;

  float v[NV][VEC];
  {
    typename Raw<VEC>::T raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * tpr;
      if (live && j < units) raw[i] = __ldg(reinterpret_cast<const typename Raw<VEC>::T*>(xr) + j);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * tpr;
      if (live && j < units) {
        unpack<VEC>(raw[i], v[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
      }
    }
  }

  float inv;
  if (rms) {
    const float ss = row_sum(v, t, tpr, units, red[0], [](float a) { return __fmul_rn(a, a); });
    const float r = __fmul_rn(ss > 0.f ? sqrtf(ss) : 0.f, inv_sqrt_h);
    inv = ss > 0.f ? 1.f / __fadd_rn(r, eps) : 0.f;
  } else {
    const float mean =
        __fmul_rn(row_sum(v, t, tpr, units, red[0], [](float a) { return a; }), inv_h);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = __fsub_rn(v[i][e], mean);   // x - mean
    const float var = __fmul_rn(
        row_sum(v, t, tpr, units, red[1], [](float c) { return __fmul_rn(c, c); }), inv_h);
    inv = var > 0.f ? 1.f / sqrtf(__fadd_rn(var, eps)) : 0.f;
  }

  // The normed row, rounded through bf16, in place; its absmax.
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * tpr;
    if (j < units) {
      float wv[VEC], bv[VEC];
      load_f32<VEC>(w + (size_t)j * VEC, wv);
      if (!rms) load_f32<VEC>(b + (size_t)j * VEC, bv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float c = __fmul_rn(__fmul_rn(v[i][e], inv), wv[e]);
        if (!rms) c = __fadd_rn(c, bv[e]);
        v[i][e] = round_bf16(c);
        m = fmaxf(m, fabsf(v[i][e]));
      }
    }
  }
  const float s = fmaxf(row_reduce<true>(m, tpr, red_max), 1e-8f) * (1.f / 127.f);

  if (!live) return;
  int8_t* qr = q + (size_t)row * h;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * tpr;
    if (j < units) {
      int l[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) l[e] = quant_level(__fdiv_rn(v[i][e], s));
      store_q<VEC>(qr + (size_t)j * VEC, l);
    }
  }
  if (t == 0) scale[row] = s;
}

typedef void (*LnKernel)(const bf16*, const bf16*, const bf16*, int8_t*, float*, int, int, int,
                         int, float, float, float);

// The instances ln_plan picks from: 16-byte vectors with 1-5 of them a
// thread in blocks of up to 256 threads, and 4 a thread in blocks of up to
// 1024; narrower vectors (H not a multiple of 8) 4 or 8 a thread in blocks
// of up to 1024.
LnKernel pick(int vec, int nv, int block) {
  if (vec == 8 && block <= 256) {
    switch (nv) {
      case 1: return ln_quant_kernel<8, 1, 256>;
      case 2: return ln_quant_kernel<8, 2, 256>;
      case 3: return ln_quant_kernel<8, 3, 256>;
      case 4: return ln_quant_kernel<8, 4, 256>;
      case 5: return ln_quant_kernel<8, 5, 256>;
      default: return nullptr;
    }
  }
  if (vec == 8) return nv == 4 ? ln_quant_kernel<8, 4, 1024> : nullptr;
  if (nv != 4 && nv != 8) return nullptr;
  switch (vec) {
    case 4: return nv == 4 ? ln_quant_kernel<4, 4, 1024> : ln_quant_kernel<4, 8, 1024>;
    case 2: return nv == 4 ? ln_quant_kernel<2, 4, 1024> : ln_quant_kernel<2, 8, 1024>;
    case 1: return nv == 4 ? ln_quant_kernel<1, 4, 1024> : ln_quant_kernel<1, 8, 1024>;
    default: return nullptr;
  }
}

int block_of(int tpr) { return tpr < 256 ? 256 : tpr; }

}  // namespace

// Norm + quantize of `rows` rows of `h` bf16 values on the plan (vec, tpr,
// nv) of ln_quant.py::ln_plan; rms != 0 selects RMSNorm (b unused, may be
// null). x, w and b must be aligned to 2 * vec bytes, vec the widest of 8, 4,
// 2 and 1 that divides h (the plain version's sums take vec values at a
// time). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not cover the row.
extern "C" int apertis_ln_quantize(const void* x, const void* w, const void* b, void* q,
                                   void* scale, int rows, int h, int vec, int tpr, int nv,
                                   int rms, float eps, void* stream) {
  const LnKernel kernel = pick(vec, nv, block_of(tpr));
  const int group = h % 8 == 0 ? 8 : h % 4 == 0 ? 4 : h % 2 == 0 ? 2 : 1;
  if (kernel == nullptr || rows <= 0 || h <= 0 || vec != group || tpr < 8 || tpr > 1024 ||
      (tpr & (tpr - 1)) || (long long)tpr * nv * vec < h ||
      reinterpret_cast<uintptr_t>(x) % (2 * vec) || reinterpret_cast<uintptr_t>(w) % (2 * vec) ||
      (b != nullptr && reinterpret_cast<uintptr_t>(b) % (2 * vec)) ||
      reinterpret_cast<uintptr_t>(q) % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  // 1/H and H^-1/2 as Python computes them, rounded to f32 as torch rounds a
  // Python float that multiplies an f32 tensor.
  const float inv_h = static_cast<float>(1.0 / h);
  const float inv_sqrt_h = static_cast<float>(std::pow(static_cast<double>(h), -0.5));
  const int block = block_of(tpr);
  const int per_block = block / tpr;
  kernel<<<(rows + per_block - 1) / per_block, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<int8_t*>(q), static_cast<float*>(scale), rows, h, tpr, rms, eps, inv_h,
      inv_sqrt_h);
  return static_cast<int>(cudaGetLastError());
}

// What the card gives the plan's kernel: registers a thread, shared memory a
// block, resident blocks an SM, threads a block and spilled bytes a thread,
// into out[0..4].
extern "C" int apertis_ln_quantize_resources(int vec, int tpr, int nv, int* out) {
  const LnKernel kernel = pick(vec, nv, block_of(tpr));
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block_of(tpr), 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = blocks;
  out[3] = block_of(tpr);
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}


// ---- the f32 form -------------------------------------------------------------

namespace {

constexpr int kLnF32Threads = 256;

// The block's sum of one double a thread, in every thread.
__device__ __forceinline__ double ln_block_sum(double v, double* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = red[0];
  for (int w = 1; w < kLnF32Threads / 32; ++w) t += red[w];
  return t;
}

// The plain version's row sum of f(v) over the row in shared memory: each
// group of g values summed in f32 in order, the groups' sums in f64,
// rounded to f32.
template <typename F>
__device__ __forceinline__ float ln_row_sum(const float* v, int h, int g, double* red, F f) {
  double acc = 0.0;
  for (int j = threadIdx.x; j < h / g; j += kLnF32Threads) {
    float p = f(v[j * g]);
    for (int e = 1; e < g; ++e) p = __fadd_rn(p, f(v[j * g + e]));
    acc += static_cast<double>(p);
  }
  return __double2float_rn(ln_block_sum(acc, red));
}

__global__ void __launch_bounds__(kLnF32Threads) ln_quant_f32_kernel(
    const float* __restrict__ x, const void* __restrict__ w, const void* __restrict__ b,
    int pbf, int8_t* __restrict__ q, float* __restrict__ scale, int h, int g, int rms,
    float eps, float inv_h, float inv_sqrt_h) {
  extern __shared__ float v[];
  __shared__ double red[kLnF32Threads / 32];
  __shared__ float red_max[kLnF32Threads / 32];
  const size_t row = blockIdx.x;
  auto param = [pbf](const void* p, int k) {
    return pbf ? __bfloat162float(static_cast<const bf16*>(p)[k])
               : static_cast<const float*>(p)[k];
  };
  for (int k = threadIdx.x; k < h; k += kLnF32Threads) v[k] = x[row * h + k];
  __syncthreads();
  float inv;
  if (rms) {
    const float ss = ln_row_sum(v, h, g, red, [](float a) { return __fmul_rn(a, a); });
    const float r = __fmul_rn(ss > 0.f ? sqrtf(ss) : 0.f, inv_sqrt_h);
    inv = ss > 0.f ? 1.f / __fadd_rn(r, eps) : 0.f;
  } else {
    const float mean = __fmul_rn(ln_row_sum(v, h, g, red, [](float a) { return a; }), inv_h);
    __syncthreads();
    for (int k = threadIdx.x; k < h; k += kLnF32Threads) v[k] = __fsub_rn(v[k], mean);
    __syncthreads();
    const float var =
        __fmul_rn(ln_row_sum(v, h, g, red, [](float c) { return __fmul_rn(c, c); }), inv_h);
    inv = var > 0.f ? 1.f / sqrtf(__fadd_rn(var, eps)) : 0.f;
  }
  float m = 0.f;
  __syncthreads();
  for (int k = threadIdx.x; k < h; k += kLnF32Threads) {
    float c = __fmul_rn(__fmul_rn(v[k], inv), param(w, k));
    if (!rms) c = __fadd_rn(c, param(b, k));
    v[k] = c;
    m = fmaxf(m, fabsf(c));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float s = red_max[0];
  for (int i = 1; i < kLnF32Threads / 32; ++i) s = fmaxf(s, red_max[i]);
  s = fmaxf(s, 1e-8f) * (1.f / 127.f);
  for (int k = threadIdx.x; k < h; k += kLnF32Threads)
    q[row * h + k] = quant_level(__fdiv_rn(v[k], s));
  if (threadIdx.x == 0) scale[row] = s;
}

}  // namespace

// Norm + quantize of `rows` rows of `h` f32 values, the norm's weight and
// bias of dtype code pbf (1 bf16, 0 f32); rms != 0 selects RMSNorm (b
// unused). Returns cudaGetLastError().
extern "C" int apertis_ln_quantize_f32(const void* x, const void* w, const void* b, void* q,
                                       void* scale, int rows, int h, int pbf, int rms, float eps,
                                       void* stream) {
  if (rows <= 0 || h <= 0 || (size_t)h * sizeof(float) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = h % 8 == 0 ? 8 : h % 4 == 0 ? 4 : h % 2 == 0 ? 2 : 1;
  const float inv_h = static_cast<float>(1.0 / h);
  const float inv_sqrt_h = static_cast<float>(std::pow(static_cast<double>(h), -0.5));
  const size_t smem = (size_t)h * sizeof(float);
  cudaError_t err = allow_smem(ln_quant_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_quant_f32_kernel<<<rows, kLnF32Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), w, b, pbf, static_cast<int8_t*>(q),
      static_cast<float*>(scale), h, g, rms, eps, inv_h, inv_sqrt_h);
  return static_cast<int>(cudaGetLastError());
}
