// mha_decode_ctx: decode attention of one query per row over one layer of
// the flat KV cache, plus the fresh token's self-term.
//
// Replaces: apertis_llm_tpu/ops/pallas/mha_step.py::mha_decode_ctx, with a
// bf16 cache (apertis_mha_decode_ctx) and an int8 cache with f32
// per-(head, slot) scales (apertis_mha_decode_ctx_int8), and their f32
// forms (apertis_mha_decode_ctx_f32: f32 q, k_new, v_new and output over an
// f32 cache, or over an int8 cache with its scales), which the TPU kernel
// serves by taking the cache as it is (mha_step.py:131) and writing q's
// dtype. The f32 forms are the same kernel instantiated on f32: q is scaled
// without a rounding, a 16-byte load of the cache holds 4 values instead of
// 8, and the output is f32.
//
// Layout: q, k_new, v_new (B, D) bf16 with D = H * Dh; the cache k, v
// (B, L, D), slot l of row b holding the head-flat projection row, so one
// head of one slot is Dh contiguous values; bias (B, L) f32 additive (0 or
// -1e30); the int8 scales ks, vs (B, H, L).
//
// Semantics (mha_step.py:54-127, 146-215), per row b and head h, in f32:
//   qs = bf16(q * Dh^-1/2)                       (rounded back to q's type)
//   s_self = sum_d qs * k_new
//   bf16:  s_l = sum_d qs * k[l]
//   int8:  qscale = max(max|qs|, 1e-8) * (1/127); qi = clip(rint(qs / qscale))
//          s_l = f32(int32 sum_d qi * k[l]) * (ks[l] * qscale)
//   s_l += bias[l];  m = max(max_l s_l, s_self)
//   p_l = exp(s_l - m);  p_self = exp(s_self - m);  denom = sum p_l + p_self
//   int8:  p_l *= vs[l]
//   out = bf16((sum_l p_l * v[l] + p_self * v_new) * (1 / denom))
// The masked stale slot still gets a score, but its p is exactly 0.
//
// Bound on the H100: bytes. Every score reads a whole K head of one slot and
// the context a whole V head, so the kernel streams the layer's cache once:
// 2 * B * L * D bytes in bf16 (59.8 MB at B = 64, L = 96 of the 1.5B model,
// 17.8 us at 3.35 TB/s), half that plus the scales in int8. Its FLOPs (4 per
// cached element) are far below the tensor-core line.
//
// Design: one block of four warps per (row, head), the TPU kernel's grid of
// B rows times its all-heads-in-one-dot segment matrices turned into B * H
// independent blocks (152 at B = 4, 2432 at B = 64). Pass 1 gives each thread
// whole slots: it reads the slot's K head with 16-byte loads (128 B in bf16,
// 64 B in int8) and dots it with the scaled q held in shared memory (the int8
// q as packed words for __dp4a, an exact int32 sum), keeping the scores in
// shared memory (L floats). A block max, then pass 2 turns the scores into
// probabilities in place and sums them. Pass 3 gives each warp every fourth
// slot and each lane Dh / 32 consecutive values of the V head, so a warp reads
// one slot's V head in one coalesced load; the four warps' partial contexts
// are added in warp order through shared memory, so results repeat from run
// to run. Shared memory is L + 5 Dh + 16 floats, at most 227 KB (L up to about
// 56,000 slots).

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsHere = kThreads / 32;

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <int BYTES> struct Raw;
template <> struct Raw<1> { typedef uint8_t T; };
template <> struct Raw<2> { typedef uint16_t T; };
template <> struct Raw<4> { typedef uint32_t T; };
template <> struct Raw<8> { typedef uint2 T; };
template <> struct Raw<16> { typedef uint4 T; };

// E consecutive values at p, as floats, in loads of the largest power of two
// bytes (up to 16) that divides their total size; p is aligned to it (lane
// l's values start at byte l * E * sizeof(V) of a 32-byte-aligned head).
// Dh 32, 64, 128, 256: one load; Dh 96, 160, 192, 224 (E = 3, 5, 6, 7): E or
// E / 2 narrower ones.
template <int E, typename V>
__device__ __forceinline__ void load_vals(const V* p, float (&out)[E]) {
  constexpr int kBytes = sizeof(V) * E;
  constexpr int kUnit = (kBytes & -kBytes) > 16 ? 16 : (kBytes & -kBytes);
  typedef typename Raw<kUnit>::T R;
  R r[kBytes / kUnit];
#pragma unroll
  for (int i = 0; i < kBytes / kUnit; ++i) r[i] = reinterpret_cast<const R*>(p)[i];
  const V* vals = reinterpret_cast<const V*>(r);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f32(vals[e]);
}

// Block-wide max or sum of one value per thread; `red` holds kWarpsHere
// floats. Ends synchronised.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarpsHere; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// q's value rounded to q's dtype T (bf16), or as it is (f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, bf16>::value) {
    return round_bf16(v);
  } else {
    return v;
  }
}

template <int DH, bool QUANT, typename T>
__global__ void __launch_bounds__(kThreads) mha_decode_kernel(
    const T* __restrict__ q, const void* __restrict__ kc, const void* __restrict__ vc,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const float* __restrict__ bias, const float* __restrict__ ks,
    const float* __restrict__ vs, T* __restrict__ out, int L, int H, float scale) {
  typedef typename std::conditional<QUANT, int8_t, T>::type CacheT;
  constexpr int kPer = 16 / sizeof(CacheT);   // cache values a 16-byte load
  constexpr int E = DH / 32;  // values of the head per lane in the context pass
  extern __shared__ float smem[];
  float* sq = smem;                          // DH: the scaled q (T's values)
  float* part = sq + DH;                     // kWarpsHere * DH: context partials
  float* red = part + kWarpsHere * DH;       // 8: block reductions
  float* scal = red + 8;                     // 8: s_self, qscale
  int8_t* sqi = reinterpret_cast<int8_t*>(scal + 8);   // DH: int8 q
  float* sp = scal + 8 + DH / 4;             // L: scores, then probabilities

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int d_model = H * DH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t head0 = (size_t)b * d_model + (size_t)h * DH;
  const CacheT* kh = static_cast<const CacheT*>(kc) + (size_t)b * L * d_model + (size_t)h * DH;
  const CacheT* vh = static_cast<const CacheT*>(vc) + (size_t)b * L * d_model + (size_t)h * DH;
  const float* brow = bias + (size_t)b * L;
  const size_t srow = ((size_t)b * H + h) * L;   // row of ks / vs

  // The scaled q, the self-term score and (int8) the quantized q.
  if (warp == 0) {
    float self = 0.f, amax = 0.f;
    for (int d = lane; d < DH; d += 32) {
      const float v = round_to<T>(__fmul_rn(to_f32(q[head0 + d]), scale));
      sq[d] = v;
      self = __fadd_rn(self, __fmul_rn(v, to_f32(k_new[head0 + d])));
      amax = fmaxf(amax, fabsf(v));
    }
    self = warp_sum(self);
    if constexpr (QUANT) {
      const float qs = fmaxf(warp_max(amax), 1e-8f) * (1.f / 127.f);
      for (int d = lane; d < DH; d += 32) sqi[d] = quant_level(__fdiv_rn(sq[d], qs));
      if (lane == 0) scal[1] = qs;
    }
    if (lane == 0) scal[0] = self;
  }
  __syncthreads();
  const float s_self = scal[0];

  // Pass 1: one slot per thread, its whole K head.
  float tmax = -INFINITY;
  for (int l = tid; l < L; l += kThreads) {
    const uint4* krow = reinterpret_cast<const uint4*>(kh + (size_t)l * d_model);
    float s;
    if constexpr (QUANT) {
      const int* qw = reinterpret_cast<const int*>(sqi);
      int acc = 0;
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        const uint4 w = krow[j];
        acc = __dp4a((int)w.x, qw[4 * j + 0], acc);
        acc = __dp4a((int)w.y, qw[4 * j + 1], acc);
        acc = __dp4a((int)w.z, qw[4 * j + 2], acc);
        acc = __dp4a((int)w.w, qw[4 * j + 3], acc);
      }
      s = __fmul_rn((float)acc, __fmul_rn(ks[srow + l], scal[1]));
    } else {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < DH / kPer; ++j) {
        const uint4 w = krow[j];
        const CacheT* kv = reinterpret_cast<const CacheT*>(&w);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc = fmaf(sq[kPer * j + e], to_f32(kv[e]), acc);
      }
      s = acc;
    }
    s = __fadd_rn(s, brow[l]);
    sp[l] = s;
    tmax = fmaxf(tmax, s);
  }
  const float m = fmaxf(block_reduce<true>(tmax, red), s_self);

  // Pass 2: probabilities in place, their sum; int8 folds the V scales in.
  float tsum = 0.f;
  for (int l = tid; l < L; l += kThreads) {
    const float p = expf(sp[l] - m);
    tsum += p;
    if constexpr (QUANT) {
      sp[l] = __fmul_rn(p, vs[srow + l]);
    } else {
      sp[l] = p;
    }
  }
  const float p_self = expf(s_self - m);
  const float denom = block_reduce<false>(tsum, red) + p_self;

  // Pass 3: warp w takes slots w, w + 4, ...; lane holds E values of the head.
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int l = warp; l < L; l += kWarpsHere) {
    float v[E];
    load_vals<E>(vh + (size_t)l * d_model + lane * E, v);
    const float p = sp[l];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(p, v[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) part[warp * DH + lane * E + e] = acc[e];
  __syncthreads();
  const float inv = 1.f / denom;
  for (int d = tid; d < DH; d += kThreads) {
    float c = part[d];
#pragma unroll
    for (int w = 1; w < kWarpsHere; ++w) c += part[w * DH + d];
    c = fmaf(p_self, to_f32(v_new[head0 + d]), c);
    out[head0 + d] = from_f32<T>(__fmul_rn(c, inv));
  }
}

template <int DH, bool QUANT, typename T>
int launch(const void* q, const void* k, const void* v, const void* k_new, const void* v_new,
           const void* bias, const void* ks, const void* vs, void* out, int B, int L, int H,
           void* stream) {
  const size_t smem = ((size_t)L + 5 * DH + 16) * sizeof(float) + DH;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(mha_decode_kernel<DH, QUANT, T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32.
  const float scale = (float)std::pow((double)DH, -0.5);
  mha_decode_kernel<DH, QUANT, T><<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), k, v, static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const float*>(bias),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<T*>(out),
      L, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT, typename T = bf16>
int dispatch(const void* q, const void* k, const void* v, const void* k_new, const void* v_new,
             const void* bias, const void* ks, const void* vs, void* out, int B, int L, int H,
             int head_dim, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32: return launch<32, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    case 64: return launch<64, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    case 96: return launch<96, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    case 128: return launch<128, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    case 160: return launch<160, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    case 192: return launch<192, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    case 224: return launch<224, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    case 256: return launch<256, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 cache. Returns cudaGetLastError().
extern "C" int apertis_mha_decode_ctx(const void* q, const void* k, const void* v,
                                      const void* k_new, const void* v_new, const void* bias,
                                      void* out, int B, int L, int H, int head_dim,
                                      void* stream) {
  return dispatch<false>(q, k, v, k_new, v_new, bias, nullptr, nullptr, out, B, L, H, head_dim,
                         stream);
}

// int8 cache with f32 per-(head, slot) scales ks, vs (B, H, L).
extern "C" int apertis_mha_decode_ctx_int8(const void* q, const void* k, const void* v,
                                           const void* k_new, const void* v_new,
                                           const void* bias, const void* ks, const void* vs,
                                           void* out, int B, int L, int H, int head_dim,
                                           void* stream) {
  return dispatch<true>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, head_dim, stream);
}

// The f32 forms: f32 q, k_new, v_new and output over an f32 cache (ks, vs
// null) or over an int8 cache with its f32 scales ks, vs (B, H, L).
extern "C" int apertis_mha_decode_ctx_f32(const void* q, const void* k, const void* v,
                                          const void* k_new, const void* v_new,
                                          const void* bias, const void* ks, const void* vs,
                                          void* out, int B, int L, int H, int head_dim,
                                          void* stream) {
  if (ks == nullptr)
    return dispatch<false, float>(q, k, v, k_new, v_new, bias, nullptr, nullptr, out, B, L, H,
                                  head_dim, stream);
  return dispatch<true, float>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, head_dim,
                               stream);
}
