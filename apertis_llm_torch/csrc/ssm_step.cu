// ssm_decode_step: one decode step of the whole selective-SSM mixer.
//
// Replaces: apertis_llm_tpu/ops/pallas/ssm_step.py::ssm_decode_step_fused
// with the bf16 and the int8 weight layouts and ffn_mode "none", "dense" or
// "moe".
//
// Semantics (ssm_step.py:82-197), per batch row, all sums in f32:
//   nrm  = pre_norm(h)                       bf16: rounded to bf16 for the dots
//   xp   = nrm @ in_proj_x                   rounded to the conv-cache dtype
//   z    = nrm @ in_proj_z
//   xa   = silu(conv window [s_0 .. s_{K-2}, xp] . conv_w + conv_b)
//   dt   = xa @ x_param[:, :R]               rounded to bf16
//   Bs   = xa @ x_param[:, R:R+C],  Cs = xa @ x_param[:, R+C:]
//   delta = softplus(dt @ dt_proj_w + dt_proj_b)         (overflow-safe)
//   h'   = exp(delta[head] * -exp(A_log)) * ssm + Bs      (new ssm state)
//   g    = (Cs * h' + D * xa) * silu(z)      bf16: rounded to bf16
//   hsum = h + g @ out_proj                  h_out = bf16(hsum)
//   dense epilogue: n2 = bf16(ffn_pre_norm(hsum)); bf16 layout: ffn_in = n2;
//                   int8 layout: (x_q, x_s) = quant_rows(n2)
//   moe epilogue (both layouts, ssm_step.py:198-231): n2 as above, then
//     mean2, cen2 = n2 - mean2, var2, inv2 = rsqrt(var2 + eps) (0 if var2 <= 0)
//     (x_q, s) = quant_rows(cen2), x_s = s * inv2
//     logits = (cen2 * inv2 * router_ln_w + router_ln_b) . router_w + router_b
//       (always LayerNorm, whatever the pre-norms are; its statistics are
//       n2's, so cen2 and inv2 serve it)
//     gates = softmax(logits); top-2 by max, the least index winning a tie
//     comb[e] = (w1 [e == i1] + w2 [e == i2]) / (w1 + w2 + 1e-6)
// (bf16 layout: xa is rounded to bf16 where it enters a dot and used in f32
// in D * xa.) In the int8 layout every projection but dt_proj is
//   acc_i32(quant_rows(a) . W_q) * row_scale * w_s[col]
// with a = nrm, xa and g taken in f32 (not rounded to bf16 first), and
// quant_rows(a) = (rint(a * (1/s)), s = max(absmax, 1e-8) * (1/127)) per row
// (ssm_step.py:39-49). g therefore stays f32 until it is quantized. dt_proj,
// conv, A_log and D stay bf16 in both layouts.
//
// Bound on the H100: bytes. At decode batch sizes every step reads the
// mixer's weights (about 10.6 MB per layer of the 1.5B model in bf16, 5.3 MB
// in int8) for 2 * rows operations per weight, far below the tensor-core
// line. The difficulty is the chain in_proj -> conv -> x_param -> dt ->
// recurrence -> out_proj, in which each stage needs whole rows of the stage
// before, and in the int8 layout each quantization needs a whole row too.
//
// Design (Hopper, decode_gemm.cuh), one structure for both layouts: each
// product's input rows are computed once, by a row kernel (one block of 256
// threads a row), and each projection is a swapped-operand wgmma product
// (128 weight columns a block, a row tile of 16 rows up to 16, else 64, as
// wgmma's N) that streams those rows beside the weight tiles through a TMA
// ring, so each weight is read from device memory once per row tile. The
// int8 layout quantizes the rows (int8 wgmma against the int8 weight, exact
// int32 sums); the bf16 layout rounds them to bf16 (kDgBW: the tree's
// row-major bf16 weight tile as wgmma's MN-major shared-memory A operand,
// f32 sums). Where a row or a weight row is not a whole number of 16-byte
// units (x_param's R + 2C: 1368 bytes in int8 at the 1.5B widths, 792 in
// bf16 at the MoE widths), the producer's own zero-filling loads stage it.
// K is split over a cluster of `split` blocks (the plans of
// ops/kernels/decode_plan.py::ssm_step_plan and bf16_step_plan): the int8
// sums are pushed to their owners (decode_gemm.cuh's owner-slot exchange),
// the bf16 f32 sums by the sliced exchange, added in rank order. Launches:
//   1. ssm_norm_kernel<bf16>: the pre-norm of h (in f32), quantized (int8)
//      or rounded to bf16;
//   2. ssm_gemm_kernel<kIn>: in_proj x and z -> xp (bf16), z (f32);
//   3. ssm_conv_kernel: conv + SiLU of x_act, quantized or rounded to bf16;
//   4. ssm_gemm_kernel<kMix>: x_param -> dt (bf16-rounded), B, C (f32);
//   5. ssm_recur_kernel: dt_proj + softplus, the recurrence (the new ssm
//      state, in place) and the gate, quantized or rounded to bf16;
//   6. ssm_gemm_kernel<kOut>: out_proj + residual -> h_out, hsum;
//   7. with the dense or moe epilogue, ssm_norm_kernel<float>: the FFN
//      pre-norm of hsum rounded to bf16 (and quantized in the int8 layout),
//      or the moe epilogue (both layouts).
// Fusing the row work into the products was measured slower: in the int8
// layout into their prologues, where each of a product's column tiles
// recomputed its rows' whole operand (the recurrence 19 times at the 1.5B
// widths), and that work, not the weights, set the time; in the bf16 layout,
// whose conv + SiLU needs no whole row, into in_proj's epilogue (scattered
// conv-window loads by the owners of each column block; on the H100 the
// step took 0.0480 against 0.0461 ms at 64 rows).

#include <string.h>


#include "common.cuh"
#include "decode_gemm.cuh"

namespace {

// The eval-mode top-2 routing of one row by one warp from lane e's logit of
// expert e (-inf past E): softmax, the two largest gates (the least index
// winning a tie) and comb[e] = (w1 [e == i1] + w2 [e == i2]) / (w1 + w2 +
// 1e-6).
__device__ void warp_top2_combine(float logit, int num_experts, float* comb) {
  const int lane = threadIdx.x & 31;
  const float neg_inf = __int_as_float(0xff800000);
  const bool valid = lane < num_experts;
  const float top = warp_max(logit);
  const float ex = valid ? expf(logit - top) : 0.f;
  const float total = warp_sum(ex);
  const float gate = valid ? ex / total : neg_inf;
  const float w1 = warp_max(gate);
  const int i1 = (int)__reduce_min_sync(0xffffffffu,
                                        (unsigned)(valid && gate == w1 ? lane : num_experts));
  const float g2 = lane == i1 ? neg_inf : gate;
  const float w2 = warp_max(g2);
  const int i2 = (int)__reduce_min_sync(0xffffffffu,
                                        (unsigned)(valid && g2 == w2 ? lane : num_experts));
  if (valid)
    comb[lane] = ((lane == i1 ? w1 : 0.f) + (lane == i2 ? w2 : 0.f)) / (w1 + w2 + 1e-6f);
}


// Four consecutive values from p, 8-byte (bf16) or 16-byte (f32) aligned.
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// The conv + SiLU of channels c .. c + 3 of a row (c and C multiples of 4;
// the bf16 kernel's formula): conv window [s_0 .. s_{K-2}, xp] . conv_w[c] +
// conv_b[c], the row's inputs read four at a time.
__device__ __forceinline__ void conv_silu4(const bf16* __restrict__ conv_state,
                                           const bf16* __restrict__ xp,
                                           const bf16* __restrict__ conv_w,
                                           const bf16* __restrict__ conv_b, size_t row, int c,
                                           int channels, int ksize, float (&act)[4]) {
  float yc[4] = {0.f, 0.f, 0.f, 0.f}, v[4];
  for (int j = 0; j < ksize - 1; ++j) {
    load4(conv_state + (row * (ksize - 1) + j) * channels + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) yc[i] += v[i] * to_f32(conv_w[(size_t)(c + i) * ksize + j]);
  }
  load4(xp + row * channels + c, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yc[i] += v[i] * to_f32(conv_w[(size_t)(c + i) * ksize + ksize - 1]);
    yc[i] += to_f32(conv_b[c + i]);
    act[i] = yc[i] * sigmoidf(yc[i]);
  }
}

// The row stride of the (B, R + 2C) dt | B | C scratch: dt padded to a
// multiple of 4 columns, so that B and C start 16-byte aligned.
__host__ __device__ constexpr int bc_stride(int rank, int channels) {
  return (rank + 3) / 4 * 4 + 2 * channels;
}

// Block sums and maxima of one value a thread over the kBlock threads of a
// block, in every thread: the warps' results added in warp order. `red`
// holds kWarps floats; the first barrier keeps an earlier result from being
// overwritten while it is read.
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kWarps; ++w) t = is_max ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

// The row quantization of ssm_step.py:39-43 of a row of n f32 values in
// shared memory, written by any of the block's threads: s = max(absmax,
// 1e-8) * (1/127) and q = rint(v * (1/s)).
__device__ __forceinline__ void block_quant_row(const float* v, int n, float* red, int8_t* q,
                                                float* scale) {
  __syncthreads();
  float m = 0.f;
  for (int k = threadIdx.x; k < n; k += kBlock) m = fmaxf(m, fabsf(v[k]));
  const float s = fmaxf(block_reduce(m, red, true), 1e-8f) * (1.f / 127.f);
  const float inv = 1.f / s;
  for (int k = threadIdx.x; k < n; k += kBlock) q[k] = quant_level(__fmul_rn(v[k], inv));
  if (threadIdx.x == 0) *scale = s;
}


// The end of a row kernel: the row's n f32 values v (shared memory, written
// by any of the block's threads) go to the next product quantized (kQ: int8
// levels at out and the row's scale) or rounded to bf16 (at out).
template <bool kQ>
__device__ __forceinline__ void row_out(const float* v, int n, float* red, void* out,
                                        float* scale) {
  if constexpr (kQ) {
    block_quant_row(v, n, red, static_cast<int8_t*>(out), scale);
  } else {
    __syncthreads();
    bf16* o = static_cast<bf16*>(out);
    for (int k = threadIdx.x; k < n; k += kBlock) o[k] = __float2bfloat16(v[k]);
  }
}

// The row kernels compute each product's input rows once, one block of
// kBlock threads a row; kQ: quantized (the int8 layout), else bf16.

// A pre-norm and its row's output: the mixer's input (x: h, bf16, the normed
// values in f32) or the dense and moe epilogues' FFN input (x: hsum, f32,
// the normed values rounded to bf16, `round_out`); with router_w, the moe
// epilogue (int8 x_q, x_s and the combine weights in both layouts: the
// router's logits summed a warp at a time, the top-2 by warp 0). Shared
// memory: the row, D floats.
template <typename T, bool kQ>
__global__ void __launch_bounds__(kBlock) ssm_norm_kernel(
    const T* __restrict__ x,              // (B, D)
    const bf16* __restrict__ norm_w, const bf16* __restrict__ norm_b, int rms, float eps,
    int round_out,
    const bf16* __restrict__ rln_w, const bf16* __restrict__ rln_b,
    const bf16* __restrict__ router_w,    // (D, E), or nullptr
    const bf16* __restrict__ router_b,
    void* __restrict__ out,               // (B, D): int8 (kQ, moe) or bf16
    float* __restrict__ x_s,              // (B,)
    float* __restrict__ comb,             // (B, E) (moe)
    int d_model, int num_experts) {
  extern __shared__ float v[];
  __shared__ float red[kWarps];
  __shared__ float logit_part[kWarps][32];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float dn = (float)d_model;
  if (d_model % 4 == 0) {   // four values a load
#pragma unroll 4
    for (int k = 4 * tid; k < d_model; k += 4 * kBlock) {
      float t[4];
      load4(x + row * d_model + k, t);
      *reinterpret_cast<float4*>(v + k) = make_float4(t[0], t[1], t[2], t[3]);
    }
    __syncthreads();
  } else {
#pragma unroll 4
    for (int k = tid; k < d_model; k += kBlock) v[k] = to_f32(x[row * d_model + k]);
  }
  if (rms) {
    float ss = 0.f;
    for (int k = tid; k < d_model; k += kBlock) ss += v[k] * v[k];
    ss = block_reduce(ss, red, false);
    const float r = (ss > 0.f ? sqrtf(ss) : 0.f) * rsqrtf(dn);
    const float inv = ss > 0.f ? 1.f / (r + eps) : 0.f;
    for (int k = tid; k < d_model; k += kBlock) {
      const float n = v[k] * inv * to_f32(norm_w[k]);
      v[k] = round_out ? round_bf16(n) : n;
    }
  } else {
    float s1 = 0.f;
    for (int k = tid; k < d_model; k += kBlock) s1 += v[k];
    const float mean = block_reduce(s1, red, false) / dn;
    float s2 = 0.f;
    for (int k = tid; k < d_model; k += kBlock) s2 += (v[k] - mean) * (v[k] - mean);
    const float var = block_reduce(s2, red, false) / dn;
    const float inv = var > 0.f ? rsqrtf(var + eps) : 0.f;
    for (int k = tid; k < d_model; k += kBlock) {
      const float n = (v[k] - mean) * inv * to_f32(norm_w[k]) + to_f32(norm_b[k]);
      v[k] = round_out ? round_bf16(n) : n;
    }
  }
  if (router_w == nullptr) {
    row_out<kQ>(v, d_model, red, static_cast<unsigned char*>(out) + row * d_model * (kQ ? 1 : 2),
                kQ ? x_s + row : nullptr);
    return;
  }
  int8_t* q = static_cast<int8_t*>(out) + row * d_model;
  float s1 = 0.f;
  for (int k = tid; k < d_model; k += kBlock) s1 += v[k];
  const float mean = block_reduce(s1, red, false) / dn;
  float s2 = 0.f, m = 0.f;
  for (int k = tid; k < d_model; k += kBlock) {
    const float c = v[k] - mean;
    s2 += c * c;
    m = fmaxf(m, fabsf(c));
  }
  const float var = block_reduce(s2, red, false) / dn;
  const float inv = var > 0.f ? rsqrtf(var + eps) : 0.f;
  const float scale = fmaxf(block_reduce(m, red, true), 1e-8f) * (1.f / 127.f);
  const float rscale = 1.f / scale;
  for (int k = tid; k < d_model; k += kBlock) q[k] = quant_level(__fmul_rn(v[k] - mean, rscale));
  if (tid == 0) x_s[row] = __fmul_rn(scale, inv);
  const int warp = tid >> 5, lane = tid & 31;
  for (int e = 0; e < num_experts; ++e) {
    float acc = 0.f;
    for (int k = tid; k < d_model; k += kBlock) {
      const float rn = __fadd_rn(__fmul_rn(__fmul_rn(v[k] - mean, inv), to_f32(rln_w[k])),
                                 to_f32(rln_b[k]));
      acc = fmaf(rn, to_f32(router_w[(size_t)k * num_experts + e]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) logit_part[warp][e] = acc;
  }
  __syncthreads();
  if (warp != 0) return;
  float logit = __int_as_float(0xff800000);
  if (lane < num_experts) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += logit_part[w][lane];
    logit = l + to_f32(router_b[lane]);
  }
  warp_top2_combine(logit, num_experts, comb + row * num_experts);
}

// x_act = silu(conv) of a row, quantized or rounded to bf16 (row_out).
// Shared memory: C floats.
template <bool kQ>
__global__ void __launch_bounds__(kBlock) ssm_conv_kernel(
    const bf16* __restrict__ conv_state,  // (B, K-1, C)
    const bf16* __restrict__ xp,          // (B, C)
    const bf16* __restrict__ conv_w,      // (C, K)
    const bf16* __restrict__ conv_b,      // (C,)
    void* __restrict__ xa_q,              // (B, C): int8 (kQ) or bf16
    float* __restrict__ xa_s,             // (B,) (kQ)
    int channels, int ksize) {
  extern __shared__ float v[];
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  for (int c = 4 * threadIdx.x; c < channels; c += 4 * kBlock) {
    float a[4];
    conv_silu4(conv_state, xp, conv_w, conv_b, row, c, channels, ksize, a);
    *reinterpret_cast<float4*>(v + c) = make_float4(a[0], a[1], a[2], a[3]);
  }
  row_out<kQ>(v, channels, red, static_cast<unsigned char*>(xa_q) + row * channels * (kQ ? 1 : 2),
              kQ ? xa_s + row : nullptr);
}

// The bytes of dt_proj_w in ssm_recur_kernel's shared memory, a multiple of
// 16 so that the f32 values after it stay aligned.
__host__ __device__ constexpr size_t recur_dtw_bytes(int rank, int heads) {
  return ((size_t)rank * heads * 2 + 15) / 16 * 16;
}

// The recurrence of a row and its gate: delta = softplus(dt . dt_proj_w +
// dt_proj_b) (f32 fused multiply-adds over R in order), h' = exp(delta[head]
// * -exp(A_log)) * ssm + Bs into ssm_out (each element read and then written
// by one thread, so ssm_out may be ssm), g = (Cs * h' + D * xa) * silu(z),
// quantized or rounded to bf16 (row_out). Shared memory: dt_proj_w (R x H
// bf16), then g (C), dt (R) and delta (H) floats.
template <bool kQ>
__global__ void __launch_bounds__(kBlock) ssm_recur_kernel(
    const float* __restrict__ bc,         // (B, bc_stride(R, C)): dt | B | C
    const float* __restrict__ z,          // (B, C)
    const float* ssm,                     // (B, C); may be ssm_out
    const bf16* __restrict__ conv_state,  // (B, K-1, C)
    const bf16* __restrict__ xp,          // (B, C)
    const bf16* __restrict__ conv_w,      // (C, K)
    const bf16* __restrict__ conv_b,      // (C,)
    const bf16* __restrict__ dt_w,        // (R, H)
    const bf16* __restrict__ dt_b,        // (H,)
    const bf16* __restrict__ a_log,       // (H, N) == (C,)
    const bf16* __restrict__ d_skip,      // (C,)
    float* ssm_out,                       // (B, C)
    void* __restrict__ g_out,             // (B, C): int8 (kQ) or bf16
    float* __restrict__ g_s,              // (B,) (kQ)
    int channels, int ksize, int rank, int heads, int d_state) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* dtw = reinterpret_cast<bf16*>(smem_b);                            // R x H
  float* g = reinterpret_cast<float*>(smem_b + recur_dtw_bytes(rank, heads));   // C
  float* dt = g + channels;          // R
  float* delta = dt + rank;          // H
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const int ldbc = bc_stride(rank, channels), rp = (rank + 3) / 4 * 4;
  const float* bcr = bc + row * ldbc;
  for (int q = threadIdx.x; q < rank; q += kBlock) dt[q] = bcr[q];
  if (rank * heads % 8 == 0) {
#pragma unroll 4
    for (int i = threadIdx.x; i < rank * heads / 8; i += kBlock)
      reinterpret_cast<uint4*>(dtw)[i] = reinterpret_cast<const uint4*>(dt_w)[i];
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < rank * heads; i += kBlock) dtw[i] = dt_w[i];
  }
  __syncthreads();
  for (int hd = threadIdx.x; hd < heads; hd += kBlock) {
    float dt_raw = 0.f;
    for (int q = 0; q < rank; ++q) dt_raw = fmaf(dt[q], to_f32(dtw[q * heads + hd]), dt_raw);
    delta[hd] = softplusf(dt_raw + to_f32(dt_b[hd]));
  }
  __syncthreads();
  for (int c = 4 * threadIdx.x; c < channels; c += 4 * kBlock) {
    float xa[4], prev[4], bs[4], cs[4], zv[4], hn[4];
    conv_silu4(conv_state, xp, conv_w, conv_b, row, c, channels, ksize, xa);
    load4(ssm + row * channels + c, prev);
    load4(bcr + rp + c, bs);
    load4(bcr + rp + channels + c, cs);
    load4(z + row * channels + c, zv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a_bar = expf(delta[(c + i) / d_state] * -expf(to_f32(a_log[c + i])));
      hn[i] = a_bar * prev[i] + bs[i];
      const float y = cs[i] * hn[i] + to_f32(d_skip[c + i]) * xa[i];
      g[c + i] = y * (zv[i] * sigmoidf(zv[i]));
    }
    *reinterpret_cast<float4*>(ssm_out + row * channels + c) =
        make_float4(hn[0], hn[1], hn[2], hn[3]);
  }
  row_out<kQ>(g, channels, red, static_cast<unsigned char*>(g_out) + row * channels * (kQ ? 1 : 2),
              kQ ? g_s + row : nullptr);
}

// The three products (decode_gemm.cuh): the rows streamed by TMA (or the
// producer's own loads) beside the weight tiles, K split over a cluster of
// `split` blocks in contiguous chunk ranges, and each launch's epilogue on
// v = acc * x_s * w_s (int8: the exact int32 sums dequantized) or v = acc
// (bf16: the f32 sums):
//   kIn:  in_proj x or z: xp (bf16) or z (f32); column tiles 0 .. ceil(C /
//         128) - 1 are x's, the rest z's;
//   kMix: x_param: dt (bf16-rounded) | B | C (f32);
//   kOut: out_proj, h + v: h_out (bf16) and hsum (f32, for the epilogue).
enum StepProduct { kIn = 0, kMix = 1, kOut = 2 };

struct StepEpilogue {
  const float* x_s;       // int8: (B,) the quantized rows' scales
  const float* ws;        // int8: (1, N) the weight's column scales (in: x's)
  const float* ws_z;      // int8, in: z's
  bf16* xp;               // in: (B, C)
  float* z;               // in: (B, C)
  float* bc;              // mix: (B, bc_stride(R, C))
  const bf16* h;          // out: (B, D)
  bf16* h_out;            // out: (B, D)
  float* hsum;            // out: (B, D), or nullptr
  int batch, n, channels, rank;
};

template <int BR, int kMode, int kKind>
__global__ void __launch_bounds__(kThreads, 1) ssm_gemm_kernel(
    const __grid_constant__ CUtensorMap x_map,    // the rows (B, K): boxes of BR rows x 128 bytes
    const __grid_constant__ CUtensorMap w_map,    // the weight (K, N); in: in_proj x
    const __grid_constant__ CUtensorMap wz_map,   // in: in_proj z
    DgRows rows, DgWeight w, DgWeight wz, StepEpilogue ep, int split, int stages) {
  typedef DgOp<kKind> Op;
  typedef typename Op::Acc Acc;
  constexpr bool kBW = kKind == kDgBW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t stage_bytes = BR * 128 + Op::kWBytes;
  Acc* part = reinterpret_cast<Acc*>(smem + (size_t)stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + (size_t)stages * stage_bytes +
      (kBW ? xset_bytes(BR, split) : dg_part_bytes(BR, split)));
  const int col_tiles = (ep.n + kDgCols - 1) / kDgCols;
  const int ct = blockIdx.x / split, rank = blockIdx.x % split;
  const bool is_z = kMode == kIn && ct >= col_tiles;
  const int n0 = (is_z ? ct - col_tiles : ct) * kDgCols;
  const int m0 = blockIdx.y * BR;
  const int nch = (rows.k + Op::kKC - 1) / Op::kKC;
  const int c_lo = rank * nch / split, c_hi = (rank + 1) * nch / split;
  const DgWeight wt{is_z ? wz.w : w.w, w.k, w.n, is_z ? wz.tma : w.tma};
  const DgRing ring{smem, bars, bars + stages, BR * 128, Op::kWBytes, stages};
  dg_init(ring, dg_full_count(rows, wt));
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const DgChunks ch{c_lo, 1, c_hi - c_lo, 1};
    dg_produce<kKind>(ring, is_z ? &wz_map : &w_map, nullptr, &x_map, wt, rows, ch, n0, m0, 0,
                      c_hi - c_lo, threadIdx.x - kDgConsumerThreads);
    if (split > 1) {
      __syncwarp();
      cluster.sync();
    }
    return;
  }
  regs_alloc<kDgConsumerRegs>();
  const DgLane L(!kBW);
  Acc acc[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
  dg_consume<kKind, BR>(ring, L, 0, c_hi - c_lo, acc);
  const uint32_t mine = dg_owned_mask(rank, split, BR / 8);
  if (split > 1) {
    if constexpr (kBW) {
      // The sliced exchange: each block's sums pushed to their owner, added
      // there in rank order from 0.
      const int blocks = min(BR / 8, (ep.batch - m0 + 7) / 8);   // with a row below B
      xpush<BR>(acc, part, L.tid, rank, split, blocks, cluster);
      cluster.sync();
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) acc[i] = 0.f;
      add_round<BR>(acc, part, 0, L.tid, rank, split, blocks, 1, 0, split);
    } else {
      dg_split_sum<BR>(acc, part, L, rank, split, mine, cluster);
    }
  }
  const float* ws = is_z ? ep.ws_z : ep.ws;
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) {
    if (kBW ? !xowns<BR>(i / 4, L.tid, rank, split) : !((mine >> (i / 4)) & 1)) continue;
    const int row = m0 + L.row(i), col = n0 + (kBW ? L.bw_column(i) : L.column(i));
    if (row >= ep.batch || col >= ep.n) continue;
    float v;
    if constexpr (kBW)
      v = acc[i];
    else
      v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), ep.x_s[row]), ws[col]);
    if constexpr (kMode == kIn) {
      const size_t o = (size_t)row * ep.channels + col;
      if (is_z)
        ep.z[o] = v;
      else
        ep.xp[o] = __float2bfloat16(v);
    } else if constexpr (kMode == kMix) {
      float* dst = ep.bc + (size_t)row * bc_stride(ep.rank, ep.channels);
      if (col < ep.rank)
        dst[col] = round_bf16(v);
      else
        dst[col - ep.rank + (ep.rank + 3) / 4 * 4] = v;
    } else {
      const size_t o = (size_t)row * ep.n + col;
      const float s = to_f32(ep.h[o]) + v;
      ep.h_out[o] = __float2bfloat16(s);
      if (ep.hsum != nullptr) ep.hsum[o] = s;
    }
  }
}

// A tensor map over a row-major (outer, inner) int8 or bf16 matrix in boxes
// of box rows x 128 bytes (dg_map_2d's cache), or none (*tma 0) for the
// producer's own loads where the row is not a multiple of 16 bytes or the
// base not 16-byte aligned.
int step_map(CUtensorMap* map, const void* base, bool bf16_elems, int outer, int inner, int box,
             int* tma) {
  memset(map, 0, sizeof(*map));
  const int elem = bf16_elems ? 2 : 1;
  *tma = inner * elem % 16 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
  if (!*tma) return 0;
  return dg_map_2d(map, base,
                   bf16_elems ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   elem, inner, outer, 128 / elem, box);
}

// The step's scratch, carved from one buffer at 256-byte boundaries: the
// three products' input rows (int8 with their scales, or bf16), z, dt | B |
// C and hsum; and, in the bf16 layout, x_act's rows (xa_q holds them).
struct StepScratch {
  void *x_q, *xa_q, *g_q;
  float *x_s, *xa_s, *g_s, *z, *bc, *hsum;
  size_t bytes;
  StepScratch(void* base, int batch, int d_model, int channels, int rank, bool int8) {
    unsigned char* p = static_cast<unsigned char*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      unsigned char* q = p == nullptr ? nullptr : p + off;
      off += (n + 255) / 256 * 256;
      return q;
    };
    const size_t b = batch, e = int8 ? 1 : 2;
    x_q = take(b * d_model * e);
    xa_q = take(b * channels * e);
    g_q = take(b * channels * e);
    x_s = reinterpret_cast<float*>(take(b * 4));
    xa_s = reinterpret_cast<float*>(take(b * 4));
    g_s = reinterpret_cast<float*>(take(b * 4));
    z = reinterpret_cast<float*>(take(b * channels * 4));
    bc = reinterpret_cast<float*>(take(b * bc_stride(rank, channels) * 4));
    hsum = reinterpret_cast<float*>(take(b * d_model * 4));
    bytes = off;
  }
};

// One product at a row tile of BR rows: the rows x (B, K) against the weight
// w (K, N) (in: and wz), on the plan's split and stages.
template <int BR, int kMode, int kKind>
int step_gemm(const void* x, int batch, int k, const void* w, const void* wz, int n,
              StepEpilogue ep, int split, int stages, cudaStream_t s) {
  constexpr bool kBW = kKind == kDgBW;
  typedef DgOp<kKind> Op;
  CUtensorMap xm, wm, wzm;
  int tx = 0, tw = 0, tz = 0;
  int err = step_map(&xm, x, kBW, batch, k, BR, &tx);
  if (err == 0) err = step_map(&wm, w, kBW, k, n, Op::kKC, &tw);
  if (err == 0) err = step_map(&wzm, wz != nullptr ? wz : w, kBW, k, n, Op::kKC, &tz);
  if (err != 0) return err;
  const int col_tiles = (n + kDgCols - 1) / kDgCols * (kMode == kIn ? 2 : 1);
  const uint32_t stage = BR * 128 + Op::kWBytes;
  const size_t smem = kBW ? dg_smem_bytes(BR, stages, stage, 1, xset_bytes(BR, split))
                          : dg_smem_bytes(BR, stages, stage, split, 0);
  auto wp = [](const void* p) { return static_cast<const int8_t*>(p); };
  return dg_launch(ssm_gemm_kernel<BR, kMode, kKind>,
                   dim3(col_tiles * split, (batch + BR - 1) / BR), dim3(kThreads), split, smem, s,
                   xm, wm, wzm, DgRows{x, batch, k, tx}, DgWeight{wp(w), k, n, tw},
                   DgWeight{wp(wz != nullptr ? wz : w), k, n, tz}, ep, split, stages);
}

// One step's tensors, as the C entry points take them: the projections are
// int8 with (1, out) f32 scales, or bf16 (scales null).
struct StepArgs {
  const bf16 *h, *conv_state;
  const float* ssm;
  const bf16 *norm_w, *norm_b;
  const void *inx, *inz, *xparam, *out_w;
  const float *inx_s, *inz_s, *xparam_s, *out_s;
  const bf16 *conv_w, *conv_b, *dt_w, *dt_b, *a_log, *d_skip;
  const bf16 *fn_w, *fn_b, *rln_w, *rln_b, *router_w, *router_b;
  bf16 *h_out, *xp_out;
  float* ssm_out;
  void* ffn_in;
  float *ffn_scale, *comb;
  int batch, d_model, channels, ksize, rank, heads, d_state, num_experts, rms;
  float eps;
};

// The step's launches at a row tile of BR rows in the int8 (kDgI8) or bf16
// (kDgBW) layout: the pre-norm, in_proj x and z, conv + SiLU, x_param, the
// recurrence and gate, out_proj, and with an epilogue the FFN input.
// splits[i] and stages[i] are the plan of product i (in, mix, out).
template <int BR, int kKind>
int launch_step(const StepArgs& a, const StepScratch& sc, const int* splits, const int* stages,
                cudaStream_t s) {
  constexpr bool kQ = kKind == kDgI8;
  const size_t row_d = (size_t)a.d_model * sizeof(float);
  const dim3 rows_grid(a.batch), row_block(kBlock);
  int err = dg_launch(ssm_norm_kernel<bf16, kQ>, rows_grid, row_block, 1, row_d, s, a.h,
                      a.norm_w, a.norm_b, a.rms, a.eps, 0, nullptr, nullptr, nullptr, nullptr,
                      sc.x_q, sc.x_s, nullptr, a.d_model, 0);
  if (err != 0) return err;
  StepEpilogue ep = {};
  ep.batch = a.batch;
  ep.channels = a.channels;
  ep.rank = a.rank;
  ep.x_s = sc.x_s;
  ep.ws = a.inx_s;
  ep.ws_z = a.inz_s;
  ep.xp = a.xp_out;
  ep.z = sc.z;
  ep.n = a.channels;
  err = step_gemm<BR, kIn, kKind>(sc.x_q, a.batch, a.d_model, a.inx, a.inz, a.channels, ep,
                                  splits[0], stages[0], s);
  if (err != 0) return err;
  err = dg_launch(ssm_conv_kernel<kQ>, rows_grid, row_block, 1, a.channels * sizeof(float), s,
                  a.conv_state, static_cast<const bf16*>(a.xp_out), a.conv_w, a.conv_b, sc.xa_q,
                  sc.xa_s, a.channels, a.ksize);
  if (err != 0) return err;
  ep.x_s = sc.xa_s;
  ep.ws = a.xparam_s;
  ep.bc = sc.bc;
  ep.n = a.rank + 2 * a.channels;
  err = step_gemm<BR, kMix, kKind>(sc.xa_q, a.batch, a.channels, a.xparam, nullptr, ep.n, ep,
                                   splits[1], stages[1], s);
  if (err != 0) return err;
  err = dg_launch(ssm_recur_kernel<kQ>, rows_grid, row_block, 1,
                  recur_dtw_bytes(a.rank, a.heads) + (size_t)(a.channels + a.rank + a.heads) * 4,
                  s, static_cast<const float*>(sc.bc), static_cast<const float*>(sc.z), a.ssm,
                  a.conv_state, static_cast<const bf16*>(a.xp_out), a.conv_w, a.conv_b, a.dt_w,
                  a.dt_b, a.a_log, a.d_skip, a.ssm_out, sc.g_q, sc.g_s, a.channels, a.ksize,
                  a.rank, a.heads, a.d_state);
  if (err != 0) return err;
  ep.x_s = sc.g_s;
  ep.ws = a.out_s;
  ep.h = a.h;
  ep.h_out = a.h_out;
  ep.hsum = a.fn_w != nullptr ? sc.hsum : nullptr;
  ep.n = a.d_model;
  err = step_gemm<BR, kOut, kKind>(sc.g_q, a.batch, a.channels, a.out_w, nullptr, a.d_model, ep,
                                   splits[2], stages[2], s);
  if (err != 0 || a.fn_w == nullptr)
    return err != 0 ? err : static_cast<int>(cudaGetLastError());
  // The moe epilogue quantizes in both layouts; the dense one as the layout.
  err = dg_launch(a.router_w != nullptr ? &ssm_norm_kernel<float, true>
                                         : &ssm_norm_kernel<float, kQ>,
                  rows_grid, row_block, 1, row_d, s, static_cast<const float*>(sc.hsum), a.fn_w,
                  a.fn_b, a.rms, a.eps, 1, a.rln_w, a.rln_b, a.router_w, a.router_b, a.ffn_in,
                  a.ffn_scale, a.comb, a.d_model, a.num_experts);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// Check a step's shape and plan, then run it at its row tile.
template <int kKind>
int run_step(const StepArgs& a, void* scratch, int row_tile, const int* sp, const int* st,
             cudaStream_t s) {
  constexpr int kKC = DgOp<kKind>::kKC;
  if (a.batch <= 0 || a.d_model % 4 != 0 || a.channels % 4 != 0 || a.d_state <= 0 ||
      a.rank <= 0 || a.heads * a.d_state != a.channels || (row_tile != 16 && row_tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.router_w != nullptr && (a.num_experts < 2 || a.num_experts > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks[3] = {(a.d_model + kKC - 1) / kKC, (a.channels + kKC - 1) / kKC,
                         (a.channels + kKC - 1) / kKC};
  for (int i = 0; i < 3; ++i)
    if (sp[i] < 1 || sp[i] > 8 || sp[i] > chunks[i] || st[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  const StepScratch sc(scratch, a.batch, a.d_model, a.channels, a.rank, kKind == kDgI8);
  return row_tile == 16 ? launch_step<16, kKind>(a, sc, sp, st, s)
                        : launch_step<64, kKind>(a, sc, sp, st, s);
}

}  // namespace

// One decode step of one layer's mixer, bf16 weight layout. conv_state is
// (B, K-1, C); ssm_out may be ssm, to update the state in place. fn_w ==
// nullptr selects ffn_mode "none" (ffn_in unused); router_w == nullptr
// selects "dense" (ffn_in is the (B, D) bf16 FFN input), else "moe": ffn_in
// is the (B, D) int8 x_q, ffn_scale the (B, 1) f32 x_s and comb the (B, E)
// f32 combine weights, E <= 32. D and C must be multiples of 4. `scratch`
// holds apertis_ssm_step_scratch(..., 0) bytes. row_tile (16 or 64),
// splits[3] and stages[3] (in, mix, out) are the plan of
// ops/kernels/decode_plan.py::bf16_step_plan. Returns cudaGetLastError(), or
// cudaErrorInvalidResourceHandle if a tensor map cannot be made.
extern "C" int apertis_ssm_decode_step(
    const void* h, const void* conv_state, const void* ssm, const void* norm_w,
    const void* norm_b, const void* inx_w, const void* inz_w, const void* conv_w,
    const void* conv_b, const void* xparam_w, const void* dt_w, const void* dt_b,
    const void* a_log, const void* d_skip, const void* out_w, const void* fn_w,
    const void* fn_b, const void* rln_w, const void* rln_b, const void* router_w,
    const void* router_b, void* h_out, void* xp_out, void* ssm_out, void* ffn_in,
    void* ffn_scale, void* comb, void* scratch, int batch, int d_model, int channels,
    int ksize, int rank, int heads, int d_state, int num_experts, int rms, float eps,
    int row_tile, const void* splits, const void* stages, void* stream) {
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  const StepArgs a{b(h), b(conv_state), static_cast<const float*>(ssm), b(norm_w), b(norm_b),
                   inx_w, inz_w, xparam_w, out_w, nullptr, nullptr, nullptr, nullptr,
                   b(conv_w), b(conv_b), b(dt_w), b(dt_b), b(a_log), b(d_skip), b(fn_w),
                   b(fn_b), b(rln_w), b(rln_b), b(router_w), b(router_b),
                   static_cast<bf16*>(h_out), static_cast<bf16*>(xp_out),
                   static_cast<float*>(ssm_out), ffn_in, static_cast<float*>(ffn_scale),
                   static_cast<float*>(comb), batch, d_model, channels, ksize, rank, heads,
                   d_state, num_experts, rms, eps};
  return run_step<kDgBW>(a, scratch, row_tile, static_cast<const int*>(splits),
                         static_cast<const int*>(stages), static_cast<cudaStream_t>(stream));
}

// The same step with the int8 weight layout: each of in_proj x / z, x_param
// and out_proj is an int8 (in, out) weight with (1, out) f32 scales; D and C
// must be multiples of 4. `scratch` holds apertis_ssm_step_scratch(..., 1)
// bytes; with the dense or the moe epilogue ffn_in is the (B, D) int8 x_q
// and ffn_scale the (B, 1) f32 x_s. row_tile (16 or 64), splits[3] and
// stages[3] (in, mix, out) are the plan of
// ops/kernels/decode_plan.py::ssm_step_plan. Returns cudaGetLastError(), or
// cudaErrorInvalidResourceHandle if a tensor map cannot be made.
extern "C" int apertis_ssm_decode_step_int8(
    const void* h, const void* conv_state, const void* ssm, const void* norm_w,
    const void* norm_b, const void* inx_q, const void* inx_s, const void* inz_q,
    const void* inz_s, const void* conv_w, const void* conv_b, const void* xparam_q,
    const void* xparam_s, const void* dt_w, const void* dt_b, const void* a_log,
    const void* d_skip, const void* out_q, const void* out_s, const void* fn_w,
    const void* fn_b, const void* rln_w, const void* rln_b, const void* router_w,
    const void* router_b, void* h_out, void* xp_out, void* ssm_out, void* ffn_in,
    void* ffn_scale, void* comb, void* scratch, int batch, int d_model, int channels,
    int ksize, int rank, int heads, int d_state, int num_experts, int rms, float eps,
    int row_tile, const void* splits, const void* stages, void* stream) {
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const StepArgs a{b(h), b(conv_state), f(ssm), b(norm_w), b(norm_b), inx_q, inz_q, xparam_q,
                   out_q, f(inx_s), f(inz_s), f(xparam_s), f(out_s), b(conv_w), b(conv_b),
                   b(dt_w), b(dt_b), b(a_log), b(d_skip), b(fn_w), b(fn_b), b(rln_w), b(rln_b),
                   b(router_w), b(router_b), static_cast<bf16*>(h_out),
                   static_cast<bf16*>(xp_out), static_cast<float*>(ssm_out), ffn_in,
                   static_cast<float*>(ffn_scale), static_cast<float*>(comb), batch, d_model,
                   channels, ksize, rank, heads, d_state, num_experts, rms, eps};
  return run_step<kDgI8>(a, scratch, row_tile, static_cast<const int*>(splits),
                         static_cast<const int*>(stages), static_cast<cudaStream_t>(stream));
}

// The bytes of a step's scratch for B rows, D, C and R in the int8 (int8 =
// 1) or the bf16 layout.
extern "C" int apertis_ssm_step_scratch(int batch, int d_model, int channels, int rank,
                                        int int8) {
  return static_cast<int>(StepScratch(nullptr, batch, d_model, channels, rank, int8 != 0).bytes);
}

// The resources of one of the step's product kernels (kernel: 0 in, 1 mix,
// 2 out of the int8 layout; 3, 4, 5 of the bf16 layout) at a row tile of
// `row_tile` rows and `smem` bytes of dynamic shared memory
// (hopper.cuh::kernel_resources), into out[0..4].
extern "C" int apertis_ssm_step_resources(int kernel, int row_tile, int smem, int* out) {
  if (row_tile != 16 && row_tile != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bool r16 = row_tile == 16;
  switch (kernel) {
    case 0: return kernel_resources(r16 ? &ssm_gemm_kernel<16, kIn, kDgI8>
                                        : &ssm_gemm_kernel<64, kIn, kDgI8>, kThreads, smem, out);
    case 1: return kernel_resources(r16 ? &ssm_gemm_kernel<16, kMix, kDgI8>
                                        : &ssm_gemm_kernel<64, kMix, kDgI8>, kThreads, smem, out);
    case 2: return kernel_resources(r16 ? &ssm_gemm_kernel<16, kOut, kDgI8>
                                        : &ssm_gemm_kernel<64, kOut, kDgI8>, kThreads, smem, out);
    case 3: return kernel_resources(r16 ? &ssm_gemm_kernel<16, kIn, kDgBW>
                                        : &ssm_gemm_kernel<64, kIn, kDgBW>, kThreads, smem, out);
    case 4: return kernel_resources(r16 ? &ssm_gemm_kernel<16, kMix, kDgBW>
                                        : &ssm_gemm_kernel<64, kMix, kDgBW>, kThreads, smem, out);
    case 5: return kernel_resources(r16 ? &ssm_gemm_kernel<16, kOut, kDgBW>
                                        : &ssm_gemm_kernel<64, kOut, kDgBW>, kThreads, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
