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
// Design of the bf16 layout: three launches per layer, each a grid of
// (column tile, row tile) blocks of 256 threads, so every stage streams its
// weight matrix across the whole card instead of through one block:
//   1. ssm_in_kernel:  pre-norm + in_proj x and z, 64 output columns a block;
//   2. ssm_mix_kernel: conv + SiLU + x_param + dt + recurrence + gate for 64
//      channels a block; the block recomputes the whole x_act row and the
//      small dt_feats row (R values) that every channel needs;
//   3. ssm_out_kernel: out_proj + residual for 64 columns a block. With the
//      dense or moe epilogue the last block of each row tile to finish (an
//      integer ticket, no float atomics) applies the FFN pre-norm (and the
//      moe epilogue) to the full rows, one warp a row.
// Every launch holds whole rows in shared memory. A block holds up to kRows
// batch rows and reads the (in, out) weights with output columns across
// lanes, so reads coalesce; the K axis is split across the 8 warps
// (common.cuh::tile_matvec). The TPU kernel's layer-stacked weights,
// scalar-prefetched layer id, split x_param stacks and 0/1 head-expansion
// matrix are not needed: the caller passes each layer's pointers, the
// x_param weight is cut into dt / B / C columns by pointer offset (or by
// column in the int8 layout), and a thread computes its head as c / N.
//
// Design of the int8 layout (Hopper, decode_gemm.cuh): each quantized
// operand is computed once, by a row kernel (one block of 256 threads a
// row), and each projection is a swapped-operand int8 wgmma product (128
// weight columns a block, a row tile of 16 rows up to 16, else 64, as
// wgmma's N) that streams those int8 rows beside the weight tiles through a
// TMA ring (the producer's own loads where a row is not a multiple of 16
// bytes, as x_param's R + 2C), so each weight is read from device memory
// once per row tile; K is split over a cluster of `split` blocks whose exact
// int32 sums are pushed to their owners (the plan of
// ops/kernels/decode_plan.py::ssm_step_plan). Seven launches:
//   1. ssm_norm_quant_kernel<bf16>: the pre-norm of h (in f32) and its row
//      quantization;
//   2. ssm_gemm_q_kernel<kIn>: in_proj x and z -> xp (bf16), z (f32);
//   3. ssm_conv_quant_kernel: conv + SiLU and the row quantization of x_act;
//   4. ssm_gemm_q_kernel<kMix>: x_param -> dt (bf16-rounded), B, C (f32);
//   5. ssm_recur_quant_kernel: dt_proj + softplus, the recurrence (the new
//      ssm state, in place), the gate and its row quantization;
//   6. ssm_gemm_q_kernel<kOut>: out_proj + residual -> h_out, hsum;
//   7. with the dense or moe epilogue, ssm_norm_quant_kernel<float>: the FFN
//      pre-norm of hsum rounded to bf16 and its quantization, or the moe
//      epilogue.
// Fusing the row work into the products' prologues, as the bf16 layout
// does, was measured slower: each of a product's column tiles recomputed
// its rows' whole operand (the recurrence 19 times at the 1.5B widths), and
// that work, not the weights, set the time.

#include <string.h>

#include <algorithm>

#include "common.cuh"
#include "decode_gemm.cuh"

namespace {

constexpr int kRows = 8;  // batch rows per block of the bf16 kernels

// ---- bf16 layout: 1. pre-norm + in_proj x / z ------------------------------
__global__ void __launch_bounds__(kBlock) ssm_in_kernel(
    const bf16* __restrict__ h,       // (B, D)
    const bf16* __restrict__ norm_w,  // (D,)
    const bf16* __restrict__ norm_b,  // (D,), unused for RMSNorm
    int rms, float eps,
    const bf16* __restrict__ inx,     // (D, C)
    const bf16* __restrict__ inz,     // (D, C)
    bf16* __restrict__ xp_out,        // (B, C) new conv-window entry
    float* __restrict__ z_out,        // (B, C) scratch
    int* __restrict__ tickets,        // (row tiles,) scratch for ssm_out_kernel
    int batch, int d_model, int channels) {
  extern __shared__ float smem[];
  float* xs = smem;                                  // kRows * D
  float* red = smem + kRows * d_model;               // kWarps * kRows * kTileN
  float* out = red + kWarps * kRows * kTileN;        // kRows * kTileN
  const int row0 = blockIdx.y * kRows;
  const int ntile = (channels + kTileN - 1) / kTileN;
  const bool is_z = (int)blockIdx.x >= ntile;
  const int col0 = (is_z ? blockIdx.x - ntile : blockIdx.x) * kTileN;
  if (blockIdx.x == 0 && threadIdx.x == 0) tickets[blockIdx.y] = 0;

  for (int i = threadIdx.x; i < kRows * d_model; i += kBlock) {
    const int r = i / d_model;
    const int k = i - r * d_model;
    xs[i] = row0 + r < batch ? to_f32(h[(size_t)(row0 + r) * d_model + k]) : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < kRows && row0 + warp < batch)
    warp_norm_row(xs + warp * d_model, d_model, norm_w, norm_b, rms, eps, true);
  __syncthreads();

  tile_matvec<kRows>(xs, d_model, is_z ? inz : inx, channels, d_model, col0, channels, red, out);
  for (int i = threadIdx.x; i < kRows * kTileN; i += kBlock) {
    const int r = i / kTileN;
    const int j = col0 + (i - r * kTileN);
    if (row0 + r >= batch || j >= channels) continue;
    const size_t o = (size_t)(row0 + r) * channels + j;
    if (is_z)
      z_out[o] = out[i];
    else
      xp_out[o] = __float2bfloat16(out[i]);
  }
}

// ---- bf16 layout: 2. conv + SiLU + x_param + dt + recurrence + gate ---------
__global__ void __launch_bounds__(kBlock) ssm_mix_kernel(
    const bf16* __restrict__ conv_state,  // (B, K-1, C)
    const bf16* __restrict__ xp,          // (B, C) from ssm_in_kernel
    const float* __restrict__ z,          // (B, C) from ssm_in_kernel
    const float* ssm,                     // (B, C); may be ssm_out (in place)
    const bf16* __restrict__ conv_w,      // (C, K)
    const bf16* __restrict__ conv_b,      // (C,)
    const bf16* __restrict__ xparam,      // (C, R + 2C)
    const bf16* __restrict__ dt_w,        // (R, H)
    const bf16* __restrict__ dt_b,        // (H,)
    const bf16* __restrict__ a_log,       // (H, N) == (C,)
    const bf16* __restrict__ d_skip,      // (C,)
    float* ssm_out,                       // (B, C); one thread reads, then writes
    bf16* __restrict__ g_out,             // (B, C) scratch
    int batch, int channels, int ksize, int rank, int heads, int d_state) {
  extern __shared__ float smem[];
  float* xa = smem;                               // kRows * C, f32 x_act
  float* xr = xa + kRows * channels;              // kRows * C, bf16-rounded
  float* dtf = xr + kRows * channels;             // kRows * R, bf16-rounded
  float* red = dtf + kRows * rank;                // kWarps * kRows * kTileN
  float* bs = red + kWarps * kRows * kTileN;      // kRows * kTileN
  float* cs = bs + kRows * kTileN;                // kRows * kTileN
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kTileN;
  const int ldw = rank + 2 * channels;

  for (int i = threadIdx.x; i < kRows * channels; i += kBlock) {
    const int r = i / channels;
    const int c = i - r * channels;
    float act = 0.f;
    if (row0 + r < batch) {
      const size_t row = row0 + r;
      const bf16* wc = conv_w + (size_t)c * ksize;
      float yc = 0.f;
      for (int j = 0; j < ksize - 1; ++j)
        yc += to_f32(conv_state[(row * (ksize - 1) + j) * channels + c]) * to_f32(wc[j]);
      yc += to_f32(xp[row * channels + c]) * to_f32(wc[ksize - 1]);
      yc += to_f32(conv_b[c]);
      act = yc * sigmoidf(yc);
    }
    xa[i] = act;
    xr[i] = round_bf16(act);
  }
  __syncthreads();

  // dt_feats: all R columns (every channel's head needs them).
  for (int t0 = 0; t0 < rank; t0 += kTileN) {
    tile_matvec<kRows>(xr, channels, xparam, ldw, channels, t0, rank, red, bs);
    for (int i = threadIdx.x; i < kRows * kTileN; i += kBlock) {
      const int r = i / kTileN;
      const int j = t0 + (i - r * kTileN);
      if (j < rank) dtf[r * rank + j] = round_bf16(bs[i]);
    }
    __syncthreads();
  }
  tile_matvec<kRows>(xr, channels, xparam + rank, ldw, channels, col0, channels, red, bs);
  tile_matvec<kRows>(xr, channels, xparam + rank + channels, ldw, channels, col0, channels, red,
                     cs);

  for (int i = threadIdx.x; i < kRows * kTileN; i += kBlock) {
    const int r = i / kTileN;
    const int c = col0 + (i - r * kTileN);
    if (row0 + r >= batch || c >= channels) continue;
    const size_t o = (size_t)(row0 + r) * channels + c;
    const int head = c / d_state;
    float dt_raw = 0.f;
    for (int q = 0; q < rank; ++q)
      dt_raw = fmaf(dtf[r * rank + q], to_f32(dt_w[(size_t)q * heads + head]), dt_raw);
    const float delta = softplusf(dt_raw + to_f32(dt_b[head]));
    const float a_bar = expf(delta * -expf(to_f32(a_log[c])));
    const float h_new = a_bar * ssm[o] + bs[i];
    const float y = cs[i] * h_new + to_f32(d_skip[c]) * xa[r * channels + c];
    const float zv = z[o];
    ssm_out[o] = h_new;
    g_out[o] = __float2bfloat16(y * (zv * sigmoidf(zv)));
  }
}

__device__ void warp_top2_combine(float logit, int num_experts, float* comb);

// The moe epilogue of one row by one warp: v is the row's n2 (bf16-rounded
// f32, read only). Writes the row's x_q and x_s and its E combine weights
// (E <= 32: lane e holds expert e's logit).
__device__ void warp_moe_epilogue(const float* v, int d, float eps,
                                  const bf16* __restrict__ rln_w, const bf16* __restrict__ rln_b,
                                  const bf16* __restrict__ router_w,
                                  const bf16* __restrict__ router_b, int num_experts,
                                  int8_t* q, float* x_s, float* comb) {
  const int lane = threadIdx.x & 31;
  const float neg_inf = __int_as_float(0xff800000);
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += v[k];
  const float mean = warp_sum(s) / (float)d;
  float v2 = 0.f, m = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float c = v[k] - mean;
    v2 += c * c;
    m = fmaxf(m, fabsf(c));
  }
  const float var = warp_sum(v2) / (float)d;
  const float inv = var > 0.f ? rsqrtf(var + eps) : 0.f;
  const float scale = fmaxf(warp_max(m), 1e-8f) * (1.f / 127.f);
  const float rscale = 1.f / scale;
  for (int k = lane; k < d; k += 32) q[k] = quant_level(__fmul_rn(v[k] - mean, rscale));
  if (lane == 0) *x_s = __fmul_rn(scale, inv);

  float logit = neg_inf;
  for (int e = 0; e < num_experts; ++e) {
    float acc = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float rn = __fadd_rn(__fmul_rn(__fmul_rn(v[k] - mean, inv), to_f32(rln_w[k])),
                                 to_f32(rln_b[k]));
      acc = fmaf(rn, to_f32(router_w[(size_t)k * num_experts + e]), acc);
    }
    const float l = warp_sum(acc) + to_f32(router_b[e]);
    if (lane == e) logit = l;
  }
  warp_top2_combine(logit, num_experts, comb);
}

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

// ---- bf16 layout: 3. out_proj + residual (+ FFN pre-norm) ------------------
__global__ void __launch_bounds__(kBlock) ssm_out_kernel(
    const bf16* __restrict__ g,        // (B, C) from ssm_mix_kernel
    const bf16* __restrict__ out_w,    // (C, D)
    const bf16* __restrict__ h,        // (B, D) residual input
    bf16* __restrict__ h_out,          // (B, D)
    float* __restrict__ hsum,          // (B, D) scratch (dense epilogue only)
    const bf16* __restrict__ fn_w,     // (D,) FFN pre-norm, or nullptr
    const bf16* __restrict__ fn_b,     // (D,), unused for RMSNorm
    const bf16* __restrict__ rln_w,    // (D,) router LayerNorm (moe), or nullptr
    const bf16* __restrict__ rln_b,    // (D,)
    const bf16* __restrict__ router_w, // (D, E); nullptr selects dense/none
    const bf16* __restrict__ router_b, // (E,)
    int rms, float eps,
    void* __restrict__ ffn_in,         // (B, D) bf16, int8 x_q (moe), or nullptr
    float* __restrict__ ffn_scale,     // (B, 1) x_s (moe)
    float* __restrict__ comb,          // (B, E) combine weights (moe)
    int* __restrict__ tickets,         // (row tiles,), zeroed by ssm_in_kernel
    int batch, int channels, int d_model, int num_experts) {
  extern __shared__ float smem[];
  // xs holds the g rows, and in the epilogue the full hsum rows.
  const int width = max(channels, d_model);
  float* xs = smem;                                          // kRows * max(C, D)
  float* red = xs + kRows * width;                           // kWarps * kRows * kTileN
  float* out = red + kWarps * kRows * kTileN;                // kRows * kTileN
  __shared__ int is_last;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kTileN;
  const bool epilogue = ffn_in != nullptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kRows * channels; i += kBlock) {
    const int r = i / channels;
    const int c = i - r * channels;
    xs[i] = row0 + r < batch ? to_f32(g[(size_t)(row0 + r) * channels + c]) : 0.f;
  }
  __syncthreads();
  tile_matvec<kRows>(xs, channels, out_w, d_model, channels, col0, d_model, red, out);
  for (int i = threadIdx.x; i < kRows * kTileN; i += kBlock) {
    const int r = i / kTileN;
    const int j = col0 + (i - r * kTileN);
    if (row0 + r >= batch || j >= d_model) continue;
    const size_t o = (size_t)(row0 + r) * d_model + j;
    const float s = to_f32(h[o]) + out[i];
    h_out[o] = __float2bfloat16(s);
    if (epilogue) hsum[o] = s;
  }
  if (!epilogue) return;

  // The last block of this row tile to finish normalises the full rows.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&tickets[blockIdx.y], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  if (warp >= kRows || row0 + warp >= batch) return;
  // Other blocks wrote these rows during this launch: read them from L2
  // (__ldcg), never from this SM's L1.
  const size_t row = row0 + warp;
  const float* src = hsum + row * d_model;
  float* v = xs + warp * d_model;
  for (int k = lane; k < d_model; k += 32) v[k] = __ldcg(src + k);
  __syncwarp();
  warp_norm_row(v, d_model, fn_w, fn_b, rms, eps, true);
  __syncwarp();
  if (router_w != nullptr) {
    warp_moe_epilogue(v, d_model, eps, rln_w, rln_b, router_w, router_b, num_experts,
                      static_cast<int8_t*>(ffn_in) + row * d_model, ffn_scale + row,
                      comb + row * num_experts);
  } else {
    bf16* dst = static_cast<bf16*>(ffn_in) + row * d_model;
    for (int k = lane; k < d_model; k += 32) dst[k] = __float2bfloat16(v[k]);
  }
}

// ---- int8 layout ------------------------------------------------------------

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

// The row kernels of the int8 layout compute each quantized operand of a
// product once, one block of kBlock threads a row.

// A pre-norm and its row quantization: the mixer's input (x: h, bf16, the
// normed values in f32) or the dense and moe epilogues' FFN input (x: hsum,
// f32, the normed values rounded to bf16, `round_out`), with
// common.cuh::warp_norm_row's formulas; with router_w, the moe epilogue
// (warp_moe_epilogue's formulas; the router's logits summed a warp at a
// time, the top-2 by warp 0). Shared memory: the row, D floats.
template <typename T>
__global__ void __launch_bounds__(kBlock) ssm_norm_quant_kernel(
    const T* __restrict__ x,              // (B, D)
    const bf16* __restrict__ norm_w, const bf16* __restrict__ norm_b, int rms, float eps,
    int round_out,
    const bf16* __restrict__ rln_w, const bf16* __restrict__ rln_b,
    const bf16* __restrict__ router_w,    // (D, E), or nullptr
    const bf16* __restrict__ router_b,
    int8_t* __restrict__ x_q,             // (B, D)
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
  int8_t* q = x_q + row * d_model;
  if (router_w == nullptr) {
    block_quant_row(v, d_model, red, q, x_s + row);
    return;
  }
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

// x_act = silu(conv) of a row and its row quantization. Shared memory: C
// floats.
__global__ void __launch_bounds__(kBlock) ssm_conv_quant_kernel(
    const bf16* __restrict__ conv_state,  // (B, K-1, C)
    const bf16* __restrict__ xp,          // (B, C)
    const bf16* __restrict__ conv_w,      // (C, K)
    const bf16* __restrict__ conv_b,      // (C,)
    int8_t* __restrict__ xa_q,            // (B, C)
    float* __restrict__ xa_s,             // (B,)
    int channels, int ksize) {
  extern __shared__ float v[];
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  for (int c = 4 * threadIdx.x; c < channels; c += 4 * kBlock) {
    float a[4];
    conv_silu4(conv_state, xp, conv_w, conv_b, row, c, channels, ksize, a);
    *reinterpret_cast<float4*>(v + c) = make_float4(a[0], a[1], a[2], a[3]);
  }
  block_quant_row(v, channels, red, xa_q + row * channels, xa_s + row);
}

// The bytes of dt_proj_w in ssm_recur_quant_kernel's shared memory, a
// multiple of 16 so that the f32 values after it stay aligned.
__host__ __device__ constexpr size_t recur_dtw_bytes(int rank, int heads) {
  return ((size_t)rank * heads * 2 + 15) / 16 * 16;
}

// The recurrence of a row and the row quantization of its gate: delta =
// softplus(dt . dt_proj_w + dt_proj_b) (the bf16 kernel's order of f32 fused
// multiply-adds), h' = exp(delta[head] * -exp(A_log)) * ssm + Bs into ssm_out
// (each element read and then written by one thread, so ssm_out may be ssm),
// g = (Cs * h' + D * xa) * silu(z). Shared memory: dt_proj_w (R x H bf16),
// then g (C), dt (R) and delta (H) floats.
__global__ void __launch_bounds__(kBlock) ssm_recur_quant_kernel(
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
    int8_t* __restrict__ g_q,             // (B, C)
    float* __restrict__ g_s,              // (B,)
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
  block_quant_row(g, channels, red, g_q + row * channels, g_s + row);
}

// The products of the int8 layout (decode_gemm.cuh): the quantized rows
// streamed by TMA (or the producer's own loads) beside the weight tiles, K
// split over a cluster of `split` blocks with the exact int32 sums pushed
// to their owners, and each launch's epilogue:
//   kIn:  in_proj x or z, acc * x_s * w_s: xp (bf16) or z (f32); column
//         tiles 0 .. ceil(C / 128) - 1 are x's, the rest z's;
//   kMix: x_param, acc * xa_s * w_s: dt (bf16-rounded) | B | C (f32);
//   kOut: out_proj, h + acc * g_s * w_s: h_out (bf16) and hsum (f32, for
//         the epilogue).
enum StepProduct { kIn = 0, kMix = 1, kOut = 2 };

struct StepEpilogue {
  const float* x_s;       // (B,) the quantized rows' scales
  const float* ws;        // (1, N) the weight's column scales (in: x's)
  const float* ws_z;      // in: z's
  bf16* xp;               // in: (B, C)
  float* z;               // in: (B, C)
  float* bc;              // mix: (B, bc_stride(R, C))
  const bf16* h;          // out: (B, D)
  bf16* h_out;            // out: (B, D)
  float* hsum;            // out: (B, D), or nullptr
  int batch, n, channels, rank;
};

template <int BR, int kMode>
__global__ void __launch_bounds__(kThreads, 1) ssm_gemm_q_kernel(
    const __grid_constant__ CUtensorMap x_map,    // the quantized rows (B, K), boxes BR x 128
    const __grid_constant__ CUtensorMap w_map,    // the weight (K, N); in: in_proj x
    const __grid_constant__ CUtensorMap wz_map,   // in: in_proj z
    DgRows rows, DgWeight w, DgWeight wz, StepEpilogue ep, int split, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t stage_bytes = BR * 128 + kDgW8Bytes;
  int* part = reinterpret_cast<int*>(smem + (size_t)stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)stages * stage_bytes +
                                               dg_part_bytes(BR, split));
  const int col_tiles = (ep.n + kDgCols - 1) / kDgCols;
  const int ct = blockIdx.x / split, rank = blockIdx.x % split;
  const bool is_z = kMode == kIn && ct >= col_tiles;
  const int n0 = (is_z ? ct - col_tiles : ct) * kDgCols;
  const int m0 = blockIdx.y * BR;
  const int nch = (rows.k + kDgKC - 1) / kDgKC;
  const int c_lo = rank * nch / split, c_hi = (rank + 1) * nch / split;
  const DgWeight wt{is_z ? wz.w : w.w, w.k, w.n, is_z ? wz.tma : w.tma};
  const DgRing ring{smem, bars, bars + stages, BR * 128, kDgW8Bytes, stages};
  dg_init(ring, dg_full_count(rows, wt));
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const DgChunks ch{c_lo, 1, c_hi - c_lo, 1};
    dg_produce<kDgI8>(ring, is_z ? &wz_map : &w_map, nullptr, &x_map, wt, rows, ch, n0, m0, 0,
                      c_hi - c_lo, threadIdx.x - kDgConsumerThreads);
    if (split > 1) {
      __syncwarp();
      cluster.sync();
    }
    return;
  }
  regs_alloc<kDgConsumerRegs>();
  const DgLane L;
  int acc[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
  dg_consume<kDgI8, BR>(ring, L, 0, c_hi - c_lo, acc);
  const uint32_t mine = dg_owned_mask(rank, split, BR / 8);
  if (split > 1) dg_split_sum<BR>(acc, part, L, rank, split, mine, cluster);
  const float* ws = is_z ? ep.ws_z : ep.ws;
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) {
    if (!((mine >> (i / 4)) & 1)) continue;
    const int row = m0 + L.row(i), col = n0 + L.column(i);
    if (row >= ep.batch || col >= ep.n) continue;
    const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), ep.x_s[row]), ws[col]);
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

// The bf16 layout's three launches.
int launch_step_bf16(const bf16* h, const bf16* conv_state, const float* ssm,
                     const bf16* norm_w, const bf16* norm_b, const bf16* inx, const bf16* inz,
                     const bf16* conv_w, const bf16* conv_b, const bf16* xparam,
                     const bf16* dt_w, const bf16* dt_b, const bf16* a_log, const bf16* d_skip,
                     const bf16* out_w, const bf16* fn_w, const bf16* fn_b, const bf16* rln_w,
                     const bf16* rln_b, const bf16* router_w, const bf16* router_b,
                     bf16* h_out, bf16* xp_out, float* ssm_out, void* ffn_in, float* ffn_scale,
                     float* comb, float* z, bf16* g, float* hsum, int* tickets, int batch,
                     int d_model, int channels, int ksize, int rank, int heads, int d_state,
                     int num_experts, int rms, float eps, cudaStream_t s) {
  const int row_tiles = (batch + kRows - 1) / kRows;
  const int col_tiles_c = (channels + kTileN - 1) / kTileN;
  const int col_tiles_d = (d_model + kTileN - 1) / kTileN;
  const size_t mat_floats = (size_t)kWarps * kRows * kTileN + kRows * kTileN;
  const size_t smem_in = ((size_t)kRows * d_model + mat_floats) * sizeof(float);
  const size_t smem_mix = ((size_t)2 * kRows * channels + (size_t)kRows * rank + mat_floats +
                           kRows * kTileN) * sizeof(float);
  const size_t smem_out =
      ((size_t)kRows * std::max(channels, d_model) + mat_floats) * sizeof(float);
  cudaError_t err = allow_smem(ssm_in_kernel, smem_in);
  if (err == cudaSuccess) err = allow_smem(ssm_mix_kernel, smem_mix);
  if (err == cudaSuccess) err = allow_smem(ssm_out_kernel, smem_out);
  if (err != cudaSuccess) return static_cast<int>(err);

  ssm_in_kernel<<<dim3(2 * col_tiles_c, row_tiles), kBlock, smem_in, s>>>(
      h, norm_w, norm_b, rms, eps, inx, inz, xp_out, z, tickets, batch, d_model, channels);
  ssm_mix_kernel<<<dim3(col_tiles_c, row_tiles), kBlock, smem_mix, s>>>(
      conv_state, xp_out, z, ssm, conv_w, conv_b, xparam, dt_w, dt_b, a_log, d_skip, ssm_out, g,
      batch, channels, ksize, rank, heads, d_state);
  ssm_out_kernel<<<dim3(col_tiles_d, row_tiles), kBlock, smem_out, s>>>(
      g, out_w, h, h_out, hsum, fn_w, fn_b, rln_w, rln_b, router_w, router_b, rms, eps,
      fn_w != nullptr ? ffn_in : nullptr, ffn_scale, comb, tickets, batch, channels, d_model,
      num_experts);
  return static_cast<int>(cudaGetLastError());
}

// A tensor map over a row-major int8 (outer, inner) matrix in boxes of box
// rows x 128 bytes, or none (*tma 0) for the producer's own loads where the
// row is not a multiple of 16 bytes or the base not 16-byte aligned.
int int8_map(CUtensorMap* map, const void* base, int outer, int inner, int box, int* tma) {
  memset(map, 0, sizeof(*map));
  *tma = inner % 16 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
  return *tma ? make_map_2d(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, inner, outer, 128, box)
              : 0;
}

// The int8 layout's scratch, carved from one buffer at 256-byte boundaries:
// the quantized rows of the three products and their scales, z, dt | B | C
// and hsum.
struct StepScratch {
  int8_t *x_q, *xa_q, *g_q;
  float *x_s, *xa_s, *g_s, *z, *bc, *hsum;
  size_t bytes;
  StepScratch(void* base, int batch, int d_model, int channels, int rank) {
    unsigned char* p = static_cast<unsigned char*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      unsigned char* q = p == nullptr ? nullptr : p + off;
      off += (n + 255) / 256 * 256;
      return q;
    };
    const size_t b = batch;
    x_q = reinterpret_cast<int8_t*>(take(b * d_model));
    xa_q = reinterpret_cast<int8_t*>(take(b * channels));
    g_q = reinterpret_cast<int8_t*>(take(b * channels));
    x_s = reinterpret_cast<float*>(take(b * 4));
    xa_s = reinterpret_cast<float*>(take(b * 4));
    g_s = reinterpret_cast<float*>(take(b * 4));
    z = reinterpret_cast<float*>(take(b * channels * 4));
    bc = reinterpret_cast<float*>(take(b * bc_stride(rank, channels) * 4));
    hsum = reinterpret_cast<float*>(take(b * d_model * 4));
    bytes = off;
  }
};

// One product of the int8 layout at a row tile of BR rows: the rows x_q (B,
// K) against the weight w (K, N) (in: and wz), on the plan's split and
// stages.
template <int BR, int kMode>
int step_gemm(const int8_t* x_q, int batch, int k, const int8_t* w, const int8_t* wz, int n,
              StepEpilogue ep, int split, int stages, cudaStream_t s) {
  CUtensorMap xm, wm, wzm;
  int tx = 0, tw = 0, tz = 0;
  int err = int8_map(&xm, x_q, batch, k, BR, &tx);
  if (err == 0) err = int8_map(&wm, w, k, n, kDgKC, &tw);
  if (err == 0) err = int8_map(&wzm, wz != nullptr ? wz : w, k, n, kDgKC, &tz);
  if (err != 0) return err;
  const int col_tiles = (n + kDgCols - 1) / kDgCols * (kMode == kIn ? 2 : 1);
  return dg_launch(ssm_gemm_q_kernel<BR, kMode>,
                   dim3(col_tiles * split, (batch + BR - 1) / BR), dim3(kThreads), split,
                   dg_smem_bytes(BR, stages, BR * 128 + kDgW8Bytes, split, 0), s, xm, wm, wzm,
                   DgRows{x_q, batch, k, tx}, DgWeight{w, k, n, tw},
                   DgWeight{wz != nullptr ? wz : w, k, n, tz}, ep, split, stages);
}

// The int8 layout's launches at a row tile of BR rows: the mixer's pre-norm
// and quantization, in_proj x and z, conv + quantization, x_param, the
// recurrence + quantization of g, out_proj, and with an epilogue the FFN
// input. splits[i] and stages[i] are the plan of product i (in, mix, out).
template <int BR>
int launch_step_int8(const bf16* h, const bf16* conv_state, const float* ssm,
                     const bf16* norm_w, const bf16* norm_b, const int8_t* inx_q,
                     const float* inx_s, const int8_t* inz_q, const float* inz_s,
                     const bf16* conv_w, const bf16* conv_b, const int8_t* xparam_q,
                     const float* xparam_s, const bf16* dt_w, const bf16* dt_b,
                     const bf16* a_log, const bf16* d_skip, const int8_t* out_q,
                     const float* out_s, const bf16* fn_w, const bf16* fn_b, const bf16* rln_w,
                     const bf16* rln_b, const bf16* router_w, const bf16* router_b,
                     bf16* h_out, bf16* xp_out, float* ssm_out, int8_t* x_q, float* x_s,
                     float* comb, const StepScratch& sc, int batch, int d_model, int channels,
                     int ksize, int rank, int heads, int d_state, int num_experts, int rms,
                     float eps, const int* splits, const int* stages, cudaStream_t s) {
  const size_t row_d = (size_t)d_model * sizeof(float);
  const dim3 rows_grid(batch), row_block(kBlock);
  int err = dg_launch(ssm_norm_quant_kernel<bf16>, rows_grid, row_block, 1, row_d, s, h,
                      norm_w, norm_b, rms, eps, 0, nullptr, nullptr, nullptr, nullptr, sc.x_q,
                      sc.x_s, nullptr, d_model, 0);
  if (err != 0) return err;
  StepEpilogue ep = {};
  ep.batch = batch;
  ep.channels = channels;
  ep.rank = rank;
  ep.x_s = sc.x_s;
  ep.ws = inx_s;
  ep.ws_z = inz_s;
  ep.xp = xp_out;
  ep.z = sc.z;
  ep.n = channels;
  err = step_gemm<BR, kIn>(sc.x_q, batch, d_model, inx_q, inz_q, channels, ep, splits[0],
                           stages[0], s);
  if (err != 0) return err;
  err = dg_launch(ssm_conv_quant_kernel, rows_grid, row_block, 1, channels * sizeof(float), s,
                  conv_state, static_cast<const bf16*>(xp_out), conv_w, conv_b, sc.xa_q,
                  sc.xa_s, channels, ksize);
  if (err != 0) return err;
  ep.x_s = sc.xa_s;
  ep.ws = xparam_s;
  ep.bc = sc.bc;
  ep.n = rank + 2 * channels;
  err = step_gemm<BR, kMix>(sc.xa_q, batch, channels, xparam_q, nullptr, ep.n, ep, splits[1],
                            stages[1], s);
  if (err != 0) return err;
  err = dg_launch(ssm_recur_quant_kernel, rows_grid, row_block, 1,
                  recur_dtw_bytes(rank, heads) + (size_t)(channels + rank + heads) * 4, s,
                  static_cast<const float*>(sc.bc), static_cast<const float*>(sc.z), ssm,
                  conv_state, static_cast<const bf16*>(xp_out), conv_w, conv_b, dt_w, dt_b,
                  a_log, d_skip, ssm_out, sc.g_q, sc.g_s, channels, ksize, rank, heads, d_state);
  if (err != 0) return err;
  ep.x_s = sc.g_s;
  ep.ws = out_s;
  ep.h = h;
  ep.h_out = h_out;
  ep.hsum = fn_w != nullptr ? sc.hsum : nullptr;
  ep.n = d_model;
  err = step_gemm<BR, kOut>(sc.g_q, batch, channels, out_q, nullptr, d_model, ep, splits[2],
                            stages[2], s);
  if (err != 0 || fn_w == nullptr) return err != 0 ? err : static_cast<int>(cudaGetLastError());
  err = dg_launch(ssm_norm_quant_kernel<float>, rows_grid, row_block, 1, row_d, s,
                  static_cast<const float*>(sc.hsum), fn_w, fn_b, rms, eps, 1, rln_w, rln_b,
                  router_w, router_b, x_q, x_s, comb, d_model, num_experts);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// One decode step of one layer's mixer, bf16 weight layout. conv_state is
// (B, K-1, C); ssm_out may be ssm, to update the state in place; z, g, hsum
// and tickets are scratch the caller allocates: z (B, C) f32, g (B, C) bf16,
// hsum (B, D) f32, tickets (ceil(B / 8),) int32. fn_w == nullptr selects
// ffn_mode "none" (ffn_in and hsum unused); router_w == nullptr selects
// "dense" (ffn_in is the bf16 FFN input), else "moe": ffn_in is the (B, D)
// int8 x_q, ffn_scale the (B, 1) f32 x_s and comb the (B, E) f32 combine
// weights, E <= 32. Returns cudaGetLastError().
extern "C" int apertis_ssm_decode_step(
    const void* h, const void* conv_state, const void* ssm, const void* norm_w,
    const void* norm_b, const void* inx_w, const void* inz_w, const void* conv_w,
    const void* conv_b, const void* xparam_w, const void* dt_w, const void* dt_b,
    const void* a_log, const void* d_skip, const void* out_w, const void* fn_w,
    const void* fn_b, const void* rln_w, const void* rln_b, const void* router_w,
    const void* router_b, void* h_out, void* xp_out, void* ssm_out, void* ffn_in,
    void* ffn_scale, void* comb, void* z, void* g, void* hsum, void* tickets, int batch,
    int d_model, int channels, int ksize, int rank, int heads, int d_state,
    int num_experts, int rms, float eps, void* stream) {
  if (router_w != nullptr && (num_experts < 2 || num_experts > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  return launch_step_bf16(
      b(h), b(conv_state), static_cast<const float*>(ssm), b(norm_w), b(norm_b), b(inx_w),
      b(inz_w), b(conv_w), b(conv_b), b(xparam_w), b(dt_w), b(dt_b), b(a_log), b(d_skip),
      b(out_w), b(fn_w), b(fn_b), b(rln_w), b(rln_b), b(router_w), b(router_b),
      static_cast<bf16*>(h_out), static_cast<bf16*>(xp_out), static_cast<float*>(ssm_out),
      ffn_in, static_cast<float*>(ffn_scale), static_cast<float*>(comb),
      static_cast<float*>(z), static_cast<bf16*>(g), static_cast<float*>(hsum),
      static_cast<int*>(tickets), batch, d_model, channels, ksize, rank, heads, d_state,
      num_experts, rms, eps, static_cast<cudaStream_t>(stream));
}

// The same step with the int8 weight layout: each of in_proj x / z, x_param
// and out_proj is an int8 (in, out) weight with (1, out) f32 scales; D and C
// must be multiples of 4. `scratch` holds apertis_ssm_step_int8_scratch
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
  const int* sp = static_cast<const int*>(splits);
  const int* st = static_cast<const int*>(stages);
  if (batch <= 0 || d_model % 4 != 0 || channels % 4 != 0 || d_state <= 0 || rank <= 0 ||
      heads * d_state != channels || (row_tile != 16 && row_tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (router_w != nullptr && (num_experts < 2 || num_experts > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks[3] = {(d_model + kDgKC - 1) / kDgKC, (channels + kDgKC - 1) / kDgKC,
                         (channels + kDgKC - 1) / kDgKC};
  for (int i = 0; i < 3; ++i)
    if (sp[i] < 1 || sp[i] > 8 || sp[i] > chunks[i] || st[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  const StepScratch sc(scratch, batch, d_model, channels, rank);
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto q = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto run = row_tile == 16 ? &launch_step_int8<16> : &launch_step_int8<64>;
  return run(b(h), b(conv_state), f(ssm), b(norm_w), b(norm_b), q(inx_q), f(inx_s), q(inz_q),
             f(inz_s), b(conv_w), b(conv_b), q(xparam_q), f(xparam_s), b(dt_w), b(dt_b),
             b(a_log), b(d_skip), q(out_q), f(out_s), b(fn_w), b(fn_b), b(rln_w), b(rln_b),
             b(router_w), b(router_b), static_cast<bf16*>(h_out), static_cast<bf16*>(xp_out),
             static_cast<float*>(ssm_out), static_cast<int8_t*>(ffn_in),
             static_cast<float*>(ffn_scale), static_cast<float*>(comb), sc, batch, d_model,
             channels, ksize, rank, heads, d_state, num_experts, rms, eps, sp, st,
             static_cast<cudaStream_t>(stream));
}

// The bytes of apertis_ssm_decode_step_int8's scratch for B rows, D, C and R.
extern "C" int apertis_ssm_step_int8_scratch(int batch, int d_model, int channels, int rank) {
  return static_cast<int>(StepScratch(nullptr, batch, d_model, channels, rank).bytes);
}

// The resources of the int8 layout's product kernel `kernel` (0 in, 1 mix,
// 2 out) at a row tile of `row_tile` rows and `smem` bytes of dynamic
// shared memory (hopper.cuh::kernel_resources), into out[0..4].
extern "C" int apertis_ssm_step_int8_resources(int kernel, int row_tile, int smem, int* out) {
  if (row_tile != 16 && row_tile != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bool r16 = row_tile == 16;
  switch (kernel) {
    case 0: return kernel_resources(r16 ? &ssm_gemm_q_kernel<16, kIn> : &ssm_gemm_q_kernel<64, kIn>,
                                    kThreads, smem, out);
    case 1: return kernel_resources(r16 ? &ssm_gemm_q_kernel<16, kMix>
                                        : &ssm_gemm_q_kernel<64, kMix>,
                                    kThreads, smem, out);
    case 2: return kernel_resources(r16 ? &ssm_gemm_q_kernel<16, kOut>
                                        : &ssm_gemm_q_kernel<64, kOut>,
                                    kThreads, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

