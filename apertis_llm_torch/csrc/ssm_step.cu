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
// (ssm_step.py:39-49, warp_quant_row). g therefore stays f32 between
// launches 2 and 3. dt_proj, conv, A_log and D stay bf16 in both layouts.
//
// Bound on the H100: bytes. At decode batch sizes every step reads the
// mixer's weights (about 10.6 MB per layer of the 1.5B model in bf16, 5.3 MB
// in int8) for 2 * rows operations per weight, far below the tensor-core
// line. The difficulty is the chain in_proj -> conv -> x_param -> dt ->
// recurrence -> out_proj, in which each stage needs whole rows of the stage
// before, and in the int8 layout each quantization needs a whole row too.
//
// Design: three launches per layer, each a grid of (column tile, row tile)
// blocks of 256 threads, so every stage streams its weight matrix across the
// whole card instead of through one block:
//   1. ssm_in_kernel:  pre-norm (+ row quantization) + in_proj x and z, 64
//      output columns a block;
//   2. ssm_mix_kernel: conv + SiLU (+ row quantization) + x_param + dt +
//      recurrence + gate for 64 channels a block; the block recomputes the
//      whole x_act row and the small dt_feats row (R values) that every
//      channel needs;
//   3. ssm_out_kernel: (row quantization of g +) out_proj + residual for 64
//      columns a block. With the dense or moe epilogue the last block of each
//      row tile to finish (an integer ticket, no float atomics) applies the
//      FFN pre-norm (and quantization, and the router) to the full rows, one
//      warp a row.
// Every launch holds whole rows in shared memory, so each per-row
// quantization is computed in the block that needs it (redundantly across
// the column tiles, with the same result). A block holds up to kRows batch
// rows and reads the (in, out) weights with output columns across lanes, so
// reads coalesce; the K axis is split across the 8 warps (common.cuh:
// tile_matvec in f32, tile_matvec_i8 in exact int32 with __dp4a). The TPU
// kernel's layer-stacked weights, scalar-prefetched layer id, split x_param
// stacks and 0/1 head-expansion matrix are not needed: the caller passes
// each layer's pointers, the x_param weight and its scales are cut into dt /
// B / C columns by pointer offset, and a thread computes its head as c / N.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 8;  // batch rows per block (one warp normalises one row)

// Pointers of one layer's projection: weight and, in the int8 layout, its
// (1, out) f32 scales (null in the bf16 layout).
template <bool kQ>
struct Proj {
  typedef typename std::conditional<kQ, int8_t, bf16>::type W;
  const W* w;
  const float* s;
};

// One tile of output columns of `rows` x `proj`: f32 rows xs in the bf16
// layout; in the int8 layout the quantized rows xq with their scales rs,
// dequantized as acc * rs[r] * w_s[col] (ssm_step.py:46-49). Result in out.
template <bool kQ>
__device__ void project(const float* xs, const int8_t* xq, const float* rs, int ldx,
                        Proj<kQ> p, int ldw, int k_total, int col0, int ncols,
                        float* red, float* out) {
  if constexpr (kQ) {
    int* iout = reinterpret_cast<int*>(out);
    tile_matvec_i8<kRows>(xq, ldx, p.w, ldw, k_total, col0, ncols,
                          reinterpret_cast<int*>(red), iout);
    for (int i = threadIdx.x; i < kRows * kTileN; i += kBlock) {
      const int r = i / kTileN;
      const int j = col0 + (i - r * kTileN);
      out[i] = j < ncols ? __fmul_rn(__fmul_rn((float)iout[i], rs[r]), p.s[j]) : 0.f;
    }
    __syncthreads();
  } else {
    tile_matvec<kRows>(xs, ldx, p.w, ldw, k_total, col0, ncols, red, out);
  }
}

// ---- 1. pre-norm + in_proj x / z ------------------------------------------
template <bool kQ>
__global__ void __launch_bounds__(kBlock) ssm_in_kernel(
    const bf16* __restrict__ h,       // (B, D)
    const bf16* __restrict__ norm_w,  // (D,)
    const bf16* __restrict__ norm_b,  // (D,), unused for RMSNorm
    int rms, float eps,
    Proj<kQ> inx,                     // (D, C)
    Proj<kQ> inz,                     // (D, C)
    bf16* __restrict__ xp_out,        // (B, C) new conv-window entry
    float* __restrict__ z_out,        // (B, C) scratch
    int* __restrict__ tickets,        // (row tiles,) scratch for ssm_out_kernel
    int batch, int d_model, int channels) {
  extern __shared__ float smem[];
  // The int8 layout needs the f32 rows xs only until they are quantized;
  // the product's buffers then reuse them, which keeps two blocks on an SM.
  const int mat_floats = kWarps * kRows * kTileN + kRows * kTileN;
  float* xs = smem;                                        // kRows * D
  float* red = kQ ? smem : smem + kRows * d_model;         // kWarps * kRows * kTileN
  float* out = red + kWarps * kRows * kTileN;              // kRows * kTileN
  float* rs = smem + (kQ ? max(kRows * d_model, mat_floats)  // kRows row scales (int8)
                         : kRows * d_model + mat_floats);
  int8_t* xq = reinterpret_cast<int8_t*>(rs + kRows);      // kRows * D (int8)
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
    warp_norm_row(xs + warp * d_model, d_model, norm_w, norm_b, rms, eps, !kQ);
  // Rows past the batch are zeros and quantize to zeros.
  if constexpr (kQ)
    if (warp < kRows) warp_quant_row(xs + warp * d_model, d_model, xq + warp * d_model, rs + warp);
  __syncthreads();

  project<kQ>(xs, xq, rs, d_model, is_z ? inz : inx, channels, d_model, col0, channels,
              red, out);
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

// ---- 2. conv + SiLU + x_param + dt + recurrence + gate ---------------------
template <bool kQ>
__global__ void __launch_bounds__(kBlock) ssm_mix_kernel(
    const bf16* __restrict__ conv_state,  // (B, K-1, C)
    const bf16* __restrict__ xp,          // (B, C) from ssm_in_kernel
    const float* __restrict__ z,          // (B, C) from ssm_in_kernel
    const float* ssm,                     // (B, C); may be ssm_out (in place)
    const bf16* __restrict__ conv_w,      // (C, K)
    const bf16* __restrict__ conv_b,      // (C,)
    Proj<kQ> xparam,                      // (C, R + 2C), scales (R + 2C,)
    const bf16* __restrict__ dt_w,        // (R, H)
    const bf16* __restrict__ dt_b,        // (H,)
    const bf16* __restrict__ a_log,       // (H, N) == (C,)
    const bf16* __restrict__ d_skip,      // (C,)
    float* ssm_out,                       // (B, C); one thread reads, then writes
    void* __restrict__ g_out,             // (B, C) scratch: bf16, or f32 (int8)
    int batch, int channels, int ksize, int rank, int heads, int d_state) {
  extern __shared__ float smem[];
  float* xa = smem;                               // kRows * C, f32 x_act
  float* xr = xa + kRows * channels;              // kRows * C, bf16-rounded (bf16)
  float* dtf = xr + kRows * channels;             // kRows * R, bf16-rounded
  float* red = dtf + kRows * rank;                // kWarps * kRows * kTileN
  float* bs = red + kWarps * kRows * kTileN;      // kRows * kTileN
  float* cs = bs + kRows * kTileN;                // kRows * kTileN
  float* as = cs + kRows * kTileN;                // kRows row scales (int8)
  int8_t* xq = reinterpret_cast<int8_t*>(as + kRows);  // kRows * C (int8)
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
    if constexpr (!kQ) xr[i] = round_bf16(act);
  }
  __syncthreads();
  if constexpr (kQ) {
    const int warp = threadIdx.x >> 5;
    if (warp < kRows) warp_quant_row(xa + warp * channels, channels, xq + warp * channels, as + warp);
    __syncthreads();
  }
  const Proj<kQ> p_b = {xparam.w + rank, kQ ? xparam.s + rank : nullptr};
  const Proj<kQ> p_c = {xparam.w + rank + channels, kQ ? xparam.s + rank + channels : nullptr};

  // dt_feats: all R columns (every channel's head needs them).
  for (int t0 = 0; t0 < rank; t0 += kTileN) {
    project<kQ>(xr, xq, as, channels, xparam, ldw, channels, t0, rank, red, bs);
    for (int i = threadIdx.x; i < kRows * kTileN; i += kBlock) {
      const int r = i / kTileN;
      const int j = t0 + (i - r * kTileN);
      if (j < rank) dtf[r * rank + j] = round_bf16(bs[i]);
    }
    __syncthreads();
  }
  project<kQ>(xr, xq, as, channels, p_b, ldw, channels, col0, channels, red, bs);
  project<kQ>(xr, xq, as, channels, p_c, ldw, channels, col0, channels, red, cs);

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
    const float g = y * (zv * sigmoidf(zv));
    if constexpr (kQ)
      static_cast<float*>(g_out)[o] = g;
    else
      static_cast<bf16*>(g_out)[o] = __float2bfloat16(g);
  }
}

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

// ---- 3. out_proj + residual (+ FFN pre-norm) --------------------------------
template <bool kQ>
__global__ void __launch_bounds__(kBlock) ssm_out_kernel(
    const void* __restrict__ g,        // (B, C) from ssm_mix_kernel: bf16, f32 (int8)
    Proj<kQ> out_p,                    // (C, D)
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
    void* __restrict__ ffn_in,         // (B, D) bf16, int8 x_q (int8 or moe), or nullptr
    float* __restrict__ ffn_scale,     // (B, 1) x_s (int8 layout or moe)
    float* __restrict__ comb,          // (B, E) combine weights (moe)
    int* __restrict__ tickets,         // (row tiles,), zeroed by ssm_in_kernel
    int batch, int channels, int d_model, int num_experts) {
  extern __shared__ float smem[];
  // xs holds the g rows, and in the epilogue the full hsum rows.
  const int width = max(channels, d_model);
  float* xs = smem;                                          // kRows * max(C, D)
  float* red = xs + kRows * width;                           // kWarps * kRows * kTileN
  float* out = red + kWarps * kRows * kTileN;                // kRows * kTileN
  float* gs = out + kRows * kTileN;                          // kRows row scales (int8)
  int8_t* xq = reinterpret_cast<int8_t*>(gs + kRows);        // kRows * C (int8)
  __shared__ int is_last;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kTileN;
  const bool epilogue = ffn_in != nullptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kRows * channels; i += kBlock) {
    const int r = i / channels;
    const int c = i - r * channels;
    const size_t o = (size_t)(row0 + r) * channels + c;
    float v = 0.f;
    if (row0 + r < batch)
      v = kQ ? static_cast<const float*>(g)[o] : to_f32(static_cast<const bf16*>(g)[o]);
    xs[i] = v;
  }
  __syncthreads();
  if constexpr (kQ) {
    if (warp < kRows) warp_quant_row(xs + warp * channels, channels, xq + warp * channels, gs + warp);
    __syncthreads();
  }
  project<kQ>(xs, xq, gs, channels, out_p, d_model, channels, col0, d_model, red, out);
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
  } else if constexpr (kQ) {
    // The quantized FFN input: the row is in shared memory that is free now.
    int8_t* q = static_cast<int8_t*>(ffn_in) + row * d_model;
    warp_quant_row(v, d_model, q, ffn_scale + row);
  } else {
    bf16* dst = static_cast<bf16*>(ffn_in) + row * d_model;
    for (int k = lane; k < d_model; k += 32) dst[k] = __float2bfloat16(v[k]);
  }
}

template <bool kQ>
int launch_step(const void* h, const void* conv_state, const void* ssm, const void* norm_w,
                const void* norm_b, Proj<kQ> inx, Proj<kQ> inz, const void* conv_w,
                const void* conv_b, Proj<kQ> xparam, const void* dt_w, const void* dt_b,
                const void* a_log, const void* d_skip, Proj<kQ> out_p, const void* fn_w,
                const void* fn_b, const void* rln_w, const void* rln_b, const void* router_w,
                const void* router_b, void* h_out, void* xp_out, void* ssm_out, void* ffn_in,
                void* ffn_scale, void* comb, void* z, void* g, void* hsum, void* tickets,
                int batch, int d_model, int channels, int ksize, int rank, int heads,
                int d_state, int num_experts, int rms, float eps, cudaStream_t s) {
  const int row_tiles = (batch + kRows - 1) / kRows;
  const int col_tiles_c = (channels + kTileN - 1) / kTileN;
  const int col_tiles_d = (d_model + kTileN - 1) / kTileN;
  const size_t red_floats = (size_t)kWarps * kRows * kTileN;
  // int8 layout: kRows row scales and kRows int8 rows after the f32 buffers.
  auto q_bytes = [](int k) { return kQ ? kRows * sizeof(float) + (size_t)kRows * k : 0; };

  const size_t mat_floats = red_floats + kRows * kTileN;
  const size_t xs_floats = (size_t)kRows * d_model;
  const size_t smem_in = (kQ ? std::max(xs_floats, mat_floats) : xs_floats + mat_floats) *
                             sizeof(float) + q_bytes(d_model);
  const size_t smem_mix = ((size_t)2 * kRows * channels + (size_t)kRows * rank + red_floats +
                           2 * kRows * kTileN) * sizeof(float) + q_bytes(channels);
  const size_t smem_out = ((size_t)kRows * (channels > d_model ? channels : d_model) +
                           red_floats + kRows * kTileN) * sizeof(float) + q_bytes(channels);
  cudaError_t err = allow_smem(ssm_in_kernel<kQ>, smem_in);
  if (err == cudaSuccess) err = allow_smem(ssm_mix_kernel<kQ>, smem_mix);
  if (err == cudaSuccess) err = allow_smem(ssm_out_kernel<kQ>, smem_out);
  if (err != cudaSuccess) return static_cast<int>(err);

  ssm_in_kernel<kQ><<<dim3(2 * col_tiles_c, row_tiles), kBlock, smem_in, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(norm_w),
      static_cast<const bf16*>(norm_b), rms, eps, inx, inz, static_cast<bf16*>(xp_out),
      static_cast<float*>(z), static_cast<int*>(tickets), batch, d_model, channels);
  ssm_mix_kernel<kQ><<<dim3(col_tiles_c, row_tiles), kBlock, smem_mix, s>>>(
      static_cast<const bf16*>(conv_state), static_cast<const bf16*>(xp_out),
      static_cast<const float*>(z), static_cast<const float*>(ssm),
      static_cast<const bf16*>(conv_w), static_cast<const bf16*>(conv_b), xparam,
      static_cast<const bf16*>(dt_w), static_cast<const bf16*>(dt_b),
      static_cast<const bf16*>(a_log), static_cast<const bf16*>(d_skip),
      static_cast<float*>(ssm_out), g, batch, channels, ksize, rank, heads, d_state);
  ssm_out_kernel<kQ><<<dim3(col_tiles_d, row_tiles), kBlock, smem_out, s>>>(
      g, out_p, static_cast<const bf16*>(h), static_cast<bf16*>(h_out),
      static_cast<float*>(hsum), static_cast<const bf16*>(fn_w),
      static_cast<const bf16*>(fn_b), static_cast<const bf16*>(rln_w),
      static_cast<const bf16*>(rln_b), static_cast<const bf16*>(router_w),
      static_cast<const bf16*>(router_b), rms, eps, fn_w != nullptr ? ffn_in : nullptr,
      static_cast<float*>(ffn_scale), static_cast<float*>(comb), static_cast<int*>(tickets),
      batch, channels, d_model, num_experts);
  return static_cast<int>(cudaGetLastError());
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
  typedef Proj<false> P;
  return launch_step<false>(
      h, conv_state, ssm, norm_w, norm_b, P{static_cast<const bf16*>(inx_w), nullptr},
      P{static_cast<const bf16*>(inz_w), nullptr}, conv_w, conv_b,
      P{static_cast<const bf16*>(xparam_w), nullptr}, dt_w, dt_b, a_log, d_skip,
      P{static_cast<const bf16*>(out_w), nullptr}, fn_w, fn_b, rln_w, rln_b, router_w,
      router_b, h_out, xp_out, ssm_out, ffn_in, ffn_scale, comb, z, g, hsum, tickets, batch,
      d_model, channels, ksize, rank, heads, d_state, num_experts, rms, eps,
      static_cast<cudaStream_t>(stream));
}

// The same step with the int8 weight layout: each of in_proj x / z, x_param
// and out_proj is an int8 (in, out) weight with (1, out) f32 scales; D and C
// must be multiples of 4. g is (B, C) f32 scratch; with the dense or the moe
// epilogue ffn_in is the (B, D) int8 x_q and ffn_scale the (B, 1) f32 x_s.
extern "C" int apertis_ssm_decode_step_int8(
    const void* h, const void* conv_state, const void* ssm, const void* norm_w,
    const void* norm_b, const void* inx_q, const void* inx_s, const void* inz_q,
    const void* inz_s, const void* conv_w, const void* conv_b, const void* xparam_q,
    const void* xparam_s, const void* dt_w, const void* dt_b, const void* a_log,
    const void* d_skip, const void* out_q, const void* out_s, const void* fn_w,
    const void* fn_b, const void* rln_w, const void* rln_b, const void* router_w,
    const void* router_b, void* h_out, void* xp_out, void* ssm_out, void* ffn_in,
    void* ffn_scale, void* comb, void* z, void* g, void* hsum, void* tickets, int batch,
    int d_model, int channels, int ksize, int rank, int heads, int d_state,
    int num_experts, int rms, float eps, void* stream) {
  if (d_model % 4 != 0 || channels % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (router_w != nullptr && (num_experts < 2 || num_experts > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  typedef Proj<true> P;
  auto proj = [](const void* q, const void* s) {
    return P{static_cast<const int8_t*>(q), static_cast<const float*>(s)};
  };
  return launch_step<true>(
      h, conv_state, ssm, norm_w, norm_b, proj(inx_q, inx_s), proj(inz_q, inz_s), conv_w,
      conv_b, proj(xparam_q, xparam_s), dt_w, dt_b, a_log, d_skip, proj(out_q, out_s),
      fn_w, fn_b, rln_w, rln_b, router_w, router_b, h_out, xp_out, ssm_out, ffn_in,
      ffn_scale, comb, z, g, hsum, tickets, batch, d_model, channels, ksize, rank, heads,
      d_state, num_experts, rms, eps, static_cast<cudaStream_t>(stream));
}
