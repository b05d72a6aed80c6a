// ssm_decode_step: one decode step of the whole selective-SSM mixer.
//
// Replaces: apertis_llm_tpu/ops/pallas/ssm_step.py::ssm_decode_step_fused
// with the bf16 weight layout and ffn_mode "none" or "dense" (the int8 layout
// and the MoE router epilogue are later work).
//
// Semantics (ssm_step.py:82-197), per batch row, all sums in f32:
//   nrm  = pre_norm(h)                       rounded to bf16 for the dots
//   xp   = nrm @ in_proj_x                   rounded to the conv-cache dtype
//   z    = nrm @ in_proj_z
//   xa   = silu(conv window [s_0 .. s_{K-2}, xp] . conv_w + conv_b)
//   dt   = xa @ x_param[:, :R]               rounded to bf16
//   Bs   = xa @ x_param[:, R:R+C],  Cs = xa @ x_param[:, R+C:]
//   delta = softplus(dt @ dt_proj_w + dt_proj_b)         (overflow-safe)
//   h'   = exp(delta[head] * -exp(A_log)) * ssm + Bs      (new ssm state)
//   g    = (Cs * h' + D * xa) * silu(z)      rounded to bf16
//   hsum = h + g @ out_proj                  h_out = bf16(hsum)
//   dense epilogue: ffn_in = bf16(ffn_pre_norm(hsum))
// (xa is rounded to bf16 where it enters a dot and used in f32 in D * xa.)
//
// Bound on the H100: bytes. At decode batch sizes every step reads the
// mixer's weights (about 10.6 MB per layer of the 1.5B model in bf16) for
// 2 * rows FLOPs per weight, far below the tensor-core line. The difficulty
// is the chain in_proj -> conv -> x_param -> dt -> recurrence -> out_proj,
// in which each stage needs whole rows of the stage before.
//
// Design: three launches per layer, each a grid of (column tile, row tile)
// blocks of 256 threads, so every stage streams its weight matrix across the
// whole card instead of through one block:
//   1. ssm_in_kernel:  pre-norm + in_proj x and z, 64 output columns a block;
//   2. ssm_mix_kernel: conv + SiLU + x_param + dt + recurrence + gate for 64
//      channels a block; the block recomputes the small dt_feats row (R
//      values) that every channel needs;
//   3. ssm_out_kernel: out_proj + residual for 64 columns a block. With the
//      dense epilogue the last block of each row tile to finish (an integer
//      ticket, no float atomics) applies the FFN pre-norm to the full rows.
// A block holds up to kRows batch rows in shared memory in f32 and reads the
// (in, out) weights with output columns across lanes, so reads coalesce; the
// K axis is split across the 8 warps (common.cuh, tile_matvec). The TPU
// kernel's layer-stacked weights, scalar-prefetched layer id and 0/1
// head-expansion matrix are not needed: the caller passes each layer's
// pointers and a thread computes its head as c / N.

#include "common.cuh"

namespace {

constexpr int kRows = 8;  // batch rows per block (one warp normalises one row)

// ---- 1. pre-norm + in_proj x / z ------------------------------------------
__global__ void __launch_bounds__(kBlock) ssm_in_kernel(
    const bf16* __restrict__ h,       // (B, D)
    const bf16* __restrict__ norm_w,  // (D,)
    const bf16* __restrict__ norm_b,  // (D,), unused for RMSNorm
    int rms, float eps,
    const bf16* __restrict__ inx_w,   // (D, C)
    const bf16* __restrict__ inz_w,   // (D, C)
    bf16* __restrict__ xp_out,        // (B, C) new conv-window entry
    float* __restrict__ z_out,        // (B, C) scratch
    int* __restrict__ tickets,        // (row tiles,) scratch for ssm_out_kernel
    int batch, int d_model, int channels) {
  extern __shared__ float smem[];
  float* xs = smem;                              // kRows * D
  float* red = xs + kRows * d_model;             // kWarps * kRows * kTileN
  float* out = red + kWarps * kRows * kTileN;    // kRows * kTileN
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

  tile_matvec<kRows>(xs, d_model, is_z ? inz_w : inx_w, channels, d_model, col0,
                     channels, red, out);
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
__global__ void __launch_bounds__(kBlock) ssm_mix_kernel(
    const bf16* __restrict__ conv_state,  // (B, K-1, C)
    const bf16* __restrict__ xp,          // (B, C) from ssm_in_kernel
    const float* __restrict__ z,          // (B, C) from ssm_in_kernel
    const float* ssm,                     // (B, C); may be ssm_out (in place)
    const bf16* __restrict__ conv_w,      // (C, K)
    const bf16* __restrict__ conv_b,      // (C,)
    const bf16* __restrict__ xparam_w,    // (C, R + 2C)
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
    tile_matvec<kRows>(xr, channels, xparam_w, ldw, channels, t0, rank, red, bs);
    for (int i = threadIdx.x; i < kRows * kTileN; i += kBlock) {
      const int r = i / kTileN;
      const int j = t0 + (i - r * kTileN);
      if (j < rank) dtf[r * rank + j] = round_bf16(bs[i]);
    }
    __syncthreads();
  }
  tile_matvec<kRows>(xr, channels, xparam_w + rank, ldw, channels, col0, channels,
                     red, bs);
  tile_matvec<kRows>(xr, channels, xparam_w + rank + channels, ldw, channels, col0,
                     channels, red, cs);

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

// ---- 3. out_proj + residual (+ FFN pre-norm) --------------------------------
__global__ void __launch_bounds__(kBlock) ssm_out_kernel(
    const bf16* __restrict__ g,        // (B, C) from ssm_mix_kernel
    const bf16* __restrict__ out_w,    // (C, D)
    const bf16* __restrict__ h,        // (B, D) residual input
    bf16* __restrict__ h_out,          // (B, D)
    float* __restrict__ hsum,          // (B, D) scratch (dense epilogue only)
    const bf16* __restrict__ fn_w,     // (D,) FFN pre-norm, or nullptr
    const bf16* __restrict__ fn_b,     // (D,), unused for RMSNorm
    int rms, float eps,
    bf16* __restrict__ ffn_in,         // (B, D), or nullptr
    int* __restrict__ tickets,         // (row tiles,), zeroed by ssm_in_kernel
    int batch, int channels, int d_model) {
  extern __shared__ float smem[];
  // xs holds the g rows, and in the epilogue the full hsum rows.
  float* xs = smem;                                          // kRows * max(C, D)
  float* red = xs + kRows * max(channels, d_model);          // kWarps * kRows * kTileN
  float* out = red + kWarps * kRows * kTileN;                // kRows * kTileN
  __shared__ int is_last;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kTileN;
  const bool epilogue = ffn_in != nullptr;

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
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= kRows || row0 + warp >= batch) return;
  // Other blocks wrote these rows during this launch: read them from L2
  // (__ldcg), never from this SM's L1.
  const float* src = hsum + (size_t)(row0 + warp) * d_model;
  float* row = xs + warp * d_model;
  for (int k = lane; k < d_model; k += 32) row[k] = __ldcg(src + k);
  __syncwarp();
  warp_norm_row(row, d_model, fn_w, fn_b, rms, eps, true);
  __syncwarp();
  bf16* dst = ffn_in + (size_t)(row0 + warp) * d_model;
  for (int k = lane; k < d_model; k += 32) dst[k] = __float2bfloat16(row[k]);
}

}  // namespace

// One decode step of one layer's mixer. conv_state is (B, K-1, C); ssm_out
// may be ssm, to update the state in place; z, g, hsum and tickets are
// scratch the caller allocates: z (B, C) f32, g (B, C) bf16, hsum (B, D) f32,
// tickets (ceil(B / 8),) int32. fn_w == nullptr selects
// ffn_mode "none" (ffn_in and hsum unused). Returns cudaGetLastError().
extern "C" int apertis_ssm_decode_step(
    const void* h, const void* conv_state, const void* ssm, const void* norm_w,
    const void* norm_b, const void* inx_w, const void* inz_w, const void* conv_w,
    const void* conv_b, const void* xparam_w, const void* dt_w, const void* dt_b,
    const void* a_log, const void* d_skip, const void* out_w, const void* fn_w,
    const void* fn_b, void* h_out, void* xp_out, void* ssm_out, void* ffn_in,
    void* z, void* g, void* hsum, void* tickets, int batch, int d_model,
    int channels, int ksize, int rank, int heads, int d_state, int rms, float eps,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (batch + kRows - 1) / kRows;
  const int col_tiles_c = (channels + kTileN - 1) / kTileN;
  const int col_tiles_d = (d_model + kTileN - 1) / kTileN;
  const size_t red_floats = (size_t)kWarps * kRows * kTileN;

  const size_t smem_in = ((size_t)kRows * d_model + red_floats + kRows * kTileN) * sizeof(float);
  const size_t smem_mix = ((size_t)2 * kRows * channels + (size_t)kRows * rank + red_floats +
                           2 * kRows * kTileN) * sizeof(float);
  const size_t smem_out = ((size_t)kRows * (channels > d_model ? channels : d_model) +
                           red_floats + kRows * kTileN) * sizeof(float);
  cudaError_t err = allow_smem(ssm_in_kernel, smem_in);
  if (err == cudaSuccess) err = allow_smem(ssm_mix_kernel, smem_mix);
  if (err == cudaSuccess) err = allow_smem(ssm_out_kernel, smem_out);
  if (err != cudaSuccess) return static_cast<int>(err);

  ssm_in_kernel<<<dim3(2 * col_tiles_c, row_tiles), kBlock, smem_in, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(norm_w),
      static_cast<const bf16*>(norm_b), rms, eps, static_cast<const bf16*>(inx_w),
      static_cast<const bf16*>(inz_w), static_cast<bf16*>(xp_out),
      static_cast<float*>(z), static_cast<int*>(tickets), batch, d_model, channels);
  ssm_mix_kernel<<<dim3(col_tiles_c, row_tiles), kBlock, smem_mix, s>>>(
      static_cast<const bf16*>(conv_state), static_cast<const bf16*>(xp_out),
      static_cast<const float*>(z), static_cast<const float*>(ssm),
      static_cast<const bf16*>(conv_w), static_cast<const bf16*>(conv_b),
      static_cast<const bf16*>(xparam_w), static_cast<const bf16*>(dt_w),
      static_cast<const bf16*>(dt_b), static_cast<const bf16*>(a_log),
      static_cast<const bf16*>(d_skip), static_cast<float*>(ssm_out),
      static_cast<bf16*>(g), batch, channels, ksize, rank, heads, d_state);
  ssm_out_kernel<<<dim3(col_tiles_d, row_tiles), kBlock, smem_out, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(out_w),
      static_cast<const bf16*>(h), static_cast<bf16*>(h_out),
      static_cast<float*>(hsum), static_cast<const bf16*>(fn_w),
      static_cast<const bf16*>(fn_b), rms, eps,
      fn_w != nullptr ? static_cast<bf16*>(ffn_in) : nullptr,
      static_cast<int*>(tickets), batch, channels, d_model);
  return static_cast<int>(cudaGetLastError());
}
