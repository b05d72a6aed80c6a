// expert_ffn_fat: the combine-folded all-expert MoE FFN at small token counts.
//
// Replaces: apertis_llm_tpu/ops/pallas/moe_ffn.py::expert_ffn_fat (the
// pipelined kernel that is the default there, moe_ffn.py:175-240) with the
// int8 fat stack (apertis_expert_ffn_fat) and the int4 one
// (apertis_expert_ffn_fat_int4).
//
// Semantics, per row, with the flattened E*I hidden cut into tiles of bn
// columns (bn from moe_ffn.py:289-294; each tile inside one expert, and the
// tile width changes the result):
//   h    = act(acc1_i32(x_q . W1t_q) * x_s * w1t_s + b1t)            (f32)
//   per tile t of expert e(t):
//     hs = max(max|h_t|, 1e-8) * (1/127);  hq = rint(h_t / hs)
//     acc += acc2_i32(hq . W2t_q[t]) * (hs * combine[:, e(t)])      (tiles in order)
//   out  = acc * w2t_s                                                (f32)
// The combine weight is folded into the tile's scale, not into h. Inputs:
// x_q (S, H) int8, x_s (S, 1), combine (S, E), W1t_q (H, E*I) int8 with
// w1t_s (1, E*I), b1t (E*I,) f32, W2t_q (E*I, H) int8 with one scale per
// output channel shared across experts, w2t_s (1, H) (models/moe_fuse.py).
// `combine @ b2` is added by the caller. The int4 layout (int4=True) is the
// same arithmetic over the unpacked weights: W1t_q4 (H/2, E*I) with shifts
// W1t_sh (H/128, E*I) and W2t_q4 (E*I/2, H) with W2t_sh (E*I/128, H)
// (models/quantize.py::quantize_weight_int4), H and bn multiples of 128.
//
// Bound on the H100: bytes at decode (31.7 MB of int8 weights a layer of the
// 1.5B MoE model, 2 * S * H * E*I int8 operations each way), operations
// from a few hundred rows up.
//
// Design: a whole-expert tile (bn = 2816 at the preset) of f32 hidden rows
// does not fit in a block's shared memory, so the kernel is three launches,
// each spread over the card, with exact int32 sums on the tensor cores
// (moe_gemm.cuh):
//   1. moe_gemm1_kernel: GEMM1 + dequantization + bias + activation for a
//      (64 rows, 128 columns) block; the f32 hidden goes to an (S, E*I)
//      buffer and each (row, tile) absmax to (S, tiles) by atomicMax;
//   2. moe_fat_gemm2_kernel: one block per (128 output columns, part of one
//      tile, 64 rows) quantizes its hidden rows as it stages them and
//      writes the exact int32 partial product of its part of the tile;
//   3. moe_fat_reduce_kernel: per output element, adds each tile's int32
//      parts (exact), scales by hs * combine, and adds the tiles in tile
//      order in f32 (the TPU kernel's order), then applies w2t_s.
// No float atomics: repeated calls give the same bits. A row whose combine
// weight for an expert is 0 contributes exactly 0 to that expert's tiles, so
// blocks in which no row routes to the expert are skipped in launches 1 and
// 2, and the reduce skips those (row, tile) terms. The int4 layout runs the
// same launches; moe_gemm.cuh unpacks the B panels as it stages them, so the
// weights cross device memory at half the int8 bytes (the bound at decode).

#include "moe_gemm.cuh"

namespace {

template <bool kI4>
__global__ void __launch_bounds__(kBlock) moe_fat_gemm2_kernel(
    const float* __restrict__ hidden,  // (S, E*I)
    const float* __restrict__ absmax,  // (S, tiles)
    const float* __restrict__ comb,    // (S, E)
    const int8_t* __restrict__ w2,     // (E*I, H), int4: (E*I / 2, H)
    const int8_t* __restrict__ w2sh,   // int4 only: (E*I / 128, H)
    int* __restrict__ partial,         // (tiles * ksplit, S, H)
    int rows, int d_model, int ei, int bn, int tiles_per_expert, int num_experts,
    int ksplit) {
  __shared__ __align__(128) GemmSmem sm;
  __shared__ float hs[kGemmM];
  const int tiles = ei / bn;
  const int t = blockIdx.y / ksplit;
  const int part = blockIdx.y - t * ksplit;
  const int e = t / tiles_per_expert;
  const int row0 = blockIdx.z * kGemmM;
  const int col0 = blockIdx.x * kGemmN;
  const int live_rows = min(kGemmM, rows - row0);
  int live = 0;
  for (int i = threadIdx.x; i < kGemmM; i += kBlock) {
    float s = 1.f;
    if (i < live_rows) {
      const size_t r = row0 + i;
      s = fmaxf(absmax[r * tiles + t], 1e-8f) * (1.f / 127.f);
      if (comb[r * num_experts + e] != 0.f) live = 1;
    }
    hs[i] = s;
  }
  if (!__syncthreads_or(live)) return;
  const int chunks = (bn + kGemmK - 1) / kGemmK;
  const int per_part = (chunks + ksplit - 1) / ksplit;
  const int k_begin = min(bn, part * per_part * kGemmK);
  const int k_end = min(bn, (part + 1) * per_part * kGemmK);
  const size_t k_off = (size_t)t * bn + k_begin;
  if constexpr (kI4)
    block_gemm_i8<true, true>(hidden + (size_t)row0 * ei + k_off, ei, live_rows, hs, w2 + col0,
                              d_model, min(kGemmN, d_model - col0), k_end - k_begin, sm,
                              w2sh + col0, (int)k_off);
  else
    block_gemm_i8<true>(hidden + (size_t)row0 * ei + k_off, ei, live_rows, hs,
                        w2 + k_off * d_model + col0, d_model, min(kGemmN, d_model - col0),
                        k_end - k_begin, sm);
  int* dst = partial + ((size_t)blockIdx.y * rows + row0) * d_model;
  for (int i = threadIdx.x; i < kGemmM * kGemmN; i += kBlock) {
    const int r = i / kGemmN;
    const int j = col0 + (i - r * kGemmN);
    if (r < live_rows && j < d_model) dst[(size_t)r * d_model + j] = sm.c[i];
  }
}

__global__ void __launch_bounds__(kBlock) moe_fat_reduce_kernel(
    const int* __restrict__ partial,   // (tiles * ksplit, S, H)
    const float* __restrict__ absmax,  // (S, tiles)
    const float* __restrict__ comb,    // (S, E)
    const float* __restrict__ w2s,     // (H,)
    float* __restrict__ out,           // (S, H)
    int rows, int d_model, int tiles, int ksplit, int tiles_per_expert, int num_experts) {
  const size_t n = (size_t)rows * d_model;
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const size_t r = i / d_model;
  const int c = (int)(i - r * d_model);
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const float col = comb[r * num_experts + t / tiles_per_expert];
    if (col == 0.f) continue;  // the term is exactly 0
    const float hs = fmaxf(absmax[r * tiles + t], 1e-8f) * (1.f / 127.f);
    int a = 0;
    for (int j = 0; j < ksplit; ++j) a += partial[(size_t)(t * ksplit + j) * n + i];
    acc = __fadd_rn(acc, __fmul_rn((float)a, __fmul_rn(hs, col)));
  }
  out[i] = __fmul_rn(acc, w2s[c]);
}

// The three launches of the int8 (kI4 false) or int4 fat layout.
template <bool kI4>
cudaError_t fat_launch(const void* xq, const void* xs, const void* comb, const void* w1q,
                       const void* w1sh, const void* w1s, const void* b1, const void* w2q,
                       const void* w2sh, const void* w2s, void* out, void* hidden,
                       void* absmax, void* partial, int rows, int d_model, int ei,
                       int num_experts, int bn, int ksplit, int act, cudaStream_t s) {
  const int tiles = ei / bn;
  const int tiles_per_expert = ei / num_experts / bn;
  const int row_tiles = (rows + kGemmM - 1) / kGemmM;
  cudaError_t err = cudaMemsetAsync(absmax, 0, (size_t)rows * tiles * sizeof(float), s);
  if (err != cudaSuccess) return err;
  moe_gemm1_kernel<kI4><<<dim3((ei + kGemmN - 1) / kGemmN, row_tiles), kBlock, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const float*>(comb), nullptr, static_cast<const int8_t*>(w1q),
      static_cast<const int8_t*>(w1sh), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<float*>(hidden), static_cast<float*>(absmax),
      rows, d_model, ei, ei, bn, tiles_per_expert, num_experts, act);
  moe_fat_gemm2_kernel<kI4><<<dim3((d_model + kGemmN - 1) / kGemmN, tiles * ksplit,
                                   row_tiles), kBlock, 0, s>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(absmax),
      static_cast<const float*>(comb), static_cast<const int8_t*>(w2q),
      static_cast<const int8_t*>(w2sh), static_cast<int*>(partial), rows, d_model, ei, bn,
      tiles_per_expert, num_experts, ksplit);
  const size_t n = (size_t)rows * d_model;
  moe_fat_reduce_kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0, s>>>(
      static_cast<const int*>(partial), static_cast<const float*>(absmax),
      static_cast<const float*>(comb), static_cast<const float*>(w2s),
      static_cast<float*>(out), rows, d_model, tiles, ksplit, tiles_per_expert, num_experts);
  return cudaGetLastError();
}

bool fat_shape_ok(int rows, int d_model, int ei, int num_experts, int bn, int ksplit,
                  int align) {
  return rows > 0 && num_experts > 0 && ei % num_experts == 0 && d_model % align == 0 &&
         bn > 0 && bn % align == 0 && (ei / num_experts) % bn == 0 && ksplit >= 1;
}

}  // namespace

// The fat MoE FFN for S rows. H and I multiples of 16, bn a multiple of 16
// dividing I, pointers 16-byte aligned. hidden (S, E*I) f32, absmax
// (S, E*I / bn) f32 and partial (E*I / bn * ksplit, S, H) int32 are scratch
// the caller allocates; absmax is zeroed here. act: 1 relu, 2 silu, else
// exact GELU. Returns cudaGetLastError().
extern "C" int apertis_expert_ffn_fat(const void* xq, const void* xs, const void* comb,
                                      const void* w1q, const void* w1s, const void* b1,
                                      const void* w2q, const void* w2s, void* out,
                                      void* hidden, void* absmax, void* partial, int rows,
                                      int d_model, int ei, int num_experts, int bn,
                                      int ksplit, int act, void* stream) {
  if (!fat_shape_ok(rows, d_model, ei, num_experts, bn, ksplit, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fat_launch<false>(
      xq, xs, comb, w1q, nullptr, w1s, b1, w2q, nullptr, w2s, out, hidden, absmax, partial,
      rows, d_model, ei, num_experts, bn, ksplit, act, static_cast<cudaStream_t>(stream)));
}

// The int4 fat MoE FFN: as apertis_expert_ffn_fat, with the packs and their
// shifts; H and bn multiples of 128.
extern "C" int apertis_expert_ffn_fat_int4(const void* xq, const void* xs, const void* comb,
                                           const void* w1q4, const void* w1sh, const void* w1s,
                                           const void* b1, const void* w2q4, const void* w2sh,
                                           const void* w2s, void* out, void* hidden,
                                           void* absmax, void* partial, int rows, int d_model,
                                           int ei, int num_experts, int bn, int ksplit, int act,
                                           void* stream) {
  if (!fat_shape_ok(rows, d_model, ei, num_experts, bn, ksplit, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fat_launch<true>(
      xq, xs, comb, w1q4, w1sh, w1s, b1, w2q4, w2sh, w2s, out, hidden, absmax, partial, rows,
      d_model, ei, num_experts, bn, ksplit, act, static_cast<cudaStream_t>(stream)));
}
