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
// Design: the decode FFN's int8 products (quant_ffn.cuh on decode_gemm.cuh:
// swapped-operand int8 wgmma, the weight as the register A operand built
// from TMA-staged tiles, int4 nibbles unpacked in registers, a TMA ring that
// a producer warpgroup keeps full) with the combine weight in each tile's
// scale, on the plan of ops/kernels/decode_plan.py::fat_plan:
//   1. ffn_up_kernel: GEMM1 (K = H, TMA zero-fills the tail) for 128 hidden
//      columns and a row tile a block. Where a tile is at most 16 blocks of
//      128 columns (bn 128 at the 3B preset and at I = 256), its blocks form
//      a cluster that requantizes the tile in the epilogue into hq and hs.
//      A wider tile (bn 2816 at the 1.5B preset: 22 blocks) writes the f32
//      hidden (5.8 MB at 64 rows, in L2) and each (row, tile) absmax by an
//      order-free atomicMax; fat_quant_kernel then writes hq and hs, each
//      tile of hq padded with zeros to whole 128-column chunks.
//   2. ffn_down_kernel: GEMM2 (K = E*I) for 128 output columns and a row
//      tile a block, the tiles split over a cluster whose owners add each
//      tile's float(acc_t) * (hs * combine[:, e(t)]) in tile order; out =
//      acc * w2t_s.
// No float atomics: repeated calls give the same bits. A row whose combine
// weight for an expert is 0 contributes exactly 0 to that expert's tiles, so
// GEMM1 skips the blocks in which no row routes to the expert of their
// columns and GEMM2 the tiles of such an expert: their weight is not read.

#include <string.h>

#include "quant_ffn.cuh"

namespace {

// The launches of the int8 (kI4 false) or int4 fat layout at a row tile of
// BR rows; up_cluster (the blocks of a tile, 0 for the wide form), split,
// group and the stages are the host's plan.
template <bool kI4, int BR>
int fat_run(const void* xq, const void* xs, const void* comb, const void* w1, const void* w1sh,
            const void* w1s, const void* b1, const void* w2, const void* w2sh, const void* w2s,
            void* out, void* hq, void* hs, void* hidden, void* absmax, int rows, int d_model,
            int ei, int experts, int bn, int act, int up_cluster, int split, int group,
            int st_up, int st_down, cudaStream_t s) {
  const int tiles = ei / bn, bnp = (bn + kDgKC - 1) / kDgKC * kDgKC;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap xm, w1m, s1m, hqm, w2m, s2m;
  memset(&s1m, 0, sizeof(s1m));   // unused by the int8 layout
  memset(&s2m, 0, sizeof(s2m));
  const int wrows = kI4 ? kDgKC / 2 : kDgKC;   // weight rows a chunk
  int err = dg_map_2d(&xm, xq, u8, 1, d_model, rows, 128, BR);
  if (err == 0) err = dg_map_2d(&w1m, w1, u8, 1, ei, kI4 ? d_model / 2 : d_model, 128, wrows);
  if (err == 0) err = dg_map_2d(&hqm, hq, u8, 1, (uint64_t)tiles * bnp, rows, 128, BR);
  if (err == 0) err = dg_map_2d(&w2m, w2, u8, 1, d_model, kI4 ? ei / 2 : ei, 128, wrows);
  if (kI4 && err == 0)
    err = dg_map_2d(&s1m, w1sh, u8, 1, ei, d_model / kDgKC, 128, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (kI4 && err == 0)
    err = dg_map_2d(&s2m, w2sh, u8, 1, d_model, ei / kDgKC, 128, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const uint32_t stage = BR * 128 + w_tile_bytes<kI4>();
  const int row_tiles = (rows + BR - 1) / BR;
  UpArgs up = {};
  up.xs = static_cast<const float*>(xs);
  up.w1s = static_cast<const float*>(w1s);
  up.b1 = b1;
  up.hq = static_cast<int8_t*>(hq);
  up.hs = static_cast<float*>(hs);
  up.comb = static_cast<const float*>(comb);
  up.hidden = static_cast<float*>(hidden);
  up.absmax = static_cast<float*>(absmax);
  up.rows = rows;
  up.k = d_model;
  up.n = ei;
  up.bn = bn;
  up.act = act;
  up.stages = st_up;
  up.cs = up_cluster;
  up.inter = ei / experts;
  up.experts = experts;
  if (up_cluster == 0) {
    err = static_cast<int>(
        cudaMemsetAsync(absmax, 0, (size_t)rows * tiles * sizeof(float), s));
    if (err != 0) return err;
  }
  err = dg_launch(ffn_up_kernel<kI4, BR, true>, dim3((ei + kDgCols - 1) / kDgCols, row_tiles),
                  dim3(kThreads), up_cluster > 1 ? up_cluster : 1,
                  dg_smem_bytes(BR, st_up, stage, 1, ffn_up_extra(BR)), s, xm, w1m, s1m, up);
  if (err != 0) return err;
  if (up_cluster == 0)
    fat_quant_kernel<<<fat_quant_grid(tiles, rows), kBlock, 0, s>>>(
        static_cast<const float*>(hidden), static_cast<const float*>(absmax),
        static_cast<int8_t*>(hq), static_cast<float*>(hs), rows, ei, bn, bnp, nullptr);
  DownArgs down = {};
  down.hs = static_cast<const float*>(hs);
  down.w2s = static_cast<const float*>(w2s);
  down.out = out;
  down.comb = static_cast<const float*>(comb);
  down.rows = rows;
  down.n = d_model;
  down.k = ei;
  down.bn = bn;
  down.split = split;
  down.stages = st_down;
  down.per = bnp / kDgKC;
  down.group = group;
  down.tile_experts = ei / experts / bn;
  down.experts = experts;
  err = dg_launch(ffn_down_kernel<kI4, BR, kDownMoe>,
                  dim3(((d_model + kDgCols - 1) / kDgCols) * split, row_tiles), dim3(kThreads),
                  split,
                  dg_smem_bytes(BR, st_down, stage, 1,
                                ffn_down_extra(BR, split, group, experts)),
                  s, hqm, w2m, s2m, down);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <bool kI4>
int fat_dispatch(const void* xq, const void* xs, const void* comb, const void* w1,
                 const void* w1sh, const void* w1s, const void* b1, const void* w2,
                 const void* w2sh, const void* w2s, void* out, void* hq, void* hs, void* hidden,
                 void* absmax, int rows, int d_model, int ei, int experts, int bn, int act,
                 int row_tile, int up_cluster, int split, int group, int st_up, int st_down,
                 void* stream) {
  const int align = kI4 ? kDgKC : 16;
  if (rows <= 0 || experts <= 0 || ei % experts != 0 || d_model <= 0 || d_model % align != 0 ||
      bn <= 0 || bn % align != 0 || (ei / experts) % bn != 0 || split < 1 || split > 16 ||
      split > ei / bn || group < 1 || group > kMaxGroup || st_up < 1 || st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // The cluster form needs whole 128-column blocks, at most kMaxUpCluster.
  if (up_cluster != 0 && (bn % kDgCols != 0 || up_cluster != bn / kDgCols ||
                          up_cluster > kMaxUpCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile == 16)
    return fat_run<kI4, 16>(xq, xs, comb, w1, w1sh, w1s, b1, w2, w2sh, w2s, out, hq, hs, hidden,
                            absmax, rows, d_model, ei, experts, bn, act, up_cluster, split,
                            group, st_up, st_down, s);
  if (row_tile == 64)
    return fat_run<kI4, 64>(xq, xs, comb, w1, w1sh, w1s, b1, w2, w2sh, w2s, out, hq, hs, hidden,
                            absmax, rows, d_model, ei, experts, bn, act, up_cluster, split,
                            group, st_up, st_down, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The fat MoE FFN for S rows. H and I multiples of 16, bn a multiple of 16
// dividing I, every tensor 16-byte aligned. hq (S, E*I / bn * bnp) int8 (bnp:
// bn rounded up to 128) and hs (S, E*I / bn) f32 are scratch the caller
// allocates; so are, for the wide form (up_cluster 0), hidden (S, E*I) f32
// and absmax (S, E*I / bn) f32, which is zeroed here (else they may be
// null). act: 1 relu, 2 silu, else exact GELU. row_tile (16 or 64),
// up_cluster, split, group and the two stage counts are the plan of
// ops/kernels/decode_plan.py::fat_plan. Returns cudaGetLastError(), or
// cudaErrorInvalidResourceHandle if a tensor map cannot be made.
extern "C" int apertis_expert_ffn_fat(const void* xq, const void* xs, const void* comb,
                                      const void* w1q, const void* w1s, const void* b1,
                                      const void* w2q, const void* w2s, void* out, void* hq,
                                      void* hs, void* hidden, void* absmax, int rows,
                                      int d_model, int ei, int num_experts, int bn, int act,
                                      int row_tile, int up_cluster, int split, int group,
                                      int st_up, int st_down, void* stream) {
  return fat_dispatch<false>(xq, xs, comb, w1q, nullptr, w1s, b1, w2q, nullptr, w2s, out, hq,
                             hs, hidden, absmax, rows, d_model, ei, num_experts, bn, act,
                             row_tile, up_cluster, split, group, st_up, st_down, stream);
}

// The int4 fat MoE FFN: as apertis_expert_ffn_fat, with the packs and their
// shifts; H and bn multiples of 128.
extern "C" int apertis_expert_ffn_fat_int4(const void* xq, const void* xs, const void* comb,
                                           const void* w1q4, const void* w1sh, const void* w1s,
                                           const void* b1, const void* w2q4, const void* w2sh,
                                           const void* w2s, void* out, void* hq, void* hs,
                                           void* hidden, void* absmax, int rows, int d_model,
                                           int ei, int num_experts, int bn, int act,
                                           int row_tile, int up_cluster, int split, int group,
                                           int st_up, int st_down, void* stream) {
  return fat_dispatch<true>(xq, xs, comb, w1q4, w1sh, w1s, b1, w2q4, w2sh, w2s, out, hq, hs,
                            hidden, absmax, rows, d_model, ei, num_experts, bn, act, row_tile,
                            up_cluster, split, group, st_up, st_down, stream);
}

// The resources of one kernel of the fat layouts (kernel: 0 up int8, 1 down
// int8, 2 up int4, 3 down int4, 4 the wide form's requantization) at a row
// tile of `row_tile` rows and `smem` bytes of dynamic shared memory
// (hopper.cuh::kernel_resources), into out[0..4].
extern "C" int apertis_expert_ffn_fat_resources(int kernel, int row_tile, int smem, int* out) {
  if (row_tile != 16 && row_tile != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bool r16 = row_tile == 16;
  switch (kernel) {
    case 0: return kernel_resources(r16 ? &ffn_up_kernel<false, 16, true>
                                        : &ffn_up_kernel<false, 64, true>, kThreads, smem, out);
    case 1: return kernel_resources(r16 ? &ffn_down_kernel<false, 16, kDownMoe>
                                        : &ffn_down_kernel<false, 64, kDownMoe>,
                                    kThreads, smem, out);
    case 2: return kernel_resources(r16 ? &ffn_up_kernel<true, 16, true>
                                        : &ffn_up_kernel<true, 64, true>, kThreads, smem, out);
    case 3: return kernel_resources(r16 ? &ffn_down_kernel<true, 16, kDownMoe>
                                        : &ffn_down_kernel<true, 64, kDownMoe>,
                                    kThreads, smem, out);
    case 4: return kernel_resources(&fat_quant_kernel, kBlock, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
