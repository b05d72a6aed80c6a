// expert_ffn_grouped: the MoE FFN over expert-sorted rows, for prefill.
//
// Replaces: apertis_llm_tpu/ops/pallas/moe_grouped.py::expert_ffn_grouped.
//
// Semantics: the rows come in tiles of 128 (ops/moe.py grouped_dispatch pads
// each expert's rows to whole tiles); tile t belongs to expert e = emap[t],
// or to none when emap[t] is -1 (the tiles past the last expert's, which the
// TPU kernel computes for expert E-1 and nobody reads: here their rows are
// 0). Per row of expert e, over the expert's I hidden columns of the fat
// stack (models/moe_fuse.py):
//   h   = act(acc1_i32(x_q . W1t_q[:, e*I : (e+1)*I]) * x_s * w1t_s + b1t)   (f32)
//   hs  = max(max|h|, 1e-8) * (1/127)      one scale per row over the whole I
//   out = bf16(acc2_i32(rint(h / hs) . W2t_q[e*I : (e+1)*I, :]) * hs * w2t_s)
// which is the per-expert MoE FFN's (#11, moe_dense.cu) arithmetic for the
// row's one expert, without its bias. Rows are independent; the caller
// gathers and combines them.
//
// Bound on the H100: operations. At request B's 2048 tokens of the 1.5B MoE
// model (P = 5120 rows, 4096 of them live) a layer does 2 * 2 * 4096 * 704 *
// 2816 = 32.5 G int8 operations (0.0164 ms at 1,979 TOP/s) against 31.7 MB
// of weights.
//
// Design: #11's three launches (quant_ffn.cuh::expert_ffn_run: int8 wgmma
// with the weight as the register A operand, TMA rings kept full by a
// producer warpgroup), one grid slice, each row tile taking the expert of
// its grouped tile from emap on the device (no host sync; the row tile, 64
// or 128, divides the grouped tile, so a row tile is one expert's):
//   1. ffn_up_kernel's wide form: GEMM1 (K = H) for 128 columns of the
//      expert's I, the weight tile from columns e * I on of the fat (H, E * I)
//      stack (TMA zero-fills x past H; columns past the expert's I, where I
//      is not a multiple of 128, are multiplied and dropped), the f32 hidden
//      (P, I) and each row's absmax over the whole I (an order-free integer
//      atomicMax on the bits of the non-negative values); a tile of no
//      expert returns at once;
//   2. fat_quant_kernel: hs (P, 1) and hq (P, Ip), I padded with zeros to
//      whole 128-row chunks, skipping the rows of tiles of no expert; its
//      rows run over the grid's y and z, since P passes y's limit of 65,535
//      from 32,768 tokens on;
//   3. expert_down_kernel: GEMM2 (K = I) for 128 output columns and a row
//      tile a block, W2's rows from e * I on (DgWeight::row0), K split over
//      a cluster where the plan finds idle SMs (int32 parts, exact in any
//      order), out = bf16(acc * hs * w2t_s); a tile of no expert writes
//      zeros.
// The f32 hidden at P = 5120 is 57.7 MB, more than the 50 MB L2, so it
// crosses device memory twice (about 0.03 ms at 3.35 TB/s): a floor of the
// three launches. The plan is ops/kernels/decode_plan.py::grouped_plan. No
// float atomics: repeated calls give the same bits.

#include "quant_ffn.cuh"

// The grouped MoE FFN over P expert-sorted rows (P a multiple of 128): out
// (P, H) bf16. H and I multiples of 16, every tensor 16-byte aligned. hq (P,
// Ip) int8 (Ip: I rounded up to 128), hs (P, 1), hidden (P, I) and absmax
// (P, 1) f32 are scratch the caller allocates; absmax is zeroed here. act: 1
// relu, 2 silu, else exact GELU. row_tile (64 or 128), split (GEMM2's
// cluster) and the two stage counts are the plan of
// ops/kernels/decode_plan.py::grouped_plan. Returns cudaGetLastError(), or
// cudaErrorInvalidResourceHandle if a tensor map cannot be made.
extern "C" int apertis_expert_ffn_grouped(const void* xq, const void* xs, const void* emap,
                                          const void* w1q, const void* w1s, const void* b1,
                                          const void* w2q, const void* w2s, void* out, void* hq,
                                          void* hs, void* hidden, void* absmax, int rows,
                                          int d_model, int ei, int num_experts, int act,
                                          int row_tile, int split, int st_up, int st_down,
                                          void* stream) {
  // GEMM1's and GEMM2's grids hold the row tiles in y (at most 65,535);
  // fat_quant_kernel's spreads the rows over y and z.
  if (rows <= 0 || rows % kGroupTile != 0 || (row_tile != 64 && row_tile != 128) ||
      rows / row_tile > 65535 || num_experts <= 0 || ei % num_experts != 0 || d_model <= 0 ||
      d_model % 16 || (ei / num_experts) % 16 || ei <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int inter = ei / num_experts, per = (inter + kDgKC - 1) / kDgKC;
  if (split < 1 || split > 16 || split > per || st_up < 1 || st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ExpertFfn f{xq, xs, w1q, w1s, b1, w2q, w2s, nullptr, emap, out, hq, hs, hidden, absmax,
                    rows, d_model, inter, num_experts, 1, act, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return row_tile == 64 ? expert_ffn_run<64, true>(f, split, st_up, st_down, s)
                        : expert_ffn_run<128, true>(f, split, st_up, st_down, s);
}
