// expert_ffn_dense: every expert's int8 FFN over every row, (E, S, H) out.
//
// Replaces: apertis_llm_tpu/ops/pallas/moe_ffn.py::expert_ffn_dense
// (pallas_call :423, _kernel:376-396), the per-expert kernel the JAX package
// serves under APERTIS_MOE_FUSED=kernel (ops/moe.py::moe_dense_fused) with the
// per-expert stack of models/moe_fuse.py::fuse_moe_decode_params.
//
// Semantics, for expert e and row r (all f32, each step rounded):
//   h    = act(acc1_i32(x_q[r] . W1_q[e]) * x_s[r] * w1_s[e] + b1[e])    (I,)
//   hs   = max(max|h|, 1e-8) * (1/127)          (over the whole of I)
//   hq   = clip(rint(h / hs), -127, 127)
//   out  = out_dtype(acc2_i32(hq . W2_q[e]) * hs * w2_s[e] + b2[e])      (H,)
// Inputs: x_q (S, H) int8 with x_s (S, 1), W1_q (E, H, I) int8 with the
// LayerNorm affine folded in, w1_s (E, 1, I), b1 (E, I), W2_q (E, I, H) int8
// with w2_s (E, 1, H), b2 (E, H); the combine is applied by the caller.
//
// Bound on the H100: bytes at decode (the 31.7 MB of int8 expert weights a
// layer of the 1.5B MoE model, read once); operations (4 E S H I int8) from a
// few hundred rows up.
//
// Design: #10's and #4's int8 products (quant_ffn.cuh on decode_gemm.cuh:
// swapped-operand int8 wgmma, the weight as the register A operand built
// from TMA-staged tiles, a ring that a producer warpgroup keeps full) over
// the per-expert stack as it is, one grid slice (blockIdx.z) an expert, on
// the plan of ops/kernels/decode_plan.py::dense_plan. The requantization
// over the whole of I means no row's GEMM2 can start before its GEMM1 has
// finished all I columns (2816 at the 1.5B widths: 22 column blocks, more
// than a cluster holds), so the two products are separate launches with the
// f32 hidden (5.8 MB at S = 64, mostly found in L2) between them
// (quant_ffn.cuh::expert_ffn_run, shared with the grouped MoE FFN, #12):
//   1. ffn_up_kernel's wide form: GEMM1 (K = H) for 128 columns of I, a row
//      tile and an expert a block, the weight tile from rows e * H on of the
//      (E * H, I) stack (TMA zero-fills x past H, so a last chunk that reads
//      into the next expert's rows adds zeros); the dequantization, bias
//      and activation, the f32 hidden (S, E * I), and each (row, expert)
//      absmax over the whole of I by an integer atomicMax on the bits of
//      the non-negative f32 values (exact and order-free);
//   2. fat_quant_kernel: hs (S, E) and hq (S, E * Ip), each expert's I
//      padded with zeros to whole 128-row chunks (Ip);
//   3. expert_down_kernel: GEMM2 (K = I) for 128 output columns, a row tile
//      and an expert a block, K split in contiguous chunk ranges over a
//      cluster of `split` blocks (6 column tiles x 8 experts at H = 704
//      leave most SMs idle without it); each block's exact int32 sums go to
//      their owners in distributed shared memory, and the owner makes the
//      one float conversion and applies hs, w2_s and b2 in the TPU kernel's
//      order.
// No float atomics: repeated calls give the same bits.

#include "quant_ffn.cuh"

// The per-expert MoE FFN for S rows and E experts: out (E, S, H) in bf16
// (out_bf16 = 1) or f32, at any H and I (an operand whose rows are not
// whole 16-byte units goes by the producers' own loads), every tensor
// 16-byte aligned. hq (S, E * Ip) int8 (Ip: I rounded up to 128), hs (S, E) f32,
// hidden (S, E * I) f32 and absmax (S, E) f32 are scratch the caller
// allocates; absmax is zeroed here. act: 1 relu, 2 silu, else exact GELU.
// row_tile (16 or 64), split (GEMM2's cluster) and the two stage counts are
// the plan of ops/kernels/decode_plan.py::dense_plan. Returns
// cudaGetLastError(), or cudaErrorInvalidResourceHandle if a tensor map
// cannot be made.
extern "C" int apertis_expert_ffn_dense(const void* xq, const void* xs, const void* w1q,
                                        const void* w1s, const void* b1, const void* w2q,
                                        const void* w2s, const void* b2, void* out, void* hq,
                                        void* hs, void* hidden, void* absmax, int rows,
                                        int d_model, int inter, int num_experts, int act,
                                        int out_bf16, int row_tile, int split, int st_up,
                                        int st_down, void* stream) {
  const int per = (inter + kDgKC - 1) / kDgKC;
  if (rows <= 0 || num_experts <= 0 || num_experts > 65535 || d_model <= 0 ||
      inter <= 0 || (rows + 15) / 16 > 65535 || split < 1 ||
      split > 16 || split > per || st_up < 1 || st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ExpertFfn f{xq, xs, w1q, w1s, b1, w2q, w2s, b2, nullptr, out, hq, hs, hidden, absmax,
                    rows, d_model, inter, num_experts, num_experts, act, out_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile == 16) return expert_ffn_run<16, false>(f, split, st_up, st_down, s);
  if (row_tile == 64) return expert_ffn_run<64, false>(f, split, st_up, st_down, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
