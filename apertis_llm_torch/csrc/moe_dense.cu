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
// f32 hidden (5.8 MB at S = 64, mostly found in L2) between them:
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
//      their owners in distributed shared memory (decode_gemm.cuh's
//      dg_split_sum: an int32 sum is exact in any order), and the owner
//      makes the one float conversion and applies hs, w2_s and b2 in the TPU
//      kernel's order.
// No float atomics: repeated calls give the same bits.

#include <string.h>

#include "quant_ffn.cuh"

namespace {

// GEMM2's arguments beside its tensor maps.
struct ExpertDownArgs {
  const float* hs;    // (S, E)
  const float* w2s;   // (E, H)
  const float* b2;    // (E, H)
  void* out;          // (E, S, H): bf16 (out_bf16) or f32
  int rows, n, k;     // S, H, I
  int per;            // K chunks of an expert in hq: Ip / 128
  int split, stages, out_bf16;
};

template <int BR>
__global__ void __launch_bounds__(kThreads, 1) expert_down_kernel(
    const __grid_constant__ CUtensorMap x_map,   // hq (S, E * Ip): BR rows x 128
    const __grid_constant__ CUtensorMap w_map,   // W2 (E * I, H)
    const ExpertDownArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int split = a.split, stages = a.stages, rows = a.rows;
  const uint32_t stage_bytes = BR * 128 + kDgW8Bytes;
  int* part = reinterpret_cast<int*>(smem + (size_t)stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(part) +
                                               dg_part_bytes(BR, split));
  const DgRing ring{smem, bars, bars + stages, BR * 128, kDgW8Bytes, stages};
  const int e = blockIdx.z, experts = gridDim.z;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kDgCols;
  const int m0 = blockIdx.y * BR;
  // This block's range of the expert's K chunks.
  const int c_lo = rank * a.per / split, c_hi = (rank + 1) * a.per / split;
  dg_init(ring, 1);
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const DgWeight wt{nullptr, experts * a.k, a.n, 1};
    const DgRows hrows{nullptr, rows, experts * a.per * kDgKC, 1};
    // Expert e is tile e of hq's per-chunk tiles; W2 has no padding.
    dg_produce<kDgI8>(ring, &w_map, &w_map, &x_map, wt, hrows,
                      DgChunks{e, 1, 1, a.per, a.per * kDgKC - a.k}, n0, m0, c_lo, c_hi,
                      threadIdx.x - kDgConsumerThreads, -c_lo);
    if (split > 1) {
      __syncwarp();
      cluster.sync();   // the sums are pushed and read
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
  // out = out_dtype(float(acc) * hs * w2_s[e] + b2[e]) for columns c0, c0 + 1
  // (H is a multiple of 16) of the column blocks this block owns.
  const int c0 = n0 + L.col;
  if (c0 >= a.n) return;
  const size_t we = (size_t)e * a.n + c0;
  const float ws0 = a.w2s[we], ws1 = a.w2s[we + 1], b0 = a.b2[we], b1 = a.b2[we + 1];
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (!((mine >> j) & 1)) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = m0 + 8 * j + 2 * (L.lane & 3) + q;
      if (row >= rows) continue;
      const float hs = a.hs[(size_t)row * experts + e];
      const float y0 =
          __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + q]), hs), ws0), b0);
      const float y1 =
          __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + q + 2]), hs), ws1), b1);
      const size_t o = ((size_t)e * rows + row) * a.n + c0;
      if (a.out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o) =
            __halves2bfloat162(__float2bfloat16(y0), __float2bfloat16(y1));
      else
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = make_float2(y0, y1);
    }
  }
}

// The three launches at a row tile of BR rows on the host's plan (split,
// stage counts).
template <int BR>
int dense_run(const void* xq, const void* xs, const void* w1, const void* w1s, const void* b1,
              const void* w2, const void* w2s, const void* b2, void* out, void* hq, void* hs,
              void* hidden, void* absmax, int rows, int d_model, int inter, int experts,
              int act, int out_bf16, int split, int st_up, int st_down, cudaStream_t s) {
  const int per = (inter + kDgKC - 1) / kDgKC, ip = per * kDgKC;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap xm, w1m, hqm, w2m, none;
  memset(&none, 0, sizeof(none));   // no int4 shifts
  int err = dg_map_2d(&xm, xq, u8, 1, d_model, rows, 128, BR);
  if (err == 0) err = dg_map_2d(&w1m, w1, u8, 1, inter, (uint64_t)experts * d_model, 128, kDgKC);
  if (err == 0) err = dg_map_2d(&hqm, hq, u8, 1, (uint64_t)experts * ip, rows, 128, BR);
  if (err == 0) err = dg_map_2d(&w2m, w2, u8, 1, d_model, (uint64_t)experts * inter, 128, kDgKC);
  if (err != 0) return err;
  err = static_cast<int>(
      cudaMemsetAsync(absmax, 0, (size_t)rows * experts * sizeof(float), s));
  if (err != 0) return err;
  const uint32_t stage = BR * 128 + kDgW8Bytes;
  const int row_tiles = (rows + BR - 1) / BR;
  UpArgs up = {};
  up.xs = static_cast<const float*>(xs);
  up.w1s = static_cast<const float*>(w1s);
  up.b1 = b1;
  up.hidden = static_cast<float*>(hidden);
  up.absmax = static_cast<float*>(absmax);
  up.rows = rows;
  up.k = d_model;
  up.n = inter;
  up.bn = inter;
  up.act = act;
  up.stages = st_up;
  up.cs = 0;
  err = dg_launch(ffn_up_kernel<false, BR, true>,
                  dim3((inter + kDgCols - 1) / kDgCols, row_tiles, experts), dim3(kThreads), 1,
                  dg_smem_bytes(BR, st_up, stage, 1, ffn_up_extra(BR)), s, xm, w1m, none, up);
  if (err != 0) return err;
  fat_quant_kernel<<<dim3(experts, rows), kBlock, 0, s>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(absmax),
      static_cast<int8_t*>(hq), static_cast<float*>(hs), experts * inter, inter, ip);
  ExpertDownArgs down = {};
  down.hs = static_cast<const float*>(hs);
  down.w2s = static_cast<const float*>(w2s);
  down.b2 = static_cast<const float*>(b2);
  down.out = out;
  down.rows = rows;
  down.n = d_model;
  down.k = inter;
  down.per = per;
  down.split = split;
  down.stages = st_down;
  down.out_bf16 = out_bf16;
  err = dg_launch(expert_down_kernel<BR>,
                  dim3(((d_model + kDgCols - 1) / kDgCols) * split, row_tiles, experts),
                  dim3(kThreads), split, dg_smem_bytes(BR, st_down, stage, split, 0), s, hqm,
                  w2m, down);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// The per-expert MoE FFN for S rows and E experts: out (E, S, H) in bf16
// (out_bf16 = 1) or f32. H and I multiples of 16, every tensor 16-byte
// aligned. hq (S, E * Ip) int8 (Ip: I rounded up to 128), hs (S, E) f32,
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
      d_model % 16 || inter <= 0 || inter % 16 || (rows + 15) / 16 > 65535 || split < 1 ||
      split > 16 || split > per || st_up < 1 || st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile == 16)
    return dense_run<16>(xq, xs, w1q, w1s, b1, w2q, w2s, b2, out, hq, hs, hidden, absmax, rows,
                         d_model, inter, num_experts, act, out_bf16, split, st_up, st_down, s);
  if (row_tile == 64)
    return dense_run<64>(xq, xs, w1q, w1s, b1, w2q, w2s, b2, out, hq, hs, hidden, absmax, rows,
                         d_model, inter, num_experts, act, out_bf16, split, st_up, st_down, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
