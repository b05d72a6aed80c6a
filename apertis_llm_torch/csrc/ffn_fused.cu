// ffn_decode: the dense FFN at decode, out = act(x @ W1 + b1) @ W2 + b2.
//
// Replaces: apertis_llm_tpu/ops/pallas/ffn_fused.py::ffn_decode_fused with
// the bf16 weight layout (apertis_ffn_decode), the int8 layout
// (apertis_ffn_decode_int8) and the int4 layout (apertis_ffn_decode_int4),
// all three Hopper tensor-core products on decode_gemm.cuh.
//
// Semantics (ffn_fused.py:42-99, bf16 layout): both products take bf16
// operands and accumulate in f32; the hidden is act(x @ W1 + b1) rounded to
// bf16 before the second product; out = bf16(sum + b2). GELU is the exact
// erf form (erff): the TPU kernel's tanh-form erf only existed because
// Mosaic has no erf.
//
// Bound on the H100: bytes. At decode row counts the step reads both weight
// matrices (2 * 2432 * 9728 bf16 = 94.6 MB per layer of the 1.5B model) for
// 4 * rows FLOPs per weight pair, far below the tensor-core line; the goal
// is to read each weight once per row tile and keep enough loads in flight.
//
// Design (decode_gemm.cuh, the bf16-weight operand kind kDgBW): two
// launches of ffn_bw_kernel, each a swapped-operand product out^T = W^T x^T
// of 128 weight columns by a row tile of 16 or 64 rows a block, the tree's
// row-major (K, N) bf16 weight tile staged by TMA (two 64-column blocks of
// 64 K rows in the 128-byte swizzle) and read by wgmma from shared memory as
// an MN-major A operand, the rows streamed beside it as the K-major B
// operand, in a ring that a producer warpgroup keeps full:
//   1. GEMM1 (K = D): hidden = bf16(act(x @ W1 + b1)) into an (S, I) bf16
//      scratch, 1.2 MB at 64 rows of the 1.5B model, which stays in L2;
//   2. GEMM2 (K = I): out = bf16(hidden @ W2 + b2), the hidden streamed by
//      TMA.
// Each splits K over a cluster of `split` blocks where its column tiles
// leave SMs idle; the blocks' f32 sums are pushed to their owner and added
// in rank order (decode_gemm.cuh's sliced exchange), so a repeated call
// gives the same bits. The host's plan (ops/kernels/decode_plan.py::bf16_ffn_plan)
// gives the row tile, the splits and the rings' stages.
//
// The f32 forms (at the end of this file) serve the trees those layouts do
// not take, as the TPU kernel does in the weights' dtype (ffn_fused.py:91,
// 99): apertis_ffn_decode_f32 float weights of any mix of f32 and bf16 (the
// input rounded to W1's dtype, the hidden to W2's, the output in its own
// dtype), apertis_ffn_decode_int8_f32 the int8 layout's arithmetic step by
// step with biases and output of either dtype. Both run the SIMT products
// of simt.cuh; the int8 form's GEMM2 adds each hidden tile's exact int32 sum
// times the tile's scale in tile order, so it equals its plain version bit
// for bit where its activation does.

#include <string.h>

#include "common.cuh"
#include "decode_gemm.cuh"
#include "quant_ffn.cuh"
#include "simt.cuh"

namespace {

// ffn_bw_kernel's arguments beside its tensor maps.
struct BwArgs {
  const bf16* bias;   // (N,)
  bf16* out;          // (S, N)
  int rows, k, n, act, split, stages;
};

// A ring stage of the bf16 layout: BR rows of 64 bf16 and the weight tile.
__host__ __device__ constexpr uint32_t bw_stage_bytes(int br) {
  return (uint32_t)br * 128 + kDgBWBytes;
}

// One bf16 product of the FFN: GEMM1 (kUp, out = bf16(act(acc + b1))) or
// GEMM2 (out = bf16(acc + b2)), blocks (column tile x split, row tile).
template <int BR, bool kUp>
__global__ void __launch_bounds__(kThreads, 1) ffn_bw_kernel(
    const __grid_constant__ CUtensorMap x_map,   // rows (S, K) bf16: boxes of BR rows x 64
    const __grid_constant__ CUtensorMap w_map,   // W (K, N) bf16: boxes of 64 rows x 64
    const BwArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int split = a.split, stages = a.stages;
  float* part = reinterpret_cast<float*>(smem + (size_t)stages * bw_stage_bytes(BR));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)stages * bw_stage_bytes(BR) +
                                               xset_bytes(BR, split));
  const DgRing ring{smem, bars, bars + stages, BR * 128, kDgBWBytes, stages};
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kDgCols;
  const int m0 = blockIdx.y * BR;
  // This block's K chunks: the rank-th of `split` contiguous ranges.
  const int chunks = (a.k + kDgKC / 2 - 1) / (kDgKC / 2);
  const int per = (chunks + split - 1) / split;
  const int c_lo = min(chunks, rank * per), c_hi = min(chunks, c_lo + per);
  const DgChunks ch{c_lo, 1, c_hi - c_lo, 1};
  dg_init(ring, 1);
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const DgWeight wt{nullptr, a.k, a.n, 1};
    const DgRows xrows{nullptr, a.rows, a.k, 1};
    dg_produce<kDgBW>(ring, &w_map, nullptr, &x_map, wt, xrows, ch, n0, m0, 0, ch.count(),
                      threadIdx.x - kDgConsumerThreads);
    if (split > 1) {
      __syncwarp();
      cluster.sync();
    }
    return;
  }
  regs_alloc<kDgConsumerRegs>();
  const DgLane L(false);
  float acc[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) acc[i] = 0.f;
  dg_consume<kDgBW, BR>(ring, L, 0, ch.count(), acc);
  if (split > 1) {
    // The K split's sum: each block's sums pushed to their owner, added
    // there in rank order from 0.
    const int blocks = min(BR / 8, (a.rows - m0 + 7) / 8);   // with a row below S
    xpush<BR>(acc, part, L.tid, rank, split, blocks, cluster);
    cluster.sync();
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) acc[i] = 0.f;
    add_round<BR>(acc, part, 0, L.tid, rank, split, blocks, 1, 0, split);
  }
  // Entry i: row 8 (i / 4) + 2 (lane % 4) + i % 2, column bw_column(i), in
  // the column blocks this block owns.
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) {
    if (!xowns<BR>(i / 4, L.tid, rank, split)) continue;
    const int row = m0 + L.row(i), col = n0 + L.bw_column(i);
    if (row >= a.rows || col >= a.n) continue;
    const float v = __fadd_rn(acc[i], to_f32(a.bias[col]));
    a.out[(size_t)row * a.n + col] = __float2bfloat16(kUp ? activate(v, a.act) : v);
  }
}

// The two launches of the bf16 layout at a row tile of BR rows on the
// host's plan.
template <int BR>
int ffn_bw_run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, void* hidden, int rows, int d_model, int inter, int act, int split_up,
               int split_down, int st_up, int st_down, cudaStream_t s) {
  const CUtensorMapDataType b16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap xm, w1m, hm, w2m;
  int err = dg_map_2d(&xm, x, b16, 2, d_model, rows, 64, BR);
  if (err == 0) err = dg_map_2d(&w1m, w1, b16, 2, inter, d_model, 64, kDgKC / 2);
  if (err == 0) err = dg_map_2d(&hm, hidden, b16, 2, inter, rows, 64, BR);
  if (err == 0) err = dg_map_2d(&w2m, w2, b16, 2, d_model, inter, 64, kDgKC / 2);
  if (err != 0) return err;
  const int row_tiles = (rows + BR - 1) / BR;
  const BwArgs up{static_cast<const bf16*>(b1), static_cast<bf16*>(hidden), rows, d_model,
                  inter, act, split_up, st_up};
  err = dg_launch(ffn_bw_kernel<BR, true>,
                  dim3(((inter + kDgCols - 1) / kDgCols) * split_up, row_tiles), dim3(kThreads),
                  split_up,
                  dg_smem_bytes(BR, st_up, bw_stage_bytes(BR), 1, xset_bytes(BR, split_up)), s,
                  xm, w1m, up);
  if (err != 0) return err;
  const BwArgs down{static_cast<const bf16*>(b2), static_cast<bf16*>(out), rows, inter, d_model,
                    act, split_down, st_down};
  err = dg_launch(ffn_bw_kernel<BR, false>,
                  dim3(((d_model + kDgCols - 1) / kDgCols) * split_down, row_tiles),
                  dim3(kThreads), split_down,
                  dg_smem_bytes(BR, st_down, bw_stage_bytes(BR), 1, xset_bytes(BR, split_down)),
                  s, hm, w2m, down);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// Whole bf16 FFN for S rows: x (S, D), W1 (D, I), b1 (I,), W2 (I, D), b2
// (D,), all bf16, bf16 out (S, D); D and I multiples of 16, every tensor
// 16-byte aligned. hidden (S, I) bf16 is scratch the caller allocates. act:
// 1 relu, 2 silu, else exact GELU. row_tile (16 or 64), the two products'
// splits and stages are the plan of ops/kernels/decode_plan.py::
// bf16_ffn_plan. Returns cudaGetLastError(), or cudaErrorInvalidResourceHandle
// if a tensor map cannot be made.
extern "C" int apertis_ffn_decode(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, void* hidden, int rows, int d_model,
                                  int inter, int act, int row_tile, int split_up, int split_down,
                                  int st_up, int st_down, void* stream) {
  if (rows <= 0 || d_model <= 0 || inter <= 0 || d_model % 16 != 0 || inter % 16 != 0 ||
      split_up < 1 || split_up > 8 || split_down < 1 || split_down > 8 || st_up < 1 ||
      st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile == 16)
    return ffn_bw_run<16>(x, w1, b1, w2, b2, out, hidden, rows, d_model, inter, act, split_up,
                          split_down, st_up, st_down, s);
  if (row_tile == 64)
    return ffn_bw_run<64>(x, w1, b1, w2, b2, out, hidden, rows, d_model, inter, act, split_up,
                          split_down, st_up, st_down, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- int8 and int4 layouts ----------------------------------------------------
//
// Semantics (ffn_fused.py:42-99 with quant=True; ops/kernels/ffn_fused.py::
// ffn_decode_int8_reference), per row, with the hidden cut into tiles of bn
// = pick_block_n(I) columns (512 at I = 9728; the tile width changes the
// result, so it is the TPU kernel's):
//   h   = act(acc1_i32(x_q . W1_q) * x_s * w1_s + b1)          (f32)
//   per tile t: hs_t = max(max|h_t|, 1e-8) * (1/127);  hq_t = rint(h_t / hs_t)
//   acc = sum over t in order of acc2_i32(hq_t . W2_q[t]) * hs_t  (f32, from 0)
//   out = bf16(acc * w2_s + b2)
// int4 (int4=True): the same over the unpacked weights (each nibble times its
// group's shift, in [-56, 56], so the int32 sums stay exact); the packs are
// w1_q4 (D / 2, I) with w1_sh (D / 128, I) and w2_q4 (I / 2, D) with w2_sh
// (I / 128, D) (models/quantize.py::quantize_weight_int4). The _rn
// intrinsics keep nvcc from contracting the multiplies and adds into fused
// multiply-adds that the reference does not have.
//
// Bound on the H100: bytes. At decode row counts the step reads both weight
// matrices (2 * 2432 * 9728 B = 47.3 MB per layer of the 1.5B model in int8,
// 23.7 MB in int4) for 4 * rows integer operations per weight pair.
//
// Design (quant_ffn.cuh, on decode_gemm.cuh): two launches of swapped-operand
// int8 wgmma products that read each weight from device memory once per row
// tile (16 rows up to 16, else 64), the weight tiles and the rows loaded by
// TMA into a ring that a producer warpgroup keeps full: ffn_up_kernel
// (GEMM1, its epilogue requantizing each (row, hidden tile) across the
// tile's cluster into hq (S, I) int8 and hs (S, I / bn) f32, 0.6 MB at 64
// rows of the 1.5B model, which stay in L2) and ffn_down_kernel (GEMM2, K
// split over a cluster whose owners add the tiles' float(acc_t) * hs_t in
// tile order, then w2_s and b2). No float atomics: a repeated call gives the
// same bits. The host's plan (ops/kernels/decode_plan.py::ffn_plan) gives
// the row tile, the split and the rings' stages.

namespace {

// The two launches of the int8 (kI4 false) or int4 layout at a row tile of
// BR rows; `split`, `st_up` and `st_down` are the host's plan.
template <bool kI4, int BR>
int ffn_quant_run(const void* xq, const void* xs, const void* w1, const void* w1sh,
                  const void* w1s, const void* b1, const void* w2, const void* w2sh,
                  const void* w2s, const void* b2, void* out, void* hq, void* hs, int rows,
                  int d_model, int inter, int bn, int act, int split, int st_up, int st_down,
                  cudaStream_t s) {
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap xm, w1m, s1m, hqm, w2m, s2m;
  memset(&s1m, 0, sizeof(s1m));   // unused by the int8 layout
  memset(&s2m, 0, sizeof(s2m));
  const int wrows = kI4 ? kDgKC / 2 : kDgKC;   // weight rows a chunk
  int err = dg_map_2d(&xm, xq, u8, 1, d_model, rows, 128, BR);
  if (err == 0) err = dg_map_2d(&w1m, w1, u8, 1, inter, kI4 ? d_model / 2 : d_model, 128, wrows);
  if (err == 0) err = dg_map_2d(&hqm, hq, u8, 1, inter, rows, 128, BR);
  if (err == 0) err = dg_map_2d(&w2m, w2, u8, 1, d_model, kI4 ? inter / 2 : inter, 128, wrows);
  if (kI4 && err == 0)
    err = dg_map_2d(&s1m, w1sh, u8, 1, inter, d_model / kDgKC, 128, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (kI4 && err == 0)
    err = dg_map_2d(&s2m, w2sh, u8, 1, d_model, inter / kDgKC, 128, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const uint32_t stage = BR * 128 + w_tile_bytes<kI4>();
  const int row_tiles = (rows + BR - 1) / BR;
  UpArgs up = {};
  up.xs = static_cast<const float*>(xs);
  up.w1s = static_cast<const float*>(w1s);
  up.b1 = b1;
  up.hq = static_cast<int8_t*>(hq);
  up.hs = static_cast<float*>(hs);
  up.rows = rows;
  up.k = d_model;
  up.n = inter;
  up.bn = bn;
  up.act = act;
  up.stages = st_up;
  up.cs = bn / kDgCols;
  err = dg_launch(ffn_up_kernel<kI4, BR, false>, dim3(inter / kDgCols, row_tiles),
                  dim3(kThreads), bn / kDgCols,
                  dg_smem_bytes(BR, st_up, stage, 1, ffn_up_extra(BR)), s, xm, w1m, s1m, up);
  if (err != 0) return err;
  DownArgs down = {};
  down.hs = static_cast<const float*>(hs);
  down.w2s = static_cast<const float*>(w2s);
  down.b2 = static_cast<const bf16*>(b2);
  down.out = out;
  down.rows = rows;
  down.n = d_model;
  down.k = inter;
  down.bn = bn;
  down.split = split;
  down.stages = st_down;
  down.per = bn / kDgKC;
  down.group = 1;
  down.tile_experts = 1;
  down.experts = 0;
  err = dg_launch(ffn_down_kernel<kI4, BR, kDownFfn>,
                  dim3(((d_model + kDgCols - 1) / kDgCols) * split, row_tiles), dim3(kThreads),
                  split, dg_smem_bytes(BR, st_down, stage, 1, ffn_down_extra(BR, split, 1, 0)),
                  s, hqm, w2m, s2m, down);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <bool kI4>
int ffn_quant_dispatch(const void* xq, const void* xs, const void* w1, const void* w1sh,
                       const void* w1s, const void* b1, const void* w2, const void* w2sh,
                       const void* w2s, const void* b2, void* out, void* hq, void* hs, int rows,
                       int d_model, int inter, int bn, int act, int row_tile, int split,
                       int st_up, int st_down, void* stream) {
  if (rows <= 0 || d_model <= 0 || d_model % (kI4 ? kDgKC : 16) != 0 || bn <= 0 ||
      bn % kDgKC != 0 || bn > 16 * kDgKC || inter % bn != 0 || split < 1 || split > 8 ||
      split > inter / bn || st_up < 1 || st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile == 16)
    return ffn_quant_run<kI4, 16>(xq, xs, w1, w1sh, w1s, b1, w2, w2sh, w2s, b2, out, hq, hs,
                                  rows, d_model, inter, bn, act, split, st_up, st_down, s);
  if (row_tile == 64)
    return ffn_quant_run<kI4, 64>(xq, xs, w1, w1sh, w1s, b1, w2, w2sh, w2s, b2, out, hq, hs,
                                  rows, d_model, inter, bn, act, split, st_up, st_down, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Whole int8 FFN for S rows: x_q (S, D) int8 with x_s (S, 1) f32, W1_q
// (D, I) int8 with w1_s (1, I) f32, W2_q (I, D) int8 with w2_s (1, D) f32,
// bf16 biases, bf16 output. D a multiple of 16, bn a multiple of 128
// dividing I, every tensor 16-byte aligned. hq (S, I) int8 and hs (S, I / bn)
// f32 are scratch the caller allocates. act: 1 relu, 2 silu, else exact
// GELU. row_tile (16 or 64), split and the two stage counts are the plan of
// ops/kernels/decode_plan.py::ffn_plan. Returns cudaGetLastError(), or
// cudaErrorInvalidResourceHandle if a tensor map cannot be made.
extern "C" int apertis_ffn_decode_int8(const void* xq, const void* xs, const void* w1q,
                                       const void* w1s, const void* b1, const void* w2q,
                                       const void* w2s, const void* b2, void* out, void* hq,
                                       void* hs, int rows, int d_model, int inter, int bn,
                                       int act, int row_tile, int split, int st_up,
                                       int st_down, void* stream) {
  return ffn_quant_dispatch<false>(xq, xs, w1q, nullptr, w1s, b1, w2q, nullptr, w2s, b2, out,
                                   hq, hs, rows, d_model, inter, bn, act, row_tile, split,
                                   st_up, st_down, stream);
}

// The int4 layout: the int8 layout's arguments with the packs w1_q4
// (D / 2, I), w2_q4 (I / 2, D) and their shifts w1_sh (D / 128, I), w2_sh
// (I / 128, D) (powers of two 1 to 8) in place of W1_q and W2_q, and D a
// multiple of 128.
extern "C" int apertis_ffn_decode_int4(const void* xq, const void* xs, const void* w1q4,
                                       const void* w1sh, const void* w1s, const void* b1,
                                       const void* w2q4, const void* w2sh, const void* w2s,
                                       const void* b2, void* out, void* hq, void* hs, int rows,
                                       int d_model, int inter, int bn, int act, int row_tile,
                                       int split, int st_up, int st_down, void* stream) {
  return ffn_quant_dispatch<true>(xq, xs, w1q4, w1sh, w1s, b1, w2q4, w2sh, w2s, b2, out, hq,
                                  hs, rows, d_model, inter, bn, act, row_tile, split, st_up,
                                  st_down, stream);
}

// The resources of one kernel of the FFN (kernel: 0 up int8, 1 down int8,
// 2 up int4, 3 down int4, 4 up bf16, 5 down bf16) at a row tile of
// `row_tile` rows and `smem` bytes of dynamic shared memory
// (hopper.cuh::kernel_resources): registers a thread, shared memory a block,
// resident blocks an SM, threads a block and spilled bytes a thread, into
// out[0..4].
extern "C" int apertis_ffn_quant_resources(int kernel, int row_tile, int smem, int* out) {
  if (row_tile != 16 && row_tile != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bool r16 = row_tile == 16;
  switch (kernel) {
    case 0: return kernel_resources(r16 ? &ffn_up_kernel<false, 16, false>
                                        : &ffn_up_kernel<false, 64, false>, kThreads, smem, out);
    case 1: return kernel_resources(r16 ? &ffn_down_kernel<false, 16, kDownFfn>
                                        : &ffn_down_kernel<false, 64, kDownFfn>,
                                    kThreads, smem, out);
    case 2: return kernel_resources(r16 ? &ffn_up_kernel<true, 16, false>
                                        : &ffn_up_kernel<true, 64, false>, kThreads, smem, out);
    case 3: return kernel_resources(r16 ? &ffn_down_kernel<true, 16, kDownFfn>
                                        : &ffn_down_kernel<true, 64, kDownFfn>,
                                    kThreads, smem, out);
    case 4: return kernel_resources(r16 ? &ffn_bw_kernel<16, true> : &ffn_bw_kernel<64, true>,
                                    kThreads, smem, out);
    case 5: return kernel_resources(r16 ? &ffn_bw_kernel<16, false> : &ffn_bw_kernel<64, false>,
                                    kThreads, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- the f32 forms (SIMT) -----------------------------------------------------

namespace {

// The int8 form's hidden requantization, one (row, tile) a block of kBlock
// threads: hs = max(absmax, 1e-8) * (1/127), hq = rint(h / hs) over the
// tile's bn columns (ffn_fused.py:93-96). Shared memory: bn floats.
__global__ void __launch_bounds__(kBlock) f32_tile_quant_kernel(
    const float* __restrict__ h, int8_t* __restrict__ hq, float* __restrict__ hs, int inter,
    int bn) {
  extern __shared__ float v[];
  __shared__ float red[kWarps];
  const int tiles = inter / bn;
  const size_t row = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const size_t base = row * inter + (size_t)t * bn;
  for (int k = threadIdx.x; k < bn; k += kBlock) v[k] = h[base + k];
  __syncthreads();
  simt_quant_row(v, bn, red, kWarps, hq + base, hs + row * tiles + t, true);
}

// GEMM2 of the int8 form: out[r, n] = (sum over the hidden tiles t, in order,
// of f32(int32 sum_{k in t} hq[r, k] * W2_q[k, n]) * hs[r, t]) * w2_s[n] +
// b2[n], one row a block of 32 columns and kSimtSlices slices of the tile.
__global__ void __launch_bounds__(kSimtThreads) f32_tile_gemm_kernel(
    const int8_t* __restrict__ hq, const float* __restrict__ hs, const int8_t* __restrict__ w2q,
    const float* __restrict__ w2s, const void* __restrict__ b2, int bbf,
    void* __restrict__ out, int obf, int d_model, int inter, int bn) {
  __shared__ int part[kSimtSlices][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const size_t row = blockIdx.y;
  const bool col = n < d_model;
  const int tiles = inter / bn;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) {
    int sum = 0;
    if (col)
      for (int k = t * bn + slice; k < (t + 1) * bn; k += kSimtSlices)
        sum += (int)hq[row * inter + k] * (int)w2q[(size_t)k * d_model + n];
    part[slice][lane] = sum;
    __syncthreads();
    if (slice == 0) {
      int total = 0;
      for (int s = 0; s < kSimtSlices; ++s) total += part[s][lane];
      acc = __fadd_rn(acc, __fmul_rn((float)total, hs[row * tiles + t]));
    }
    __syncthreads();
  }
  if (slice == 0 && col)
    stv(out, row * d_model + n, __fadd_rn(__fmul_rn(acc, w2s[n]), ldv(b2, n, bbf)), obf);
}

}  // namespace

// The float FFN for S rows, SIMT: x (S, D) of dtype code xbf (1 bf16, 0 f32),
// W1 (D, I) and W2 (I, D) of codes w1bf and w2bf, b1 and b2 of codes b1bf
// and b2bf, out (S, D) of code obf; hidden (S, I) is scratch of W2's dtype.
// hidden = act(x' @ W1 + b1) rounded to W2's dtype (x' is x rounded to W1's),
// out = hidden @ W2 + b2. act: 1 relu, 2 silu, else exact GELU. Returns
// cudaGetLastError().
extern "C" int apertis_ffn_decode_f32(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, void* out, void* hidden,
                                      int rows, int d_model, int inter, int act, int xbf,
                                      int w1bf, int b1bf, int w2bf, int b2bf, int obf,
                                      void* stream) {
  if (rows <= 0 || d_model <= 0 || inter <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = simt_rowmat<false>(x, xbf, nullptr, d_model, w1, w1bf, nullptr, inter, rows,
                                       d_model, inter, b1, b1bf, act, nullptr, 0, 0, hidden,
                                       w2bf, inter, nullptr, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(simt_rowmat<false>(hidden, w2bf, nullptr, inter, w2, w2bf, nullptr,
                                             d_model, rows, inter, d_model, b2, b2bf, -1,
                                             nullptr, 0, 0, out, obf, d_model, nullptr, 0, st));
}

// The int8 FFN for S rows, SIMT, with biases and output of either dtype:
// x_q (S, D) int8 with x_s (S, 1) f32, W1_q (D, I) with w1_s (1, I), W2_q
// (I, D) with w2_s (1, D), b1 and b2 of codes b1bf and b2bf, out of code obf;
// h (S, I) f32, hq (S, I) int8 and hs (S, I / bn) f32 are scratch. bn divides
// I. Returns cudaGetLastError().
extern "C" int apertis_ffn_decode_int8_f32(const void* xq, const void* xs, const void* w1q,
                                           const void* w1s, const void* b1, const void* w2q,
                                           const void* w2s, const void* b2, void* out, void* h,
                                           void* hq, void* hs, int rows, int d_model, int inter,
                                           int bn, int act, int b1bf, int b2bf, int obf,
                                           void* stream) {
  if (rows <= 0 || d_model <= 0 || bn <= 0 || inter % bn)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = simt_rowmat<true>(xq, 0, static_cast<const float*>(xs), d_model, w1q, 0,
                                      static_cast<const float*>(w1s), inter, rows, d_model,
                                      inter, b1, b1bf, act, nullptr, 0, 0, h, 0, inter, nullptr,
                                      0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem(f32_tile_quant_kernel, (size_t)bn * sizeof(float))) != cudaSuccess)
    return static_cast<int>(err);
  f32_tile_quant_kernel<<<rows * (inter / bn), kBlock, (size_t)bn * sizeof(float), st>>>(
      static_cast<const float*>(h), static_cast<int8_t*>(hq), static_cast<float*>(hs), inter,
      bn);
  f32_tile_gemm_kernel<<<dim3((d_model + 31) / 32, rows), kSimtThreads, 0, st>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(hs),
      static_cast<const int8_t*>(w2q), static_cast<const float*>(w2s), b2, b2bf, out, obf,
      d_model, inter, bn);
  return static_cast<int>(cudaGetLastError());
}
