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
// 99):
//   apertis_ffn_decode_f32, float weights of any mix of f32 and bf16 (the
//   input rounded to W1's dtype, the hidden to W2's, biases and output of
//   either dtype): each product is ffn_bw_kernel, a bf16 weight as above
//   (f32 rows rounded to bf16 by the producer), an f32 weight in split TF32
//   (decode_gemm.cuh's kDgTF: the TMA-staged row-major f32 tile read into
//   register A fragments and split into hi and lo there, the rows split by
//   the producer, hi.hi + lo.hi + hi.lo a k8 step, a fresh accumulator a
//   32-K chunk added in f32 registers; bf16 rows have no lo part, so the
//   chat's GEMM1 on the step's bf16 FFN input runs two products a step).
//   Bound: bytes. Both f32 weights are 2 * 2432 * 9728 * 4 = 189 MB a layer
//   of the 1.5B model (0.0565 ms at 3.35 TB/s); the three TF32 products at
//   64 rows (18.2 GFLOP at 495 TFLOP/s, 0.037 ms) stay under that, where the
//   same products on CUDA cores (0.09 ms at 67 TFLOP/s) would not.
//   apertis_ffn_decode_int8_f32, the int8 layout with biases and output of
//   either dtype: the int8 layout's two launches below, whose epilogues read
//   and write by dtype code (quant_ffn.cuh's UpArgs::b1_f32, and GEMM2's
//   kDownFfnF32 mode with DownArgs::b2_f32 and out_f32), so it equals its
//   plain version bit for bit where its activation does.
// The layouts' own instances (ffn_bw_kernel without kCoded, GEMM2's
// kDownFfn) keep their bf16 operands fixed at compile time: with the codes
// read at run time the bf16 layout's GEMM1 spilled registers at a row tile
// of 64 and ran slower there.

#include <string.h>

#include <algorithm>

#include "common.cuh"
#include "decode_gemm.cuh"
#include "quant_ffn.cuh"

namespace {

// ffn_bw_kernel's arguments beside its tensor maps.
struct BwArgs {
  const void* bias;   // (N,): bf16, or f32 (bias_f32)
  void* out;          // (S, N): bf16, or f32 (out_f32); with out_lo its TF32 hi parts
  int rows, k, n, act, split, stages;
  int bias_f32, out_f32;
  // f32 rows of a bf16 weight, which the producer loads and rounds (x_map
  // is then unused); null: x_map's.
  const float* x;
  float* out_lo;      // (S, N) or null: the output's TF32 lo parts (GEMM1's hidden for an f32 W2)
};

// A ring stage of the float layouts: BR rows of 128 bytes (twice that for
// split-TF32 rows with a lo tile) and the weight tile.
template <int BR, int kKind, bool kLo>
__host__ __device__ constexpr uint32_t bw_stage_bytes() {
  return (uint32_t)BR * 128 * (kLo ? 2 : 1) + DgOp<kKind>::kWBytes;
}

// One float product of the FFN: GEMM1 (kUp, out = act(acc + b1)) or GEMM2
// (out = acc + b2), each rounded to out's dtype, blocks (column tile x
// split, row tile). kKind: kDgBW (a bf16 weight) or kDgTF (an f32 weight in
// split TF32; kLo: the rows are f32, so their lo parts enter). kCoded: the
// f32 form's, whose bias and output dtypes, f32 rows (a.x) and lo output
// are read from `a`; without it (the bf16 layout) all are bf16 by TMA, fixed
// at compile time.
template <int BR, bool kUp, int kKind, bool kLo, bool kCoded>
__global__ void __launch_bounds__(kThreads, 1) ffn_bw_kernel(
    const __grid_constant__ CUtensorMap x_map,    // rows (S, K), boxes of BR rows x 128 bytes:
                                                  // bf16, or kDgTF their f32 hi parts
    const __grid_constant__ CUtensorMap xlo_map,  // kLo: the rows' f32 lo parts
    const __grid_constant__ CUtensorMap w_map,    // W (K, N): bf16 boxes of 64 rows x 64,
                                                  // f32 of 32 x 32
    const BwArgs a) {
  typedef DgOp<kKind> Op;
  constexpr bool kTF = kKind == kDgTF;
  constexpr uint32_t kStage = bw_stage_bytes<BR, kKind, kLo>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int split = a.split, stages = a.stages;
  float* part = reinterpret_cast<float*>(smem + (size_t)stages * kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)stages * kStage +
                                               xset_bytes(BR, split));
  const DgRing ring{smem, bars, bars + stages, kStage - Op::kWBytes, Op::kWBytes, stages};
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kDgCols;
  const int m0 = blockIdx.y * BR;
  // This block's K chunks: the rank-th of `split` contiguous ranges.
  const int chunks = (a.k + Op::kKC - 1) / Op::kKC;
  const int per = (chunks + split - 1) / split;
  const int c_lo = min(chunks, rank * per), c_hi = min(chunks, c_lo + per);
  const DgChunks ch{c_lo, 1, c_hi - c_lo, 1};
  const DgWeight wt{nullptr, a.k, a.n, 1};
  const float* x_f32 = kCoded ? a.x : nullptr;
  const DgRows xrows{x_f32, a.rows, a.k, x_f32 == nullptr ? 1 : 0, x_f32 != nullptr, kLo ? 1 : 0};
  dg_init(ring, dg_full_count(xrows, wt));
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    dg_produce<kKind>(ring, &w_map, &xlo_map, &x_map, wt, xrows, ch, n0, m0, 0, ch.count(),
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
  if constexpr (kTF)
    dg_consume_tf<BR, kLo>(ring, L, 0, ch.count(), acc);
  else
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
  // Entry i: row 8 (i / 4) + 2 (lane % 4) + i % 2, column bw_column(i) (bf16
  // weight) or column(i) (split TF32), in the column blocks this block owns.
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) {
    if (!xowns<BR>(i / 4, L.tid, rank, split)) continue;
    const int row = m0 + L.row(i), col = n0 + (kTF ? L.column(i) : L.bw_column(i));
    if (row >= a.rows || col >= a.n) continue;
    const float b = kCoded && a.bias_f32 ? static_cast<const float*>(a.bias)[col]
                                         : to_f32(static_cast<const bf16*>(a.bias)[col]);
    float v = __fadd_rn(acc[i], b);
    if (kUp) v = activate(v, a.act);
    const size_t o = (size_t)row * a.n + col;
    if (kCoded && a.out_lo != nullptr)
      tf_split_store(v, static_cast<float*>(a.out), a.out_lo, o);
    else if (kCoded && a.out_f32)
      static_cast<float*>(a.out)[o] = v;
    else
      static_cast<bf16*>(a.out)[o] = __float2bfloat16(v);
  }
}

// The split-TF32 parts of n values of dtype code xbf (1 bf16, 0 f32): hi
// and, where lo is not null, lo (the f32 form's GEMM1 rows).
__global__ void __launch_bounds__(kBlock) tf32_split_kernel(const void* __restrict__ x, int xbf,
                                                            float* __restrict__ hi,
                                                            float* __restrict__ lo, size_t n) {
  for (size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x; i < n; i += (size_t)gridDim.x * kBlock)
    tf_split_store(xbf ? __bfloat162float(static_cast<const bf16*>(x)[i])
                       : static_cast<const float*>(x)[i],
                   hi, lo, i);
}

// The float FFN's operands: x (S, D), W1 (D, I), b1, W2 (I, D), b2 and out
// (S, D), each tensor's dtype code (1 bf16, 0 f32), and its scratch.
struct FloatFfn {
  const void *x, *w1, *b1, *w2, *b2;
  void *out, *scratch;
  int rows, d_model, inter, act;
  int xbf, w1bf, b1bf, w2bf, b2bf, obf;
};

// The float FFN's scratch, carved from one buffer at 256-byte boundaries:
// the hidden (S, I) in W2's dtype (for an f32 W2: its TF32 hi parts, then
// its lo parts), and for an f32 W1 the rows' hi parts (S, D) and, unless x
// is bf16, their lo parts.
struct FloatScratch {
  void* hidden;
  float *hidden_lo, *x_hi, *x_lo;
  size_t bytes;
  FloatScratch(void* base, const FloatFfn& f) {
    unsigned char* p = static_cast<unsigned char*>(base);
    size_t off = 0;
    auto take = [&](size_t n) {
      unsigned char* q = n == 0 || p == nullptr ? nullptr : p + off;
      off += (n + 255) / 256 * 256;
      return q;
    };
    const size_t si = (size_t)f.rows * f.inter, sd = (size_t)f.rows * f.d_model;
    hidden = take(si * (f.w2bf ? 2 : 4));
    hidden_lo = reinterpret_cast<float*>(take(f.w2bf ? 0 : si * 4));
    x_hi = reinterpret_cast<float*>(take(f.w1bf ? 0 : sd * 4));
    x_lo = reinterpret_cast<float*>(take(f.w1bf || f.xbf ? 0 : sd * 4));
    bytes = off;
  }
};

// One product of the float FFN at a row tile of BR rows: rows `x` (S x k;
// dtype code xbf) against the weight w (k, n) of dtype code wbf, bias and
// out of codes bbf and obf, on the host's split and stages. For an f32
// weight, x is the rows' TF32 hi parts and x_lo their lo parts (null: none,
// the rows were bf16); out_lo, where not null, takes the output's lo parts.
template <int BR, bool kUp>
int ffn_float_gemm(const void* x, const float* x_lo, int xbf, const void* w, int wbf,
                   const void* bias, int bbf, void* out, float* out_lo, int obf, int rows, int k,
                   int n, int act, int split, int stages, cudaStream_t s) {
  CUtensorMap xm, xlm, wm;
  memset(&xm, 0, sizeof(xm));
  memset(&xlm, 0, sizeof(xlm));
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // Rows by TMA, but f32 rows of a bf16 weight (the producer rounds them).
  const bool x_tma = !wbf || xbf;
  int err = 0;
  if (!wbf) {
    err = dg_map_2d(&xm, x, f32, 4, k, rows, 32, BR);
    if (err == 0 && x_lo != nullptr) err = dg_map_2d(&xlm, x_lo, f32, 4, k, rows, 32, BR);
  } else if (xbf) {
    err = dg_map_2d(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, rows, 64, BR);
  }
  if (err == 0)
    err = wbf ? dg_map_2d(&wm, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, k, 64, kDgKC / 2)
              : dg_map_2d(&wm, w, f32, 4, n, k, 32, kDgTFKC);
  if (err != 0) return err;
  const BwArgs args{bias, out, rows, k, n, act, split, stages, !bbf, !obf,
                    x_tma ? nullptr : static_cast<const float*>(x), out_lo};
  const dim3 grid(((n + kDgCols - 1) / kDgCols) * split, (rows + BR - 1) / BR);
  const size_t extra = xset_bytes(BR, split);
  if (wbf) {
    const size_t smem = dg_smem_bytes(BR, stages, bw_stage_bytes<BR, kDgBW, false>(), 1, extra);
    if (xbf && bbf && obf && out_lo == nullptr)   // the bf16 layout
      return dg_launch(ffn_bw_kernel<BR, kUp, kDgBW, false, false>, grid, dim3(kThreads), split,
                       smem, s, xm, xlm, wm, args);
    return dg_launch(ffn_bw_kernel<BR, kUp, kDgBW, false, true>, grid, dim3(kThreads), split,
                     smem, s, xm, xlm, wm, args);
  }
  if constexpr (kUp) {   // GEMM2's rows, the f32 hidden, always have lo parts
    if (x_lo == nullptr)
      return dg_launch(ffn_bw_kernel<BR, kUp, kDgTF, false, true>, grid, dim3(kThreads), split,
                       dg_smem_bytes(BR, stages, bw_stage_bytes<BR, kDgTF, false>(), 1, extra),
                       s, xm, xlm, wm, args);
  }
  return dg_launch(ffn_bw_kernel<BR, kUp, kDgTF, true, true>, grid, dim3(kThreads), split,
                   dg_smem_bytes(BR, stages, bw_stage_bytes<BR, kDgTF, true>(), 1, extra), s, xm,
                   xlm, wm, args);
}

// The launches of a float FFN at a row tile of BR rows on the host's plan:
// for an f32 W1 the rows' split, then GEMM1, which writes the hidden in
// W2's dtype (split for an f32 W2), and GEMM2, which reads it.
template <int BR>
int ffn_float_run(const FloatFfn& f, int split_up, int split_down, int st_up, int st_down,
                  cudaStream_t s) {
  const FloatScratch sc(f.scratch, f);
  const void* x = f.x;
  if (!f.w1bf) {
    const size_t n = (size_t)f.rows * f.d_model;
    tf32_split_kernel<<<(unsigned)std::min<size_t>((n + kBlock - 1) / kBlock, 1024), kBlock, 0,
                        s>>>(f.x, f.xbf, sc.x_hi, sc.x_lo, n);
    x = sc.x_hi;
  }
  int err = ffn_float_gemm<BR, true>(x, sc.x_lo, f.xbf, f.w1, f.w1bf, f.b1, f.b1bf, sc.hidden,
                                     sc.hidden_lo, f.w2bf, f.rows, f.d_model, f.inter, f.act,
                                     split_up, st_up, s);
  if (err == 0)
    err = ffn_float_gemm<BR, false>(sc.hidden, sc.hidden_lo, f.w2bf, f.w2, f.w2bf, f.b2, f.b2bf,
                                    f.out, nullptr, f.obf, f.rows, f.inter, f.d_model, f.act,
                                    split_down, st_down, s);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

int ffn_float_dispatch(const FloatFfn& f, int row_tile, int split_up, int split_down, int st_up,
                       int st_down, void* stream) {
  const int align = f.w1bf && f.w2bf ? 16 : 4;
  if (f.rows <= 0 || f.d_model <= 0 || f.inter <= 0 || f.d_model % align != 0 ||
      f.inter % align != 0 || split_up < 1 || split_up > 8 || split_down < 1 ||
      split_down > 8 || st_up < 1 || st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile == 16) return ffn_float_run<16>(f, split_up, split_down, st_up, st_down, s);
  if (row_tile == 64) return ffn_float_run<64>(f, split_up, split_down, st_up, st_down, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  const FloatFfn f{x, w1, b1, w2, b2, out, hidden, rows, d_model, inter, act, 1, 1, 1, 1, 1, 1};
  return ffn_float_dispatch(f, row_tile, split_up, split_down, st_up, st_down, stream);
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
                  cudaStream_t s, int b1_f32, int b2_f32, int out_f32) {
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
  up.b1_f32 = b1_f32;
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
  down.b2_f32 = b2_f32;
  down.out_f32 = out_f32;
  const dim3 grid(((d_model + kDgCols - 1) / kDgCols) * split, row_tiles);
  const size_t smem = dg_smem_bytes(BR, st_down, stage, 1, ffn_down_extra(BR, split, 1, 0));
  // The int8 layout's bf16 b2 and output fixed at compile time; the f32
  // form's read by code.
  if constexpr (!kI4) {
    if (b2_f32 || out_f32)
      err = dg_launch(ffn_down_kernel<false, BR, kDownFfnF32>, grid, dim3(kThreads), split, smem,
                      s, hqm, w2m, s2m, down);
    else
      err = dg_launch(ffn_down_kernel<false, BR, kDownFfn>, grid, dim3(kThreads), split, smem,
                      s, hqm, w2m, s2m, down);
  } else {
    err = dg_launch(ffn_down_kernel<true, BR, kDownFfn>, grid, dim3(kThreads), split, smem, s,
                    hqm, w2m, s2m, down);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

template <bool kI4>
int ffn_quant_dispatch(const void* xq, const void* xs, const void* w1, const void* w1sh,
                       const void* w1s, const void* b1, const void* w2, const void* w2sh,
                       const void* w2s, const void* b2, void* out, void* hq, void* hs, int rows,
                       int d_model, int inter, int bn, int act, int row_tile, int split,
                       int st_up, int st_down, void* stream, int b1_f32 = 0, int b2_f32 = 0,
                       int out_f32 = 0) {
  if (rows <= 0 || d_model <= 0 || d_model % (kI4 ? kDgKC : 16) != 0 || bn <= 0 ||
      bn % kDgKC != 0 || bn > 16 * kDgKC || inter % bn != 0 || split < 1 || split > 8 ||
      split > inter / bn || st_up < 1 || st_down < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_tile == 16)
    return ffn_quant_run<kI4, 16>(xq, xs, w1, w1sh, w1s, b1, w2, w2sh, w2s, b2, out, hq, hs,
                                  rows, d_model, inter, bn, act, split, st_up, st_down, s,
                                  b1_f32, b2_f32, out_f32);
  if (row_tile == 64)
    return ffn_quant_run<kI4, 64>(xq, xs, w1, w1sh, w1s, b1, w2, w2sh, w2s, b2, out, hq, hs,
                                  rows, d_model, inter, bn, act, split, st_up, st_down, s,
                                  b1_f32, b2_f32, out_f32);
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
// 2 up int4, 3 down int4, 4 up bf16, 5 down bf16; the f32 form's split-TF32
// products: 6 up on f32 rows, 7 up on bf16 rows, 8 down) at a row tile of
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
    case 4: return kernel_resources(r16 ? &ffn_bw_kernel<16, true, kDgBW, false, false>
                                        : &ffn_bw_kernel<64, true, kDgBW, false, false>,
                                    kThreads, smem, out);
    case 5: return kernel_resources(r16 ? &ffn_bw_kernel<16, false, kDgBW, false, false>
                                        : &ffn_bw_kernel<64, false, kDgBW, false, false>,
                                    kThreads, smem, out);
    case 6: return kernel_resources(r16 ? &ffn_bw_kernel<16, true, kDgTF, true, true>
                                        : &ffn_bw_kernel<64, true, kDgTF, true, true>,
                                    kThreads, smem, out);
    case 7: return kernel_resources(r16 ? &ffn_bw_kernel<16, true, kDgTF, false, true>
                                        : &ffn_bw_kernel<64, true, kDgTF, false, true>,
                                    kThreads, smem, out);
    case 8: return kernel_resources(r16 ? &ffn_bw_kernel<16, false, kDgTF, true, true>
                                        : &ffn_bw_kernel<64, false, kDgTF, true, true>,
                                    kThreads, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- the f32 forms ---------------------------------------------------------

// The float FFN for S rows with the dtype codes (1 bf16, 0 f32) of x (S, D),
// W1 (D, I), b1, W2 (I, D), b2 and out (S, D): hidden = act(x' @ W1 + b1)
// rounded to W2's dtype (x' is x rounded to W1's), out = hidden @ W2 + b2.
// Each product runs on the tensor cores: a bf16 weight as the bf16 layout's
// (f32 rows rounded to bf16 by the producer), an f32 weight in split TF32
// (the rows split into TF32 parts first). `scratch` holds
// apertis_ffn_f32_scratch bytes. D and I multiples of 4 (16 where both
// weights are bf16), every tensor 16-byte aligned. act: 1
// relu, 2 silu, else exact GELU. row_tile (16 or 64), the two products'
// splits and stages are the plan of ops/kernels/decode_plan.py::
// f32_ffn_plan. Returns cudaGetLastError(), or cudaErrorInvalidResourceHandle
// if a tensor map cannot be made.
extern "C" int apertis_ffn_decode_f32(const void* x, const void* w1, const void* b1,
                                      const void* w2, const void* b2, void* out, void* scratch,
                                      int rows, int d_model, int inter, int act, int xbf,
                                      int w1bf, int b1bf, int w2bf, int b2bf, int obf,
                                      int row_tile, int split_up, int split_down, int st_up,
                                      int st_down, void* stream) {
  const FloatFfn f{x, w1, b1, w2, b2, out, scratch, rows, d_model, inter, act,
                   xbf, w1bf, b1bf, w2bf, b2bf, obf};
  return ffn_float_dispatch(f, row_tile, split_up, split_down, st_up, st_down, stream);
}

// The bytes of apertis_ffn_decode_f32's scratch for S rows, D, I and the
// dtype codes of x, W1 and W2.
extern "C" int apertis_ffn_f32_scratch(int rows, int d_model, int inter, int xbf, int w1bf,
                                       int w2bf) {
  FloatFfn f = {};
  f.rows = rows;
  f.d_model = d_model;
  f.inter = inter;
  f.xbf = xbf;
  f.w1bf = w1bf;
  f.w2bf = w2bf;
  return static_cast<int>(FloatScratch(nullptr, f).bytes);
}

// The int8 FFN with biases and output of either dtype (codes b1bf, b2bf and
// obf: 1 bf16, 0 f32), as an int8 tree quantized from an f32 one holds
// them: apertis_ffn_decode_int8's arguments and plan otherwise, its two
// Hopper launches.
extern "C" int apertis_ffn_decode_int8_f32(const void* xq, const void* xs, const void* w1q,
                                           const void* w1s, const void* b1, const void* w2q,
                                           const void* w2s, const void* b2, void* out, void* hq,
                                           void* hs, int rows, int d_model, int inter, int bn,
                                           int act, int b1bf, int b2bf, int obf, int row_tile,
                                           int split, int st_up, int st_down, void* stream) {
  return ffn_quant_dispatch<false>(xq, xs, w1q, nullptr, w1s, b1, w2q, nullptr, w2s, b2, out,
                                   hq, hs, rows, d_model, inter, bn, act, row_tile, split, st_up,
                                   st_down, stream, !b1bf, !b2bf, !obf);
}
