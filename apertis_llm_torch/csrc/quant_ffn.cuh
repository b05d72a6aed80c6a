// The int8 and int4 two-product FFN on decode_gemm.cuh's swapped-operand
// products, shared by the decode FFN's int8 and int4 layouts (ffn_fused.cu,
// #4) and the fat MoE expert FFN's (moe_ffn.cu, #10), whose arithmetic is
// the FFN's with the routing weight folded into each hidden tile's scale;
// the per-expert MoE FFN (moe_dense.cu, #11) and the grouped one
// (moe_grouped.cu, #12) run GEMM1's wide form, its requantization and
// expert_down_kernel (below): #11 over its per-expert stack, one grid slice
// an expert, #12 over the fat stack, each row tile the expert of its grouped
// tile:
//   h   = act(acc1_i32(x_q . W1_q) * x_s * w1_s + b1)                 (f32)
//   per hidden tile t of bn columns:
//     hs_t = max(max|h_t|, 1e-8) * (1/127);  hq_t = rint(h_t / hs_t)
//   acc = sum over t in order of acc2_i32(hq_t . W2_q[t]) * c_t      (f32, from 0)
// with c_t = hs_t and out = bf16(acc * w2_s + b2) for the FFN, and, for the
// MoE layer, c_t = hs_t * combine[:, e(t)] (e(t) the tile's expert, every
// tile inside one expert) and out = acc * w2_s in f32. The _rn intrinsics
// keep nvcc from contracting the multiplies and adds into fused
// multiply-adds that the plain versions do not have.
//
//   1. ffn_up_kernel: one block per 128 hidden columns and row tile, the
//      whole K, the rows streamed beside each W1 tile. Epilogue in
//      registers: dequantization, bias and activation, then each row's
//      absmax over the lane's two columns, the warp (shuffles), the block
//      (shared memory) and the bn / 128 blocks of the hidden tile, which
//      form one thread-block cluster (distributed shared memory; a max is
//      exact in any order); it writes hq (S, N) int8 and hs (S, N / bn) f32.
//      A MoE tile wider than a cluster (bn / 128 above 16, or bn not a
//      multiple of 128: the "wide" form, cs 0) writes the f32 hidden instead
//      and each (row, tile) absmax by an atomicMax on the bits of the
//      non-negative values (exact and order-free) into a zeroed (S, tiles);
//      fat_quant_kernel (below) then writes hq and hs.
//   2. ffn_down_kernel: one block per 128 output columns, row tile and part
//      r of a K split over a cluster of `split` blocks, which takes the
//      hidden tiles t = r, r + split, ...: a fresh int32 accumulator per tile
//      over its chunks (hq streamed beside W2), then p_t = float(acc_t) *
//      c_t. In round rho block r holds the `group` consecutive tiles of
//      unit rho * split + r (group 1 for the FFN; up to 8 for the MoE
//      layer's many narrow tiles, so that there are fewer rounds); after a
//      cluster barrier each block adds, for the sums it owns,
//      the blocks' p_t in rank order and, inside a rank, in group order,
//      which is tile order, to its running f32 sum, so every f32 add is the
//      plain version's, in its order. The p_t move as 16-byte remote stores;
//      the second barrier of a round (the slots read) is waited for only
//      before the next round's first push. The producer issues, before each
//      round's barriers, only the chunks whose stage the consumers free
//      before them.
// A MoE block whose rows route none of their weight to an expert reads none
// of that expert's weight: GEMM1 skips such a block (its whole cluster,
// which lies in one tile of one expert, alike), GEMM2 such a tile (p_t is 0
// there, as every one of its terms is: the combine weight is 0). No float
// atomics: a repeated call gives the same bits.
// ffn_down_kernel is also #8's product at a K split (quant_matmul.cu): the
// rows x quantized per 512-wide K block, c_t = that block's row scale s_t,
// the last tile partial where K is not a multiple of 512, and out =
// x.dtype(acc * w_s), then + b in x's dtype.
#pragma once

#include <string.h>

#include <type_traits>

#include "decode_gemm.cuh"

namespace {

// The requantization step, one copy for every kernel that takes it: GEMM1's
// hidden tiles (above), the wide form's (fat_quant_kernel, below) and
// #8's rows per 512-wide K block (quant_matmul.cu::fused_quant_kernel). The
// scale of values whose largest magnitude is `absmax`, max(absmax, 1e-8) *
// (1/127), a multiply; a value's level clip(rint(v / s)), a true division;
// four levels packed into a word, the first in its low byte.
__device__ __forceinline__ float requant_scale(float absmax) {
  return __fmul_rn(fmaxf(absmax, 1e-8f), 1.f / 127.f);
}
__device__ __forceinline__ int8_t requant_level(float v, float s) {
  return quant_level(__fdiv_rn(v, s));
}
__device__ __forceinline__ uint32_t requant_pack4(float a, float b, float c, float d, float s) {
  return (uint32_t)(uint8_t)requant_level(a, s) | (uint32_t)(uint8_t)requant_level(b, s) << 8 |
         (uint32_t)(uint8_t)requant_level(c, s) << 16 |
         (uint32_t)(uint8_t)requant_level(d, s) << 24;
}

template <bool kI4>
__host__ __device__ constexpr uint32_t w_tile_bytes() { return kI4 ? kDgW4Bytes : kDgW8Bytes; }

// The operand kind of decode_gemm.cuh: int8 rows against an int8 or int4
// weight.
template <bool kI4>
constexpr int kFfnKind = kI4 ? kDgI4 : kDgI8;

// The largest cluster of ffn_up_kernel: the blocks of one hidden tile of up
// to 16 * 128 columns.
constexpr int kMaxUpCluster = 16;

// ffn_up_kernel's shared memory beyond the ring: the consumer warps' row
// maxima, the block's, and every cluster block's pushed to this one (in the
// wide form: the block's maxima of each tile its columns touch).
constexpr size_t ffn_up_extra(int br) {
  return (size_t)(kConsumers * 4 + 1 + kMaxUpCluster) * br * 4;
}

// GEMM1's arguments beside its tensor maps. The per-expert MoE FFN (#11,
// moe_dense.cu) runs GEMM1 over a grid of gridDim.z = E slices, slice e
// being expert e's product: the weight's K rows e * K .. e * K + K - 1 of
// the (E * K, N) stack, w1s, b1 and the hidden's columns and tiles from
// e * N on (Z = gridDim.z * N of them, (E, 1, I) and (E, I) flattened);
// every row is routed to every expert (comb null). The FFN and the fat MoE
// FFN run one slice, and so does the grouped MoE FFN (#12, moe_grouped.cu,
// the kernel's kGrouped form): its rows come in tiles of kGroupTile, each
// one expert's (emap) or none's (-1: the block returns at once), and expert
// e's product is the columns e * N .. e * N + N - 1 of the fat (K, E * N)
// weight, w1s and b1 (N = I; the hidden (S, N) and absmax (S, 1) hold the
// row's own expert).
struct UpArgs {
  const float* xs;     // (S, 1)
  const float* w1s;    // (1, Z)
  const void* b1;      // (Z,): bf16 or f32 (FFN, b1_f32), f32 (MoE)
  int8_t* hq;          // (S, N), the cluster form
  float* hs;           // (S, N / bn), the cluster form
  const float* comb;   // fat MoE: (S, E); null for #11
  float* hidden;       // MoE, wide form: (S, Z) f32
  float* absmax;       // MoE, wide form: (S, Z / bn), zeroed
  int rows, k, n, bn, act, stages;
  int cs;              // blocks of a hidden tile, one cluster; 0: the wide form
  int inter, experts;  // fat MoE: I (N = E * I) and E; #12: E
  const int* emap;     // kGrouped: (S / kGroupTile,) tile -> expert, -1: none
  int b1_f32;          // FFN: b1 is f32 (the f32 form's tree), else bf16
};

// GEMM1's arguments in its any-width instances (kAny): x_q (x_own) or W1
// (w_own) whose rows are not whole 16-byte units is staged by the
// producer's own loads from x or w, else by TMA. A type of its own, so that
// the aligned instances' parameters keep UpArgs' layout: two more fields
// there changed their code (the H100 ran the aligned GEMM1 up to 27 %
// slower).
struct UpArgsAny : UpArgs {
  const void* x;
  const void* w;
  int x_own, w_own;
};

// Rows of one expert tile of the grouped MoE FFN's layout
// (ops/kernels/moe_grouped.py::TILE).
constexpr int kGroupTile = 128;

// kGrouped is #12's form, a compile-time choice so that no other caller's
// kernel carries its branches. kAny (the MoE FFNs at widths whose rows are
// not whole 16-byte units, or an odd N or bn) takes UpArgsAny and reads
// which operands the producer loads and the widths' parity at run time;
// without it the operands are TMA's and N and bn even, fixed at compile
// time, and the aligned widths' kernels keep their code.
template <bool kI4, int BR, bool kMoe, bool kGrouped = false, bool kAny = false>
__global__ void __launch_bounds__(kThreads, 1) ffn_up_kernel(
    const __grid_constant__ CUtensorMap x_map,   // x_q (S, K): boxes of BR rows x 128
    const __grid_constant__ CUtensorMap w_map,   // W1 (K, N); int4: packed (K / 2, N)
    const __grid_constant__ CUtensorMap sh_map,  // int4: shifts (K / 128, N)
    const std::conditional_t<kAny, UpArgsAny, UpArgs> a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t stage_bytes = BR * 128 + w_tile_bytes<kI4>();
  float* wmax = reinterpret_cast<float*>(smem + (size_t)a.stages * stage_bytes);  // [8][BR]
  float* cmax = wmax + kConsumers * 4 * BR;                                      // [BR]
  float* allmax = cmax + BR;                                          // [kMaxUpCluster][BR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(allmax + kMaxUpCluster * BR);
  const DgRing ring{smem, bars, bars + a.stages, BR * 128, w_tile_bytes<kI4>(), a.stages};
  const int cs = a.cs, bn = a.bn, rows = a.rows;
  const int n0 = blockIdx.x * kDgCols;
  const int m0 = blockIdx.y * BR;
  const int slice = blockIdx.z;                 // #11: the expert
  // #12: the row tile's expert (BR divides kGroupTile), 0 otherwise.
  const int wexp = kGrouped ? a.emap[m0 / kGroupTile] : 0;
  if (kGrouped && wexp < 0) return;
  const int goff = (slice + wexp) * a.n;        // the first column of w1s and b1
  const int hoff = slice * a.n;                 // and of the hidden
  const int chunks = (a.k + kDgKC - 1) / kDgKC;
  const DgChunks ch{0, 1, chunks, 1};
  if constexpr (kMoe) {
    if (a.comb != nullptr) {
      // The experts of this block's columns (one, unless the wide form's
      // columns cross into the next expert): none routed, nothing to do.
      const int e_lo = n0 / a.inter, e_hi = (min(n0 + kDgCols, a.n) - 1) / a.inter;
      int live = 0;
      for (int i = threadIdx.x; i < BR * (e_hi - e_lo + 1); i += kThreads) {
        const int r = m0 + i % BR;
        if (r < rows && a.comb[(size_t)r * a.experts + e_lo + i / BR] != 0.f) live = 1;
      }
      if (!__syncthreads_or(live)) return;
    }
    if (cs == 0)
      for (int i = threadIdx.x; i < kMaxUpCluster * BR; i += kThreads) allmax[i] = 0.f;
  }
  // The operands the producer loads itself (kAny), and the full barrier's
  // arrivals (dg_full_count): one for TMA, 128 for the producer's loads.
  const void* x_own = nullptr;
  const void* w_own = nullptr;
  if constexpr (kAny) {
    x_own = a.x_own ? a.x : nullptr;
    w_own = a.w_own ? a.w : nullptr;
  }
  dg_init(ring, (x_own && w_own ? 0 : 1) + (x_own || w_own ? 128 : 0));
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const DgWeight wt{static_cast<const int8_t*>(w_own), (int)gridDim.z * a.k,
                      kGrouped ? a.experts * a.n : a.n, w_own == nullptr, slice * a.k};
    const DgRows xrows{x_own, rows, a.k, x_own == nullptr};
    // #12: a last column block of an expert whose N is not a multiple of 128
    // multiplies the next expert's first columns too; the epilogue drops
    // them (col_live), so they reach neither the hidden nor the absmax.
    dg_produce<kFfnKind<kI4>>(ring, &w_map, &sh_map, &x_map, wt, xrows, ch, n0 + wexp * a.n, m0,
                              0, chunks, threadIdx.x - kDgConsumerThreads);
    if (cs > 1) {
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
  dg_consume<kFfnKind<kI4>, BR>(ring, L, 0, chunks, acc);

  // h = act(acc * x_s * w1_s + b1) for columns c0, c0 + 1 (past N, in the
  // wide form's last block or the odd N's last column, nothing), and each
  // row's absmax: row slot 2 j + e is row 8 j + 2 (lane % 4) + e.
  const int c0 = n0 + L.col;
  const bool col_live = c0 < a.n;
  float ws[2] = {0.f, 0.f}, bb[2] = {0.f, 0.f};
  if (col_live) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (kAny) {   // an odd N's last column has no c0 + 1
        if (c0 + e >= a.n) continue;
      }
      ws[e] = a.w1s[goff + c0 + e];
      if (kMoe || a.b1_f32)
        bb[e] = static_cast<const float*>(a.b1)[goff + c0 + e];
      else
        bb[e] = to_f32(static_cast<const bf16*>(a.b1)[goff + c0 + e]);
    }
  }
  float h[BR / 2], m[BR / 4];
#pragma unroll
  for (int i = 0; i < BR / 4; ++i) m[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) {
    const int row = m0 + L.row(i);
    const float x_s = row < rows ? a.xs[row] : 0.f;
    const int e = (i & 3) >> 1;
    h[i] = activate(
        __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i]), x_s), ws[e]), bb[e]), a.act);
    const int slot = 2 * (i / 4) + (i & 1);
    m[slot] = fmaxf(m[slot], fabsf(h[i]));
  }
  const int tiles = a.n / bn;
  if (kMoe && cs == 0) {
    // The wide form: the f32 hidden, and the block's maxima of each (row,
    // tile its columns touch) into the global absmax, both in the slices'
    // concatenated columns. Where N and bn are even a lane's two columns lie
    // in one tile and are stored as a pair; else (an odd I) each live column
    // on its own, its |h| maxed into its own tile's row.
    const int t_lo = n0 / bn;
    const size_t ld = (size_t)gridDim.z * a.n, all_tiles = (size_t)gridDim.z * tiles;
    bool paired = true;
    if constexpr (kAny) {
      paired = a.n % 2 == 0 && bn % 2 == 0;
      if (!paired) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + q;
          if (c >= a.n) continue;
          int* tq = reinterpret_cast<int*>(allmax) + (c / bn - t_lo) * BR;
#pragma unroll
          for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 8 * j + 2 * (L.lane & 3) + e;
              if (m0 + r >= rows) continue;
              const float hv = h[4 * j + e + 2 * q];
              a.hidden[(size_t)(m0 + r) * ld + hoff + c] = hv;
              atomicMax(tq + r, __float_as_int(fabsf(hv)));
            }
          }
        }
      }
    }
    if (paired && col_live) {
      int* tmax = reinterpret_cast<int*>(allmax) + (c0 / bn - t_lo) * BR;
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * (L.lane & 3) + e;
          if (m0 + r >= rows) continue;
          *reinterpret_cast<float2*>(a.hidden + (size_t)(m0 + r) * ld + hoff + c0) =
              make_float2(h[4 * j + e], h[4 * j + e + 2]);
          atomicMax(tmax + r, __float_as_int(m[2 * j + e]));
        }
      }
    }
    named_sync(1, kDgConsumerThreads);
    const int ntl = (min(n0 + kDgCols, a.n) - 1) / bn - t_lo + 1;
    for (int i = L.tid; i < ntl * BR; i += kDgConsumerThreads) {
      const int r = m0 + i % BR;
      if (r < rows)
        atomicMax(reinterpret_cast<int*>(a.absmax) + (size_t)r * all_tiles +
                      (size_t)slice * tiles + t_lo + i / BR,
                  __float_as_int(allmax[i]));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < BR / 4; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 4));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 8));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 16));
  }
  if (L.lane < 4) {
#pragma unroll
    for (int i = 0; i < BR / 4; ++i)
      wmax[(L.tid / 32) * BR + 8 * (i / 2) + 2 * L.lane + (i & 1)] = m[i];
  }
  named_sync(1, kDgConsumerThreads);
  // The block's row maxima, pushed to every block of the cluster (remote
  // stores), then maxed over the cluster locally.
  const int rank = (n0 % bn) / kDgCols;
  for (int r = L.tid; r < BR; r += kDgConsumerThreads) {
    float v = 0.f;
    for (int w = 0; w < kConsumers * 4; ++w) v = fmaxf(v, wmax[w * BR + r]);
    if (cs == 1) allmax[r] = v;
    for (int q = 0; q < cs && cs > 1; ++q) *cluster.map_shared_rank(allmax + rank * BR + r, q) = v;
  }
  if (cs > 1)
    cluster.sync();
  else
    named_sync(1, kDgConsumerThreads);
  for (int r = L.tid; r < BR; r += kDgConsumerThreads) {
    float v = 0.f;
    for (int q = 0; q < cs; ++q) v = fmaxf(v, allmax[q * BR + r]);
    cmax[r] = v;
  }
  named_sync(1, kDgConsumerThreads);
  float sc[BR / 4];
#pragma unroll
  for (int i = 0; i < BR / 4; ++i)
    sc[i] = requant_scale(cmax[8 * (i / 2) + 2 * (L.lane & 3) + (i & 1)]);

  // hq = rint(h / hs), a true division; hs by the tile's first block.
  const bool first = n0 % bn == 0;
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * (L.lane & 3) + e;
      if (row >= rows) continue;
      const float s = sc[2 * j + e];
      const int q0 = requant_level(h[4 * j + e], s);
      const int q1 = requant_level(h[4 * j + e + 2], s);
      *reinterpret_cast<uint16_t*>(a.hq + (size_t)row * a.n + c0) =
          (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      if (first && L.col == 0) a.hs[(size_t)row * tiles + n0 / bn] = s;
    }
  }
}

// The wide form's requantization (the fat MoE FFN's, #11's and #12's), one
// block per (tile, row): hs = max(absmax, 1e-8) * (1/127) and hq[r, t * bnp +
// j] = rint(hidden[r, t * bn + j] / hs) for j < bn, 0 up to bnp (bnp a
// multiple of 128, bn any width). The rows run over the grid's y and z
// (fat_quant_grid), since y stops at 65,535. #12 (emap set) skips the rows
// of tiles of no expert, which GEMM1 did not write and GEMM2 does not read.
// kAny: a tile may start unaligned (bn or E*I not a multiple of 4).
template <bool kAny>
__global__ void __launch_bounds__(kBlock) fat_quant_kernel(
    const float* __restrict__ hidden,   // (S, E*I)
    const float* __restrict__ absmax,   // (S, tiles)
    int8_t* __restrict__ hq,            // (S, tiles * bnp)
    float* __restrict__ hs,             // (S, tiles)
    int rows, int ei, int bn, int bnp, const int* __restrict__ emap) {
  const int t = blockIdx.x, tiles = gridDim.x;
  const size_t r = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (r >= (size_t)rows || (emap != nullptr && emap[r / kGroupTile] < 0)) return;
  const float s = requant_scale(absmax[r * tiles + t]);
  if (threadIdx.x == 0) hs[r * tiles + t] = s;
  const float* src = hidden + r * ei + (size_t)t * bn;
  int8_t* dst = hq + (r * tiles + t) * bnp;
  // 16-byte loads where the tile's values start aligned and bn is a
  // multiple of 4; else one value at a time (I = 2790: every other tile).
  const bool vec = !kAny || (((r * ei + (size_t)t * bn) & 3) == 0 && (bn & 3) == 0);
  for (int j = 4 * threadIdx.x; j < bnp; j += 4 * kBlock) {
    uint32_t w = 0;
    if (vec && j < bn) {
      const float4 v = *reinterpret_cast<const float4*>(src + j);
      w = requant_pack4(v.x, v.y, v.z, v.w, s);
    } else if (j < bn) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < bn) w |= (uint32_t)(uint8_t)requant_level(src[j + q], s) << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(dst + j) = w;
  }
}

// fat_quant_kernel's grid: a block a (tile, row), the rows split evenly over
// the fewest z slices that keep y within 65,535 (one slice up to 65,535 rows).
inline dim3 fat_quant_grid(int tiles, int rows) {
  const int z = (rows + 65534) / 65535;
  return dim3(tiles, (rows + z - 1) / z, z);
}

// GEMM2's form (its template's kMode): the FFN's (out = bf16(acc * w2_s +
// b2), b2 bf16), the MoE layer's (c_t with the combine weight, out = acc *
// w2_s in f32), #8's (c_t = s_t, K not a multiple of bn, out = x.dtype(acc
// * w_s) then + b in that type, b possibly null, bf16 or f32) or the FFN's
// f32 form's (b2 and out each bf16 or f32, by DownArgs' codes).
enum DownMode { kDownFfn = 0, kDownMoe = 1, kDownBlock = 2, kDownFfnF32 = 3 };

// GEMM2's arguments beside its tensor maps.
struct DownArgs {
  const float* hs;     // (S, tiles)
  const float* w2s;    // (1, N)
  const void* b2;      // (N,): bf16 or f32 (FFN, b2_f32; #8: out_f32), or null (#8)
  void* out;           // (S, N): bf16 or f32 (FFN, out_f32), f32 (MoE)
  const float* comb;   // MoE: (S, E)
  int rows, n, k, bn, split, stages;
  int per;             // K chunks a hidden tile in hq: its tiles' stride over 128
  int group;           // consecutive tiles a block takes in a round, 1 to kMaxGroup
  int tile_experts;    // MoE: tiles an expert
  int experts;         // MoE: E
  int out_f32;         // kDownFfnF32: f32 out; #8: f32 x and out; else bf16
  int b2_f32;          // kDownFfnF32: f32 b2, else bf16
  // MoE at any H: W2 whose rows are not whole 16-byte units (w_own) is
  // staged by the producer's own loads from w; 0: by TMA.
  const void* w;
  int w_own;
};

// The most tiles a block takes in one round of ffn_down_kernel.
constexpr int kMaxGroup = 8;

// ffn_down_kernel's shared memory beyond its ring (dg_smem_bytes with no
// split): the exchange's slot sets of the group's tiles (xset_bytes), the
// round's c_t of the block's tiles (two buffers of group x BR f32) and, for
// the MoE layer, a byte a live expert.
inline size_t ffn_down_extra(int br, int split, int group, int experts) {
  return (size_t)group * xset_bytes(br, split) + 2 * (size_t)group * br * 4 +
         (size_t)(experts + 15) / 16 * 16;
}

// kAny: as ffn_up_kernel's (W2 by the producer where H breaks TMA, an odd
// H's last column stored alone).
template <bool kI4, int BR, int kMode, bool kAny = false>
__global__ void __launch_bounds__(kThreads, 1) ffn_down_kernel(
    const __grid_constant__ CUtensorMap x_map,   // hq (S, tiles * per * 128): BR rows x 128
    const __grid_constant__ CUtensorMap w_map,   // W2 (K, N); int4: packed (K / 2, N)
    const __grid_constant__ CUtensorMap sh_map,  // int4: shifts (K / 128, N)
    const DownArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int split = a.split, stages = a.stages, rows = a.rows, per = a.per, group = a.group;
  const uint32_t stage_bytes = BR * 128 + w_tile_bytes<kI4>();
  const uint32_t set_floats = xset_bytes(BR, split) / 4;
  float* part = reinterpret_cast<float*>(smem + (size_t)stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(part + (size_t)group * set_floats);
  float* cvs = reinterpret_cast<float*>(bars + 2 * stages);                   // [2][group][BR]
  unsigned char* live = reinterpret_cast<unsigned char*>(cvs + 2 * group * BR);   // MoE: [E]
  const DgRing ring{smem, bars, bars + stages, BR * 128, w_tile_bytes<kI4>(), stages};
  constexpr bool kMoe = kMode == kDownMoe;
  // Tiles of bn K rows; #8's last one of `last` chunks (fewer than `per`
  // where K is not a multiple of 512).
  const int tiles = (a.k + a.bn - 1) / a.bn;
  const int last = (a.k - (tiles - 1) * a.bn + kDgKC - 1) / kDgKC;
  auto chunks_of = [&](int t) { return kMode == kDownBlock && t == tiles - 1 ? last : per; };
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kDgCols;
  const int m0 = blockIdx.y * BR;
  // Tile t is tile t % group of unit t / group; round rho holds the units
  // rho * split .. rho * split + split - 1, block r the unit rho * split + r.
  const int units = (tiles + group - 1) / group;
  const int rounds = (units + split - 1) / split;
  const int wgap = per * kDgKC - a.bn;   // hq's padding a tile, which W2 has not
  if constexpr (kMoe) {
    // The experts that some row of this row tile routes to.
    for (int i = threadIdx.x; i < a.experts; i += kThreads) live[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < BR * a.experts; i += kThreads) {
      const int r = m0 + i % BR;
      if (r < rows && a.comb[(size_t)r * a.experts + i / BR] != 0.f) live[i / BR] = 1;
    }
  }
  const DgWeight wt{kAny ? static_cast<const int8_t*>(a.w) : nullptr, a.k, a.n,
                    kAny ? !a.w_own : 1};
  const DgRows hrows{nullptr, rows, tiles * per * kDgKC, 1};
  dg_init(ring, kAny ? dg_full_count(hrows, wt) : 1);
  cg::cluster_group cluster = cg::this_cluster();
  auto tile_live = [&](int t) { return !kMoe || live[t / a.tile_experts] != 0; };

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const int ptid = threadIdx.x - kDgConsumerThreads;
    // issued: ring positions filled; (q, c): the next chunk, chunk c of
    // this block's q-th tile (tile (rank + (q / group) * split) * group +
    // q % group); freed: the positions the consumers release by the end of
    // the round.
    int issued = 0, q = 0, c = 0, freed = 0;
    const int held = ((units - rank + split - 1) / split) * group;
    auto tile_of = [&](int qi) { return (rank + (qi / group) * split) * group + qi % group; };
    for (int rho = 0; rho < rounds; ++rho) {
      for (int g = 0; g < group; ++g) {
        const int t = (rho * split + rank) * group + g;
        if (t < tiles && tile_live(t)) freed += chunks_of(t);
      }
      // The chunks whose stage the consumers free before this round's
      // barriers (position i waits for position i - stages).
      const int upto = freed + stages;
      while (q < held && issued < upto) {
        const int t = tile_of(q);
        if (t >= tiles || !tile_live(t)) {
          ++q;
          continue;
        }
        const int to = min(chunks_of(t), c + (upto - issued));
        dg_produce<kFfnKind<kI4>>(ring, &w_map, &sh_map, &x_map, wt, hrows,
                                  DgChunks{t, 1, 1, per, wgap}, n0, m0, c, to, ptid,
                                  issued - c);
        issued += to - c;
        c = to;
        if (c == chunks_of(t)) {
          c = 0;
          ++q;
        }
      }
      if (split > 1) {
        __syncwarp();
        cluster_arrive();   // the consumers' pushes of the round are in
        cluster_wait();
        cluster_arrive();   // and the owners have read them
        cluster_wait();
      }
    }
    return;
  }
  regs_alloc<kDgConsumerRegs>();
  const DgLane L;
  const int blocks = min(BR / 8, (rows - m0 + 7) / 8);   // column blocks with a real row
  float sum[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) sum[i] = 0.f;
  // The rows' c_t of round rho's tiles (0 for a tile no row routes to:
  // GEMM1 wrote no hs there), each thread's share of group * BR (at most
  // 512), loaded a round ahead and staged through shared memory.
  float cvr[2];
  auto load_cv = [&](int rho) {
    const int t0 = (rho * split + rank) * group;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = L.tid + h * kDgConsumerThreads;
      const int g = idx / BR, row = m0 + idx % BR, t = t0 + g;
      float v = 0.f;
      if (rho < rounds && g < group && t < tiles && row < rows && tile_live(t)) {
        v = a.hs[(size_t)row * tiles + t];
        if constexpr (kMoe) v = __fmul_rn(v, a.comb[(size_t)row * a.experts + t / a.tile_experts]);
      }
      cvr[h] = v;
    }
  };
  load_cv(0);
  int pos = 0;
  for (int rho = 0; rho < rounds; ++rho) {
    const int t0 = (rho * split + rank) * group;
    float* cv = cvs + (rho & 1) * group * BR;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = L.tid + h * kDgConsumerThreads;
      if (idx < group * BR) cv[idx] = cvr[h];
    }
    named_sync(1, kDgConsumerThreads);
    load_cv(rho + 1);
    // The owners' reading of the last round's slots (the second barrier) is
    // waited for only before this round's first push, so that the first
    // tile's products overlap it.
    bool freed = rho == 0 || split == 1;
    for (int g = 0; g < group; ++g) {
      const int t = t0 + g;
      if (t >= tiles) break;
      int acc[BR / 2];
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
      if (tile_live(t)) {
        dg_consume<kFfnKind<kI4>, BR>(ring, L, pos, pos + chunks_of(t), acc);
        pos += chunks_of(t);
      }
      float p[BR / 2];
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) {
        p[i] = __fmul_rn(__int2float_rn(acc[i]), cv[g * BR + L.row(i)]);
        if (split == 1) sum[i] = __fadd_rn(sum[i], p[i]);
      }
      if (split > 1 && tile_live(t)) {
        if (!freed) {
          cluster_wait();
          freed = true;
        }
        xpush<BR>(p, part + g * set_floats, L.tid, rank, split, blocks, cluster);
      }
    }
    if (split > 1) {
      if (!freed) cluster_wait();
      cluster_arrive();   // this block's p of the round are in their owners' slots
      cluster_wait();     // and every block's
      add_round<BR>(sum, part, set_floats, L.tid, rank, split, blocks, group,
                    rho * split * group, tiles, kMoe ? live : nullptr, a.tile_experts);
      cluster_arrive();   // read: the next round may overwrite them
    }
  }
  // FFN: out = out_dtype(acc * w2_s + b2); MoE: out = acc * w2_s (f32); #8:
  // x.dtype(acc * w_s) (+ b); for columns c0, c0 + 1 (N is even but for
  // the MoE layer's, whose odd N's last column has no c0 + 1).
  const int c0 = n0 + L.col;
  if (c0 >= a.n) return;
  const bool c1 = !kAny || c0 + 1 < a.n;
  const float ws0 = a.w2s[c0], ws1 = c1 ? a.w2s[c0 + 1] : 0.f;
  float b0 = 0.f, b1v = 0.f;
  if constexpr (kMode == kDownFfn) {
    b0 = to_f32(static_cast<const bf16*>(a.b2)[c0]);
    b1v = to_f32(static_cast<const bf16*>(a.b2)[c0 + 1]);
  } else if constexpr (kMode == kDownFfnF32) {
    if (a.b2_f32) {
      b0 = static_cast<const float*>(a.b2)[c0];
      b1v = static_cast<const float*>(a.b2)[c0 + 1];
    } else {
      b0 = to_f32(static_cast<const bf16*>(a.b2)[c0]);
      b1v = to_f32(static_cast<const bf16*>(a.b2)[c0 + 1]);
    }
  } else if constexpr (kMode == kDownBlock) {
    if (a.b2 != nullptr && a.out_f32) {
      b0 = static_cast<const float*>(a.b2)[c0];
      b1v = static_cast<const float*>(a.b2)[c0 + 1];
    } else if (a.b2 != nullptr) {
      b0 = to_f32(static_cast<const bf16*>(a.b2)[c0]);
      b1v = to_f32(static_cast<const bf16*>(a.b2)[c0 + 1]);
    }
  }
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (!xowns<BR>(j, L.tid, rank, split)) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * (L.lane & 3) + e;
      if (row >= rows) continue;
      const size_t o = (size_t)row * a.n + c0;
      const float y0 = __fmul_rn(sum[4 * j + e], ws0), y1 = __fmul_rn(sum[4 * j + e + 2], ws1);
      if constexpr (kMode == kDownMoe) {
        float* out = static_cast<float*>(a.out) + o;
        if (!kAny || a.n % 2 == 0) {
          *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
        } else {
          out[0] = y0;
          if (c1) out[1] = y1;
        }
      } else if (kMode == kDownFfn || (kMode == kDownFfnF32 && !a.out_f32)) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o) = __halves2bfloat162(
            __float2bfloat16(__fadd_rn(y0, b0)), __float2bfloat16(__fadd_rn(y1, b1v)));
      } else if (kMode == kDownFfnF32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
            make_float2(__fadd_rn(y0, b0), __fadd_rn(y1, b1v));
      } else if (a.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
            a.b2 != nullptr ? make_float2(__fadd_rn(y0, b0), __fadd_rn(y1, b1v))
                            : make_float2(y0, y1);
      } else {
        bf16 o0 = __float2bfloat16(y0), o1 = __float2bfloat16(y1);
        if (a.b2 != nullptr) {
          o0 = __float2bfloat16(__fadd_rn(__bfloat162float(o0), b0));
          o1 = __float2bfloat16(__fadd_rn(__bfloat162float(o1), b1v));
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o) =
            __halves2bfloat162(o0, o1);
      }
    }
  }
}

// GEMM2 of the per-expert (#11, moe_dense.cu) and grouped (#12,
// moe_grouped.cu) MoE FFN: out = out_dtype(float(acc2_i32(hq . W2_q[e])) *
// hs * w2_s (+ b2)) for 128 output columns, a row tile and a grid slice a
// block (#11: slice e is expert e; #12: one slice, the expert of the row
// tile's grouped tile, and a tile of no expert writes zeros), K = I split in
// contiguous chunk ranges over a cluster of `split` blocks; each block's
// exact int32 sums go to their owners in distributed shared memory
// (decode_gemm.cuh's dg_split_sum: an int32 sum is exact in any order), and
// the owner makes the one float conversion and applies hs, w2_s and b2 in
// the TPU kernels' order. kGrouped is #12's form, a compile-time choice so
// that #11's kernel carries none of its branches.
struct ExpertDownArgs {
  const float* hs;    // (S, slices)
  const float* w2s;   // (slices, H): #11 each expert's, #12 the fat stack's
  const float* b2;    // #11: (slices, H); #12: none (no bias)
  const int* emap;    // #12: as UpArgs::emap
  void* out;          // (slices, S, H): bf16 (out_bf16) or f32
  int rows, n, k;     // S, H, I
  int experts;        // E: W2 is the (E * I, H) stack
  int per;            // K chunks of an expert in hq: Ip / 128
  int split, stages, out_bf16;
  const void* w;      // W2, for the producer's own loads where H breaks TMA (w_own)
  int w_own;
};

template <int BR, bool kGrouped, bool kAny = false>
__global__ void __launch_bounds__(kThreads, 1) expert_down_kernel(
    const __grid_constant__ CUtensorMap x_map,   // hq (S, slices * Ip): BR rows x 128
    const __grid_constant__ CUtensorMap w_map,   // W2 (E * I, H)
    const ExpertDownArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int split = a.split, stages = a.stages, rows = a.rows;
  const int slice = blockIdx.z, slices = gridDim.z;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kDgCols;
  const int m0 = blockIdx.y * BR;
  const int e = kGrouped ? a.emap[m0 / kGroupTile] : slice;
  if (kGrouped && e < 0) {
    // bf16 zeros, by the cluster's first block; every block of the cluster
    // returns here, before any cluster barrier.
    if (rank == 0)
      for (int i = threadIdx.x; i < BR * kDgCols; i += kThreads) {
        const int row = m0 + i / kDgCols, c = n0 + i % kDgCols;
        if (row < rows && c < a.n)
          static_cast<bf16*>(a.out)[(size_t)row * a.n + c] = __float2bfloat16(0.f);
      }
    return;
  }
  const uint32_t stage_bytes = BR * 128 + kDgW8Bytes;
  int* part = reinterpret_cast<int*>(smem + (size_t)stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(part) +
                                               dg_part_bytes(BR, split));
  const DgRing ring{smem, bars, bars + stages, BR * 128, kDgW8Bytes, stages};
  // This block's range of the expert's K chunks.
  const int c_lo = rank * a.per / split, c_hi = (rank + 1) * a.per / split;
  // hq's tile `slice` (padded to Ip), against W2's rows e * I on (no
  // padding): DgChunks' weight gap and DgWeight::row0 place chunk c at row
  // e * I + 128 c.
  const DgWeight wt{kAny ? static_cast<const int8_t*>(a.w) : nullptr, a.experts * a.k, a.n,
                    kAny ? !a.w_own : 1, (e - slice) * a.k};
  const DgRows hrows{nullptr, rows, slices * a.per * kDgKC, 1};
  dg_init(ring, kAny ? dg_full_count(hrows, wt) : 1);
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    dg_produce<kDgI8>(ring, &w_map, &w_map, &x_map, wt, hrows,
                      DgChunks{slice, 1, 1, a.per, a.per * kDgKC - a.k}, n0, m0, c_lo, c_hi,
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
  // out = out_dtype(float(acc) * hs * w2_s (+ b2)) for columns c0, c0 + 1
  // (an odd H's last column has no c0 + 1) of the column blocks this block
  // owns.
  const int c0 = n0 + L.col;
  if (c0 >= a.n) return;
  const bool c1 = !kAny || c0 + 1 < a.n;
  const size_t we = (size_t)slice * a.n + c0;
  const float ws0 = a.w2s[we], ws1 = c1 ? a.w2s[we + 1] : 0.f;
  const float b0 = kGrouped ? 0.f : a.b2[we], b1 = kGrouped || !c1 ? 0.f : a.b2[we + 1];
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (!((mine >> j) & 1)) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = m0 + 8 * j + 2 * (L.lane & 3) + q;
      if (row >= rows) continue;
      const float hs = a.hs[(size_t)row * slices + slice];
      float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + q]), hs), ws0);
      float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + q + 2]), hs), ws1);
      if (!kGrouped) {
        y0 = __fadd_rn(y0, b0);
        y1 = __fadd_rn(y1, b1);
      }
      const size_t o = ((size_t)slice * rows + row) * a.n + c0;
      if (kAny && a.n % 2 != 0) {   // odd H: one value a store
        if (a.out_bf16) {
          static_cast<bf16*>(a.out)[o] = __float2bfloat16(y0);
          if (c1) static_cast<bf16*>(a.out)[o + 1] = __float2bfloat16(y1);
        } else {
          static_cast<float*>(a.out)[o] = y0;
          if (c1) static_cast<float*>(a.out)[o + 1] = y1;
        }
      } else if (a.out_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o) =
            __halves2bfloat162(__float2bfloat16(y0), __float2bfloat16(y1));
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = make_float2(y0, y1);
      }
    }
  }
}

// The operands of the per-expert (#11) and grouped (#12) MoE FFN. #11:
// `slices` = E, W1 the per-expert (E * H, I) stack with w1s (E, 1, I) and b1
// (E, I), W2 (E * I, H) with w2s and b2 (E, H), emap null, out (E, S, H);
// #12: slices 1, W1 the fat (H, E * I) stack with w1s (1, E * I) and b1
// (E * I), W2 (E * I, H) with w2s (1, H), b2 null, emap (S / kGroupTile),
// out (S, H) bf16. Scratch: hq (S, slices * Ip) int8, hs (S, slices),
// hidden (S, slices * I) and absmax (S, slices) f32.
struct ExpertFfn {
  const void *xq, *xs, *w1, *w1s, *b1, *w2, *w2s, *b2, *emap;
  void *out, *hq, *hs, *hidden, *absmax;
  int rows, d_model, inter, experts, slices, act, out_bf16;
};

// Their three launches at a row tile of BR rows on the host's plan (GEMM2's
// split, the two stage counts), #12's where kGrouped: GEMM1's wide form,
// fat_quant_kernel over each slice's whole I, expert_down_kernel.
template <int BR, bool kGrouped>
int expert_ffn_run(const ExpertFfn& f, int split, int st_up, int st_down, cudaStream_t s) {
  const int per = (f.inter + kDgKC - 1) / kDgKC, ip = per * kDgKC;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const uint64_t ei = (uint64_t)f.experts * f.inter;
  CUtensorMap xm, w1m, hqm, w2m, none;
  memset(&none, 0, sizeof(none));   // no int4 shifts
  // x_q, W1 and W2 by TMA where their rows are whole 16-byte units, else by
  // the producers' own loads (H = 693, I = 2790).
  int tx = 0, tw1 = 0, tw2 = 0;
  int err = dg_map_or_own(&xm, f.xq, 1, f.rows, f.d_model, BR, &tx);
  if (err == 0)
    err = kGrouped ? dg_map_or_own(&w1m, f.w1, 1, f.d_model, (int)ei, kDgKC, &tw1)
                   : dg_map_or_own(&w1m, f.w1, 1, f.experts * f.d_model, f.inter, kDgKC, &tw1);
  if (err == 0) err = dg_map_2d(&hqm, f.hq, u8, 1, (uint64_t)f.slices * ip, f.rows, 128, BR);
  if (err == 0) err = dg_map_or_own(&w2m, f.w2, 1, (int)ei, f.d_model, kDgKC, &tw2);
  if (err != 0) return err;
  // #12's W1 tile starts at column e * I of the fat stack: where that is not
  // a whole number of 16-byte units, the producers load it (TMA takes a box
  // at such a column and faults).
  if (kGrouped && f.inter % 16 != 0) tw1 = 0;
  // The any-width instances where an operand goes by the producers' loads
  // or H or I is odd (or not a multiple of 4: the requantization's loads).
  const bool any = !tx || !tw1 || !tw2 || f.d_model % 2 != 0 || f.inter % 4 != 0;
  err = static_cast<int>(
      cudaMemsetAsync(f.absmax, 0, (size_t)f.rows * f.slices * sizeof(float), s));
  if (err != 0) return err;
  const uint32_t stage = BR * 128 + kDgW8Bytes;
  const int row_tiles = (f.rows + BR - 1) / BR;
  const int* emap = static_cast<const int*>(f.emap);
  UpArgsAny up = {};
  up.xs = static_cast<const float*>(f.xs);
  up.w1s = static_cast<const float*>(f.w1s);
  up.b1 = f.b1;
  up.hidden = static_cast<float*>(f.hidden);
  up.absmax = static_cast<float*>(f.absmax);
  up.rows = f.rows;
  up.k = f.d_model;
  up.n = f.inter;
  up.bn = f.inter;
  up.act = f.act;
  up.stages = st_up;
  up.cs = 0;
  up.experts = f.experts;
  up.emap = emap;
  up.x = f.xq;
  up.w = f.w1;
  up.x_own = !tx;
  up.w_own = !tw1;
  const dim3 up_grid((f.inter + kDgCols - 1) / kDgCols, row_tiles, f.slices);
  const size_t up_smem = dg_smem_bytes(BR, st_up, stage, 1, ffn_up_extra(BR));
  err = any ? dg_launch(ffn_up_kernel<false, BR, true, kGrouped, true>, up_grid, dim3(kThreads), 1,
                        up_smem, s, xm, w1m, none, up)
            : dg_launch(ffn_up_kernel<false, BR, true, kGrouped>, up_grid, dim3(kThreads), 1,
                        up_smem, s, xm, w1m, none, static_cast<const UpArgs&>(up));
  if (err != 0) return err;
  const dim3 qgrid = fat_quant_grid(f.slices, f.rows);
  if (any)
    fat_quant_kernel<true><<<qgrid, kBlock, 0, s>>>(
        static_cast<const float*>(f.hidden), static_cast<const float*>(f.absmax),
        static_cast<int8_t*>(f.hq), static_cast<float*>(f.hs), f.rows, f.slices * f.inter,
        f.inter, ip, emap);
  else
    fat_quant_kernel<false><<<qgrid, kBlock, 0, s>>>(
        static_cast<const float*>(f.hidden), static_cast<const float*>(f.absmax),
        static_cast<int8_t*>(f.hq), static_cast<float*>(f.hs), f.rows, f.slices * f.inter,
        f.inter, ip, emap);
  ExpertDownArgs down = {};
  down.hs = static_cast<const float*>(f.hs);
  down.w2s = static_cast<const float*>(f.w2s);
  down.b2 = static_cast<const float*>(f.b2);
  down.emap = emap;
  down.out = f.out;
  down.rows = f.rows;
  down.n = f.d_model;
  down.k = f.inter;
  down.experts = f.experts;
  down.per = per;
  down.split = split;
  down.stages = st_down;
  down.out_bf16 = f.out_bf16;
  down.w = f.w2;
  down.w_own = !tw2;
  err = dg_launch(any ? expert_down_kernel<BR, kGrouped, true> : expert_down_kernel<BR, kGrouped>,
                  dim3(((f.d_model + kDgCols - 1) / kDgCols) * split, row_tiles, f.slices),
                  dim3(kThreads), split, dg_smem_bytes(BR, st_down, stage, split, 0), s, hqm,
                  w2m, down);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace
