// The swapped-operand product core of the Hopper decode and int8-weight
// kernels: the decode mixer step (ssm_step.cu, int8 and bf16 layouts), the
// decode FFN (ffn_fused.cu, quant_ffn.cuh), the fat MoE FFN (moe_ffn.cu) and
// quant_matmul.cu's qm_kernel (#7, #6 with bf16 x, #8's block-scaled mode).
//
// A block of 384 threads computes, for 128 weight columns (two consumer
// warpgroups of 64, wgmma's M side) and BR rows (16 to 256, wgmma's N side),
// the sums out^T = W^T x^T over a list of K chunks:
// - the tree's row-major int8 (K, N) weight tile is staged in shared memory
//   by TMA in the 128-byte swizzle (or, where N breaks TMA's 16-byte rows,
//   by the producer warpgroup's own zero-filling loads) and becomes wgmma's
//   register A operand through ldmatrix.trans and byte permutes
//   (hopper.cuh::qm_frags); an int4 weight's packed 64-row tile and its
//   group's shift row are staged the same way and unpacked into int8
//   fragments in registers (hopper.cuh::i4_frags); for bf16 rows the int8
//   levels become bf16 fragments exactly;
// - the rows (int8, quantized by an earlier launch, or bf16) are the
//   K-major B operand, streamed from device memory by TMA (or the
//   producer's own loads) beside each weight tile;
// - a ring of stages with full and empty mbarriers, kept full by the
//   producer warpgroup; at up to 64 rows the consumers build the next
//   chunk's fragments while the last chunk's products run.
// The operand kinds (DgOp): int8 rows and weight (exact int32 sums, 128 K a
// chunk), int8 rows and an int4 weight (the same), bf16 rows and an int8
// weight (f32 sums, 64 K a chunk), bf16 rows and a bf16 weight (f32 sums, 64
// K a chunk): the bf16 weight tile is staged as two 64-column blocks of 64 K
// rows (by TMA, or by the producer's own 8-byte loads where a row is not a
// whole number of 16-byte units, as x_param's R + 2C at the MoE widths) and
// read by wgmma straight from shared memory as an MN-major A operand
// (hopper.cuh::BwMma), with no register fragments; f32 rows (or bf16
// ones) and an f32 weight (f32 sums, 32 K a chunk, kDgTF): split TF32, the
// f32 weight tile staged by TMA as four 32-column blocks in the 128-byte
// swizzle, each value read into wgmma's register A fragment and split there
// into TF32 hi and lo parts (hopper.cuh::tf32_round), the rows' parts split
// by the launch before (rows of bf16 values have no lo part) and staged by
// TMA as a hi tile and a lo tile; each k8 step runs hi.hi + lo.hi (+ hi.lo) and each chunk's
// products start a fresh accumulator that is added to the f32 sum in
// registers (the tensor cores' own f32 sum over thousands of terms drifts,
// as in flash_attention_f32.cu); f32 rows and an int8 weight (f32 sums, 64
// K a chunk, kDgB3): the rows split by the launch before into three bf16
// parts, hi + mid + lo (exact for normal f32 values), staged by TMA as three
// tiles beside one int8 weight tile, whose bf16 A fragments (exact levels)
// serve the three parts' products into one fresh accumulator a chunk, added
// to the f32 sum in registers as kDgTF's.
// A K split over a thread-block cluster adds the blocks' sums in one of two
// exchanges: the owner-slot one (dg_split_sum: a column block's sums to one
// rank) or the sliced one (xpush / add_round: runs of (thread, column block)
// pairs, 16-byte pushes, and tile-ordered rounds for the products that must
// add per-tile f32 terms in order).
#pragma once

#include <cooperative_groups.h>
#include <string.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kDgCols = kConsumers * 64;                   // weight columns a block
constexpr int kDgKC = 128;                                 // int8 K rows a chunk: one int4 group
constexpr uint32_t kDgW8Bytes = kDgKC * 128;               // int8 weight tile
constexpr uint32_t kDgW4Bytes = kDgKC / 2 * 128 + 1024;    // packed tile + shift row
constexpr int kDgProducerRegs = 56;
constexpr int kDgConsumerRegs = 224;
constexpr size_t kDgSmemLimit = 232448;                    // dynamic shared memory a block
constexpr int kDgConsumerThreads = kConsumers * 128;

enum DgKind { kDgI8 = 0, kDgI4 = 1, kDgBf16 = 2, kDgBW = 3, kDgTF = 4, kDgB3 = 5 };

constexpr uint32_t kDgBWBytes = kDgKC / 2 * 256;           // bf16 weight tile: 64 x 128
constexpr int kDgTFKC = kDgKC / 4;                         // f32 K rows a chunk: 128 bytes
constexpr uint32_t kDgTFBlock = kDgTFKC * 128;             // one 32-column block of it
constexpr uint32_t kDgTFBytes = 4 * kDgTFBlock;            // f32 weight tile: 32 x 128

// One operand kind: K values a chunk (a 128-byte row of the rows' tile),
// the weight tile's bytes in a stage and those TMA brings, the
// accumulator's type.
template <int kKind>
struct DgOp {
  static constexpr bool kW8 = kKind == kDgI8 || kKind == kDgI4;   // int8 wgmma
  static constexpr int kKC = kW8 ? kDgKC : (kKind == kDgTF ? kDgTFKC : kDgKC / 2);
  static constexpr uint32_t kWBytes =
      kKind == kDgI4 ? kDgW4Bytes
                     : (kKind == kDgBW ? kDgBWBytes
                                       : (kKind == kDgTF ? kDgTFBytes : (uint32_t)kKC * 128));
  static constexpr uint32_t kWTx = kKind == kDgI4 ? kDgKC / 2 * 128 + 128 : kWBytes;
  typedef typename std::conditional<kW8, int, float>::type Acc;
};

// The ring of one block: `stages` stages of the rows' tile (x_bytes: BR
// rows of 128 bytes) and a weight tile (w_bytes; an int4 one with its shift
// row 8192 bytes on), each a whole number of 1024-byte swizzle atoms.
struct DgRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  uint32_t x_bytes, w_bytes;
  int stages;
  __device__ __forceinline__ uint32_t stage_bytes() const { return x_bytes + w_bytes; }
  __device__ __forceinline__ unsigned char* x(int s) const { return base + s * stage_bytes(); }
  __device__ __forceinline__ unsigned char* w(int s) const { return x(s) + x_bytes; }
  __device__ __forceinline__ const int8_t* sh(int s) const {
    return reinterpret_cast<const int8_t*>(w(s) + kDgKC / 2 * 128);
  }
};

// The K chunks a block reads, in order: `ntiles` tiles of `per` chunks, the
// i-th chunk being chunk i % per of tile t0 + (i / per) * tstep (K chunk
// (t0 + (i / per) * tstep) * per + i % per). A contiguous K range [c0, c1)
// is {c0, 1, c1 - c0, 1}. The weight's K row of a chunk is the rows' one
// less `wgap` a tile before it: rows whose tiles are padded to whole chunks
// (per * chunk K values) against a weight whose tiles are not.
struct DgChunks {
  int t0, tstep, ntiles, per;
  int wgap = 0;
  __device__ __forceinline__ int count() const { return ntiles * per; }
};

// One product's weight: int8 (K, N), int4 packed (K / 2, N) with its
// (K / 128, N) shifts, or bf16 (K, N); loaded by TMA (w_map, sh_map) when
// `tma`, else by the producer's own loads. `row0` (0 where it is left out)
// is the product's first K row in a stack of weights that one TMA map
// spans (#11's per-expert (E * H, I) stack); k and n are then the stack's.
struct DgWeight {
  const int8_t* w;
  int k, n;
  int tma;
  int row0;
};

// The streamed B operand: int8 or bf16 rows (rows, k) of row stride k, a
// tile of x_bytes / 128 rows from m0, loaded by TMA (x_map) when `tma`.
// `f32` (kDgBW): the rows are f32 in memory, loaded by the producer, which
// rounds them to bf16. kDgTF: the rows' TF32 hi parts (f32, by TMA) and,
// with `lo`, their lo parts by a second map into a second tile (x_bytes
// holds both); where TMA cannot load them (a row that is not a multiple of
// 16 bytes), the producer loads both, the lo parts from `x_lo`. kDgB3: the
// rows' three bf16 parts (hi, mid, lo), each `part_rows` rows on from the
// last in one (3 part_rows, k) matrix, by TMA only, into three tiles
// (x_bytes holds the three).
struct DgRows {
  const void* x;
  int rows, k;
  int tma;
  int f32 = 0;
  int lo = 0;
  int part_rows = 0;
  const void* x_lo = nullptr;
};

// The arrivals a stage's full barrier expects: one for the TMA loads (which
// carry their bytes), 128 for the producer's own.
__device__ __forceinline__ int dg_full_count(const DgRows& rows, const DgWeight& wt) {
  return ((wt.tma || rows.tma) ? 1 : 0) + ((!wt.tma || !rows.tma) ? 128 : 0);
}

__device__ __forceinline__ void dg_init(const DgRing& r, int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) {
      mbar_init(&r.full[s], full_count);
      mbar_init(&r.empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// 8 bf16 of row `row` of a (rows, cols) bf16 matrix with leading dimension
// `ld`, from column `col`; zeros past the edges. `vec`: cols is a multiple of
// 8 and the base 16-byte aligned.
__device__ __forceinline__ int4 load8_bf16(const bf16* __restrict__ base, int row, int col,
                                           int rows, int cols, size_t ld, bool vec) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  const bf16* src = base + (size_t)row * ld + col;
  if (vec) return *reinterpret_cast<const int4*>(src);
  const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (col + j < cols) w[j >> 1] |= (uint32_t)h[j] << (16 * (j & 1));
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// 4 bf16 of row `row` of a (rows, cols) bf16 matrix with leading dimension
// `ld`, from column `col`, as 8 bytes; zeros past the edges. `vec`: cols is
// a multiple of 4 and the base 8-byte aligned.
__device__ __forceinline__ uint2 load4_bf16(const bf16* __restrict__ base, int row, int col,
                                            int rows, int cols, size_t ld, bool vec) {
  if (row >= rows || col >= cols) return make_uint2(0, 0);
  const bf16* src = base + (size_t)row * ld + col;
  if (vec) return *reinterpret_cast<const uint2*>(src);
  const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < cols) w[j >> 1] |= (uint32_t)h[j] << (16 * (j & 1));
  return make_uint2(w[0], w[1]);
}

// 4 f32 of row `row` of a (rows, cols) f32 matrix with leading dimension
// `ld`, from column `col`; zeros past the edges. `vec`: cols is a multiple
// of 4 and the base 16-byte aligned.
__device__ __forceinline__ float4 load4_f32(const float* __restrict__ base, int row, int col,
                                            int rows, int cols, size_t ld, bool vec) {
  if (row >= rows || col >= cols) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = base + (size_t)row * ld + col;
  if (vec) return *reinterpret_cast<const float4*>(src);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < cols) v[j] = src[j];
  return make_float4(v[0], v[1], v[2], v[3]);
}

// 8 f32 of row `row` of a (rows, cols) f32 matrix with leading dimension
// `ld`, from column `col`, rounded to bf16 (as 16 bytes); zeros past the
// edges. `vec`: cols is a multiple of 4 and the base 16-byte aligned.
__device__ __forceinline__ int4 load8_f32_bf16(const float* __restrict__ base, int row, int col,
                                               int rows, int cols, size_t ld, bool vec) {
  float v[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 f = load4_f32(base, row, col + 4 * h, rows, cols, ld, vec);
    v[4 * h] = f.x;
    v[4 * h + 1] = f.y;
    v[4 * h + 2] = f.z;
    v[4 * h + 3] = f.w;
  }
  return make_int4((int)pack_bf16(v[0], v[1]), (int)pack_bf16(v[2], v[3]),
                   (int)pack_bf16(v[4], v[5]), (int)pack_bf16(v[6], v[7]));
}

// The rows' split-TF32 parts of value v, as the products take them: hi[i]
// and, where lo is not null, lo[i].
__device__ __forceinline__ void tf_split_store(float v, float* hi, float* lo, size_t i) {
  const float h = tf32_hi(v);
  hi[i] = h;
  if (lo != nullptr) lo[i] = tf32_lo(v, h);
}

// Issue chunks [from, to) of `ch` into the ring, chunk i at ring position
// pos0 + i (a block that walks several tiles goes on round the ring): the
// weight tile (and an int4 tile's shift row) and the rows' tile.
// TMA loads are issued by one thread (ptid 0) and counted in bytes; an
// operand that TMA cannot load (a row that is not a multiple of 16 bytes, an
// unaligned base) is staged by all 128 producer threads with zero-filling
// 16-byte loads (a bf16 weight: 8-byte loads, half a swizzle chunk each; a
// row of any width: narrower loads where its place is not aligned) in the
// swizzled layout, after which they arrive. Position p
// goes to stage p % stages and first waits until the consumers have
// released position p - stages. The stage, its round and the chunk are
// counted as the loop goes (no division a chunk: the producer's time per
// chunk delays the consumers once the ring is full).
template <int kKind>
__device__ __forceinline__ void dg_produce(const DgRing& r, const CUtensorMap* w_map,
                                           const CUtensorMap* sh_map, const CUtensorMap* x_map,
                                           const DgWeight& wt, const DgRows& rows,
                                           const DgChunks& ch, int n0, int m0, int from, int to,
                                           int ptid, int pos0 = 0) {
  typedef DgOp<kKind> Op;
  const bool manual = !wt.tma || !rows.tma;
  if (!manual && ptid != 0) return;
  const uint32_t tx = (rows.tma ? r.x_bytes : 0) + (wt.tma ? Op::kWTx : 0);
  const int x_align = Op::kW8 ? 16 : (rows.f32 ? 4 : 8);   // values a 16-byte load
  // (The tile's first column n0 too: #12's expert column blocks start at
  // e * I.)
  const bool vec_w = kKind == kDgBW
                         ? wt.n % 4 == 0 && n0 % 4 == 0 &&
                               reinterpret_cast<uintptr_t>(wt.w) % 8 == 0
                         : (kKind == kDgTF ? wt.n % 4 == 0 && n0 % 4 == 0
                                           : wt.n % 16 == 0 && n0 % 16 == 0) &&
                               reinterpret_cast<uintptr_t>(wt.w) % 16 == 0;
  const bool vec_x = rows.k % x_align == 0 && reinterpret_cast<uintptr_t>(rows.x) % 16 == 0;
  const bool vec_tf = kKind == kDgTF && rows.k % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(rows.x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(rows.x_lo) % 16 == 0;
  int next = (pos0 + from) % r.stages, round = (pos0 + from) / r.stages;
  int tq = from / ch.per, tc = from % ch.per;   // chunk `from`: chunk tc of tile tq
  for (int i = from; i < to; ++i) {
    if (round > 0) mbar_wait(&r.empty[next], (round - 1) & 1);
    const int s = next;
    const int tile = ch.t0 + tq * ch.tstep;
    const int k0 = (tile * ch.per + tc) * Op::kKC;
    const int kw = k0 - tile * ch.wgap + wt.row0;   // the weight's K row
    if (++next == r.stages) {
      next = 0;
      ++round;
    }
    if (++tc == ch.per) {
      tc = 0;
      ++tq;
    }
    if (ptid == 0 && tx != 0) {
      mbar_arrive_tx(&r.full[s], tx);
      if (rows.tma) {
        if constexpr (kKind == kDgB3) {
#pragma unroll
          for (int p = 0; p < 3; ++p)
            tma_load_2d(r.x(s) + p * (r.x_bytes / 3), x_map, &r.full[s], k0,
                        m0 + p * rows.part_rows);
        } else {
          tma_load_2d(r.x(s), x_map, &r.full[s], k0, m0);
          if (kKind == kDgTF && rows.lo)   // the lo tile, by the second map (sh_map)
            tma_load_2d(r.x(s) + r.x_bytes / 2, sh_map, &r.full[s], k0, m0);
        }
      }
      if (wt.tma) {
        if constexpr (kKind == kDgI4) {
          tma_load_2d(r.w(s), w_map, &r.full[s], n0, kw / 2);
          tma_load_2d(r.w(s) + kDgKC / 2 * 128, sh_map, &r.full[s], n0, kw / kDgKC);
        } else if constexpr (kKind == kDgBW) {
          tma_load_2d(r.w(s), w_map, &r.full[s], n0, kw);
          tma_load_2d(r.w(s) + kDgBWBytes / 2, w_map, &r.full[s], n0 + 64, kw);
        } else if constexpr (kKind == kDgTF) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_2d(r.w(s) + j * kDgTFBlock, w_map, &r.full[s], n0 + 32 * j, kw);
        } else {
          tma_load_2d(r.w(s), w_map, &r.full[s], n0, kw);
        }
      }
    }
    if (!manual) continue;
    // 16-byte units u: row u / 8, chunk u % 8, at the chunk's swizzled place.
    // Each thread's loads of a tile are unrolled, so that they are in flight
    // together.
    if (!rows.tma && kKind == kDgTF) {
      // The f32 hi tile and, with lo, the lo tile x_bytes / 2 on: 16-byte
      // units of four values, zeros past the rows' edges.
      const int tile = rows.lo ? (int)r.x_bytes / 2 : (int)r.x_bytes, units = tile / 16;
#pragma unroll 4
      for (int u = ptid; u < units * (rows.lo ? 2 : 1); u += 128) {
        const int part = u >= units, v = u - part * units, row = v >> 3, c = v & 7;
        *reinterpret_cast<float4*>(r.x(s) + part * tile + row * 128 + ((c ^ (row & 7)) << 4)) =
            load4_f32(static_cast<const float*>(part ? rows.x_lo : rows.x), m0 + row, k0 + 4 * c,
                      rows.rows, rows.k, (size_t)rows.k, vec_tf);
      }
    } else if (!rows.tma) {
      unsigned char* dst = r.x(s);
#pragma unroll 4
      for (int u = ptid; u < (int)(r.x_bytes / 128) * 8; u += 128) {
        const int row = u >> 3, c = u & 7;
        int4 v;
        if constexpr (Op::kW8)
          v = load16(static_cast<const int8_t*>(rows.x), m0 + row, k0 + 16 * c, rows.rows,
                     rows.k, (size_t)rows.k, vec_x);
        else if (rows.f32)
          v = load8_f32_bf16(static_cast<const float*>(rows.x), m0 + row, k0 + 8 * c,
                             rows.rows, rows.k, (size_t)rows.k, vec_x);
        else
          v = load8_bf16(static_cast<const bf16*>(rows.x), m0 + row, k0 + 8 * c, rows.rows,
                         rows.k, (size_t)rows.k, vec_x);
        *reinterpret_cast<int4*>(dst + row * 128 + ((c ^ (row & 7)) << 4)) = v;
      }
    }
    if (!wt.tma) {
      unsigned char* dst = r.w(s);
      if constexpr (kKind == kDgBW) {
        // 8-byte units u: column block u / 1024, K row (u / 16) % 64, half
        // u % 2 of its 16-byte chunk (u / 2) % 8 (8 columns); 16 threads
        // read one 128-byte run of a weight row.
        const bf16* w16 = reinterpret_cast<const bf16*>(wt.w);
#pragma unroll
        for (int u = ptid; u < (int)(kDgBWBytes / 8); u += 128) {
          const int half = u & 1, c = (u >> 1) & 7, row = (u >> 4) & 63, blk = u >> 10;
          *reinterpret_cast<uint2*>(dst + blk * (kDgBWBytes / 2) + row * 128 +
                                    ((c ^ (row & 7)) << 4) + 8 * half) =
              load4_bf16(w16, kw + row, n0 + 64 * blk + 8 * c + 4 * half, wt.k, wt.n,
                         (size_t)wt.n, vec_w);
        }
      } else if constexpr (kKind == kDgTF) {
        // 16-byte units u: K row u / 32, columns 4 (u % 32) .. + 3, in column
        // block (u % 32) / 8; 32 threads read one 512-byte weight row.
        const float* w32 = reinterpret_cast<const float*>(wt.w);
#pragma unroll
        for (int u = ptid; u < (int)(kDgTFBytes / 16); u += 128) {
          const int row = u >> 5, cu = u & 31, q = cu & 7;
          *reinterpret_cast<float4*>(dst + (cu >> 3) * kDgTFBlock + row * 128 +
                                     ((q ^ (row & 7)) << 4)) =
              load4_f32(w32, kw + row, n0 + 4 * cu, wt.k, wt.n, (size_t)wt.n, vec_w);
        }
      } else {
#pragma unroll
        for (int u = ptid; u < Op::kKC * 8; u += 128) {
          const int row = u >> 3, c = u & 7;
          *reinterpret_cast<int4*>(dst + row * 128 + ((c ^ (row & 7)) << 4)) =
              load16(wt.w, kw + row, n0 + 16 * c, wt.k, wt.n, (size_t)wt.n, vec_w);
        }
      }
    }
    fence_proxy_async();
    mbar_arrive(&r.full[s]);
  }
}

// A consumer thread's place: warpgroup wg owns weight columns 64 wg ..
// 64 wg + 63 of the block's 128, warp w of it 16 w .. 16 w + 15, this lane
// columns col and col + 1 (col = 64 wg + 16 w + 2 (lane / 4)) and the
// rows 8 j + 2 (lane % 4) + {0, 1}: acc[4 j + e] is row 8 j + 2 (lane % 4) +
// (e & 1), column col + (e >> 1).
struct DgLane {
  int tid, wg, warp, lane, col;
  uint32_t frag_off, sel_even, sel_odd;
  __device__ __forceinline__ explicit DgLane(bool w8 = true) {
    tid = threadIdx.x;
    wg = tid / 128;
    warp = (tid / 32) % 4;
    lane = tid % 32;
    col = 64 * wg + 16 * warp + 2 * (lane >> 2);
    frag_off = w8 ? qm_frag_offset<true>(lane, 4 * wg + warp)
                  : qm_frag_offset<false>(lane, 4 * wg + warp);
    sel_even = (lane & 3) < 2 ? 0x6420u : 0x2064u;
    sel_odd = (lane & 3) < 2 ? 0x7531u : 0x3175u;
  }
  __device__ __forceinline__ int row(int i) const { return 8 * (i / 4) + 2 * (lane & 3) + (i & 1); }
  __device__ __forceinline__ int column(int i) const { return col + ((i & 3) >> 1); }
  // A bf16 weight's products (dg_mma_bw) keep wgmma's own row order: entry
  // i is column 64 wg + 16 warp + lane / 4 + 8 ((i % 4) / 2).
  __device__ __forceinline__ int bw_column(int i) const {
    return 64 * wg + 16 * warp + (lane >> 2) + 8 * ((i & 3) >> 1);
  }
};

// The A fragments of the chunk in stage s (int8; int4 with the lane's two
// columns' group shifts from the stage's shift row; bf16).
template <int kKind>
__device__ __forceinline__ void dg_frags(const DgRing& r, const DgLane& L, int s,
                                         uint32_t (&a)[4][4]) {
  const uint32_t w = smem_u32(r.w(s)) + L.frag_off;
  if constexpr (kKind == kDgI4) {
    const int8_t* sh = r.sh(s);
    i4_frags(w, L.sel_even, L.sel_odd, shift_exponent(sh[L.col]), shift_exponent(sh[L.col + 1]),
             a);
  } else {
    qm_frags<DgOp<kKind>::kW8>(w, L.sel_even, L.sel_odd, a);
  }
}

// Four wgmma (m64nBRk32 s8 or m64nBRk16 bf16) of one chunk against its B
// tile, as one commit group.
template <int kKind, int BR>
__device__ __forceinline__ void dg_mma(const unsigned char* b, const uint32_t (&a)[4][4],
                                       typename DgOp<kKind>::Acc (&acc)[BR / 2]) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    QmMma<DgOp<kKind>::kW8, BR>::run(acc, a[kk], sw128_desc(b + 32 * kk, 16, 1024), 1);
  wg_commit();
}

// Four wgmma (m64nBRk16 bf16) of one chunk of a bf16 weight: this
// warpgroup's 64 weight columns are column block `wg` of the stage's weight
// tile `w`, MN-major (k16 step kk: its K rows 16 kk .. 16 kk + 15), against
// the rows' K-major tile `b`; one commit group.
template <int BR>
__device__ __forceinline__ void dg_mma_bw(const unsigned char* w, const unsigned char* b, int wg,
                                          float (&acc)[BR / 2]) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    BwMma<BR>::run(acc,
                   sw128_desc(w + wg * (kDgBWBytes / 2) + kk * 16 * 128, kDgBWBytes / 2, 1024),
                   sw128_desc(b + 32 * kk, 16, 1024), 1);
  wg_commit();
}

// Consume ring positions [i0, i1) into acc (added to it). At up to 64 rows
// position i's stage is waited for and its A fragments built while position
// i - 1's products run: two fragment sets take turns, at most two commit
// groups are in flight, and a stage is released once its group has
// completed. Above 64 rows (128 or 256 accumulators a thread leave no room
// for a second fragment set) and with one stage, each chunk's products
// complete before the next chunk's fragments. The accumulators are not
// touched between a wgmma and its wait (that would serialise every wgmma),
// only fenced after the last.
template <int kKind, int BR>
__device__ __forceinline__ void dg_consume(const DgRing& r, const DgLane& L, int i0, int i1,
                                           typename DgOp<kKind>::Acc (&acc)[BR / 2]) {
  if (i0 >= i1) return;
  // The stage of the next position and its phase, counted as the loop goes
  // (a division a chunk would sit between one chunk's products and the
  // next's).
  int s = i0 % r.stages;
  uint32_t ph = (i0 / r.stages) & 1;
  auto next = [&]() {
    if (++s == r.stages) {
      s = 0;
      ph ^= 1;
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (L.lane == 0) mbar_arrive(&r.empty[st]);
  };
  if constexpr (kKind == kDgBW) {
    // No fragments to build: position i's products are issued while
    // position i - 1's run, whose stage is released once they complete.
    int prev = s;
    mbar_wait(&r.full[s], ph);
    dg_mma_bw<BR>(r.w(s), r.x(s), L.wg, acc);
    next();
    for (int i = i0 + 1; i < i1; ++i) {
      mbar_wait(&r.full[s], ph);
      dg_mma_bw<BR>(r.w(s), r.x(s), L.wg, acc);
      wg_wait<1>();
      release(prev);
      prev = s;
      next();
    }
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < BR / 2; ++j) acc_fence(acc[j]);
    release(prev);
    return;
  }
  uint32_t a0[4][4];
  if (BR > 64 || r.stages < 2) {
    for (int i = i0; i < i1; ++i) {
      mbar_wait(&r.full[s], ph);
      dg_frags<kKind>(r, L, s, a0);
      dg_mma<kKind, BR>(r.x(s), a0, acc);
      wg_wait<0>();
#pragma unroll
      for (int j = 0; j < BR / 2; ++j) acc_fence(acc[j]);
      release(s);
      next();
    }
    return;
  }
  if constexpr (BR <= 64) {
    uint32_t a1[4][4];
    int prev = s;
    mbar_wait(&r.full[s], ph);
    dg_frags<kKind>(r, L, s, a0);
    dg_mma<kKind, BR>(r.x(s), a0, acc);
    next();
    int i = i0 + 1;
    while (i < i1) {
      mbar_wait(&r.full[s], ph);
      dg_frags<kKind>(r, L, s, a1);
      dg_mma<kKind, BR>(r.x(s), a1, acc);
      wg_wait<1>();
      release(prev);
      prev = s;
      next();
      if (++i >= i1) break;
      mbar_wait(&r.full[s], ph);
      dg_frags<kKind>(r, L, s, a0);
      dg_mma<kKind, BR>(r.x(s), a0, acc);
      wg_wait<1>();
      release(prev);
      prev = s;
      next();
      ++i;
    }
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < BR / 2; ++j) acc_fence(acc[j]);
    release(prev);
  }
}

// ---- split TF32 (kDgTF) --------------------------------------------------
//
// The weight's 64 columns of a warpgroup are wgmma's M rows in the int8
// kinds' order: M row 16 w + g + 8 h of warp w is weight column 16 w + 2 g +
// h, so a lane's A fragment of a k8 step (rows g, g + 8; K l % 4 and
// l % 4 + 4) is two 8-byte loads of adjacent columns, and its accumulators
// are DgLane::column's columns. The rows' K runs in order (TMA's layout), so
// no slot permutation is needed.

// The byte offset, in a stage's f32 weight tile, of this lane's two columns
// at K row l % 4 + 4 half of the chunk's first k8 step (a step is 1024
// bytes on: 8 rows of 128, whose swizzle phase repeats).
__device__ __forceinline__ uint32_t tf_frag_offset(const DgLane& L, int half) {
  const int k = (L.lane & 3) + 4 * half, c = L.col & 31;
  return (L.col >> 5) * kDgTFBlock + k * 128 + (((c >> 2) ^ k) << 4) + (c & 3) * 4;
}

// The A fragments of the chunk in weight tile w: step kk's hi parts
// f[kk][0] and lo parts f[kk][1] (registers: K l % 4 of columns c, c + 1,
// then K l % 4 + 4 of the same).
__device__ __forceinline__ void tf_frags(const unsigned char* w, uint32_t off0, uint32_t off1,
                                         uint32_t (&f)[4][2][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float2 a = *reinterpret_cast<const float2*>(w + off0 + kk * 1024);
    const float2 b = *reinterpret_cast<const float2*>(w + off1 + kk * 1024);
    const float v[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = tf32_hi(v[i]);
      f[kk][0][i] = __float_as_uint(h);
      f[kk][1][i] = __float_as_uint(tf32_lo(v[i], h));
    }
  }
}

// The chunk's products into a fresh accumulator t: for each k8 step, the
// weight's hi and lo parts against the rows' hi tile `b` and, with kLo,
// the weight's hi parts against the rows' lo tile (BR * 128 bytes on); one
// commit group.
template <int BR, bool kLo>
__device__ __forceinline__ void tf_mma(const unsigned char* b, const uint32_t (&f)[4][2][4],
                                       float (&t)[BR / 2]) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = sw128_desc(b + 32 * kk, 16, 1024);
    WgmmaTf32<BR>::rs(t, f[kk][0], bh, kk > 0 ? 1 : 0);
    WgmmaTf32<BR>::rs(t, f[kk][1], bh, 1);
    if constexpr (kLo)
      WgmmaTf32<BR>::rs(t, f[kk][0], sw128_desc(b + BR * 128 + 32 * kk, 16, 1024), 1);
  }
  wg_commit();
}

// Consume ring positions [i0, i1) of split-TF32 chunks into acc (added to
// it, chunk by chunk in order, with f32 adds that round to nearest). Two
// fragment sets and two chunk accumulators take turns: position i's
// fragments are built and its products issued while position i - 1's run;
// once those complete, their sum is added and their stage released.
template <int BR, bool kLo>
__device__ __forceinline__ void dg_consume_tf(const DgRing& r, const DgLane& L, int i0, int i1,
                                              float (&acc)[BR / 2]) {
  if (i0 >= i1) return;
  int s = i0 % r.stages;
  uint32_t ph = (i0 / r.stages) & 1;
  auto next = [&]() {
    if (++s == r.stages) {
      s = 0;
      ph ^= 1;
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (L.lane == 0) mbar_arrive(&r.empty[st]);
  };
  auto add = [&](float (&t)[BR / 2]) {
#pragma unroll
    for (int j = 0; j < BR / 2; ++j) {
      acc_fence(t[j]);
      acc[j] = __fadd_rn(acc[j], t[j]);
    }
  };
  const uint32_t off0 = tf_frag_offset(L, 0), off1 = tf_frag_offset(L, 1);
  uint32_t f0[4][2][4], f1[4][2][4];
  float t0[BR / 2], t1[BR / 2];
  int prev = s;
  mbar_wait(&r.full[s], ph);
  tf_frags(r.w(s), off0, off1, f0);
  tf_mma<BR, kLo>(r.x(s), f0, t0);
  next();
  for (int i = i0 + 1; i < i1; i += 2) {
    mbar_wait(&r.full[s], ph);
    tf_frags(r.w(s), off0, off1, f1);
    tf_mma<BR, kLo>(r.x(s), f1, t1);
    wg_wait<1>();
    add(t0);
    release(prev);
    prev = s;
    next();
    if (i + 1 >= i1) {
      wg_wait<0>();
      add(t1);
      release(prev);
      return;
    }
    mbar_wait(&r.full[s], ph);
    tf_frags(r.w(s), off0, off1, f0);
    tf_mma<BR, kLo>(r.x(s), f0, t0);
    wg_wait<1>();
    add(t1);
    release(prev);
    prev = s;
    next();
  }
  wg_wait<0>();
  add(t0);
  release(prev);
}

// ---- f32 rows in three bf16 parts (kDgB3) ----------------------------------
//
// The stage holds the rows' hi, mid and lo tiles (BR * 128 bytes each, in
// that order) and the int8 weight tile, whose A fragments are kDgBf16's:
// the levels as exact bf16. Each product of a part is exact in f32.

// The chunk's products into a fresh accumulator t: the lo part's four k16
// steps, then the mid part's, then the hi part's (the small terms summed
// first), against the same fragments; one commit group.
template <int BR>
__device__ __forceinline__ void b3_mma(const unsigned char* b, const uint32_t (&a)[4][4],
                                       float (&t)[BR / 2]) {
  wg_fence();
#pragma unroll
  for (int p = 2; p >= 0; --p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      QmMma<false, BR>::run(t, a[kk], sw128_desc(b + p * BR * 128 + 32 * kk, 16, 1024),
                            p < 2 || kk > 0 ? 1 : 0);
  wg_commit();
}

// Consume ring positions [i0, i1) of three-part chunks into acc (added to
// it, chunk by chunk in order, with f32 adds that round to nearest). At up
// to 64 rows two fragment sets and two chunk accumulators take turns, as in
// dg_consume_tf: position i's fragments are built and its products issued
// while position i - 1's run. At 128 rows (64 accumulators a thread, and as
// many again for the chunk's) each chunk's products complete before the
// next chunk's fragments.
template <int BR>
__device__ __forceinline__ void dg_consume_b3(const DgRing& r, const DgLane& L, int i0, int i1,
                                              float (&acc)[BR / 2]) {
  if (i0 >= i1) return;
  int s = i0 % r.stages;
  uint32_t ph = (i0 / r.stages) & 1;
  auto next = [&]() {
    if (++s == r.stages) {
      s = 0;
      ph ^= 1;
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (L.lane == 0) mbar_arrive(&r.empty[st]);
  };
  auto add = [&](float (&t)[BR / 2]) {
#pragma unroll
    for (int j = 0; j < BR / 2; ++j) {
      acc_fence(t[j]);
      acc[j] = __fadd_rn(acc[j], t[j]);
    }
  };
  uint32_t a0[4][4];
  float t0[BR / 2];
  if constexpr (BR > 64) {
    for (int i = i0; i < i1; ++i) {
      mbar_wait(&r.full[s], ph);
      dg_frags<kDgB3>(r, L, s, a0);
      b3_mma<BR>(r.x(s), a0, t0);
      wg_wait<0>();
      add(t0);
      release(s);
      next();
    }
  } else {
    uint32_t a1[4][4];
    float t1[BR / 2];
    int prev = s;
    mbar_wait(&r.full[s], ph);
    dg_frags<kDgB3>(r, L, s, a0);
    b3_mma<BR>(r.x(s), a0, t0);
    next();
    for (int i = i0 + 1; i < i1; i += 2) {
      mbar_wait(&r.full[s], ph);
      dg_frags<kDgB3>(r, L, s, a1);
      b3_mma<BR>(r.x(s), a1, t1);
      wg_wait<1>();
      add(t0);
      release(prev);
      prev = s;
      next();
      if (i + 1 >= i1) {
        wg_wait<0>();
        add(t1);
        release(prev);
        return;
      }
      mbar_wait(&r.full[s], ph);
      dg_frags<kDgB3>(r, L, s, a0);
      b3_mma<BR>(r.x(s), a0, t0);
      wg_wait<1>();
      add(t1);
      release(prev);
      prev = s;
      next();
    }
    wg_wait<0>();
    add(t0);
    release(prev);
  }
}

// The K split's exchange over a cluster of `split` blocks: accumulator
// column block j (entries 4 j .. 4 j + 3, rows 8 j .. 8 j + 7) is owned by
// block j % split, in its slot j / split. Each block pushes its values of
// every column block to the owner's shared memory (remote stores, which do
// not wait), in the owner's slots for the pushing rank; after a cluster
// barrier the owner reads them locally. dg_part_bytes is the slots' size.
// Owners and slots are counted as the unrolled loops go, and ownership is a
// bit mask (dg_owned_mask), so that no division by the runtime split is
// made for each column block.
__host__ __device__ constexpr uint32_t dg_part_bytes(int br, int split) {
  return split > 1 ? (uint32_t)split * ((br / 8 + split - 1) / split) * 4 * kDgConsumerThreads * 4
                   : 0u;
}

// Entry e of slot `slot` that rank `from` fills in its owner's slots.
template <typename T>
__device__ __forceinline__ T* dg_slot(T* part, const DgLane& L, int from, int owned, int slot,
                                      int e) {
  return part + ((from * owned + slot) * 4 + e) * kDgConsumerThreads + L.tid;
}

// The column blocks j < blocks that block `rank` owns (j % split == rank),
// as bits; all of them when split is 1.
__device__ __forceinline__ uint32_t dg_owned_mask(int rank, int split, int blocks) {
  uint32_t m = 0;
  for (int j = rank; j < blocks; j += split) m |= 1u << j;
  return m;
}

template <int BR, typename T>
__device__ __forceinline__ void dg_push(const T (&v)[BR / 2], T* part, const DgLane& L, int rank,
                                        int split, cg::cluster_group& cluster) {
  const int owned = (BR / 8 + split - 1) / split;
  int owner = 0, slot = 0;
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *cluster.map_shared_rank(dg_slot(part, L, rank, owned, slot, e), owner) = v[4 * j + e];
    if (++owner == split) {
      owner = 0;
      ++slot;
    }
  }
}

// Add, for every column block this block owns (`mine`, dg_owned_mask), the
// first `count` ranks' pushed values in rank order to acc (from acc's own
// value).
template <int BR, typename T>
__device__ __forceinline__ void dg_add_slots(T (&acc)[BR / 2], T* part, const DgLane& L,
                                             uint32_t mine, int split, int count) {
  const int owned = (BR / 8 + split - 1) / split;
  int slot = 0;
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (!((mine >> j) & 1)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      for (int q = 0; q < count; ++q) acc[4 * j + e] += *dg_slot(part, L, q, owned, slot, e);
    ++slot;
  }
}

// The K split's sum: after the push and a cluster barrier, the owner adds
// the blocks' sums (in rank order, from 0) into acc, for its column blocks
// `mine` (dg_owned_mask); the caller's epilogue reads only those. The
// producer warpgroup takes part in the barrier. A block that goes on to
// another tile waits at a second cluster barrier before its next push.
template <int BR, typename T>
__device__ __forceinline__ void dg_split_sum(T (&acc)[BR / 2], T* part, const DgLane& L,
                                             int rank, int split, uint32_t mine,
                                             cg::cluster_group& cluster) {
  dg_push<BR>(acc, part, L, rank, split, cluster);
  cluster.sync();
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
  dg_add_slots<BR>(acc, part, L, mine, split, split);
}

// The two halves of a cluster barrier (cluster.sync() is both): every
// thread of the cluster's blocks arrives, with release semantics, and later
// waits, with acquire semantics, for all to have arrived; arrivals and waits
// alternate in each thread, and work between the two overlaps the
// barrier's latency.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The sliced exchange of a K split over a cluster of `split` blocks
// (quant_ffn.cuh's GEMM2, and the bf16 FFN's and bf16 mixer step's
// products): a consumer thread's four sums of an accumulator column block j
// (pair p = 256 j + thread) are owned by rank p * split / P
// of the P = 256 BR / 8 pairs, so that each rank owns a run of about P /
// split pairs (threads of one or two column blocks, or all of one). A
// thread pushes the four sums of each of its column blocks with a row below
// S as one 16-byte remote store into the owner's slot set, at [pushing
// rank][the pair's place in the owner's run], and the owner's thread adds
// them. A slot set (one tile's sums) takes split x ceil(P / split) x 16
// bytes: about BR x 512 at any split, so that a round can hold several
// tiles, and every owner's adds are spread over its run's threads.
__host__ __device__ constexpr uint32_t xset_bytes(int br, int split) {
  return split > 1 ? (uint32_t)split * ((br / 8 * kDgConsumerThreads + split - 1) / split) * 16
                   : 0u;
}

// The owner of pair p (of P) and its place in the owner's run.
__device__ __forceinline__ int xowner(int p, int pairs, int split, int& local) {
  const int owner = p * split / pairs;
  local = p - (owner * pairs + split - 1) / split;
  return owner;
}

// Push this thread's sums of its first `blocks` column blocks (those with a
// row below S), of tile set `set`, from rank `rank` to their owners.
template <int BR>
__device__ __forceinline__ void xpush(const float (&v)[BR / 2], float* set, int tid, int rank,
                                      int split, int blocks, cg::cluster_group& cluster) {
  constexpr int kPairs = BR / 8 * kDgConsumerThreads;
  const int run = (kPairs + split - 1) / split;
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (j >= blocks) break;
    int local;
    const int owner = xowner(j * kDgConsumerThreads + tid, kPairs, split, local);
    *cluster.map_shared_rank(reinterpret_cast<float4*>(set) + rank * run + local, owner) =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// Add, for each of this thread's column blocks that rank `rank` owns, the
// round's pushed sums in tile order to acc: rank q's slot set for its group
// tile g (set g of `group`, `set_floats` apart) for q = 0, 1, ..., and
// inside each rank g = 0, 1, ..., where the tile t0 + q * group + g exists
// (below `tiles`) and is live: a MoE tile of an expert that no row routes
// to (live[t / tile_experts] 0; `live` null: all are live) was not pushed,
// and its terms, all ±0, would not move a sum that starts from +0.
template <int BR>
__device__ __forceinline__ void add_round(float (&acc)[BR / 2], const float* part,
                                          uint32_t set_floats, int tid, int rank, int split,
                                          int blocks, int group, int t0, int tiles,
                                          const unsigned char* live = nullptr,
                                          int tile_experts = 1) {
  constexpr int kPairs = BR / 8 * kDgConsumerThreads;
  const int run = (kPairs + split - 1) / split;
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (j >= blocks) break;
    int local;
    if (xowner(j * kDgConsumerThreads + tid, kPairs, split, local) != rank) continue;
    float4 s = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    for (int q = 0, t = t0; q < split && t < tiles; ++q) {
      for (int g = 0; g < group && t < tiles; ++g, ++t) {
        if (live != nullptr && live[t / tile_experts] == 0) continue;
        const float4 v = reinterpret_cast<const float4*>(part + g * set_floats)[q * run + local];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    acc[4 * j] = s.x;
    acc[4 * j + 1] = s.y;
    acc[4 * j + 2] = s.z;
    acc[4 * j + 3] = s.w;
  }
}

// Whether rank `rank` owns this thread's column block j of a K split over
// `split` blocks (all of them without a split).
template <int BR>
__device__ __forceinline__ bool xowns(int j, int tid, int rank, int split) {
  int local;
  return xowner(j * kDgConsumerThreads + tid, BR / 8 * kDgConsumerThreads, split, local) == rank;
}

// Shared memory of a ring kernel, as ops/kernels/decode_plan.py computes
// it: the 1024-byte alignment slack, the ring, the split's slots
// (dg_part_bytes), `extra` bytes of the kernel's own and two mbarriers a
// stage.
inline size_t dg_smem_bytes(int br, int stages, uint32_t stage_bytes, int split, size_t extra) {
  return 1024 + (size_t)stages * stage_bytes + dg_part_bytes(br, split) + extra +
         16 * (size_t)stages;
}

// Allow `kernel` `smem` bytes of dynamic shared memory (and, with
// `nonportable`, clusters above 8 blocks) on the current device, calling the
// runtime only where a kernel needs more than it was allowed: a decode step
// launches its kernels every layer, and each runtime call costs host time.
// What was allowed is only ever raised.
template <typename Kern>
cudaError_t dg_allow(Kern kernel, size_t smem, bool nonportable) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, std::pair<size_t, bool>> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = allowed.find(key);
  if (it != allowed.end()) {
    if (it->second.first >= smem && (it->second.second || !nonportable)) return cudaSuccess;
    smem = std::max(smem, it->second.first);
    nonportable = nonportable || it->second.second;
  }
  err = allow_smem(kernel, smem);
  if (err == cudaSuccess && nonportable)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) allowed[key] = std::make_pair(smem, nonportable);
  return err;
}

// hopper.cuh::make_map_2d through a cache keyed by all the map is made of,
// so that a cached map is the one an encode would give: a decode step makes
// the same maps (the same weights, the same scratch) every layer, and each
// encode costs host time. Emptied when it holds 4096 maps.
inline int dg_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                     int elem_bytes, uint64_t inner, uint64_t outer, uint32_t box_inner,
                     uint32_t box_outer, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  typedef std::tuple<const void*, int, int, uint64_t, uint64_t, uint32_t, uint32_t, int> Key;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> maps;
  const Key key(base, static_cast<int>(type), elem_bytes, inner, outer, box_inner, box_outer,
                static_cast<int>(swizzle));
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return 0;
  }
  const int err =
      make_map_2d(map, base, type, elem_bytes, inner, outer, box_inner, box_outer, swizzle);
  if (err == 0) {
    if (maps.size() >= 4096) maps.clear();
    maps.emplace(key, *map);
  }
  return err;
}

// A tensor map over a row-major (outer, inner) matrix of `elem`-byte values
// (1 int8, 2 bf16, 4 f32) in boxes of box rows x 128 bytes (dg_map_2d's
// cache), or none (*tma 0) for the producer's own loads where the row is
// not a multiple of 16 bytes or the base not 16-byte aligned.
inline int dg_map_or_own(CUtensorMap* map, const void* base, int elem, int outer, int inner,
                         int box, int* tma) {
  memset(map, 0, sizeof(*map));
  *tma = (size_t)inner * elem % 16 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
  if (!*tma) return 0;
  const CUtensorMapDataType type = elem == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return dg_map_2d(map, base, type, elem, inner, outer, 128 / elem, box);
}

// Launch `kernel` on `grid` blocks of `block` threads in clusters of
// `cluster` blocks along x (none when 1; more than 8 with the non-portable
// size allowed); returns the launch's error (the caller reads
// cudaGetLastError once, after its last launch).
template <typename Kern, typename... Args>
int dg_launch(Kern kernel, dim3 grid, dim3 block, int cluster, size_t smem, cudaStream_t stream,
              Args... args) {
  if (smem > kDgSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dg_allow(kernel, smem, cluster > 8);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

}  // namespace
