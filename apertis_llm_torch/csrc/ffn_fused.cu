// ffn_decode: the dense FFN at decode, out = act(x @ W1 + b1) @ W2 + b2.
//
// Replaces: apertis_llm_tpu/ops/pallas/ffn_fused.py::ffn_decode_fused with
// the bf16 weight layout (apertis_ffn_decode), the int8 layout
// (apertis_ffn_decode_int8) and the int4 layout (apertis_ffn_decode_int4),
// the last two, Hopper tensor-core products, at the end of this file.
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
// is to read each weight once per call and keep enough loads in flight.
//
// Design: pass 1 runs one block of 8 warps per (128-column slice of I,
// part of the output columns, tile of up to 64 rows). It computes the hidden
// slice act(x @ W1[:, slice] + b1) with bf16 tensor-core tiles (WMMA
// 16x16x16, f32 accumulators), staging x through shared memory in 128-wide
// K chunks with the ragged rows zero-filled; warp w owns hidden column tile
// w for every row tile, so each W1 tile is loaded once per block, eight at
// a time. The hidden slice stays in shared memory (rounded to bf16) and is
// multiplied by W2[slice, part] the same way, warp w owning output column
// tile w of each 128-column chunk. With up to 64 rows in one block every
// weight is read from device memory once per call (twice from L2 for W1
// when the output is split into parts to fill the card).
//
// The TPU kernel summed the I tiles along a sequential grid; blocks here run
// in parallel, so their outputs must be added across blocks. Eight slices
// form a group, and a group is one thread-block cluster: each block stores
// its f32 tile of an output chunk in its own shared memory, and after a
// cluster barrier block r adds the r-th eighth of the tile over the eight
// blocks (distributed shared memory, in rank order, four floats at a time)
// and writes it to the group's f32 partial (groups, S, D) in device memory.
// Two tile buffers alternate, so one barrier per chunk suffices. Pass 2 adds the
// ceil(I / 1024) group partials in a fixed order plus b2. There are no float
// atomics, so results are the same from run to run, and the scratch is an
// eighth of one partial per slice: 10 x 64 x 2432 x 4 B = 6.2 MB at 64 rows
// of the 1.5B model.

#include <cooperative_groups.h>
#include <mma.h>
#include <string.h>

#include "common.cuh"
#include "decode_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;

constexpr int kSlice = 128;          // I columns per block (8 warps x 16)
constexpr int kChunk = 128;          // K chunk of x staged in shared memory
constexpr int kTileRows = 64;        // rows per block (4 row tiles of 16)
constexpr int kLdx = kChunk + 8;     // bf16 row stride of the staged x chunk
constexpr int kLdh = kSlice + 8;     // bf16 row stride of the hidden slice
constexpr int kLdf = kSlice + 4;     // f32 row stride of the hidden accumulator
constexpr int kSteps = kChunk / 16;  // 16-deep steps per chunk (== kSlice / 16)
constexpr int kCluster = 8;         // I slices per group: one thread-block cluster

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// x chunk, hidden accumulator (then output tile), hidden slice, second output
// tile: 100 KB, so two blocks fit on an SM.
constexpr size_t kSmemBytes = (size_t)kTileRows * kLdx * sizeof(bf16) +
                              (size_t)kTileRows * kLdf * sizeof(float) +
                              (size_t)kTileRows * kLdh * sizeof(bf16) +
                              (size_t)kTileRows * kLdf * sizeof(float);

// Two blocks per SM (at most 128 registers a thread): with one, the grid of
// the 1.5B model's 64-row step needs two waves.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kBlock, 2)
ffn_partial_kernel(
    const bf16* __restrict__ x,    // (S, D)
    const bf16* __restrict__ w1,   // (D, I)
    const bf16* __restrict__ b1,   // (I,)
    const bf16* __restrict__ w2,   // (I, D)
    float* __restrict__ partial,   // (groups, S, D)
    int rows, int d_model, int inter, int chunks_per_part, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);            // kTileRows * kLdx
  float* hf = reinterpret_cast<float*>(xs + kTileRows * kLdx);  // kTileRows * kLdf
  bf16* hb = reinterpret_cast<bf16*>(hf + kTileRows * kLdf);    // kTileRows * kLdh
  float* of = reinterpret_cast<float*>(hb + kTileRows * kLdh);  // kTileRows * kLdf
  const int warp = threadIdx.x >> 5;
  const int slice = blockIdx.x;          // the grid pads the slices to whole groups
  const int i0 = slice * kSlice;
  const int row0 = blockIdx.z * kTileRows;
  const int live_rows = min(kTileRows, rows - row0);
  const int row_tiles = (live_rows + 15) / 16;              // tiles with a real row
  const int icols = max(0, min(kSlice, inter - i0));        // multiple of 16; 0 = pad
  const bf16 zero = __float2bfloat16(0.f);

  // ---- hidden slice: x @ W1[:, i0 + 16 * warp ...] ----
  FragC acc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[t], 0.f);
  const bool has_col = warp * 16 < icols;
  const int k_end = icols > 0 ? d_model : 0;   // a padding slice skips the product
  for (int k0 = 0; k0 < k_end; k0 += kChunk) {
    const int kw = min(kChunk, d_model - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = threadIdx.x; i < kTileRows * kChunk; i += kBlock) {
      const int r = i / kChunk;
      const int k = i - r * kChunk;
      xs[r * kLdx + k] = (r < live_rows && k < kw)
                             ? x[(size_t)(row0 + r) * d_model + k0 + k] : zero;
    }
    __syncthreads();
    if (!has_col) continue;
    FragB b[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      if (s * 16 < kw)
        wmma::load_matrix_sync(b[s], w1 + (size_t)(k0 + s * 16) * inter + i0 + warp * 16,
                               inter);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (s * 16 >= kw) break;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t >= row_tiles) break;
        FragA a;
        wmma::load_matrix_sync(a, xs + t * 16 * kLdx + s * 16, kLdx);
        wmma::mma_sync(acc[t], a, b[s], acc[t]);
      }
    }
  }
  if (has_col) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < row_tiles)
        wmma::store_matrix_sync(hf + t * 16 * kLdf + warp * 16, acc[t], kLdf,
                                wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileRows * kSlice; i += kBlock) {
    const int r = i / kSlice;
    const int j = i - r * kSlice;
    const float v = (r < row_tiles * 16 && j < icols)
                        ? activate(hf[r * kLdf + j] + to_f32(b1[i0 + j]), act) : 0.f;
    hb[r * kLdh + j] = __float2bfloat16(v);
  }
  __syncthreads();

  // ---- hidden slice @ W2[slice, this part's columns], summed over the group ----
  // hf is free again. It and `of` take turns holding this block's f32 tile
  // of one output chunk, which the cluster's blocks read after the barrier.
  float* tile = hf;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* group_out = partial + ((size_t)(slice / kCluster) * rows + row0) * d_model;
  const int steps = icols / 16;
  const int chunks = (d_model + kSlice - 1) / kSlice;
  const int part = blockIdx.y;
  const int c_end = min(chunks, (part + 1) * chunks_per_part);
  for (int cc = part * chunks_per_part; cc < c_end; ++cc) {  // same count in the cluster
    const int col = cc * kSlice + warp * 16;
    if (col < d_model) {  // D is a multiple of 16: the warp's 16 columns are real
      FragB b[kSteps];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        if (s < steps)
          wmma::load_matrix_sync(b[s], w2 + (size_t)(i0 + s * 16) * d_model + col, d_model);
      FragC o[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) wmma::fill_fragment(o[t], 0.f);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (s >= steps) break;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t >= row_tiles) break;
          FragA a;
          wmma::load_matrix_sync(a, hb + t * 16 * kLdh + s * 16, kLdh);
          wmma::mma_sync(o[t], a, b[s], o[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (t < row_tiles)
          wmma::store_matrix_sync(tile + t * 16 * kLdf + warp * 16, o[t], kLdf,
                                  wmma::mem_row_major);
    }
    // Every block's tile of this chunk is in its shared memory, and every
    // block has read the tiles of the chunk before, so the buffer this
    // block fills next (that of two chunks back) is free.
    cluster.sync();
    const int ccols = min(kSlice, d_model - cc * kSlice);  // multiple of 16
    for (int i = rank * kBlock + threadIdx.x; i < live_rows * (kSlice / 4);
         i += kCluster * kBlock) {
      const int r = i / (kSlice / 4);
      const int j = (i - r * (kSlice / 4)) * 4;
      if (j >= ccols) continue;
      float4* mine = reinterpret_cast<float4*>(tile + r * kLdf + j);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < kCluster; ++q) {
        const float4 v = *cluster.map_shared_rank(mine, q);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<float4*>(group_out + (size_t)r * d_model + cc * kSlice + j) = s;
    }
    tile = tile == hf ? of : hf;
  }
  cluster.sync();  // no block exits while another still reads its tiles
}

__global__ void __launch_bounds__(kBlock) ffn_reduce_kernel(
    const float* __restrict__ partial,  // (groups, S, D)
    const bf16* __restrict__ b2,        // (D,)
    bf16* __restrict__ out,             // (S, D)
    int groups, int rows, int d_model) {
  const size_t n = (size_t)rows * d_model;
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += partial[(size_t)g * n + i];
  out[i] = __float2bfloat16(s + to_f32(b2[i % d_model]));
}

}  // namespace

// Whole FFN for S rows. D and I must be multiples of 16 and the weight
// pointers 32-byte aligned (WMMA tile loads). `partial` is caller-allocated
// f32 scratch of ceil(I / 1024) * S * D floats (one partial per group of
// eight 128-wide slices of I); the output columns are split into parts of
// `chunks_per_part` 128-column chunks. act: 1 relu, 2 silu, else exact GELU.
// Returns cudaGetLastError().
extern "C" int apertis_ffn_decode(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out,
                                  void* partial, int rows, int d_model, int inter,
                                  int chunks_per_part, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_model % 16 != 0 || inter % 16 != 0 || chunks_per_part < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (inter + kCluster * kSlice - 1) / (kCluster * kSlice);
  const int chunks = (d_model + kSlice - 1) / kSlice;
  const int parts = (chunks + chunks_per_part - 1) / chunks_per_part;
  const int row_tiles = (rows + kTileRows - 1) / kTileRows;
  cudaError_t err = allow_smem(ffn_partial_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_partial_kernel<<<dim3(groups * kCluster, parts, row_tiles), kBlock, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<float*>(partial), rows, d_model, inter, chunks_per_part, act);
  const size_t n = (size_t)rows * d_model;
  ffn_reduce_kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), groups, rows, d_model);
  return static_cast<int>(cudaGetLastError());
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
// Design (decode_gemm.cuh): two launches of swapped-operand int8 wgmma
// products that read each weight from device memory once per row tile (16
// rows up to 16, else 64), the weight tiles and the rows loaded by TMA into
// a ring that a producer warpgroup keeps full:
//   1. ffn_up_kernel: one block per 128 hidden columns and row tile, the
//      whole K = D, x_q streamed beside each W1 tile. Epilogue in registers:
//      dequantization, bias and activation, then each row's absmax over the
//      lane's two columns, the warp (shuffles), the block (shared memory)
//      and the bn / 128 blocks of the hidden tile, which form one
//      thread-block cluster (distributed shared memory; a max is exact in
//      any order). It writes hq (S, I) int8 and hs (S, I / bn) f32, 0.6 MB at
//      64 rows of the 1.5B model, which stay in L2.
//   2. ffn_down_kernel: one block per 128 output columns, row tile and part
//      r of a K split over a cluster of `split` blocks, which takes the
//      hidden tiles t = r, r + split, ...: a fresh int32 accumulator per tile
//      over its bn / 128 chunks (hq streamed beside W2), then p_t =
//      float(acc_t) * hs_t. In round rho the cluster holds the tiles
//      rho * split .. rho * split + split - 1; after a cluster barrier block
//      r adds, for the accumulator rows it owns, the blocks' p_t in rank
//      order, which is tile order, to its running f32 sum, so every f32 add
//      is the plain version's, in its order. The epilogue applies w2_s and
//      b2. The producer issues, before each round's barriers, only the
//      chunks whose stage the consumers free before them.
// No float atomics: a repeated call gives the same bits. The host's plan
// (ops/kernels/decode_plan.py::ffn_plan) gives the row tile, the split and
// the ring's stages.

namespace {

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
// maxima, the block's, and every cluster block's pushed to this one.
constexpr size_t ffn_up_extra(int br) {
  return (size_t)(kConsumers * 4 + 1 + kMaxUpCluster) * br * 4;
}

template <bool kI4, int BR>
__global__ void __launch_bounds__(kThreads, 1) ffn_up_kernel(
    const __grid_constant__ CUtensorMap x_map,   // x_q (S, D): boxes of BR rows x 128
    const __grid_constant__ CUtensorMap w_map,   // W1 (D, I); int4: packed (D / 2, I)
    const __grid_constant__ CUtensorMap sh_map,  // int4: shifts (D / 128, I)
    const float* __restrict__ xs,    // (S, 1)
    const float* __restrict__ w1s,   // (1, I)
    const bf16* __restrict__ b1,     // (I,)
    int8_t* __restrict__ hq,         // (S, I)
    float* __restrict__ hs,          // (S, I / bn)
    int rows, int d_model, int inter, int bn, int act, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t stage_bytes = BR * 128 + w_tile_bytes<kI4>();
  float* wmax = reinterpret_cast<float*>(smem + (size_t)stages * stage_bytes);  // [8][BR]
  float* cmax = wmax + kConsumers * 4 * BR;                                    // [BR]
  float* allmax = cmax + BR;                                        // [kMaxUpCluster][BR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(allmax + kMaxUpCluster * BR);
  const DgRing ring{smem, bars, bars + stages, BR * 128, w_tile_bytes<kI4>(), stages};
  const int cs = bn / kDgCols;   // the blocks of one hidden tile: one cluster
  const int n0 = blockIdx.x * kDgCols;
  const int m0 = blockIdx.y * BR;
  const int chunks = (d_model + kDgKC - 1) / kDgKC;
  const DgChunks ch{0, 1, chunks, 1};
  dg_init(ring, 1);
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const DgWeight wt{nullptr, d_model, inter, 1};
    const DgRows xrows{nullptr, rows, d_model, 1};
    dg_produce<kFfnKind<kI4>>(ring, &w_map, &sh_map, &x_map, wt, xrows, ch, n0, m0, 0, chunks,
                              threadIdx.x - kDgConsumerThreads);
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

  // h = act(acc * x_s * w1_s + b1) for columns c0, c0 + 1 (I is a multiple
  // of 128), and each row's absmax: row slot 2 j + e is row 8 j + 2 (lane %
  // 4) + e.
  const int c0 = n0 + L.col;
  const float ws[2] = {w1s[c0], w1s[c0 + 1]};
  const float bb[2] = {to_f32(b1[c0]), to_f32(b1[c0 + 1])};
  float h[BR / 2], m[BR / 4];
#pragma unroll
  for (int i = 0; i < BR / 4; ++i) m[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) {
    const int row = m0 + L.row(i);
    const float x_s = row < rows ? xs[row] : 0.f;
    const int e = (i & 3) >> 1;
    h[i] = activate(
        __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[i]), x_s), ws[e]), bb[e]), act);
    const int slot = 2 * (i / 4) + (i & 1);
    m[slot] = fmaxf(m[slot], fabsf(h[i]));
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
    sc[i] = fmaxf(cmax[8 * (i / 2) + 2 * (L.lane & 3) + (i & 1)], 1e-8f) * (1.f / 127.f);

  // hq = rint(h / hs), a true division; hs by the tile's first block.
  const int tiles = inter / bn;
  const bool first = n0 % bn == 0;
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * (L.lane & 3) + e;
      if (row >= rows) continue;
      const float s = sc[2 * j + e];
      const int q0 = quant_level(__fdiv_rn(h[4 * j + e], s));
      const int q1 = quant_level(__fdiv_rn(h[4 * j + e + 2], s));
      *reinterpret_cast<uint16_t*>(hq + (size_t)row * inter + c0) =
          (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      if (first && L.col == 0) hs[(size_t)row * tiles + n0 / bn] = s;
    }
  }
}

template <bool kI4, int BR>
__global__ void __launch_bounds__(kThreads, 1) ffn_down_kernel(
    const __grid_constant__ CUtensorMap x_map,   // hq (S, I): boxes of BR rows x 128
    const __grid_constant__ CUtensorMap w_map,   // W2 (I, D); int4: packed (I / 2, D)
    const __grid_constant__ CUtensorMap sh_map,  // int4: shifts (I / 128, D)
    const float* __restrict__ hs,    // (S, I / bn)
    const float* __restrict__ w2s,   // (1, D)
    const bf16* __restrict__ b2,     // (D,)
    bf16* __restrict__ out,          // (S, D)
    int rows, int d_model, int inter, int bn, int split, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t stage_bytes = BR * 128 + w_tile_bytes<kI4>();
  float* part = reinterpret_cast<float*>(smem + (size_t)stages * stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)stages * stage_bytes +
                                               dg_part_bytes(BR, split));
  const DgRing ring{smem, bars, bars + stages, BR * 128, w_tile_bytes<kI4>(), stages};
  const int tiles = inter / bn, per = bn / kDgKC;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kDgCols;
  const int m0 = blockIdx.y * BR;
  const int rounds = (tiles + split - 1) / split;
  const DgChunks ch{rank, split, (tiles - rank + split - 1) / split, per};
  dg_init(ring, 1);
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    regs_dealloc<kDgProducerRegs>();
    const int ptid = threadIdx.x - kDgConsumerThreads;
    const DgWeight wt{nullptr, inter, d_model, 1};
    const DgRows hrows{nullptr, rows, inter, 1};
    int issued = 0;
    for (int rho = 0; rho < rounds; ++rho) {
      // The chunks whose stage the consumers free before this round's
      // barriers (chunk i waits for chunk i - stages).
      const int upto = min(ch.count(), (rho + 1) * per + stages);
      dg_produce<kFfnKind<kI4>>(ring, &w_map, &sh_map, &x_map, wt, hrows, ch, n0, m0, issued,
                                upto, ptid);
      issued = upto;
      if (split > 1) {
        __syncwarp();
        cluster.sync();
        cluster.sync();
      }
    }
    return;
  }
  regs_alloc<kDgConsumerRegs>();
  const DgLane L;
  const uint32_t mine = dg_owned_mask(rank, split, BR / 8);
  float sum[BR / 2];
#pragma unroll
  for (int i = 0; i < BR / 2; ++i) sum[i] = 0.f;
  for (int rho = 0; rho < rounds; ++rho) {
    const int t = rho * split + rank;
    if (t < tiles) {
      float hv[BR / 4];   // the rows' hs_t, loaded while the tile's products run
#pragma unroll
      for (int i = 0; i < BR / 4; ++i) {
        const int row = m0 + 8 * (i / 2) + 2 * (L.lane & 3) + (i & 1);
        hv[i] = row < rows ? hs[(size_t)row * tiles + t] : 0.f;
      }
      int acc[BR / 2];
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
      dg_consume<kFfnKind<kI4>, BR>(ring, L, rho * per, (rho + 1) * per, acc);
      float p[BR / 2];
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) {
        p[i] = __fmul_rn(__int2float_rn(acc[i]), hv[2 * (i / 4) + (i & 1)]);
        if (split == 1) sum[i] = __fadd_rn(sum[i], p[i]);
      }
      if (split > 1) dg_push<BR>(p, part, L, rank, split, cluster);
    }
    if (split > 1) {
      cluster.sync();   // every block's p of this round is in its owner's slots
      dg_add_slots<BR>(sum, part, L, mine, split, min(split, tiles - rho * split));
      cluster.sync();   // and read: the next round may overwrite them
    }
  }
  // out = bf16(acc * w2_s + b2) for columns c0, c0 + 1 (D is even).
  const int c0 = n0 + L.col;
  if (c0 >= d_model) return;
  const float ws0 = w2s[c0], ws1 = w2s[c0 + 1];
  const float b0 = to_f32(b2[c0]), b1v = to_f32(b2[c0 + 1]);
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (!((mine >> j) & 1)) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * (L.lane & 3) + e;
      if (row >= rows) continue;
      const bf16 o0 = __float2bfloat16(__fadd_rn(__fmul_rn(sum[4 * j + e], ws0), b0));
      const bf16 o1 = __float2bfloat16(__fadd_rn(__fmul_rn(sum[4 * j + e + 2], ws1), b1v));
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * d_model + c0) =
          __halves2bfloat162(o0, o1);
    }
  }
}

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
  int err = make_map_2d(&xm, xq, u8, 1, d_model, rows, 128, BR);
  if (err == 0) err = make_map_2d(&w1m, w1, u8, 1, inter, kI4 ? d_model / 2 : d_model, 128, wrows);
  if (err == 0) err = make_map_2d(&hqm, hq, u8, 1, inter, rows, 128, BR);
  if (err == 0) err = make_map_2d(&w2m, w2, u8, 1, d_model, kI4 ? inter / 2 : inter, 128, wrows);
  if (kI4 && err == 0)
    err = make_map_2d(&s1m, w1sh, u8, 1, inter, d_model / kDgKC, 128, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (kI4 && err == 0)
    err = make_map_2d(&s2m, w2sh, u8, 1, d_model, inter / kDgKC, 128, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const uint32_t stage = BR * 128 + w_tile_bytes<kI4>();
  const int row_tiles = (rows + BR - 1) / BR;
  err = dg_launch(ffn_up_kernel<kI4, BR>, dim3(inter / kDgCols, row_tiles), dim3(kThreads),
                  bn / kDgCols, dg_smem_bytes(BR, st_up, stage, 1, ffn_up_extra(BR)), s,
                  xm, w1m, s1m,
                  static_cast<const float*>(xs), static_cast<const float*>(w1s),
                  static_cast<const bf16*>(b1), static_cast<int8_t*>(hq),
                  static_cast<float*>(hs), rows, d_model, inter, bn, act, st_up);
  if (err != 0) return err;
  err = dg_launch(ffn_down_kernel<kI4, BR>,
                  dim3(((d_model + kDgCols - 1) / kDgCols) * split, row_tiles), dim3(kThreads),
                  split, dg_smem_bytes(BR, st_down, stage, split, 0), s, hqm, w2m, s2m,
                  static_cast<const float*>(hs), static_cast<const float*>(w2s),
                  static_cast<const bf16*>(b2), static_cast<bf16*>(out), rows, d_model, inter,
                  bn, split, st_down);
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

// The resources of one kernel of the int8 or int4 FFN (kernel: 0 up int8,
// 1 down int8, 2 up int4, 3 down int4) at a row tile of `row_tile` rows and
// `smem` bytes of dynamic shared memory (hopper.cuh::kernel_resources):
// registers a thread, shared memory a block, resident blocks an SM, threads
// a block and spilled bytes a thread, into out[0..4].
extern "C" int apertis_ffn_quant_resources(int kernel, int row_tile, int smem, int* out) {
  if (row_tile != 16 && row_tile != 64) return static_cast<int>(cudaErrorInvalidValue);
  const bool r16 = row_tile == 16;
  switch (kernel) {
    case 0: return kernel_resources(r16 ? &ffn_up_kernel<false, 16> : &ffn_up_kernel<false, 64>,
                                    kThreads, smem, out);
    case 1: return kernel_resources(r16 ? &ffn_down_kernel<false, 16> : &ffn_down_kernel<false, 64>,
                                    kThreads, smem, out);
    case 2: return kernel_resources(r16 ? &ffn_up_kernel<true, 16> : &ffn_up_kernel<true, 64>,
                                    kThreads, smem, out);
    case 3: return kernel_resources(r16 ? &ffn_down_kernel<true, 16> : &ffn_down_kernel<true, 64>,
                                    kThreads, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

