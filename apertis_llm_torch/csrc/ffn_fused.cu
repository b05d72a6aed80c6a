// ffn_decode: the dense FFN at decode, out = act(x @ W1 + b1) @ W2 + b2.
//
// Replaces: apertis_llm_tpu/ops/pallas/ffn_fused.py::ffn_decode_fused with
// the bf16 weight layout (apertis_ffn_decode), the int8 layout
// (apertis_ffn_decode_int8) and the int4 layout (apertis_ffn_decode_int4),
// the last two at the end of this file.
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

#include "common.cuh"

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

// ---- int8 layout -------------------------------------------------------------
//
// Semantics (ffn_fused.py:42-99 with quant=True), per row, with the hidden
// cut into tiles of `bn` columns (bn = _pick_block_n(I, 1216), 512 at the
// 1.5B width; the tile width changes the result, so it is the TPU kernel's):
//   h   = acc1_i32(x_q . W1_q) * x_s * w1_s + b1             (f32)
//   a   = act(h)
//   per tile t: hs_t = max(max|a_t|, 1e-8) * (1/127);  hq_t = rint(a_t / hs_t)
//   acc = sum over t in order of acc2_i32(hq_t . W2_q[t]) * hs_t   (f32)
//   out = bf16(acc * w2_s + b2)
// The _rn intrinsics keep nvcc from contracting the multiplies and adds into
// fused multiply-adds that the reference does not have.
//
// Bound on the H100: bytes. At decode row counts the step reads both int8
// weight matrices (2 * 2432 * 9728 B = 47.3 MB per layer of the 1.5B model)
// for 4 * rows integer operations per weight pair.
//
// Design: three launches, each spread over the whole card.
//   1. ffn_i8_hidden_kernel, one block per (64 hidden columns, 16 rows):
//      exact int32 GEMM1 (tile_matvec_i8, __dp4a), dequantization, bias and
//      activation; the f32 hidden goes to an (S, I) scratch buffer.
//   2. ffn_i8_tile_kernel, one block per (256 output columns, hidden tile,
//      16 rows): loads its rows of one hidden tile, requantizes them per
//      (row, tile) (every column group of the tile computes the same scales),
//      runs the exact int32 GEMM2 over the tile for its four 64-column tiles
//      and writes acc2 * hs_t to an f32 partial (tiles, S, D).
//   3. ffn_i8_reduce_kernel adds the tiles' partials in tile order, which is
//      the TPU kernel's order of accumulation, then applies w2_s and b2.
// There are no float atomics, so a repeated call gives the same bits. Scratch
// at 64 rows of the 1.5B model: 2.5 MB of hidden and 11.8 MB of partials.

namespace {

constexpr int kRowsI8 = 16;   // rows per block of the int8 launches
constexpr int kColTiles = 4;  // 64-column tiles per block of ffn_i8_tile_kernel

// tile_matvec_i8 over an int4-packed weight (models/quantize.py::
// quantize_weight_int4): wq4 (k_total / 2, ldw) bytes, byte row 64 g + j
// holding contraction rows 128 g + j (low nibble) and 128 g + j + 64 (high
// nibble), and sh (k_total / 128, ldw) int8 shifts. Each nibble is
// sign-extended and multiplied by its group's shift (1, 2, 4 or 8) before the
// dot, so the values lie in [-56, 56] and the int32 sums are exact, as the
// TPU kernel's int8 dot over the unpacked block. The warps split the byte
// rows in runs of four, which stay inside one group: a lane packs the low
// nibbles of four byte rows (contraction rows j..j+3 of the group) into one
// __dp4a word and the high nibbles (rows j+64..j+67) into another.
// k_total must be a multiple of 128. Ends synchronised.
template <int RB>
__device__ void tile_matvec_i4(const int8_t* xq, int ldx, const int8_t* __restrict__ wq4,
                               int ldw, const int8_t* __restrict__ sh, int k_total, int col0,
                               int ncols, int* red, int* out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_b = k_total / 2;
  const int kper = (((rows_b + kWarps - 1) / kWarps) + 3) & ~3;
  const int q0 = warp * kper;
  const int q1 = min(rows_b, q0 + kper);
  const int ja = col0 + lane;
  const int jb = col0 + 32 + lane;
  const bool va = ja < ncols;
  const bool vb = jb < ncols;
  int acc_a[RB], acc_b[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    acc_a[r] = 0;
    acc_b[r] = 0;
  }
  for (int q = q0; q < q1; q += 4) {
    const int g = q >> 6;
    const int klo = g * 128 + (q & 63);
    const int sa = va ? sh[(size_t)g * ldw + ja] : 0;
    const int sb = vb ? sh[(size_t)g * ldw + jb] : 0;
    int lo_a = 0, hi_a = 0, lo_b = 0, hi_b = 0;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int8_t* wr = wq4 + (size_t)(q + qq) * ldw;
      const int pa = va ? wr[ja] : 0;
      const int pb = vb ? wr[jb] : 0;
      lo_a |= ((int4_nibble(pa, false) * sa) & 0xff) << (8 * qq);
      hi_a |= ((int4_nibble(pa, true) * sa) & 0xff) << (8 * qq);
      lo_b |= ((int4_nibble(pb, false) * sb) & 0xff) << (8 * qq);
      hi_b |= ((int4_nibble(pb, true) * sb) & 0xff) << (8 * qq);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int xlo = *reinterpret_cast<const int*>(xq + r * ldx + klo);
      const int xhi = *reinterpret_cast<const int*>(xq + r * ldx + klo + 64);
      acc_a[r] = __dp4a(xhi, hi_a, __dp4a(xlo, lo_a, acc_a[r]));
      acc_b[r] = __dp4a(xhi, hi_b, __dp4a(xlo, lo_b, acc_b[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    red[(warp * RB + r) * kTileN + lane] = acc_a[r];
    red[(warp * RB + r) * kTileN + 32 + lane] = acc_b[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RB * kTileN; i += kBlock) {
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi * RB * kTileN + i];
    out[i] = sum;
  }
  __syncthreads();
}

// kI4: W1 is int4-packed with its shifts w1sh (D / 128, I).
template <bool kI4>
__global__ void __launch_bounds__(kBlock) ffn_i8_hidden_kernel(
    const int8_t* __restrict__ xq,   // (S, D)
    const float* __restrict__ xs,    // (S, 1)
    const int8_t* __restrict__ w1,   // (D, I), int4: (D / 2, I)
    const int8_t* __restrict__ w1sh, // int4 only: (D / 128, I)
    const float* __restrict__ w1s,   // (1, I)
    const bf16* __restrict__ b1,     // (I,)
    float* __restrict__ hidden,      // (S, I)
    int rows, int d_model, int inter, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* red = reinterpret_cast<int*>(smem_raw);                  // kWarps * kRowsI8 * kTileN
  int* out = red + kWarps * kRowsI8 * kTileN;                   // kRowsI8 * kTileN
  int8_t* x = reinterpret_cast<int8_t*>(out + kRowsI8 * kTileN);  // kRowsI8 * D
  const int row0 = blockIdx.y * kRowsI8;
  const int col0 = blockIdx.x * kTileN;
  const int words = d_model / 4;
  for (int i = threadIdx.x; i < kRowsI8 * words; i += kBlock) {
    const int r = i / words;
    const int k = i - r * words;
    reinterpret_cast<int*>(x)[i] =
        row0 + r < rows ? reinterpret_cast<const int*>(xq + (size_t)(row0 + r) * d_model)[k]
                        : 0;
  }
  __syncthreads();
  if constexpr (kI4)
    tile_matvec_i4<kRowsI8>(x, d_model, w1, inter, w1sh, d_model, col0, inter, red, out);
  else
    tile_matvec_i8<kRowsI8>(x, d_model, w1, inter, d_model, col0, inter, red, out);
  for (int i = threadIdx.x; i < kRowsI8 * kTileN; i += kBlock) {
    const int r = i / kTileN;
    const int j = col0 + (i - r * kTileN);
    if (row0 + r >= rows || j >= inter) continue;
    const float h = __fadd_rn(__fmul_rn(__fmul_rn((float)out[i], xs[row0 + r]), w1s[j]),
                              to_f32(b1[j]));
    hidden[(size_t)(row0 + r) * inter + j] = activate(h, act);
  }
}

// kI4: W2 is int4-packed with its shifts w2sh (I / 128, D); bn is then a
// multiple of 128, so each tile starts on a group boundary.
template <bool kI4>
__global__ void __launch_bounds__(kBlock) ffn_i8_tile_kernel(
    const float* __restrict__ hidden,  // (S, I)
    const int8_t* __restrict__ w2,     // (I, D), int4: (I / 2, D)
    const int8_t* __restrict__ w2sh,   // int4 only: (I / 128, D)
    float* __restrict__ partial,       // (tiles, S, D)
    int rows, int d_model, int inter, int bn) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* red = reinterpret_cast<int*>(smem_raw);            // kWarps * kRowsI8 * kTileN
  int* out = red + kWarps * kRowsI8 * kTileN;             // kRowsI8 * kTileN
  float* hs = reinterpret_cast<float*>(out + kRowsI8 * kTileN);  // kRowsI8
  float* hf = hs + kRowsI8;                               // kRowsI8 * bn
  int8_t* hq = reinterpret_cast<int8_t*>(hf + kRowsI8 * bn);     // kRowsI8 * bn
  const int tile = blockIdx.y;
  const int k0 = tile * bn;
  const int row0 = blockIdx.z * kRowsI8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kRowsI8 * bn; i += kBlock) {
    const int r = i / bn;
    const int k = i - r * bn;
    hf[i] = row0 + r < rows ? hidden[(size_t)(row0 + r) * inter + k0 + k] : 0.f;
  }
  __syncthreads();
  // Requantize each row's tile: hs = max(absmax, 1e-8) * (1/127), a true
  // division by hs (ffn_fused.py:81-83). Rows past S are zeros.
  for (int r = warp; r < kRowsI8; r += kWarps) {
    const float* v = hf + r * bn;
    float m = 0.f;
    for (int k = lane; k < bn; k += 32) m = fmaxf(m, fabsf(v[k]));
    const float s = fmaxf(warp_max(m), 1e-8f) * (1.f / 127.f);
    for (int k = lane; k < bn; k += 32) hq[r * bn + k] = quant_level(__fdiv_rn(v[k], s));
    if (lane == 0) hs[r] = s;
  }
  __syncthreads();
  // The requantized tile serves kColTiles column tiles of the output.
  float* dst = partial + (size_t)tile * rows * d_model;
  for (int ct = 0; ct < kColTiles; ++ct) {
    const int col0 = (blockIdx.x * kColTiles + ct) * kTileN;
    if (col0 >= d_model) break;
    if constexpr (kI4)
      tile_matvec_i4<kRowsI8>(hq, bn, w2 + (size_t)(k0 / 2) * d_model, d_model,
                              w2sh + (size_t)(k0 / 128) * d_model, bn, col0, d_model, red, out);
    else
      tile_matvec_i8<kRowsI8>(hq, bn, w2 + (size_t)k0 * d_model, d_model, bn, col0, d_model,
                              red, out);
    for (int i = threadIdx.x; i < kRowsI8 * kTileN; i += kBlock) {
      const int r = i / kTileN;
      const int j = col0 + (i - r * kTileN);
      if (row0 + r >= rows || j >= d_model) continue;
      dst[(size_t)(row0 + r) * d_model + j] = __fmul_rn((float)out[i], hs[r]);
    }
  }
}

__global__ void __launch_bounds__(kBlock) ffn_i8_reduce_kernel(
    const float* __restrict__ partial,  // (tiles, S, D)
    const float* __restrict__ w2s,      // (1, D)
    const bf16* __restrict__ b2,        // (D,)
    bf16* __restrict__ out,             // (S, D)
    int tiles, int rows, int d_model) {
  const size_t n = (size_t)rows * d_model;
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) acc = __fadd_rn(acc, partial[(size_t)t * n + i]);
  const int col = (int)(i % d_model);
  out[i] = __float2bfloat16(__fadd_rn(__fmul_rn(acc, w2s[col]), to_f32(b2[col])));
}

}  // namespace

namespace {

// The three launches of the int8 (kI4 false) or int4 layout.
template <bool kI4>
cudaError_t ffn_quant_launch(const void* xq, const void* xs, const void* w1q, const void* w1sh,
                             const void* w1s, const void* b1, const void* w2q,
                             const void* w2sh, const void* w2s, const void* b2, void* out,
                             void* hidden, void* partial, int rows, int d_model, int inter,
                             int bn, int act, cudaStream_t s) {
  const int tiles = inter / bn;
  const int row_tiles = (rows + kRowsI8 - 1) / kRowsI8;
  const size_t mat = (size_t)(kWarps + 1) * kRowsI8 * kTileN * sizeof(int);
  const size_t smem_hidden = mat + (size_t)kRowsI8 * d_model;
  const size_t smem_tile = mat + kRowsI8 * sizeof(float) + (size_t)kRowsI8 * bn * 5;
  cudaError_t err = allow_smem(ffn_i8_hidden_kernel<kI4>, smem_hidden);
  if (err == cudaSuccess) err = allow_smem(ffn_i8_tile_kernel<kI4>, smem_tile);
  if (err != cudaSuccess) return err;
  ffn_i8_hidden_kernel<kI4><<<dim3((inter + kTileN - 1) / kTileN, row_tiles), kBlock,
                              smem_hidden, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w1q), static_cast<const int8_t*>(w1sh),
      static_cast<const float*>(w1s), static_cast<const bf16*>(b1),
      static_cast<float*>(hidden), rows, d_model, inter, act);
  const int col_groups = (d_model + kColTiles * kTileN - 1) / (kColTiles * kTileN);
  ffn_i8_tile_kernel<kI4><<<dim3(col_groups, tiles, row_tiles), kBlock, smem_tile, s>>>(
      static_cast<const float*>(hidden), static_cast<const int8_t*>(w2q),
      static_cast<const int8_t*>(w2sh), static_cast<float*>(partial), rows, d_model, inter,
      bn);
  const size_t n = (size_t)rows * d_model;
  ffn_i8_reduce_kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(w2s),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), tiles, rows, d_model);
  return cudaGetLastError();
}

}  // namespace

// Whole int8 FFN for S rows: x_q (S, D) int8 with x_s (S, 1) f32, W1_q
// (D, I) int8 with w1_s (1, I) f32, W2_q (I, D) int8 with w2_s (1, D) f32,
// bf16 biases, bf16 output. D must be a multiple of 4 and bn a multiple of 4
// dividing I. `hidden` (S, I) and `partial` (I / bn, S, D) are f32 scratch
// the caller allocates. act: 1 relu, 2 silu, else exact GELU. Returns
// cudaGetLastError().
extern "C" int apertis_ffn_decode_int8(const void* xq, const void* xs, const void* w1q,
                                       const void* w1s, const void* b1, const void* w2q,
                                       const void* w2s, const void* b2, void* out,
                                       void* hidden, void* partial, int rows, int d_model,
                                       int inter, int bn, int act, void* stream) {
  if (rows <= 0 || d_model % 4 != 0 || bn <= 0 || bn % 4 != 0 || inter % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ffn_quant_launch<false>(
      xq, xs, w1q, nullptr, w1s, b1, w2q, nullptr, w2s, b2, out, hidden, partial, rows,
      d_model, inter, bn, act, static_cast<cudaStream_t>(stream)));
}

// ---- int4 layout --------------------------------------------------------------
//
// Semantics (ffn_fused.py:42-99 with int4=True): the int8 layout's, with
// W1_q and W2_q the unpacked int4 weights (values times their group's shift,
// in [-56, 56]) and w1_s, w2_s the int4 base scales. The packs are
// w1_q4 (D / 2, I) with w1_sh (D / 128, I) and w2_q4 (I / 2, D) with
// w2_sh (I / 128, D) (models/quantize.py::quantize_weight_int4).
//
// Bound on the H100: bytes, half the int8 layout's weight bytes (24 MB per
// layer of the 1.5B model, 0.007 ms at 3.35 TB/s).
//
// Design: the int8 layout's three launches, with tile_matvec_i4 unpacking
// the nibbles on load in place of tile_matvec_i8. D and bn must be
// multiples of 128, so every hidden tile of GEMM2 starts on a group.
extern "C" int apertis_ffn_decode_int4(const void* xq, const void* xs, const void* w1q4,
                                       const void* w1sh, const void* w1s, const void* b1,
                                       const void* w2q4, const void* w2sh, const void* w2s,
                                       const void* b2, void* out, void* hidden, void* partial,
                                       int rows, int d_model, int inter, int bn, int act,
                                       void* stream) {
  if (rows <= 0 || d_model % 128 != 0 || bn <= 0 || bn % 128 != 0 || inter % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ffn_quant_launch<true>(
      xq, xs, w1q4, w1sh, w1s, b1, w2q4, w2sh, w2s, b2, out, hidden, partial, rows, d_model,
      inter, bn, act, static_cast<cudaStream_t>(stream)));
}
