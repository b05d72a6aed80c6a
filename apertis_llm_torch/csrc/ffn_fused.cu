// ffn_decode: the dense FFN at decode, out = act(x @ W1 + b1) @ W2 + b2.
//
// Replaces: apertis_llm_tpu/ops/pallas/ffn_fused.py::ffn_decode_fused with
// the bf16 weight layout (the int8 and int4 layouts are later work).
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
