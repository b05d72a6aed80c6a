// Hopper building blocks of the flash-attention, int8-weight GEMM and int8
// decode kernels: mbarriers, TMA tensor loads, wgmma shared-memory
// descriptors, the flash kernels' wgmma products (bf16 and TF32) and online
// softmax, and the int8 and int4 weight fragments of the swapped-operand
// products (an int8 (K, N) weight as wgmma's register A operand), in
// inline PTX (sm_90a). Header-only, in an anonymous namespace like
// common.cuh.
//
// Shared-memory tiles are the 128-byte-swizzled layout that a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: a tile of R rows is column blocks of
// 128 bytes a row (64 bf16 or 32 f32 columns), block c holding columns
// 64c..64c+63 (bf16) or 32c..32c+31 (f32) of every row as R rows of 128
// bytes (R * 128 bytes, 1024-byte aligned); inside each group of 8 rows
// (1024 bytes) the 16-byte chunks of row r are permuted by XOR with r % 8. A
// width that is not a multiple of the block (Dh 8, 40 or 96 in f32) fills
// its last block in part: the TMA writes zeros past the tensor's edge. wgmma
// reads such a tile through a descriptor either K-major (the product's
// reduction axis runs along the row: Q and K in Q K^T) or, for bf16 only,
// MN-major (the reduction axis runs down the rows: V in P V). TF32 operands
// are K-major only: a product that reduces down the stored rows (P V, dS K)
// reads a transposed copy written by threads in the same layout
// (flash_attention_f32.cu). A k-step reads 32 bytes of the row (16 bf16 or
// 8 f32 columns), so a block holds 4 k-steps.
#pragma once

#include <cmath>
#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after `p` in shared memory (the swizzle
// atoms of the tiles must start on one); callers reserve 1024 bytes extra.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Warp specialisation: the producer warpgroup gives registers back and the
// consumer warpgroups take them (every warp of a warpgroup executes it).
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below the smallest normal f32 are 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Named barriers 1..15 between warpgroups: `sync` waits until `n` threads
// have arrived or synced on barrier `id`; `arrive` counts this warp without
// waiting.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ---- the flash kernels' blocks ------------------------------------------------

// A block is two consumer warpgroups of 64 rows each and a producer
// warpgroup that gives its registers to them (setmaxnreg).
constexpr int kWgRows = 64;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, warpgroup 0 first), so that one's element-wise work
// runs while the other's products hold the tensor cores. Both must take the
// same number of turns.
struct Turns {
  int wg;
  __device__ __forceinline__ void start() const {
    if (wg == 0) named_arrive(1, 2 * 128);
  }
  __device__ __forceinline__ void mine() const { named_sync(1 + wg, 2 * 128); }
  // Warpgroup 1's last turn of the block hands over to no one.
  __device__ __forceinline__ void theirs(bool last) const {
    if (wg == 0 || !last) named_arrive(2 - wg, 2 * 128);
  }
};

// A persistent block's work items are the BH * ntiles row tiles (`rows`
// rows each) of BH matrices: item i is matrix bh, tile from row row0, the
// last tiles first when `last_first` (the heaviest query tiles under
// causal masking). Block b of a grid of G takes, in round r, item
// snake_item(r, b, G): round r of the list, in the blocks' order on even
// rounds and reversed on odd ones, so that with the items sorted heaviest
// first each block's sum of costs comes out even.
__device__ __forceinline__ void tile_item(int i, int BH, int ntiles, bool last_first, int rows,
                                          int& bh, int& row0) {
  const int t = i / BH;
  bh = i - t * BH;
  row0 = (last_first ? ntiles - 1 - t : t) * rows;
}

__device__ __forceinline__ int snake_item(int r, int b, int G) {
  return r * G + ((r & 1) ? G - 1 - b : b);
}

// Key tiles of BK rows that a query tile of `rows` rows from q0 visits.
__device__ __forceinline__ int key_tiles(int L, int BK, int q0, int rows, int causal) {
  const int n = (L + BK - 1) / BK;
  return causal ? min(n, (q0 + rows + BK - 1) / BK) : n;
}

// A persistent grid: a block an SM, or one an item where there are fewer;
// 0 if the device cannot be read.
inline int persistent_grid(long long items) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return (int)(items < sms ? items : sms);
}

// Online softmax of key tile j (BK keys) in the accumulator layout, for the
// bf16 and f32 flash forward kernels: this thread's scores of rows r0 and
// r0 + 8 in `sc` (raw q . k) become p; the row max m (log2 domain, scores
// times scale * log2 e) and the row sum l are updated, and alpha is the
// factor for O. Masked scores are -inf; a row max stays -inf only while its
// row has seen no key, and then 0 stands in for it, so that no inf - inf
// arises.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int j, int L, int r0,
                                               int row_lo, int lane, int causal,
                                               float scale_log2) {
  if (j * BK + BK > L || (causal && j * BK + BK - 1 > row_lo)) {
    const int c0 = j * BK + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = c0 + 8 * (i >> 2) + (i & 1);
      if (col >= L || (causal && col > r0 + 8 * ((i >> 1) & 1))) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    mb[h] = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = exp2_approx(m[h] - mb[h]);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], scale_log2, -mb[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); a block
// barrier must follow before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA loads.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA --------------------------------------------------------------------

// Load the box at (c0, c1, c2) of a 3-d tensor map into shared memory; the
// barrier counts its bytes. Out-of-bounds elements are written as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Load the box at (c0, c1) of a 2-d tensor map (c0 along the contiguous
// axis) into shared memory; the barrier counts its bytes. Out-of-bounds
// elements are written as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Orders this thread's ordinary shared-memory stores before later reads by
// the async proxy (wgmma, TMA): a thread that fills a tile by hand runs it
// before it arrives on the tile's barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime so that the
// library needs no -lcuda; null if the driver has none.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
#else
    const bool ok =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess;
#endif
    return ok ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// The error an entry point returns when a tensor map cannot be made.
constexpr int kTensorMapError = static_cast<int>(cudaErrorInvalidResourceHandle);

// A tensor map over BH contiguous (L, dh) matrices of `type` (bf16 by
// default, `elem_bytes` bytes an element) that loads boxes of `rows` rows x
// one 128-byte column block in the 128-byte swizzle; rows past L and columns
// past dh read as zeros. dh * elem_bytes a multiple of 16 (16-byte row
// strides) and the base 16-byte aligned.
inline int make_tile_map(CUtensorMap* map, const void* base, int BH, int L, int dh, int rows,
                         CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         int elem_bytes = 2) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * elem_bytes, (cuuint64_t)L * dh * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError;
}

// A tensor map over a row-major (outer, inner) matrix of `elem_bytes`-byte
// elements that loads boxes of box_outer rows x box_inner elements (128
// bytes) in the 128-byte swizzle (or `swizzle`); rows and columns past the
// edges read as zeros. The row stride, inner * elem_bytes, must be a multiple of 16 and the
// base 16-byte aligned.
inline int make_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                       int elem_bytes, uint64_t inner, uint64_t outer, uint32_t box_inner,
                       uint32_t box_outer,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError;
}

// Load rows [row0, row0 + rows) of matrix bh, all DHP columns (DHP / 64
// blocks of bf16, DHP / 32 of f32), into a swizzled tile (the map's box has
// `rows` rows).
template <int DHP, typename T>
__device__ __forceinline__ void tma_load_tile(T* tile, const CUtensorMap* map, uint64_t* bar,
                                              int rows, int row0, int bh) {
  constexpr int kCols = 128 / sizeof(T);   // columns of a block
#pragma unroll
  for (int c = 0; c < DHP / kCols; ++c)
    tma_load_3d(tile + c * rows * kCols, map, bar, c * kCols, row0, bh);
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `p`: `lbo` is the byte stride
// between 64-column blocks (MN-major operands only), `sbo` between groups of
// 8 rows (1024 in these tiles).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: the 64-row slice at `row0` of a tile of `rows` rows, k16
// step kk (columns 16kk..16kk+15): column block kk / 4, 32 bytes a step
// inside it.
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* tile, int rows, int row0, int kk) {
  return sw128_desc(tile + (kk >> 2) * rows * 64 + row0 * 64 + (kk & 3) * 16, 16, 1024);
}

// MN-major operand: rows 16kk..16kk+15 of a tile of `rows` rows, from
// column block cb on.
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* tile, int rows, int kk, int cb) {
  return sw128_desc(tile + cb * rows * 64 + kk * 16 * 64, rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these accumulators
// across an in-flight wgmma.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 values as one register of bf16 (the first in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator layout of a 64 x N wgmma: thread t of the warpgroup (warp
// w = t / 32, lane l) holds d[4j + e] at row 16w + l / 4 + 8 (e / 2) and
// column 8j + 2 (l % 4) + e % 2. The A operand from registers (64 x 16, k
// step kk) uses the same rows: a[0] (row r, columns 2 (l % 4) + {0, 1}),
// a[1] (row r + 8), a[2] and a[3] the same 8 columns on. So columns
// 16kk..16kk+15 of an accumulator, rounded to bf16, are A fragment kk.
template <int R>
__device__ __forceinline__ void to_a_frag(const float (&d)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// wgmma m64nNk16 with bf16 operands and f32 accumulators, one asm statement
// for each form and N the kernels use: `ss` reads A and B from shared
// memory, both K-major (N = 32, 64, 128); `rs` takes A from registers and B
// MN-major (N = 64, 128, 256). `acc` = 0 overwrites D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D (64 x 32, f32) (+)= A B^T, A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  // D (64 x 64, f32) (+)= A B^T, A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D (64 x 64, f32) (+)= A B, A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  // D (64 x 128, f32) (+)= A B^T, A and B K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D (64 x 128, f32) (+)= A B, A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<256> {
  // D (64 x 256, f32) (+)= A B, A in registers, B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// ---- TF32 products (the f32 flash kernels) --------------------------------

// K-major f32 operand: the 64-row slice at `row0` of a tile of `rows` rows,
// k8 step kk (columns 8kk..8kk+7): column block kk / 4, 32 bytes a step
// inside it.
__device__ __forceinline__ uint64_t kmajor_desc(const float* tile, int rows, int row0, int kk) {
  return sw128_desc(tile + (kk >> 2) * rows * 32 + row0 * 32 + (kk & 3) * 8, 16, 1024);
}

// An f32 value as TF32 "hi" and "lo" parts, the split of 3xTF32 products
// (CUTLASS's FastF32 rule): hi = x rounded to TF32 (sign, exponent, 10
// mantissa bits; to nearest, ties away from zero, as cvt.rna.tf32.f32: add
// half a TF32 ulp to the magnitude's bits and clear the low 13), lo = x - hi
// (exact, by Sterbenz's lemma) rounded to TF32 the same way. hi + lo carries
// x to about 2^-22 of it, with errors of either sign; the tensor core reads
// both exactly. (Rounding hi toward zero instead biases every product's
// error one way, which a long sum accumulates.)
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ float tf32_hi(float x) { return __uint_as_float(tf32_round(x)); }
__device__ __forceinline__ float tf32_lo(float x, float hi) {
  return __uint_as_float(tf32_round(x - hi));
}

// The register A fragment of k8 step kk (TF32, 64 x 8) from the accumulator
// of a 64 x N product, split into hi and lo. A fragment register i holds
// row 16w + l / 4 + 8 (i % 2) and column l % 4 + 4 (i / 2); the accumulator
// gives this thread columns 2 (l % 4) and 2 (l % 4) + 1 of the same rows
// (d[4kk + e]: row + 8 (e / 2), column 8kk + 2 (l % 4) + e % 2). So the
// fragment takes {d[4kk], d[4kk + 2], d[4kk + 1], d[4kk + 3]}: its column
// (slot) s < 4 is column 2s of the step, slot s >= 4 column 2 (s - 4) + 1,
// and the B operand's k rows must be written in the same order
// (tf32_slot). No shuffle: the product sums over the step's 8 columns in
// any order.
template <int R>
__device__ __forceinline__ void to_tf32_frags(const float (&d)[R], int kk, uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  const float x[4] = {d[4 * kk], d[4 * kk + 2], d[4 * kk + 1], d[4 * kk + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = tf32_hi(x[i]);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(tf32_lo(x[i], h));
  }
}

// The slot of column k (0..7) of a k8 step in the order to_tf32_frags
// gives the A fragment: even columns in slots 0-3, odd ones in 4-7.
__host__ __device__ constexpr int tf32_slot(int k) { return (k & 1) * 4 + (k >> 1); }

// wgmma m64nNk8 with TF32 operands and f32 accumulators (no transpose
// flags: both operands K-major), one asm statement for each form and N the
// f32 flash kernels and decode_gemm.cuh's split-TF32 products use: `ss`
// reads A and B from shared memory (N = 8 to 128); `rs` takes A from
// registers (N = 16, 32, 64). `acc` = 0 overwrites D.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<8> {
  // D (64 x 8, f32) (+)= A B^T, A and B K-major TF32 in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct WgmmaTf32<16> {
  // D (64 x 16, f32) (+)= A B^T, A and B K-major TF32 in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }  // D (64 x 16, f32) (+)= A B^T, A from registers (a TF32 fragment), B
  // K-major TF32 in shared memory (decode_gemm.cuh's split-TF32 weights).
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgmmaTf32<32> {
  // D (64 x 32, f32) (+)= A B^T, A and B K-major TF32 in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D (64 x 32, f32) (+)= A B^T, A from registers (a TF32 fragment), B
  // K-major TF32 in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgmmaTf32<64> {
  // D (64 x 64, f32) (+)= A B^T, A and B K-major TF32 in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // D (64 x 64, f32) (+)= A B^T, A from registers (a TF32 fragment), B
  // K-major TF32 in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgmmaTf32<128> {
  // D (64 x 128, f32) (+)= A B^T, A and B K-major TF32 in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// ---- int8 weight fragments (the int8-weight GEMMs and the decode kernels) ----

// 16 bytes of row `row` of a (rows, cols) int8 matrix with leading dimension
// `ld`, from column `col`; zeros past the edges. `vec`: cols is a multiple of
// 16 and the base 16-byte aligned, so a 16-byte load is in bounds and aligned;
// otherwise 8- or 4-byte loads where the 16 bytes are in bounds and so
// aligned, else byte loads.
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ base, int row, int col,
                                       int rows, int cols, size_t ld, bool vec) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  const int8_t* src = base + (size_t)row * ld + col;
  if (vec) return *reinterpret_cast<const int4*>(src);
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (col + 16 <= cols && at % 8 == 0) {
    const int2 a = reinterpret_cast<const int2*>(src)[0], b = reinterpret_cast<const int2*>(src)[1];
    return make_int4(a.x, a.y, b.x, b.y);
  }
  if (col + 16 <= cols && at % 4 == 0) {
    const int* p = reinterpret_cast<const int*>(src);
    return make_int4(p[0], p[1], p[2], p[3]);
  }
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (col + j < cols) w[j >> 2] |= (int)(uint8_t)src[j] << (8 * (j & 3));
  return make_int4(w[0], w[1], w[2], w[3]);
}

// wgmma with A from registers and B K-major in shared memory (`b`, a
// 128-byte-swizzle descriptor): #7 D (64 x N, s32) (+)= A (64 x 32, s8) B
// (32 x N, s8); #6 D (64 x N, f32) (+)= A (64 x 16, bf16) B (16 x N, bf16).
// `acc` = 0 overwrites D.
template <bool W8A8, int N>
struct QmMma;

template <>
struct QmMma<true, 16> {
  static __device__ __forceinline__ void run(int (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct QmMma<true, 64> {
  static __device__ __forceinline__ void run(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct QmMma<true, 128> {
  static __device__ __forceinline__ void run(int (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct QmMma<true, 256> {
  static __device__ __forceinline__ void run(int (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct QmMma<false, 16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct QmMma<false, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct QmMma<false, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct QmMma<false, 256> {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// wgmma with both operands in shared memory for a bf16 (K, N) weight tile as
// the A operand: D (64 x N, f32) (+)= A (64 x 16, bf16) B (16 x N, bf16),
// A MN-major (the weight's columns, wgmma's M, run along its stored rows:
// imm-trans-a 1, which the PTX ISA allows for 16-bit types from shared
// memory) and B K-major (the streamed rows). `acc` = 0 overwrites D.
template <int N>
struct BwMma;

template <>
struct BwMma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct BwMma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

__device__ __forceinline__ void acc_fence(int& v) { asm volatile("" : "+r"(v)::"memory"); }
__device__ __forceinline__ void acc_fence(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// Four transposed 8 x 8 matrices of 16-bit elements: lanes 8i..8i+7 give the
// row addresses of matrix i, and lane l receives from matrix i the elements
// (rows 2 (l % 4) and 2 (l % 4) + 1, column l / 4) as one register.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four int8 levels (bytes b0..b3) as bf16 pairs, exactly: lo = (b0, b2),
// hi = (b1, b3). Each byte with its sign bit flipped (b + 128) becomes the
// mantissa of 2^23; subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t r, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = r ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)), 8388736.f);
  lo = pack_bf16(f[0], f[2]);
  hi = pack_bf16(f[1], f[3]);
}

// The A fragments of one K chunk for this warp's 16 weight columns, from
// the stage's swizzled weight tile at shared address `w` (+ the lane's row
// offset `off`, qm_frag_offset): a[kk] for k step kk = 0..3.
template <bool W8A8>
__device__ __forceinline__ void qm_frags(uint32_t w, uint32_t sel_even, uint32_t sel_odd,
                                         uint32_t (&a)[4][4]) {
  if constexpr (W8A8) {
    // k32 step kk: matrices 0 and 1 give each lane k 4q..4q+3 (q = lane %
    // 4) of columns 2g and 2g + 1 (g = lane / 4) as two k pairs; matrices 2
    // and 3 the same 16 k on. The selectors put a column's four bytes in k
    // order: a[0] row g (column 2g), a[1] row g + 8 (column 2g + 1), a[2]
    // and a[3] the same at k + 16.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];
      ldsm_x4_trans(w + kk * 32 * 128, r);
      a[kk][0] = __byte_perm(r[0], r[1], sel_even);
      a[kk][1] = __byte_perm(r[0], r[1], sel_odd);
      a[kk][2] = __byte_perm(r[2], r[3], sel_even);
      a[kk][3] = __byte_perm(r[2], r[3], sel_odd);
    }
  } else {
    // Two k16 steps per ldmatrix.x4: matrix i holds k 8i..8i+7, a lane's
    // register the k pair 2q, 2q + 1 of columns 2g and 2g + 1.
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t r[4];
      ldsm_x4_trans(w + p * 32 * 128, r);
      s8x4_to_bf16(r[0], a[2 * p][0], a[2 * p][1]);
      s8x4_to_bf16(r[1], a[2 * p][2], a[2 * p][3]);
      s8x4_to_bf16(r[2], a[2 * p + 1][0], a[2 * p + 1][1]);
      s8x4_to_bf16(r[3], a[2 * p + 1][2], a[2 * p + 1][3]);
    }
  }
}

// Byte offset of the row this lane addresses in ldmatrix (matrix lane / 8,
// row lane % 8), in column chunk `chunk` (16 bytes) of a swizzled tile of
// 128-byte rows.
template <bool W8A8>
__device__ __forceinline__ uint32_t qm_frag_offset(int lane, int chunk) {
  const int mat = lane >> 3, i = lane & 7;
  const int row = W8A8 ? 16 * (mat >> 1) + 4 * (i >> 1) + (i & 1) + 2 * ((mat & 1) ^ (i >> 2))
                       : 8 * mat + i;
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The values of the four nibbles of packed int4 bytes: the low nibble of
// each byte of `p` sign-extended ((n ^ 8) - 8 a byte, without borrows
// between bytes) and shifted left by e, which is the value times 2^e; each
// product lies in [-64, 56] and so stays exact in its byte. The high
// nibbles are nibbles_lo(p >> 4, e).
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t p, int e) {
  const uint32_t v = __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  return (v << e) & (0x01010101u * ((0xFFu << e) & 0xFFu));
}

// The exponent e of a group shift 2^e (1, 2, 4 or 8,
// models/quantize.py::quantize_weight_int4).
__device__ __forceinline__ int shift_exponent(int8_t s) { return max(__ffs((int)s) - 1, 0); }

// The A fragments of one 128-row group of an int4 weight
// (models/quantize.py's packing: byte row j of the group holds contraction
// row j in its low nibble and row j + 64 in its high one) for this warp's
// 16 weight columns: the packed tile's 64 byte rows are swizzled 128-byte
// rows as an int8 tile's, so qm_frags' row choice and selectors give each
// lane four consecutive byte rows of one column; their low nibbles are k
// steps 0 and 1, their high nibbles k steps 2 and 3, each times the
// column's group shift 2^e (e_even for column 2g, e_odd for 2g + 1).
__device__ __forceinline__ void i4_frags(uint32_t w, uint32_t sel_even, uint32_t sel_odd,
                                         int e_even, int e_odd, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t r[4];
    ldsm_x4_trans(w + kk * 32 * 128, r);
    const uint32_t p[4] = {__byte_perm(r[0], r[1], sel_even), __byte_perm(r[0], r[1], sel_odd),
                           __byte_perm(r[2], r[3], sel_even), __byte_perm(r[2], r[3], sel_odd)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = (i & 1) ? e_odd : e_even;
      a[kk][i] = nibbles_lo(p[i], e);
      a[kk + 2][i] = nibbles_lo(p[i] >> 4, e);
    }
  }
}

// Registers per thread, shared memory per block (static and dynamic, bytes),
// resident blocks per SM, threads per block and local (spill) bytes per
// thread of a kernel launched with `threads` threads and `smem` bytes of
// dynamic shared memory, into out[0..4]. Returns the CUDA error. The
// kernel's dynamic shared memory limit is raised to `smem` where it is
// lower, never lowered: a launcher may remember what it allowed
// (decode_gemm.cuh::dg_allow).
template <typename K>
int kernel_resources(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && (size_t)attr.maxDynamicSharedSizeBytes < smem)
    err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[2] = blocks;
  out[3] = threads;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace
