// Hopper building blocks of the flash-attention kernels: mbarriers, TMA
// tensor loads, wgmma shared-memory descriptors and the wgmma products
// themselves, in inline PTX (sm_90a). Header-only, in an anonymous namespace
// like common.cuh.
//
// Shared-memory tiles are the 128-byte-swizzled layout that a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: a tile of R rows x (64 * C) bf16 columns
// is C column blocks, block c holding columns 64c..64c+63 of every row as R
// rows of 128 bytes (R * 128 bytes, 1024-byte aligned); inside each group of
// 8 rows (1024 bytes) the 16-byte chunks of row r are permuted by XOR with
// r % 8. wgmma reads such a tile through a descriptor either K-major (the
// product's reduction axis runs along the row: Q and K in Q K^T) or MN-major
// (the reduction axis runs down the rows: V in P V).
#pragma once

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

// A tensor map over BH contiguous (L, dh) bf16 matrices that loads boxes of
// `rows` rows x 64 columns in the 128-byte swizzle; rows past L and columns
// past dh read as zeros. dh a multiple of 8 (16-byte row strides).
inline int make_tile_map(CUtensorMap* map, const void* base, int BH, int L, int dh, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)L * dh * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError;
}

// Load rows [row0, row0 + rows) of matrix bh, all DHP / 64 column blocks,
// into a swizzled tile (the map's box has `rows` rows).
template <int DHP>
__device__ __forceinline__ void tma_load_tile(bf16* tile, const CUtensorMap* map, uint64_t* bar,
                                              int rows, int row0, int bh) {
#pragma unroll
  for (int c = 0; c < DHP / 64; ++c) tma_load_3d(tile + c * rows * 64, map, bar, c * 64, row0, bh);
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

// Registers per thread, shared memory per block (static and dynamic, bytes),
// resident blocks per SM, threads per block and local (spill) bytes per
// thread of a kernel launched with `threads` threads and `smem` bytes of
// dynamic shared memory, into out[0..4]. Returns the CUDA error.
template <typename K>
int kernel_resources(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
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
