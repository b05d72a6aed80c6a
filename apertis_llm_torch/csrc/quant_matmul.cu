// The int8-weight products of serving. The weight is int8 W_q (K, N) in the
// row-major (in, out) layout of the JAX tree, read as it is, with f32 column
// scales w_s (1, N); the bias b (N,) is added in the output type after its
// one rounding, as the JAX package's `_linear` adds it.
//
// quant_matmul_dyn (#7): the w8a8 product with its dequantizing epilogue,
//   out = out_dtype((float)(x_q . W_q) * x_s[m] * w_s[n])  (+ b[n])
// for int8 x_q (M, K) with f32 row scales x_s (M, 1).
// Replaces: apertis_llm_tpu/ops/pallas/quant_matmul.py::quant_matmul_dyn
// (_quant_matmul_dyn_impl, _dyn_kernel:94-110), whose arithmetic is also the
// JAX package's default w8a8 linear (quant_matmul_dyn_xla, used by
// models/apertis.py::_linear under APERTIS_QUANT_MATMUL=dyn). The int32 sums
// are exact; the epilogue multiplies in the order acc * x_s * w_s with
// separate roundings (the _rn intrinsics keep nvcc from contracting them), so
// the result is bit-equal to the plain PyTorch version and to the TPU kernel.
//
// quant_matmul (#6, APERTIS_QUANT_MATMUL=pallas): the weight-only product
//   out = x.dtype((x . float(W_q)) * w_s[n])  (+ b[n])
// for bf16 or f32 x (M, K), f32 accumulation.
// Replaces: quant_matmul.py::quant_matmul (_quant_matmul_impl:59, _kernel:32-47).
// bf16 x: the int8 levels are converted exactly to bf16 (|q| <= 127) and
// multiplied on the tensor cores with f32 accumulators, so every product is
// exact and only the order of the f32 sums differs from the TPU kernel. f32
// x: TF32 would round x to 10 mantissa bits, so the f32 form is a SIMT loop
// of f32 fused multiply-adds (64 x 64 tiles, 4 x 4 outputs a thread), not a
// tensor-core product.
//
// quant_matmul_dyn_fused (#8, APERTIS_QUANT_MATMUL=fused): the w8a8 product
// that quantizes x inside the kernel, per row and per 512-wide K block
// [512 j, 512 j + 512) (one block when K <= 512):
//   s_j = max(max|x[m, block j]|, 1e-8) * (1/127)   (a multiply, not / 127)
//   q   = clip(rint(x / s_j), -127, 127)             (a true division)
//   acc = sum_j float(q_j . W_q[block j]) * s_j      (j increasing, each
//                                                     product and sum rounded)
//   out = x.dtype(acc * w_s[n])  (+ b[n])
// Replaces: quant_matmul.py::quant_matmul_dyn_fused
// (_quant_matmul_dyn_fused_impl:262, _dyn_fused_kernel:231-259). The int32
// block sums are exact and the f32 steps are the TPU kernel's in its order,
// so the result is bit-equal to the plain version.
//
// Bound on the H100: operations (2 M N K at 1,979 TOP/s int8, 989 TFLOP/s
// bf16, 67 TFLOP/s f32) from a few hundred rows up, e.g. the 1.5B model's
// prefill FFN at M = 2048; bytes (the int8 weight, K N bytes at 3.35 TB/s)
// at decode row counts, e.g. the int8 LM head (2432 x 32000) at every decode
// step.
//
// Design of #7 and #6 with bf16 x (Hopper, sm_90a): one kernel, qm_kernel,
// templated on the operand type and on BR, the activation rows of a tile.
// - Swapped operands. Each output tile is computed transposed, out^T = W^T
//   x^T: 128 weight columns (two consumer warpgroups of 64) are wgmma's M
//   side and BR activation rows (16, 64, 128 or 256) its N side, so the same
//   kernel fills the tensor cores at 2048 rows and wastes little at 4 to 64
//   decode rows. x is the B operand, read from shared memory K-major as its
//   rows are stored (int8 K-major is the only int8 B layout wgmma takes).
//   The weight is the A operand, from registers: int8 wgmma takes A K-major
//   only, and the tree's weight tile is N-major, so each warp builds its A
//   fragments from the staged tile with ldmatrix.trans (8 x 8 matrices of
//   16-bit pairs of columns) and byte permutes. For #7 (m64nBRk32, s8), a
//   lane's register must hold four consecutive k of one column: the lane's
//   eight row addresses of each ldmatrix matrix are chosen (k rows {0, 1, 4,
//   5, 10, 11, 14, 15} and {2, 3, 6, 7, 8, 9, 12, 13}) so that the two
//   matrices give the lane k 4q..4q+3 of two columns, and two __byte_perm
//   split them into one register per column; each matrix's rows fall on
//   eight distinct 16-byte chunks of the swizzle, so the reads are free of
//   bank conflicts. A fragment's row 16w + g is weight column 16w + 2g and
//   row 16w + g + 8 is column 16w + 2g + 1, so a lane's accumulators hold
//   two adjacent output columns. For #6 (m64nBRk16, bf16) the k pairs of
//   ldmatrix.trans are the fragment's own, and the int8 levels become bf16
//   exactly in registers: a level's byte (sign flipped) is placed in the
//   mantissa of 2^23, 2^23 + 128 is subtracted, and pairs are packed to bf16
//   (as CUTLASS's mixed-input GEMMs feed a narrow operand).
// - Loads: a producer warpgroup keeps a ring of stages full (3 to 8, as
//   many as ~200 KB of shared memory holds), with full and empty mbarriers.
//   One thread issues 2-d TMA loads of the x tile (BR rows x 128 bytes of K)
//   and the weight tile (128 rows of K for int8, 64 for bf16, x 128
//   columns) in the 128-byte swizzle; rows and columns past the edges arrive
//   as zeros. TMA needs 16-byte row strides, so where K (x) or N (w) breaks
//   that (N = 44, K = 597) the producer's 128 threads stage that operand
//   with their own zero-filling loads in the same swizzled layout and fence
//   it to the async proxy (a variant chosen by shape on the host). The
//   producer gives its registers to the consumers (setmaxnreg 56 / 224).
// - Consumers: per K chunk, wait for the stage, build the A fragments
//   (4 ldmatrix.x4 for int8, 2 for bf16), issue 4 wgmma into the s32 or f32
//   accumulators, wait for them and release the stage; the two warpgroups
//   interleave on the tensor cores. There is no branch between a wgmma and
//   its wait. (On the H100 at 2048 x 2432 x 9728 the kernel runs at 39 %
//   of the int8 peak and draws about 4.6 TB/s of tiles from L2, where
//   64-row tiles drew about 7; taking turns between the warpgroups, as the
//   flash kernels do, was tried and changed no time, so neither L2 nor the
//   fragments' build is what holds it.)
// - Tiles: persistent blocks (one of 384 threads an SM) walk the (row tile,
//   column tile) items, row tiles fastest, so that the producer runs ahead
//   into the next tile's loads during the epilogue. At decode rows, where
//   there are too few column tiles for the SMs (N = 2432: 19), K is split
//   over a thread-block cluster of up to 4 blocks: each writes its
//   accumulators to its shared memory, and after a cluster barrier block r
//   adds, for the accumulator columns j with j % split == r, the blocks'
//   partials in rank order through distributed shared memory and stores
//   them. No atomics: a repeated call gives the same bits. A split pays
//   only while each block keeps 16 or more K chunks: on the H100 (700 W;
//   `chip_smoke.py --qmm`) a split of the MHA QKV's 19 chunks (64 x 2432 x
//   7296) in two took 0.0128 ms against 0.0101 unsplit, one of w2's 76 (64
//   x 9728 x 2432) in four 0.0128 against 0.0234. The host chooses BR, the
//   split and the TMA variant from (M, N, K)
//   (ops/kernels/quant_matmul.py::tile_plan).
// - Epilogue, from the accumulators' registers: #7 (float)acc, * x_s[m],
//   * w_s[n] (each rounded), to the output type, + b in it; #6 acc * w_s[n],
//   to bf16, + b. Adjacent column pairs are stored as one 4-byte (bf16) or
//   8-byte (f32) store where N is even; rows past M and columns past N are
//   not written.
//
// #8 keeps its simple tile: one block of 8 warps per (128 rows, 128 columns)
// of the output, K in chunks of 64, WMMA int8 fragments (m16n16k16, int32
// accumulators); each warp owns a 32 x 64 sub-tile. Both operands are staged
// in shared memory as panels 16 bytes wide (A: four 128-row x 16-k panels,
// B: eight 64-k x 16-column panels), each read with ldm = 16. The next
// chunk's global loads are issued into registers before the current chunk's
// products. #8 first reads its 128 rows of each 512-column block once for the
// row scales (one warp a row, 16 rows a warp), then quantizes x as it stages
// the A panels, and at the end of the block folds the int32 fragments into
// f32 accumulators in registers (through the warp's 16 x 16 staging tile, a
// lane owning 8 columns of one row of each fragment). Any M, N and K is
// taken: rows, columns and k past the operands' edges are staged as zeros.

#include <cooperative_groups.h>
#include <mma.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;

constexpr int kBM = 128;                 // rows per block (#8)
constexpr int kBN = 128;                 // columns per block (#8)
constexpr int kBK = 64;                  // K chunk (#8)
constexpr int kPanelA = kBM * 16;        // bytes of one 16-deep A panel
constexpr int kPanelB = kBK * 16;        // bytes of one 16-wide B panel

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> FragC;

// 16 bytes of row `row` of a (rows, cols) int8 matrix with leading dimension
// `ld`, from column `col`; zeros past the edges. `vec`: cols is a multiple of
// 16 and the base 16-byte aligned, so a 16-byte load is in bounds and aligned.
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ base, int row, int col,
                                       int rows, int cols, size_t ld, bool vec) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  const int8_t* src = base + (size_t)row * ld + col;
  if (vec) return *reinterpret_cast<const int4*>(src);
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (col + j < cols) w[j >> 2] |= (int)(uint8_t)src[j] << (8 * (j & 3));
  return make_int4(w[0], w[1], w[2], w[3]);
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

// ---- #7 and #6 (bf16 x): the Hopper kernel ------------------------------------

constexpr int kQmCols = kConsumers * 64;   // weight (output) columns a tile
constexpr int kQmProducerRegs = 56;
constexpr int kQmConsumerRegs = 224;
constexpr int kQmMaxStages = 8;
constexpr size_t kQmSmemBudget = 200 * 1024;   // the ring and the split-K partials

// Shared memory of one ring stage: the x tile (BR rows of 128 bytes: 128
// int8 or 64 bf16 values of K) and the weight tile (KC rows of K x 128 int8
// columns), both whole 1024-byte swizzle atoms; with a split, the two
// warpgroups' accumulators (BR / 2 registers x 128 threads each).
template <bool W8A8, int BR>
struct QmPlan {
  static constexpr int kKC = W8A8 ? 128 : 64;          // K values a chunk
  static constexpr uint32_t kXBytes = BR * 128;
  static constexpr uint32_t kWBytes = kKC * 128;
  static constexpr uint32_t kStage = kXBytes + kWBytes;
  static constexpr uint32_t kPartial = kConsumers * (BR / 2) * 128 * 4;
  static int stages(int split) {
    const size_t room = kQmSmemBudget - (split > 1 ? kPartial : 0);
    return room / kStage < (size_t)kQmMaxStages ? (int)(room / kStage) : kQmMaxStages;
  }
  static size_t bytes(int stages, int split) {
    return (size_t)stages * kStage + (split > 1 ? kPartial : 0) + 2 * stages * 8 + 1024;
  }
};

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

// The epilogue of one thread: columns col and col + 1 of the output.
struct QmEpilogue {
  void* out;
  const float* xs;   // #7's row scales; unused by #6
  int m, n, col;
  float ws0, ws1, b0, b1;
  bool has_b, pair, out_bf16;

  __device__ __forceinline__ float value(int acc, int row, float wsc) const {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs[row]), wsc);
  }
  __device__ __forceinline__ float value(float acc, int, float wsc) const {
    return __fmul_rn(acc, wsc);
  }

  template <typename Acc>
  __device__ __forceinline__ void put(int row, Acc v0, Acc v1) const {
    if (row >= m || col >= n) return;
    float y0 = value(v0, row, ws0), y1 = value(v1, row, ws1);
    const size_t o = (size_t)row * n + col;
    if (out_bf16) {
      bf16 o0 = __float2bfloat16(y0), o1 = __float2bfloat16(y1);
      if (has_b) {
        o0 = __float2bfloat16(__fadd_rn(__bfloat162float(o0), b0));
        o1 = __float2bfloat16(__fadd_rn(__bfloat162float(o1), b1));
      }
      bf16* p = static_cast<bf16*>(out) + o;
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(o0, o1);
      } else {
        p[0] = o0;
        if (col + 1 < n) p[1] = o1;
      }
    } else {
      if (has_b) {
        y0 = __fadd_rn(y0, b0);
        y1 = __fadd_rn(y1, b1);
      }
      float* p = static_cast<float*>(out) + o;
      if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
      } else {
        p[0] = y0;
        if (col + 1 < n) p[1] = y1;
      }
    }
  }
};

template <bool W8A8, int BR>
__global__ void __launch_bounds__(kThreads, 1)
    qm_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map, const void* __restrict__ x,
              const float* __restrict__ xs, const int8_t* __restrict__ wq,
              const float* __restrict__ ws, const void* __restrict__ bias,
              void* __restrict__ out, int m, int n, int k, int out_bf16, int split, int tma_x,
              int tma_w, int stages) {
  typedef QmPlan<W8A8, BR> P;
  typedef typename std::conditional<W8A8, int, float>::type Acc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* partial = smem + stages * P::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(partial + (split > 1 ? P::kPartial : 0));
  uint64_t* empty = full + stages;
  auto sx = [&](int s) { return smem + s * P::kStage; };
  auto sw = [&](int s) { return smem + s * P::kStage + P::kXBytes; };

  const int tiles_m = (m + BR - 1) / BR;
  const int tiles = tiles_m * ((n + kQmCols - 1) / kQmCols);
  const int clusters = gridDim.x / split;
  const int cluster_id = blockIdx.x / split;
  const int rank = blockIdx.x % split;
  const int chunks = (k + P::kKC - 1) / P::kKC;
  const int c_begin = rank * chunks / split;
  const int c_end = (rank + 1) * chunks / split;
  const bool manual = !(tma_x && tma_w);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], (tma_x || tma_w ? 1 : 0) + (manual ? 128 : 0));
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer warpgroup: thread 0 issues the TMA loads; all 128 threads
    // stage an operand that TMA cannot load. Every thread takes part in the
    // split's cluster barriers.
    regs_dealloc<kQmProducerRegs>();
    const int ptid = threadIdx.x - kConsumers * 128;
    const uint32_t tx = (tma_x ? P::kXBytes : 0) + (tma_w ? P::kWBytes : 0);
    const bool vec_x = (W8A8 ? k % 16 : k % 8) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vec_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
    int stage = 0, round = 0;
    for (int t = cluster_id; t < tiles; t += clusters) {
      const int m0 = (t % tiles_m) * BR;
      const int n0 = (t / tiles_m) * kQmCols;
      if (manual || ptid == 0) {
        for (int c = c_begin; c < c_end; ++c) {
          if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
          const int k0 = c * P::kKC;
          if (ptid == 0 && tx != 0) {
            mbar_arrive_tx(&full[stage], tx);
            if (tma_x) tma_load_2d(sx(stage), &x_map, &full[stage], k0, m0);
            if (tma_w) tma_load_2d(sw(stage), &w_map, &full[stage], n0, k0);
          }
          if (manual) {
            // 16-byte units u: row u / 8, chunk u % 8, at the chunk's
            // swizzled place in its 128-byte row.
            if (!tma_x) {
              unsigned char* dst = sx(stage);
              for (int u = ptid; u < BR * 8; u += 128) {
                const int r = u >> 3, ch = u & 7;
                const int4 v =
                    W8A8 ? load16(static_cast<const int8_t*>(x), m0 + r, k0 + 16 * ch, m, k,
                                  (size_t)k, vec_x)
                         : load8_bf16(static_cast<const bf16*>(x), m0 + r, k0 + 8 * ch, m, k,
                                      (size_t)k, vec_x);
                *reinterpret_cast<int4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) = v;
              }
            }
            if (!tma_w) {
              unsigned char* dst = sw(stage);
              for (int u = ptid; u < P::kKC * 8; u += 128) {
                const int r = u >> 3, ch = u & 7;
                const int4 v = load16(wq, k0 + r, n0 + 16 * ch, k, n, (size_t)n, vec_w);
                *reinterpret_cast<int4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) = v;
              }
            }
            fence_proxy_async();
            mbar_arrive(&full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            ++round;
          }
        }
      }
      if (split > 1) {
        __syncwarp();
        cluster.sync();   // the partials are written
        cluster.sync();   // and read
      }
    }
    return;
  }
  regs_alloc<kQmConsumerRegs>();

  // Consumers: warpgroup wg owns weight columns 64 wg .. 64 wg + 63 of each
  // tile, warp w of it columns 16 w .. 16 w + 15, this lane columns col and
  // col + 1 and the tile's rows 8 j + 2 (lane % 4) + {0, 1}.
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t frag_off = qm_frag_offset<W8A8>(lane, 4 * wg + warp);
  const uint32_t sel_even = (lane & 3) < 2 ? 0x6420u : 0x2064u;
  const uint32_t sel_odd = (lane & 3) < 2 ? 0x7531u : 0x3175u;
  Acc* mine = reinterpret_cast<Acc*>(partial) + wg * (BR / 2) * 128 + tid;
  Acc acc[BR / 2];
  int stage = 0, round = 0;
  for (int t = cluster_id; t < tiles; t += clusters) {
    const int m0 = (t % tiles_m) * BR;
    const int n0 = (t / tiles_m) * kQmCols;
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
    for (int c = c_begin; c < c_end; ++c) {
      mbar_wait(&full[stage], round & 1);
      uint32_t a[4][4];
      qm_frags<W8A8>(smem_u32(sw(stage)) + frag_off, sel_even, sel_odd, a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        QmMma<W8A8, BR>::run(acc, a[kk], sw128_desc(sx(stage) + 32 * kk, 16, 1024), 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) acc_fence(acc[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        ++round;
      }
    }

    QmEpilogue epi;
    epi.out = out;
    epi.xs = xs;
    epi.m = m;
    epi.n = n;
    epi.col = n0 + 64 * wg + 16 * warp + 2 * (lane >> 2);
    epi.ws0 = epi.col < n ? ws[epi.col] : 0.f;
    epi.ws1 = epi.col + 1 < n ? ws[epi.col + 1] : 0.f;
    epi.has_b = bias != nullptr;
    epi.out_bf16 = out_bf16 != 0;
    epi.b0 = epi.b1 = 0.f;
    if (epi.has_b) {
      if (epi.out_bf16) {
        const bf16* bb = static_cast<const bf16*>(bias);
        if (epi.col < n) epi.b0 = __bfloat162float(bb[epi.col]);
        if (epi.col + 1 < n) epi.b1 = __bfloat162float(bb[epi.col + 1]);
      } else {
        const float* bf = static_cast<const float*>(bias);
        if (epi.col < n) epi.b0 = bf[epi.col];
        if (epi.col + 1 < n) epi.b1 = bf[epi.col + 1];
      }
    }
    epi.pair = epi.col + 1 < n && n % 2 == 0;
    const int row0 = m0 + 2 * (lane & 3);
    if (split == 1) {
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        epi.put(row0 + 8 * j, acc[4 * j], acc[4 * j + 2]);
        epi.put(row0 + 8 * j + 1, acc[4 * j + 1], acc[4 * j + 3]);
      }
    } else {
      // Split K: accumulator column block j is summed and stored by block
      // j % split of the cluster, the partials added in rank order.
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) mine[i * 128] = acc[i];
      cluster.sync();
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        if (j % split != rank) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Acc s = 0;
          for (int r = 0; r < split; ++r) s += *cluster.map_shared_rank(mine + (4 * j + e) * 128, r);
          acc[4 * j + e] = s;
        }
        epi.put(row0 + 8 * j, acc[4 * j], acc[4 * j + 2]);
        epi.put(row0 + 8 * j + 1, acc[4 * j + 1], acc[4 * j + 3]);
      }
      cluster.sync();   // no block reuses or leaves its partials while they are read
    }
  }
}

template <bool W8A8, int BR>
int qm_launch(const void* x, const void* xs, const void* wq, const void* ws, const void* bias,
              void* out, int m, int n, int k, int out_bf16, int split, int tma_x, int tma_w,
              cudaStream_t stream) {
  typedef QmPlan<W8A8, BR> P;
  CUtensorMap x_map, w_map;
  memset(&x_map, 0, sizeof(x_map));
  memset(&w_map, 0, sizeof(w_map));
  int err = 0;
  if (tma_x)
    err = make_map_2d(&x_map, x,
                      W8A8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      W8A8 ? 1 : 2, (uint64_t)k, (uint64_t)m, P::kKC, BR);
  if (err == 0 && tma_w)
    err = make_map_2d(&w_map, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)n, (uint64_t)k,
                      kQmCols, P::kKC);
  if (err != 0) return err;
  const int stages = P::stages(split);
  const size_t smem = P::bytes(stages, split);
  cudaError_t cerr = allow_smem(qm_kernel<W8A8, BR>, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long tiles =
      (long long)((m + BR - 1) / BR) * ((n + kQmCols - 1) / kQmCols);
  const int fit = persistent_grid(tiles * split);
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int clusters = fit / split > 0 ? fit / split : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;   // a cluster only where K is split
  cerr = cudaLaunchKernelEx(&cfg, qm_kernel<W8A8, BR>, x_map, w_map, x,
                            static_cast<const float*>(xs), static_cast<const int8_t*>(wq),
                            static_cast<const float*>(ws), bias, out, m, n, k, out_bf16, split,
                            tma_x, tma_w, stages);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

// The host's tile plan: BR (rows) 16, 64, 128 or 256; split 1 to 4, and
// only at rows 16 and 64 (the partials' shared memory); TMA flags 0 or 1.
template <bool W8A8>
int qm_dispatch(const void* x, const void* xs, const void* wq, const void* ws, const void* bias,
                void* out, int m, int n, int k, int out_bf16, int rows, int split, int tma_x,
                int tma_w, cudaStream_t s) {
  if (m <= 0 || n <= 0 || k <= 0 || split < 1 || split > 4 || (split > 1 && rows > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16:
      return qm_launch<W8A8, 16>(x, xs, wq, ws, bias, out, m, n, k, out_bf16, split, tma_x,
                                 tma_w, s);
    case 64:
      return qm_launch<W8A8, 64>(x, xs, wq, ws, bias, out, m, n, k, out_bf16, split, tma_x,
                                 tma_w, s);
    case 128:
      return qm_launch<W8A8, 128>(x, xs, wq, ws, bias, out, m, n, k, out_bf16, split, tma_x,
                                  tma_w, s);
    case 256:
      return qm_launch<W8A8, 256>(x, xs, wq, ws, bias, out, m, n, k, out_bf16, split, tma_x,
                                  tma_w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool W8A8, int BR>
int qm_resources(int split, int* out) {
  typedef QmPlan<W8A8, BR> P;
  return kernel_resources(qm_kernel<W8A8, BR>, kThreads, P::bytes(P::stages(split), split), out);
}

// ---- #6 with f32 x --------------------------------------------------------------

constexpr int kSt = 64;                  // output tile of the f32 form (rows and columns)
constexpr int kSk = 16;                  // K chunk of the f32 form

// #6 with f32 x: a SIMT loop of f32 fused multiply-adds (no TF32), one
// 64 x 64 output tile a block, 4 x 4 outputs a thread, K in chunks of 16.
__global__ void __launch_bounds__(kBlock) quant_matmul_f32_kernel(
    const float* __restrict__ x,     // (M, K)
    const int8_t* __restrict__ wq,   // (K, N)
    const float* __restrict__ ws,    // (N,)
    const float* __restrict__ bias,  // (N,) or nullptr
    float* __restrict__ out,         // (M, N)
    int m, int n, int k) {
  __shared__ float sa[kSk][kSt + 4];   // the x tile, k-major
  __shared__ float sb[kSk][kSt];       // the weight tile as f32
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kSt;
  const int n0 = blockIdx.x * kSt;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += kSk) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = threadIdx.x + it * kBlock;
      const int r = i >> 4, kk = i & 15;            // 16 threads read 16 k of a row
      const int row = m0 + r, kc = k0 + kk;
      sa[kk][r] = (row < m && kc < k) ? x[(size_t)row * k + kc] : 0.f;
      const int kr = k0 + (i >> 6), col = n0 + (i & 63);
      sb[i >> 6][i & 63] = (kr < k && col < n) ? (float)wq[(size_t)kr * n + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[kk][ty * 4 + i];
        b[i] = sb[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (row < m && col < n) {
        float y = __fmul_rn(acc[i][j], ws[col]);
        if (bias != nullptr) y = __fadd_rn(y, bias[col]);
        out[(size_t)row * n + col] = y;
      }
    }
  }
}

// ---- #8, the w8a8 product that quantizes x per 512-wide K block ---------------

constexpr int kQBlock = 512;   // the TPU kernel's K block (quant_matmul.py BLOCK_K)

__device__ __forceinline__ float elem_f32(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float elem_f32(const float* p) { return *p; }

// 16 values of row `row` of a (rows, ld) matrix from column `col` as f32,
// zeros at or past column `col_end` and past the rows. `vec`: 16-byte loads
// are aligned (the row length is a multiple of 16 bytes, the base aligned).
template <typename T>
__device__ __forceinline__ void load16_f32(const T* __restrict__ base, int row, int col,
                                           int rows, int col_end, size_t ld, bool vec,
                                           float (&v)[16]) {
  if (row >= rows) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.f;
    return;
  }
  const T* src = base + (size_t)row * ld + col;
  if (vec && col + 16 <= col_end) {
    __align__(16) T buf[16];
#pragma unroll
    for (int q = 0; q < (int)(16 * sizeof(T) / 16); ++q)
      reinterpret_cast<int4*>(buf)[q] = reinterpret_cast<const int4*>(src)[q];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = elem_f32(buf + j);
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = col + j < col_end ? elem_f32(src + j) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1) quant_matmul_dyn_fused_kernel(
    const T* __restrict__ x,         // (M, K) bf16 or f32
    const int8_t* __restrict__ wq,   // (K, N)
    const float* __restrict__ ws,    // (N,)
    const T* __restrict__ bias,      // (N,) or nullptr
    T* __restrict__ out,             // (M, N)
    int m, int n, int k, bool vec_a, bool vec_b) {
  __shared__ __align__(128) int8_t sa[(kBK / 16) * kPanelA];   // 8 KB
  __shared__ __align__(128) int8_t sb[(kBN / 16) * kPanelB];   // 8 KB
  __shared__ __align__(128) int sc[kWarps][16 * 16];          // 8 KB
  __shared__ float srow[kBM];                                 // the block's row scales
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool live = m0 + wm * 32 < m;
  const int row_frags = live ? min(2, (m - m0 - wm * 32 + 15) / 16) : 0;
  int* stage = sc[warp];
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;

  FragC acc[2][4];
  float facc[2][4][8];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) facc[t][j][q] = 0.f;

  int g_end = 0;
  int4 ra[2], rb[2];
  // A items are quantized as they are fetched, with the block's row scales.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = threadIdx.x + it * kBlock;
      const int r = i >> 2;
      float v[16];
      load16_f32(x, m0 + r, k0 + (i & 3) * 16, m, g_end, (size_t)k, vec_a, v);
      const float s = srow[r];
      int w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j >> 2] |= (int)(uint8_t)quant_level(__fdiv_rn(v[j], s)) << (8 * (j & 3));
      ra[it] = make_int4(w[0], w[1], w[2], w[3]);
      rb[it] = load16(wq, k0 + (i >> 3), n0 + (i & 7) * 16, k, n, (size_t)n, vec_b);
    }
  };
  for (int g0 = 0; g0 < k; g0 += kQBlock) {
    g_end = min(k, g0 + kQBlock);
    __syncthreads();  // the previous block's fold has read srow
    // Row scales: one warp a row, lanes over the block's columns.
    for (int rr = 0; rr < kBM / kWarps; ++rr) {
      const int r = warp * (kBM / kWarps) + rr;
      const int row = m0 + r;
      float mx = 0.f;
      if (row < m)
        for (int col = g0 + lane; col < g_end; col += 32)
          mx = fmaxf(mx, fabsf(elem_f32(x + (size_t)row * k + col)));
      mx = warp_max(mx);
      if (lane == 0) srow[r] = row < m ? __fmul_rn(fmaxf(mx, 1e-8f), 1.f / 127.f) : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[t][j], 0);
    const int c1 = (g_end + kBK - 1) / kBK;
    fetch(g0);
    for (int c = g0 / kBK; c < c1; ++c) {
      __syncthreads();  // the previous chunk has been consumed
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int i = threadIdx.x + it * kBlock;
        *reinterpret_cast<int4*>(sa + (i & 3) * kPanelA + (i >> 2) * 16) = ra[it];
        *reinterpret_cast<int4*>(sb + (i & 7) * kPanelB + (i >> 3) * 16) = rb[it];
      }
      __syncthreads();
      if (c + 1 < c1) fetch((c + 1) * kBK);
      if (row_frags == 0) continue;
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        FragB fb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], sb + (wn * 4 + j) * kPanelB + s * 256, 16);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t >= row_frags) break;
          FragA fa;
          wmma::load_matrix_sync(fa, sa + s * kPanelA + (wm * 32 + t * 16) * 16, 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[t][j], fa, fb[j], acc[t][j]);
        }
      }
    }
    // acc += float(block sum) * s_row, each product and sum rounded.
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < row_frags) {
        const float s = srow[wm * 32 + t * 16 + er];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(stage, acc[t][j], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int q = 0; q < 8; ++q)
            facc[t][j][q] = __fadd_rn(facc[t][j][q],
                                      __fmul_rn((float)stage[er * 16 + ec + q], s));
          __syncwarp();
        }
      }
    }
  }

  // Epilogue: out = x.dtype(acc * w_s) (+ b).
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int row = m0 + wm * 32 + t * 16 + er;
    if (t < row_frags && row < m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col0 = n0 + wn * 64 + j * 16 + ec;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = col0 + q;
          if (col < n) {
            T o = from_f32<T>(__fmul_rn(facc[t][j][q], ws[col]));
            if (bias != nullptr) o = from_f32<T>(__fadd_rn(to_f32(o), to_f32(bias[col])));
            out[(size_t)row * n + col] = o;
          }
        }
      }
    }
  }
}

}  // namespace

// out (M, N) = round(acc * x_s * w_s) (+ b) in bf16 (out_bf16 = 1) or f32;
// `bias` is nullptr or (N,) of the output's type. Any M, N, K >= 1. `rows`,
// `split`, `tma_x` and `tma_w` are the host's tile plan
// (ops/kernels/quant_matmul.py::tile_plan): the activation rows of a tile
// (16, 64, 128 or 256), the blocks of a cluster that split K (1 to 4; above
// 1 only at 16 or 64 rows), and whether x and W_q are loaded by TMA (their
// row strides multiples of 16 bytes, their bases 16-byte aligned). Returns
// cudaGetLastError(), or cudaErrorInvalidResourceHandle if a tensor map
// cannot be made.
extern "C" int apertis_quant_matmul_dyn(const void* xq, const void* xs, const void* wq,
                                        const void* ws, const void* bias, void* out, int m,
                                        int n, int k, int out_bf16, int rows, int split,
                                        int tma_x, int tma_w, void* stream) {
  return qm_dispatch<true>(xq, xs, wq, ws, bias, out, m, n, k, out_bf16, rows, split, tma_x,
                           tma_w, static_cast<cudaStream_t>(stream));
}

// out (M, N) = x.dtype((x . float(W_q)) * w_s) (+ b) for bf16 (x_bf16 = 1)
// or f32 x and out; `bias` is nullptr or (N,) of x's type. Any M, N, K >= 1.
// bf16 x takes the tile plan as apertis_quant_matmul_dyn does; f32 x ignores
// it, and its row count is at most 65535 * 64. Returns cudaGetLastError(),
// or cudaErrorInvalidResourceHandle if a tensor map cannot be made.
extern "C" int apertis_quant_matmul(const void* x, const void* wq, const void* ws,
                                    const void* bias, void* out, int m, int n, int k, int x_bf16,
                                    int rows, int split, int tma_x, int tma_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return qm_dispatch<false>(x, nullptr, wq, ws, bias, out, m, n, k, 1, rows, split, tma_x,
                              tma_w, s);
  if (m <= 0 || n <= 0 || k <= 0 || (m + kSt - 1) / kSt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  quant_matmul_f32_kernel<<<dim3((n + kSt - 1) / kSt, (m + kSt - 1) / kSt), kBlock, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<const float*>(bias), static_cast<float*>(out),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// The resources of #7's (w8a8 = 1) or #6's bf16 (w8a8 = 0) kernel at a
// tile of `rows` activation rows and a K split over `split` blocks
// (hopper.cuh::kernel_resources): registers a thread, shared memory a
// block, resident blocks an SM, threads a block and spilled bytes a thread,
// into out[0..4]. Returns the CUDA error.
extern "C" int apertis_quant_matmul_resources(int w8a8, int rows, int split, int* out) {
  if (split < 1 || split > 4 || (split > 1 && rows > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16: return w8a8 ? qm_resources<true, 16>(split, out) : qm_resources<false, 16>(split, out);
    case 64: return w8a8 ? qm_resources<true, 64>(split, out) : qm_resources<false, 64>(split, out);
    case 128:
      return w8a8 ? qm_resources<true, 128>(split, out) : qm_resources<false, 128>(split, out);
    case 256:
      return w8a8 ? qm_resources<true, 256>(split, out) : qm_resources<false, 256>(split, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (M, N) = x.dtype(sum_j float(q_j . W_q[block j]) * s_j * w_s) (+ b), x
// quantized per row and 512-wide K block in the kernel; bf16 (x_bf16 = 1) or
// f32 x and out, `bias` nullptr or (N,) of x's type. Any M, N, K >= 1; the
// row count is at most 65535 * 128. Returns cudaGetLastError().
extern "C" int apertis_quant_matmul_dyn_fused(const void* x, const void* wq, const void* ws,
                                              const void* bias, void* out, int m, int n, int k,
                                              int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = n % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  if (x_bf16)
    quant_matmul_dyn_fused_kernel<bf16><<<grid, kBlock, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(ws), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
        m, n, k, aligned && k % 8 == 0, vec_b);
  else
    quant_matmul_dyn_fused_kernel<float><<<grid, kBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(ws), static_cast<const float*>(bias),
        static_cast<float*>(out), m, n, k, aligned && k % 4 == 0, vec_b);
  return static_cast<int>(cudaGetLastError());
}
