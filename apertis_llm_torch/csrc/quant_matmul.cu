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
//   (as CUTLASS's mixed-input GEMMs feed a narrow operand). The fragment
//   builders and the wgmma forms (qm_frags, qm_frag_offset, QmMma) live in
//   hopper.cuh, and the ring, its producer, the consumers' loop and the
//   split's exchange in decode_gemm.cuh, one copy shared with the int8
//   decode kernels (ssm_step.cu, ffn_fused.cu); qm_kernel adds the tile
//   walk and the epilogue.
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
//   accumulators and release the stage once they are done; at up to 64
//   rows the next chunk's fragments are built while a chunk's products run
//   (two commit groups in flight), at 128 and 256 rows (128 or 256
//   accumulators a thread) each chunk's products are waited for before the
//   next. The two warpgroups interleave on the tensor cores. There is no
//   branch between a wgmma and its wait. (On the H100 at 2048 x 2432 x 9728 the kernel runs at 39 %
//   of the int8 peak and draws about 4.6 TB/s of tiles from L2, where
//   64-row tiles drew about 7; taking turns between the warpgroups, as the
//   flash kernels do, was tried and changed no time, so neither L2 nor the
//   fragments' build is what holds it.)
// - Tiles: persistent blocks (one of 384 threads an SM) walk the (row tile,
//   column tile) items, row tiles fastest, so that the producer runs ahead
//   into the next tile's loads during the epilogue. At decode rows, where
//   there are too few column tiles for the SMs (N = 2432: 19), K is split
//   over a thread-block cluster of up to 4 blocks: each pushes its
//   accumulators of column block j to block j % split's shared memory
//   (distributed shared memory), and after a cluster barrier that block
//   adds them in rank order and stores them. No atomics: a repeated call
//   gives the same bits. A split pays only while each block keeps 16 or
//   more K chunks: on the H100 (700 W;
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

#include "common.cuh"
#include "decode_gemm.cuh"
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

// ---- #7 and #6 (bf16 x): the Hopper kernel ------------------------------------

constexpr int kQmMaxStages = 8;
constexpr size_t kQmSmemBudget = 200 * 1024;   // the ring and the split's slots

// Shared memory of one ring stage: the x tile (BR rows of 128 bytes: 128
// int8 or 64 bf16 values of K) and the weight tile (a chunk's K rows x 128
// int8 columns), both whole 1024-byte swizzle atoms; with a split, the
// slots of decode_gemm.cuh's exchange.
template <bool W8A8, int BR>
struct QmPlan {
  typedef DgOp<W8A8 ? kDgI8 : kDgBf16> Op;
  static constexpr uint32_t kStage = BR * 128 + Op::kWBytes;
  static int stages(int split) {
    const size_t room = kQmSmemBudget - dg_part_bytes(BR, split);
    return room / kStage < (size_t)kQmMaxStages ? (int)(room / kStage) : kQmMaxStages;
  }
  static size_t bytes(int stages, int split) {
    return dg_smem_bytes(BR, stages, kStage, split, 0);
  }
};


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

  // The tile's columns from n0: the column scales and the bias.
  __device__ __forceinline__ void at(int c, const float* ws, const void* bias) {
    col = c;
    ws0 = col < n ? ws[col] : 0.f;
    ws1 = col + 1 < n ? ws[col + 1] : 0.f;
    b0 = b1 = 0.f;
    if (has_b) {
      if (out_bf16) {
        const bf16* bb = static_cast<const bf16*>(bias);
        if (col < n) b0 = __bfloat162float(bb[col]);
        if (col + 1 < n) b1 = __bfloat162float(bb[col + 1]);
      } else {
        const float* bf = static_cast<const float*>(bias);
        if (col < n) b0 = bf[col];
        if (col + 1 < n) b1 = bf[col + 1];
      }
    }
    pair = col + 1 < n && n % 2 == 0;
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
  typedef typename P::Op::Acc Acc;
  constexpr int kKind = W8A8 ? kDgI8 : kDgBf16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  Acc* part = reinterpret_cast<Acc*>(smem + (size_t)stages * P::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)stages * P::kStage +
                                               dg_part_bytes(BR, split));
  const DgRing ring{smem, bars, bars + stages, BR * 128, P::Op::kWBytes, stages};
  const DgRows rows{x, m, k, tma_x};
  const DgWeight wt{wq, k, n, tma_w};

  const int tiles_m = (m + BR - 1) / BR;
  const int tiles = tiles_m * ((n + kDgCols - 1) / kDgCols);
  const int clusters = gridDim.x / split;
  const int cluster_id = blockIdx.x / split;
  const int rank = blockIdx.x % split;
  const int chunks = (k + P::Op::kKC - 1) / P::Op::kKC;
  const int c_begin = rank * chunks / split;
  const int nch = (rank + 1) * chunks / split - c_begin;
  const DgChunks ch{c_begin, 1, nch, 1};
  dg_init(ring, dg_full_count(rows, wt));
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kDgConsumerThreads) {
    // Producer warpgroup: it runs on round the ring into the next tile's
    // loads while the consumers finish a tile; every thread takes part in
    // the split's cluster barriers.
    regs_dealloc<kDgProducerRegs>();
    const int ptid = threadIdx.x - kDgConsumerThreads;
    int pos = 0;
    for (int t = cluster_id; t < tiles; t += clusters, pos += nch) {
      dg_produce<kKind>(ring, &w_map, nullptr, &x_map, wt, rows, ch, (t / tiles_m) * kDgCols,
                        (t % tiles_m) * BR, 0, nch, ptid, pos);
      if (split > 1) {
        __syncwarp();
        cluster.sync();   // the sums are pushed
        cluster.sync();   // and read
      }
    }
    return;
  }
  regs_alloc<kDgConsumerRegs>();
  const DgLane L(W8A8);
  const uint32_t mine = dg_owned_mask(rank, split, BR / 8);
  int pos = 0;
  for (int t = cluster_id; t < tiles; t += clusters, pos += nch) {
    const int m0 = (t % tiles_m) * BR;
    Acc acc[BR / 2];
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
    dg_consume<kKind, BR>(ring, L, pos, pos + nch, acc);
    // Split K: accumulator column block j is summed, in rank order, and
    // stored by block j % split of the cluster.
    if (split > 1) dg_split_sum<BR>(acc, part, L, rank, split, mine, cluster);
    // The epilogue's state is made here, from the parameters, so that
    // nothing of it stays in registers through the products.
    QmEpilogue epi;
    epi.out = out;
    epi.xs = xs;
    epi.m = m;
    epi.n = n;
    epi.has_b = bias != nullptr;
    epi.out_bf16 = out_bf16 != 0;
    epi.at((t / tiles_m) * kDgCols + L.col, ws, bias);
    const int row0 = m0 + 2 * (L.lane & 3);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      if (!((mine >> j) & 1)) continue;
      epi.put(row0 + 8 * j, acc[4 * j], acc[4 * j + 2]);
      epi.put(row0 + 8 * j + 1, acc[4 * j + 1], acc[4 * j + 3]);
    }
    if (split > 1) cluster.sync();   // no block pushes again until its sums are read
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
                      W8A8 ? 1 : 2, (uint64_t)k, (uint64_t)m, P::Op::kKC, BR);
  if (err == 0 && tma_w)
    err = make_map_2d(&w_map, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)n, (uint64_t)k,
                      kDgCols, P::Op::kKC);
  if (err != 0) return err;
  const int stages = P::stages(split);
  const long long tiles =
      (long long)((m + BR - 1) / BR) * ((n + kDgCols - 1) / kDgCols);
  const int fit = persistent_grid(tiles * split);
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int clusters = fit / split > 0 ? fit / split : 1;
  err = dg_launch(qm_kernel<W8A8, BR>, dim3(clusters * split), dim3(kThreads), split,
                  P::bytes(stages, split), stream, x_map, w_map, x,
                  static_cast<const float*>(xs), static_cast<const int8_t*>(wq),
                  static_cast<const float*>(ws), bias, out, m, n, k, out_bf16, split, tma_x,
                  tma_w, stages);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
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
