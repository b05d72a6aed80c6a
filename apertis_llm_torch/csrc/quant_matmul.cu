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
// x (the f32 form, apertis_quant_matmul_f32): TF32 would round x to 10
// mantissa bits, so a row pass (qm_split_kernel) first writes x as three
// bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
// whose sum is x exactly for normal f32 values (8 + 8 + 8 bits of a 24-bit
// significand), and the same kernel multiplies each part by the same exact
// bf16 levels: three products a weight tile, each exact in f32, summed in
// a fresh f32 accumulator a 64-K chunk that is added to the row's sum in
// registers with f32 adds (decode_gemm.cuh's kDgB3; the tensor cores' own
// sum over thousands of terms drifts). Against the plain version's f32
// product (cuBLAS, TF32 off), the sums differ in order only.
//
// quant_matmul_dyn_fused (#8, APERTIS_QUANT_MATMUL=fused): the w8a8 product
// that quantizes x per row and per 512-wide K block [512 j, 512 j + 512)
// (one block when K <= 512):
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
// bf16, three bf16 products for f32 x) from a few hundred rows up, e.g. the
// 1.5B model's prefill FFN at M = 2048; bytes (the int8 weight, K N bytes
// at 3.35 TB/s) at decode row counts, e.g. the int8 LM head (2432 x 32000)
// at every decode step.
//
// Design of #7 and #6 (Hopper, sm_90a): one kernel, qm_kernel, templated on
// the operand kind (int8 x, bf16 x, f32 x as three bf16 parts) and on BR,
// the activation rows of a tile (16 to 128 for f32 x, whose chunk
// accumulators double the consumers' registers).
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
//   next. With f32 x (kDgB3) a stage holds the three parts' tiles beside
//   one weight tile: the chunk's fragments are built once and serve 12
//   wgmma (lo, mid, hi) into a fresh accumulator that is added to the f32
//   sum once they complete (decode_gemm.cuh::dg_consume_b3; two chunks in
//   flight up to 64 rows, one at 128). The two warpgroups interleave on the
//   tensor cores. There is no branch between a wgmma and its wait. (On the H100 at 2048 x 2432 x 9728 the kernel runs at 39 %
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
// Design of #8 (Hopper): two launches.
// 1. fused_quant_kernel, one pass over x: one warp a (row, 512-wide block),
//    the block's 512 values in registers (16 a lane), its absmax by
//    shuffles, the levels and the scale by quant_ffn.cuh's requantization
//    step (the fat MoE FFN's, one device function). It writes x_q (M, Kp)
//    int8, Kp = K padded to whole 128-byte chunks with zeros past K, so that
//    TMA always loads it, and the scales (M, ceil(K / 512)) f32. Every column
//    tile of the product reads these rows; none quantizes x again.
// 2. The product, on the host's plan (ops/kernels/quant_matmul.py::
//    fused_plan): qm_kernel's block-scaled mode (the tile walk and ring of
//    #7, int8 wgmma), with one int32 accumulator a 512-wide block (four
//    chunks) folded into f32 registers after the block's last chunk,
//    acc_f = acc_f + float(acc_i) * s_j[row] in j order (the block's row
//    scales loaded into registers while its products run), then the
//    epilogue x.dtype(acc_f * w_s) (+ b). Its f32 accumulators double the
//    consumers' accumulator registers, so the plan takes row tiles of 16,
//    64 or 128 only. Where the plan splits K over a cluster (64 rows or
//    fewer, few column tiles: w2 at 64 x 9728 x 2432), the product is
//    quant_ffn.cuh's ffn_down_kernel with bn = 512: the blocks of the split
//    fall on whole 512-wide blocks, and each block's term float(acc_j) *
//    s_j reaches its owner, which adds them in j order (the tile-ordered
//    exchange of the FFN's GEMM2, in rounds of `group` blocks).

#include <cooperative_groups.h>
#include <string.h>

#include "common.cuh"
#include "decode_gemm.cuh"
#include "hopper.cuh"
#include "quant_ffn.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kQBlock = 512;   // #8's K block (the TPU kernel's BLOCK_K)
constexpr int kQBlockChunks = kQBlock / kDgKC;

// ---- #7 and #6: the Hopper kernel ----------------------------------------------

constexpr int kQmMaxStages = 8;
constexpr size_t kQmSmemBudget = 200 * 1024;   // the ring and the split's slots

// Shared memory of one ring stage: the x tile (BR rows of 128 bytes: 128
// int8 or 64 bf16 values of K; three of them for f32 x's parts) and the
// weight tile (a chunk's K rows x 128 int8 columns), all whole 1024-byte
// swizzle atoms; with a split, the slots of decode_gemm.cuh's exchange.
template <int kKind, int BR>
struct QmPlan {
  typedef DgOp<kKind> Op;
  static constexpr uint32_t kXBytes = (kKind == kDgB3 ? 3 : 1) * BR * 128;
  static constexpr uint32_t kStage = kXBytes + Op::kWBytes;
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

// The epilogue of one tile from its accumulators' registers: the column
// blocks this block owns (`mine`), each thread's columns col and col + 1 of
// rows row0 + 8 j and row0 + 8 j + 1. Its state is made here, from the
// parameters, so that nothing of it stays in registers through the products.
template <int BR, typename V>
__device__ __forceinline__ void qm_store(const V (&acc)[BR / 2], const DgLane& L, uint32_t mine,
                                         void* out, const float* xs, const float* ws,
                                         const void* bias, int m, int n, int m0, int n0,
                                         int out_bf16) {
  QmEpilogue epi;
  epi.out = out;
  epi.xs = xs;
  epi.m = m;
  epi.n = n;
  epi.has_b = bias != nullptr;
  epi.out_bf16 = out_bf16 != 0;
  epi.at(n0 + L.col, ws, bias);
  const int row0 = m0 + 2 * (L.lane & 3);
#pragma unroll
  for (int j = 0; j < BR / 8; ++j) {
    if (!((mine >> j) & 1)) continue;
    epi.put(row0 + 8 * j, acc[4 * j], acc[4 * j + 2]);
    epi.put(row0 + 8 * j + 1, acc[4 * j + 1], acc[4 * j + 3]);
  }
}

// #7 (kDgI8), #6 with bf16 x (kDgBf16) or with f32 x in three bf16 parts
// (kDgB3: x the (3 part_rows, kx) parts of qm_split_kernel, hi then mid then
// lo), and #8's block-scaled mode (kScaled: int8 x_q rows of
// fused_quant_kernel, `xs` its (M, ceil(K / 512)) block scales, no split).
template <int kKind, int BR, bool kScaled = false>
__global__ void __launch_bounds__(kThreads, 1)
    qm_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map, const void* __restrict__ x,
              const float* __restrict__ xs, const int8_t* __restrict__ wq,
              const float* __restrict__ ws, const void* __restrict__ bias,
              void* __restrict__ out, int m, int n, int k, int out_bf16, int split, int tma_x,
              int tma_w, int stages, int part_rows) {
  typedef QmPlan<kKind, BR> P;
  typedef typename P::Op::Acc Acc;
  constexpr bool W8A8 = kKind == kDgI8;
  static_assert(!kScaled || W8A8, "the block-scaled mode is int8");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  Acc* part = reinterpret_cast<Acc*>(smem + (size_t)stages * P::kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)stages * P::kStage +
                                               dg_part_bytes(BR, split));
  const DgRing ring{smem, bars, bars + stages, P::kXBytes, P::Op::kWBytes, stages};
  DgRows rows{x, m, k, tma_x};
  rows.part_rows = part_rows;
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
    const int m0 = (t % tiles_m) * BR, n0 = (t / tiles_m) * kDgCols;
    if constexpr (kScaled) {
      // Block j's chunks into a fresh int32 accumulator, folded into the
      // f32 one with the block's row scales (loaded while its products run):
      // acc_f = acc_f + float(acc_i) * s_j, each rounded, j increasing.
      const int nb = (k + kQBlock - 1) / kQBlock;
      const int row0 = m0 + 2 * (L.lane & 3);
      float acc_f[BR / 2];
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) acc_f[i] = 0.f;
      for (int j = 0; j < nb; ++j) {
        float s_j[BR / 4];
#pragma unroll
        for (int r = 0; r < BR / 4; ++r) {
          const int row = row0 + 8 * (r / 2) + (r & 1);
          s_j[r] = row < m ? xs[(size_t)row * nb + j] : 0.f;
        }
        int acc[BR / 2];
#pragma unroll
        for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
        const int c0 = j * kQBlockChunks;
        dg_consume<kKind, BR>(ring, L, pos + c0, pos + min(nch, c0 + kQBlockChunks), acc);
#pragma unroll
        for (int i = 0; i < BR / 2; ++i)
          acc_f[i] = __fadd_rn(acc_f[i],
                               __fmul_rn(__int2float_rn(acc[i]), s_j[2 * (i / 4) + (i & 1)]));
      }
      qm_store<BR>(acc_f, L, mine, out, xs, ws, bias, m, n, m0, n0, out_bf16);
    } else {
      Acc acc[BR / 2];
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) acc[i] = 0;
      if constexpr (kKind == kDgB3)
        dg_consume_b3<BR>(ring, L, pos, pos + nch, acc);
      else
        dg_consume<kKind, BR>(ring, L, pos, pos + nch, acc);
      // Split K: accumulator column block j is summed, in rank order, and
      // stored by block j % split of the cluster.
      if (split > 1) dg_split_sum<BR>(acc, part, L, rank, split, mine, cluster);
      qm_store<BR>(acc, L, mine, out, xs, ws, bias, m, n, m0, n0, out_bf16);
      if (split > 1) cluster.sync();   // no block pushes again until its sums are read
    }
  }
}

// A launch of qm_kernel; `kx` is the row length of x (K, or #8's padded Kp,
// or the parts' Kp), `part_rows` the rows of one of f32 x's parts.
template <int kKind, int BR, bool kScaled = false>
int qm_launch(const void* x, const void* xs, const void* wq, const void* ws, const void* bias,
              void* out, int m, int n, int k, int kx, int out_bf16, int split, int tma_x,
              int tma_w, cudaStream_t stream, int part_rows = 0) {
  typedef QmPlan<kKind, BR> P;
  constexpr bool W8A8 = kKind == kDgI8;
  CUtensorMap x_map, w_map;
  memset(&x_map, 0, sizeof(x_map));
  memset(&w_map, 0, sizeof(w_map));
  int err = 0;
  // The maps come from dg_map_2d's cache: a model's linears make the same
  // maps (the same weights, the same scratch) call after call.
  if (tma_x)
    err = dg_map_2d(&x_map, x,
                    W8A8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    W8A8 ? 1 : 2, (uint64_t)kx,
                    (uint64_t)(kKind == kDgB3 ? 3 * part_rows : m), P::Op::kKC, BR);
  if (err == 0 && tma_w)
    err = dg_map_2d(&w_map, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)n, (uint64_t)k,
                    kDgCols, P::Op::kKC);
  if (err != 0) return err;
  const int stages = P::stages(split);
  const long long tiles =
      (long long)((m + BR - 1) / BR) * ((n + kDgCols - 1) / kDgCols);
  const int fit = persistent_grid(tiles * split);
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int clusters = fit / split > 0 ? fit / split : 1;
  err = dg_launch(qm_kernel<kKind, BR, kScaled>, dim3(clusters * split), dim3(kThreads), split,
                  P::bytes(stages, split), stream, x_map, w_map, x,
                  static_cast<const float*>(xs), static_cast<const int8_t*>(wq),
                  static_cast<const float*>(ws), bias, out, m, n, k, out_bf16, split, tma_x,
                  tma_w, stages, part_rows);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// The host's tile plan: BR (rows) 16, 64, 128 or 256; split 1 to 4, and
// only at rows 16 and 64 (the partials' shared memory); TMA flags 0 or 1.
template <int kKind>
int qm_dispatch(const void* x, const void* xs, const void* wq, const void* ws, const void* bias,
                void* out, int m, int n, int k, int out_bf16, int rows, int split, int tma_x,
                int tma_w, cudaStream_t s) {
  if (m <= 0 || n <= 0 || k <= 0 || split < 1 || split > 4 || (split > 1 && rows > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16:
      return qm_launch<kKind, 16>(x, xs, wq, ws, bias, out, m, n, k, k, out_bf16, split, tma_x,
                                 tma_w, s);
    case 64:
      return qm_launch<kKind, 64>(x, xs, wq, ws, bias, out, m, n, k, k, out_bf16, split, tma_x,
                                 tma_w, s);
    case 128:
      return qm_launch<kKind, 128>(x, xs, wq, ws, bias, out, m, n, k, k, out_bf16, split, tma_x,
                                  tma_w, s);
    case 256:
      return qm_launch<kKind, 256>(x, xs, wq, ws, bias, out, m, n, k, k, out_bf16, split, tma_x,
                                  tma_w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kKind, int BR>
int qm_resources(int split, int* out) {
  typedef QmPlan<kKind, BR> P;
  return kernel_resources(qm_kernel<kKind, BR>, kThreads, P::bytes(P::stages(split), split), out);
}

// ---- #6 with f32 x ------------------------------------------------------------

constexpr int kQmPartAlign = 8;   // the parts' row length Kp: K rounded up to 16 bytes

// The rows' three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid) (each difference exact in f32), into `parts` (3, mp,
// kp): part p's row r at (p mp + r) kp; zeros past K and from row m, so
// that TMA loads whole tiles. One thread a 4-value unit (a 16-byte load of
// x where `vec`: K a multiple of 4 and x 16-byte aligned).
__global__ void __launch_bounds__(kBlock) qm_split_kernel(const float* __restrict__ x,
                                                          bf16* __restrict__ parts, int m, int k,
                                                          int mp, int kp, bool vec) {
  const long long u = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int units = kp / 4;
  if (u >= (long long)mp * units) return;
  const int row = (int)(u / units), col = (int)(u % units) * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (row < m) {
    const float* src = x + (size_t)row * k + col;
    if (vec && col + 4 <= k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < k) v[j] = __ldg(src + j);
    }
  }
  uint32_t hi[2], mid[2], lo[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float h[2], md[2], l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = v[2 * j + e];
      h[e] = round_bf16(a);
      const float r1 = __fsub_rn(a, h[e]);
      md[e] = round_bf16(r1);
      l[e] = round_bf16(__fsub_rn(r1, md[e]));
    }
    hi[j] = pack_bf16(h[0], h[1]);
    mid[j] = pack_bf16(md[0], md[1]);
    lo[j] = pack_bf16(l[0], l[1]);
  }
  const size_t o = (size_t)row * kp + col, part = (size_t)mp * kp;
  *reinterpret_cast<uint2*>(parts + o) = make_uint2(hi[0], hi[1]);
  *reinterpret_cast<uint2*>(parts + part + o) = make_uint2(mid[0], mid[1]);
  *reinterpret_cast<uint2*>(parts + 2 * part + o) = make_uint2(lo[0], lo[1]);
}

// The product of the three parts on the plan's row tile (16, 64 or 128).
int qm_f32_product(const bf16* parts, const void* wq, const void* ws, const void* bias,
                   void* out, int m, int n, int k, int kp, int mp, int rows, int split,
                   int tma_w, cudaStream_t s) {
  switch (rows) {
    case 16:
      return qm_launch<kDgB3, 16>(parts, nullptr, wq, ws, bias, out, m, n, k, kp, 0, split, 1,
                                  tma_w, s, mp);
    case 64:
      return qm_launch<kDgB3, 64>(parts, nullptr, wq, ws, bias, out, m, n, k, kp, 0, split, 1,
                                  tma_w, s, mp);
    case 128:
      return qm_launch<kDgB3, 128>(parts, nullptr, wq, ws, bias, out, m, n, k, kp, 0, split, 1,
                                   tma_w, s, mp);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- #8, the w8a8 product that quantizes x per 512-wide K block ---------------

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

// #8's quantization pass, one warp a (row, 512-wide block j): lane l holds
// the block's values 16 l .. 16 l + 15 (zeros past K), the warp's absmax
// gives s_j = requant_scale, and the lane writes its 16 levels (zeros past
// K, whose value is 0) where they lie below the row stride kp; lane 0
// writes s_j into xs (M, nb). `vec`: x's rows are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kBlock) fused_quant_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int m, int k,
    int kp, int nb, bool vec) {
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= m * nb) return;
  const int row = item / nb, j = item - row * nb;
  const int col = j * kQBlock + 16 * lane;
  float v[16];
  load16_f32(x, row, col, m, k, (size_t)k, vec, v);
  float mx = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q) mx = fmaxf(mx, fabsf(v[q]));
  const float s = requant_scale(warp_max(mx));
  if (col < kp)
    *reinterpret_cast<uint4*>(xq + (size_t)row * kp + col) =
        make_uint4(requant_pack4(v[0], v[1], v[2], v[3], s),
                   requant_pack4(v[4], v[5], v[6], v[7], s),
                   requant_pack4(v[8], v[9], v[10], v[11], s),
                   requant_pack4(v[12], v[13], v[14], v[15], s));
  if (lane == 0) xs[(size_t)row * nb + j] = s;
}

// #8's product at a K split: ffn_down_kernel over the 512-wide blocks of
// x_q (M, kp), the block scales xs (M, nb) as the tiles' c_t.
template <int BR>
int fused_down(const int8_t* xq, const float* xs, const void* wq, const float* ws,
               const void* bias, void* out, int m, int n, int k, int kp, int out_bf16, int split,
               int group, int stages, cudaStream_t s) {
  CUtensorMap xm, wm, shm;
  memset(&shm, 0, sizeof(shm));   // no int4 shifts
  int err = make_map_2d(&xm, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kp, m, 128, BR);
  if (err == 0)
    err = make_map_2d(&wm, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k, kDgCols, kDgKC);
  if (err != 0) return err;
  DownArgs a = {};
  a.hs = xs;
  a.w2s = ws;
  a.b2 = bias;
  a.out = out;
  a.rows = m;
  a.n = n;
  a.k = k;
  a.bn = kQBlock;
  a.split = split;
  a.stages = stages;
  a.per = kQBlockChunks;
  a.group = group;
  a.tile_experts = 1;
  a.out_f32 = !out_bf16;
  return dg_launch(ffn_down_kernel<false, BR, kDownBlock>,
                   dim3(((n + kDgCols - 1) / kDgCols) * split, (m + BR - 1) / BR),
                   dim3(kThreads), split,
                   dg_smem_bytes(BR, stages, BR * 128 + kDgW8Bytes, 1,
                                 ffn_down_extra(BR, split, group, 0)),
                   s, xm, wm, shm, a);
}

// #8's product on the plan: qm_kernel's block-scaled mode, or at a split
// ffn_down_kernel.
template <int BR>
int fused_product(const int8_t* xq, const float* xs, const void* wq, const void* ws,
                  const void* bias, void* out, int m, int n, int k, int kp, int out_bf16,
                  int split, int group, int stages, int tma_w, cudaStream_t s) {
  if (split > 1)
    return fused_down<BR>(xq, xs, wq, static_cast<const float*>(ws), bias, out, m, n, k, kp,
                          out_bf16, split, group, stages, s);
  return qm_launch<kDgI8, BR, true>(xq, xs, wq, ws, bias, out, m, n, k, kp, out_bf16, 1, 1,
                                    tma_w, s);
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
  return qm_dispatch<kDgI8>(xq, xs, wq, ws, bias, out, m, n, k, out_bf16, rows, split, tma_x,
                            tma_w, static_cast<cudaStream_t>(stream));
}

// out (M, N) = bf16((x . float(W_q)) * w_s) (+ b) for bf16 x (x_bf16 must
// be 1: f32 x takes apertis_quant_matmul_f32); `bias` is nullptr or (N,)
// bf16. Any M, N, K >= 1, on the tile plan as apertis_quant_matmul_dyn
// takes it. Returns cudaGetLastError(), or cudaErrorInvalidResourceHandle if
// a tensor map cannot be made.
extern "C" int apertis_quant_matmul(const void* x, const void* wq, const void* ws,
                                    const void* bias, void* out, int m, int n, int k, int x_bf16,
                                    int rows, int split, int tma_x, int tma_w, void* stream) {
  if (!x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return qm_dispatch<kDgBf16>(x, nullptr, wq, ws, bias, out, m, n, k, 1, rows, split, tma_x,
                              tma_w, static_cast<cudaStream_t>(stream));
}

// out (M, N) = (x . float(W_q)) * w_s (+ b) in f32 for f32 x (M, K); `bias`
// is nullptr or (N,) f32. Any M, N, K >= 1. `parts` is the caller's bf16
// scratch of 3 x mp x kp values (16-byte aligned): mp = M rounded up to
// `rows`, kp = K rounded up to a multiple of 8. rows (16, 64 or 128), split
// (1 to 4; above 1 only at 16 or 64 rows) and tma_w are the plan of
// ops/kernels/quant_matmul.py::f32_plan. Two launches: the split pass, then
// the product. Returns cudaGetLastError(), or cudaErrorInvalidResourceHandle
// if a tensor map cannot be made.
extern "C" int apertis_quant_matmul_f32(const void* x, const void* wq, const void* ws,
                                        const void* bias, void* out, void* parts, int m, int n,
                                        int k, int rows, int split, int tma_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = (k + kQmPartAlign - 1) / kQmPartAlign * kQmPartAlign;
  const long long mp = rows > 0 ? (long long)(m + rows - 1) / rows * rows : 0;
  if (m <= 0 || n <= 0 || k <= 0 || (rows != 16 && rows != 64 && rows != 128) || split < 1 ||
      split > 4 || (split > 1 && rows > 64) || 3 * mp > 0x7fffffffLL || mp * (kp / 4) > 0x7fffffffLL * kBlock ||
      reinterpret_cast<uintptr_t>(parts) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = mp * (kp / 4);
  qm_split_kernel<<<(unsigned)((units + kBlock - 1) / kBlock), kBlock, 0, s>>>(
      static_cast<const float*>(x), static_cast<bf16*>(parts), m, k, (int)mp, kp,
      k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return qm_f32_product(static_cast<const bf16*>(parts), wq, ws, bias, out, m, n, k, kp,
                        (int)mp, rows, split, tma_w, s);
}

// The resources of #7's (form 1), #6's bf16 (form 0) or #6's f32 (form 2,
// rows 16 to 128) kernel at a tile of `rows` activation rows and a K split
// over `split` blocks (hopper.cuh::kernel_resources): registers a thread,
// shared memory a block, resident blocks an SM, threads a block and spilled
// bytes a thread, into out[0..4]. Returns the CUDA error.
extern "C" int apertis_quant_matmul_resources(int form, int rows, int split, int* out) {
  if (split < 1 || split > 4 || (split > 1 && rows > 64) || form < 0 || form > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16:
      return form == 1 ? qm_resources<kDgI8, 16>(split, out)
                       : form == 0 ? qm_resources<kDgBf16, 16>(split, out)
                                   : qm_resources<kDgB3, 16>(split, out);
    case 64:
      return form == 1 ? qm_resources<kDgI8, 64>(split, out)
                       : form == 0 ? qm_resources<kDgBf16, 64>(split, out)
                                   : qm_resources<kDgB3, 64>(split, out);
    case 128:
      return form == 1 ? qm_resources<kDgI8, 128>(split, out)
                       : form == 0 ? qm_resources<kDgBf16, 128>(split, out)
                                   : qm_resources<kDgB3, 128>(split, out);
    case 256:
      return form == 1 ? qm_resources<kDgI8, 256>(split, out)
                       : form == 0 ? qm_resources<kDgBf16, 256>(split, out)
                                   : static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (M, N) = x.dtype(sum_j float(q_j . W_q[block j]) * s_j * w_s) (+ b), x
// quantized per row and 512-wide K block; bf16 (x_bf16 = 1) or f32 x and
// out, `bias` nullptr or (N,) of x's type. Any M, N, K >= 1. xq (M, Kp)
// int8, Kp = K rounded up to a multiple of 128, and xs (M, ceil(K / 512))
// f32 are scratch the caller allocates (xq 16-byte aligned). rows (16, 64
// or 128), split (1 to 4, whole 512-wide blocks, only at 16 or 64 rows and
// a TMA weight), group and stages (the split's; unused without one) and
// tma_w are the plan of ops/kernels/quant_matmul.py::fused_plan. Returns
// cudaGetLastError(), or cudaErrorInvalidResourceHandle if a tensor map
// cannot be made.
extern "C" int apertis_quant_matmul_dyn_fused(const void* x, const void* wq, const void* ws,
                                              const void* bias, void* out, void* xq, void* xs,
                                              int m, int n, int k, int x_bf16, int rows,
                                              int split, int group, int stages, int tma_w,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (k + kQBlock - 1) / kQBlock, kp = (k + kDgKC - 1) / kDgKC * kDgKC;
  if (m <= 0 || n <= 0 || k <= 0 || split < 1 || split > 4 || split > nb ||
      (split > 1 && (rows > 64 || !tma_w || group < 1 || group > kMaxGroup || stages < 1)) ||
      (long long)m * nb > 0x7fffffffLL - kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 qgrid((unsigned)(((long long)m * nb + kWarps - 1) / kWarps));
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_bf16)
    fused_quant_kernel<bf16><<<qgrid, kBlock, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), m, k, kp,
        nb, aligned && k % 8 == 0);
  else
    fused_quant_kernel<float><<<qgrid, kBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), m, k,
        kp, nb, aligned && k % 4 == 0);
  const cudaError_t qerr = cudaGetLastError();
  if (qerr != cudaSuccess) return static_cast<int>(qerr);
  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* sc = static_cast<const float*>(xs);
  switch (rows) {
    case 16:
      return fused_product<16>(q, sc, wq, ws, bias, out, m, n, k, kp, x_bf16, split, group,
                               stages, tma_w, s);
    case 64:
      return fused_product<64>(q, sc, wq, ws, bias, out, m, n, k, kp, x_bf16, split, group,
                               stages, tma_w, s);
    case 128:
      return fused_product<128>(q, sc, wq, ws, bias, out, m, n, k, kp, x_bf16, split, group,
                                stages, tma_w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The resources of #8's launches (hopper.cuh::kernel_resources) at a row
// tile of `rows` (16, 64 or 128): kernel 0 the quantization pass (bf16 x),
// 1 qm_kernel's block-scaled mode (its own ring), 2 ffn_down_kernel at a
// split with `smem` bytes (16 or 64 rows); into out[0..4].
extern "C" int apertis_quant_matmul_fused_resources(int kernel, int rows, int smem, int* out) {
  if (kernel == 0) return kernel_resources(fused_quant_kernel<bf16>, kBlock, 0, out);
  if (kernel == 2 && (rows == 16 || rows == 64))
    return kernel_resources(rows == 16 ? &ffn_down_kernel<false, 16, kDownBlock>
                                       : &ffn_down_kernel<false, 64, kDownBlock>,
                            kThreads, smem, out);
  if (kernel != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 16:
      return kernel_resources(qm_kernel<kDgI8, 16, true>, kThreads,
                              QmPlan<kDgI8, 16>::bytes(QmPlan<kDgI8, 16>::stages(1), 1), out);
    case 64:
      return kernel_resources(qm_kernel<kDgI8, 64, true>, kThreads,
                              QmPlan<kDgI8, 64>::bytes(QmPlan<kDgI8, 64>::stages(1), 1), out);
    case 128:
      return kernel_resources(qm_kernel<kDgI8, 128, true>, kThreads,
                              QmPlan<kDgI8, 128>::bytes(QmPlan<kDgI8, 128>::stages(1), 1), out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
