// flash_attention_fwd: causal attention over full sequences with an online
// softmax, returning the output and the log-sum-exp of every query row.
//
// Replaces: the forward of apertis_llm_tpu/ops/pallas/flash_attention.py::
// flash_attention (_fwd_kernel, _fwd); the backward is flash_attention_bwd.cu.
//
// Layout: q, k, v, out (B, H, L, Dh) bf16, contiguous; lse (B, H, L) f32.
//
// Semantics (flash_attention.py:34-77), per (b, h) and query row i, in f32:
//   s_ij = (q_i . k_j) * Dh^-1/2, masked where j >= L or (causal) i < j
//   online over key tiles: m' = max(m, max_j s_ij); p_ij = exp(s_ij - m');
//     alpha = exp(m - m'); l = l * alpha + sum_j p_ij; acc = acc * alpha + p V
//   l = max(l, 1e-30);  out_i = bf16(acc / l);  lse_i = m + log(l)
// Key tiles wholly above the diagonal are skipped. Differences of order and
// rounding from the TPU kernel, all below a bf16 ulp of the output: q . k is
// the bf16 tensor-core product in f32; the scale is folded into base 2, as
// FlashAttention does: m is kept as max_j (q . k) * (Dh^-1/2 * log2 e) and
// p = 2^(fma(q . k, Dh^-1/2 * log2 e, -m)) on the special-function unit
// (ex2.approx, relative error about 2^-22), lse = (m + log2 l) * ln 2; P V
// runs on the tensor cores with p rounded to bf16 (the TPU kernel keeps p in
// f32), l sums the f32 p. The backward (flash_attention_bwd.cu) recomputes p
// with the same factor: 2^(fma(q . k, Dh^-1/2 * log2 e, -lse * log2 e)).
// Masked scores are -inf rather than -1e30; a row that saw no key (none can:
// key 0 is in every row's first tile) would give out = 0.
//
// Bound on the H100: at L = 1024, B = 4, H = 38, Dh = 64 the function reads
// q, k, v and writes out, 79.7 MB (23.8 us at 3.35 TB/s), and does 20.4 GFLOP
// of causal products (20.6 us at 989 TFLOP/s bf16): bytes by a little, with
// the operations close behind as L grows. Only wgmma reaches that rate, and
// only if S, P and O never leave the registers.
//
// Design (Hopper, sm_90a): the work items are (b * h, 128-row query tile),
// the heaviest tiles first under `causal`. A persistent grid (one block of
// 384 threads an SM) walks them in hopper.cuh::snake_item order, which
// evens out the causal triangle over the SMs and lets one item's loads
// overlap the previous item's last products and epilogue. A block is two
// consumer warpgroups, 64 query rows each, and a producer warpgroup that
// gives its registers to the consumers (setmaxnreg: 40 and 232 a thread).
// - Loads: one producer thread issues TMA loads of each item's Q tile (two
//   buffers; one at DHP 256) and of a ring of K and V tiles (BK key rows;
//   three stages, two at DHP 256), with full and empty mbarriers; the tensor
//   maps are 3-d (Dh, L, B * H), so rows past L and columns past Dh arrive
//   as zeros, and the 128-byte swizzle that the TMA writes is wgmma's
//   canonical layout.
// - Products: S = Q K^T is a wgmma m64nBKk16 per 16 columns of Dh, Q and K
//   read from shared memory K-major (as they are stored). S stays in
//   registers; the online softmax runs in the accumulator's layout (a thread
//   holds two rows, so a row max or sum is two quad shuffles). P is rounded
//   to bf16 in registers and is the register A operand of O += P V, a wgmma
//   m64nDHPk16 per 16 keys with V read MN-major (Dh contiguous) from shared
//   memory. O stays in registers, f32, over all key tiles.
// - Overlap: tile j's S = Q K^T is issued together with tile j-1's O += P V,
//   and tile j's softmax runs while P V is still on the tensor cores; O is
//   rescaled once P V has retired. The two warpgroups take turns to issue
//   (named barriers), so that one's softmax runs while the other's products
//   hold the tensor cores. The first tile is peeled off the loop, so that no
//   branch on the tile index separates a wgmma from its wait (ptxas would
//   serialise every wgmma of the kernel).
// - Masking in registers, on tiles that cross the diagonal or L only. Both
//   warpgroups walk every key tile of an item, so that their turns pair up:
//   at BK 64 warpgroup 0's last tile is wholly masked (p = 0).
// - Dh is padded to DHP = 64, 128 or 256, whole 128-byte swizzle atoms (a
//   32-wide template would need the 64-byte swizzle and its own descriptors
//   for no shape the models use); BK = 128 at DHP 64 and 64 above, so that
//   O (DHP / 2 registers a thread), this tile's S and the previous tile's P
//   fit in 232 registers. Shared memory: 129 KB (DHP 64), 161 KB (128),
//   193 KB (256).

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = kConsumers * kWgRows;   // query rows a block
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory plan for a padded head width DHP: the Q buffers, then K and
// V of each stage, then the barriers; every tile is whole swizzle atoms.
template <int DHP>
struct Plan {
  static constexpr int kBK = DHP == 64 ? 128 : 64;        // key rows a tile
  static constexpr int kStages = DHP == 256 ? 2 : 3;      // K/V ring depth
  static constexpr int kQBufs = DHP == 256 ? 1 : 2;       // Q tiles in flight
  static constexpr uint32_t kQBytes = kBQ * DHP * 2;      // one Q tile
  static constexpr uint32_t kTileBytes = kBK * DHP * 2;   // one of K, V
  static constexpr uint32_t kKV = kQBufs * kQBytes;       // the K/V ring
  static constexpr uint32_t kBar = kKV + 2 * kStages * kTileBytes;
  static constexpr size_t kBytes = kBar + 2 * (kQBufs + kStages) * 8 + 1024;   // + alignment
};

// Online softmax of key tile j (BK keys) in the accumulator layout: this
// thread's scores of rows r0 and r0 + 8 in `sc` (raw q . k) become p; the
// row max m (log2 domain, scores times scale * log2 e) and the row sum l are
// updated, and alpha is the factor for O. Masked scores are -inf; a row max
// stays -inf only while its row has seen no key, and then 0 stands in for
// it, so that no inf - inf arises.
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

template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                     float* __restrict__ lse, int BH, int L, int dh, float scale_log2,
                     int causal) {
  typedef Plan<DHP> P;
  constexpr int BK = P::kBK;
  constexpr int NQ = P::kQBufs;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* q_empty = q_full + NQ;
  uint64_t* full = q_empty + NQ;
  uint64_t* empty = full + kStages;
  auto sQ = [&](int b) { return reinterpret_cast<bf16*>(smem + b * P::kQBytes); };
  auto sK = [&](int s) { return reinterpret_cast<bf16*>(smem + P::kKV + 2 * s * P::kTileBytes); };
  auto sV = [&](int s) { return sK(s) + BK * DHP; };

  const int nqt = (L + kBQ - 1) / kBQ;
  const int total = BH * nqt;
  const int G = gridDim.x;

  if (threadIdx.x == 0) {
    for (int b = 0; b < NQ; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], kConsumers * 128);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // A persistent block: it walks its work items (snake_item) while the
  // producer runs ahead into the next item's Q and K/V tiles, so that one
  // item's loads overlap the previous one's last products and epilogue.
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer warpgroup: one thread keeps the Q buffers and the ring full.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int kv = 0;   // K/V tiles loaded so far
      for (int it = 0;; ++it) {
        const int item = snake_item(it, blockIdx.x, G);
        if (item >= total) break;
        int bh, q0;
        tile_item(item, BH, nqt, causal, kBQ, bh, q0);
        const int qb = it % NQ;
        if (it >= NQ) mbar_wait(&q_empty[qb], (it / NQ - 1) & 1);
        mbar_arrive_tx(&q_full[qb], P::kQBytes);
        tma_load_tile<DHP>(sQ(qb), &q_map, &q_full[qb], kBQ, q0, bh);
        const int num_kb = key_tiles(L, BK, q0, kBQ, causal);
        for (int j = 0; j < num_kb; ++j, ++kv) {
          const int s = kv % kStages;
          if (kv >= kStages) mbar_wait(&empty[s], (kv / kStages - 1) & 1);
          mbar_arrive_tx(&full[s], 2 * P::kTileBytes);
          tma_load_tile<DHP>(sK(s), &k_map, &full[s], BK, j * BK, bh);
          tma_load_tile<DHP>(sV(s), &v_map, &full[s], BK, j * BK, bh);
        }
      }
    }
    return;
  }
  regs_alloc<kConsumerRegs>();

  // Consumers: warpgroup wg owns query rows row_lo..row_lo+63 of each item;
  // this thread rows r0 and r0 + 8 (the accumulator layout, hopper.cuh::
  // to_a_frag). The running max m is kept in the log2 domain (scores times
  // scale * log2 e). Both warpgroups walk every key tile of the item
  // (warpgroup 0's last one may be wholly masked), so that their turns
  // (hopper.cuh::Turns) pair up.
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  float o[DHP / 2], m[2], l[2], alpha[2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];   // P of the previous tile, the A operand of its P V
  int kv = 0;                // K/V tiles consumed so far
  const Turns turns{wg};
  turns.start();
  for (int it = 0;; ++it) {
    const int item = snake_item(it, blockIdx.x, G);
    if (item >= total) break;
    const bool last_item = snake_item(it + 1, blockIdx.x, G) >= total;
    int bh, q0;
    tile_item(item, BH, nqt, causal, kBQ, bh, q0);
    const int num_kb = key_tiles(L, BK, q0, kBQ, causal);
    const int row_lo = q0 + wg * kWgRows;
    const int r0 = row_lo + (tid / 32) * 16 + lane / 4;
    const int qb = it % NQ;
    const bf16* q_tile = sQ(qb);
    auto stage = [&](int j) { return (kv + j) % kStages; };
    auto phase = [&](int j) { return ((kv + j) / kStages) & 1; };
    auto issue_s = [&](int j) {
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk)
        Wgmma<BK>::ss(sc, kmajor_desc(q_tile, kBQ, wg * kWgRows, kk),
                      kmajor_desc(sK(stage(j)), BK, 0, kk), kk > 0);
      wg_commit();
    };
    auto issue_pv = [&](int j) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<DHP>::rs(o, pa[kk], mnmajor_desc(sV(stage(j)), BK, kk, 0), 1);
      wg_commit();
    };

#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    // The first tile alone, then each tile's S = Q K^T issued beside the
    // previous tile's O += P V, so that the softmax overlaps P V. (No branch
    // on the tile index sits between a wgmma and its wait: the compiler
    // would then serialise every wgmma.)
    mbar_wait(&q_full[qb], (it / NQ) & 1);
    mbar_wait(&full[stage(0)], phase(0));
    turns.mine();
    wg_fence();
    issue_s(0);
    turns.theirs(false);
    wg_wait<0>();
    reg_fence(sc);
    online_softmax<BK>(sc, m, l, alpha, 0, L, r0, row_lo, lane, causal, scale_log2);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_a_frag(sc, kk, pa[kk]);
    for (int j = 1; j < num_kb; ++j) {
      mbar_wait(&full[stage(j)], phase(j));
      turns.mine();
      wg_fence();
      issue_s(j);
      issue_pv(j - 1);
      turns.theirs(false);
      wg_wait<1>();
      reg_fence(sc);
      online_softmax<BK>(sc, m, l, alpha, j, L, r0, row_lo, lane, causal, scale_log2);
      wg_wait<0>();
      reg_fence(o);
      mbar_arrive(&empty[stage(j - 1)]);   // the previous tile is done with
#pragma unroll
      for (int i = 0; i < DHP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a_frag(sc, kk, pa[kk]);
    }
    mbar_arrive(&q_empty[qb]);   // every S of this item has retired
    turns.mine();
    wg_fence();
    issue_pv(num_kb - 1);
    turns.theirs(last_item);
    wg_wait<0>();
    reg_fence(o);
    mbar_arrive(&empty[stage(num_kb - 1)]);
    kv += num_kb;

    const size_t base = (size_t)bh * L * dh;
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < DHP / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const int row = r0 + 8 * h;
      const int col = 8 * (i >> 2) + 2 * (lane % 4);
      if (row < L && col < dh)
        *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)row * dh + col) =
            __floats2bfloat162_rn(o[i] / l[h], o[i + 1] / l[h]);
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < L)
          lse[(size_t)bh * L + r0 + 8 * h] = (m[h] + log2f(l[h])) * kLn2;
    }
  }
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int L,
           int dh, int causal, void* stream) {
  typedef Plan<DHP> P;
  CUtensorMap q_map, k_map, v_map;
  int err = make_tile_map(&q_map, q, BH, L, dh, kBQ);
  if (err == 0) err = make_tile_map(&k_map, k, BH, L, dh, P::kBK);
  if (err == 0) err = make_tile_map(&v_map, v, BH, L, dh, P::kBK);
  if (err != 0) return err;
  cudaError_t cerr = allow_smem(flash_fwd_kernel<DHP>, P::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  // Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32, times
  // log2 e (the backward's factor, flash_attention_bwd.cu).
  const float scale_log2 = (float)std::pow((double)dh, -0.5) * kLog2e;
  const int grid = persistent_grid((long long)BH * ((L + kBQ - 1) / kBQ));
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  flash_fwd_kernel<DHP><<<grid, kThreads, P::kBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), static_cast<float*>(lse), BH, L, dh,
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward kernel's resources at head width dh (hopper.cuh::
// kernel_resources); read by apertis_flash_attention_resources.
int flash_fwd_resources(int dh, int* out) {
  if (dh <= 64) return kernel_resources(flash_fwd_kernel<64>, kThreads, Plan<64>::kBytes, out);
  if (dh <= 128) return kernel_resources(flash_fwd_kernel<128>, kThreads, Plan<128>::kBytes, out);
  return kernel_resources(flash_fwd_kernel<256>, kThreads, Plan<256>::kBytes, out);
}

// Attention of BH = B * H (L, dh) matrices; dh a multiple of 8 up to 256.
// Returns cudaGetLastError(), or cudaErrorInvalidResourceHandle if a tensor
// map cannot be made.
extern "C" int apertis_flash_attention_fwd(const void* q, const void* k, const void* v,
                                           void* out, void* lse, int BH, int L, int dh,
                                           int causal, void* stream) {
  if (BH <= 0 || L <= 0 || dh <= 0 || dh % 8 ||
      (long long)BH * ((L + kBQ - 1) / kBQ) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 64) return launch<64>(q, k, v, out, lse, BH, L, dh, causal, stream);
  if (dh <= 128) return launch<128>(q, k, v, out, lse, BH, L, dh, causal, stream);
  if (dh <= 256) return launch<256>(q, k, v, out, lse, BH, L, dh, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
