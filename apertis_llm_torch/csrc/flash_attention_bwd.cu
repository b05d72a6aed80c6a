// flash_attention_dq / flash_attention_dkv: the backward of causal flash
// attention, recomputing the probabilities from the forward's log-sum-exp.
//
// Replaces: the backward of apertis_llm_tpu/ops/pallas/flash_attention.py::
// flash_attention (_flash_bwd: _dq_kernel and its pallas_call, _dkv_kernel and
// its pallas_call).
//
// Layout: q, k, v, dout, dq, dk, dv (B, H, L, Dh) bf16, contiguous; lse and
// delta = sum_d out * dout (B, H, L) f32.
//
// Semantics (flash_attention.py:131-204), per (b, h), in f32:
//   s_ij = (q_i . k_j) * Dh^-1/2, the forward kernel's own arithmetic: the bf16
//          tensor-core product, then the scale folded into base 2, so that
//          p_ij = 2^(fma(q_i . k_j, Dh^-1/2 * log2 e, -lse_i * log2 e)) is the
//          forward's p (flash_attention.cu), on the special-function unit;
//   p_ij = exp(s_ij - lse_i), 0 where j >= L, i >= L or (causal) i < j;
//   dp_ij = dout_i . v_j;  ds_ij = p_ij * (dp_ij - delta_i) * Dh^-1/2;
//   dq_i = sum_j ds_ij k_j;  dk_j = sum_i ds_ij q_i;  dv_j = sum_i p_ij dout_i.
// Tiles wholly above the diagonal are skipped (the TPU dQ kernel visits them
// and masks them: the same arithmetic). The products run on the tensor cores
// with p and ds rounded to bf16 (the TPU kernels keep them in f32); the sums
// are f32 and the outputs are rounded to bf16 once.
//
// Bound on the H100: operations, by a little. At (4, 38, 1024, 64) the causal
// half costs 3 products (s, dp, dq) in dQ and 4 (s, dp, dv, dk) in dK/dV, 2 Dh
// flops a pair each: 30.6 GFLOP (31 us at 989 TFLOP/s bf16) against 101 MB
// of inputs and outputs (30 us at 3.35 TB/s) in dQ, 40.8 GFLOP (41 us)
// against 121 MB (36 us) in dK/dV.
//
// Design (Hopper, sm_90a), the building blocks of the forward
// (flash_attention.cu, hopper.cuh): persistent blocks (one of 384 threads
// an SM) of two consumer warpgroups and a producer warpgroup (setmaxnreg: 40
// and 232 registers a thread) whose one thread keeps the block's own tiles
// (two items in flight; one at DHP 256 in dQ) and a ring of streamed TMA
// tiles full (128-byte swizzle, rows past L and columns past Dh zero; three
// stages at DHP 64, two above), every product a wgmma with f32 accumulators
// in registers, and every intermediate (S, P, dP, dS) in registers: no
// shared-memory score tiles, no atomics, so results repeat from run to run.
// The split into a dQ kernel and a dK/dV kernel is the TPU kernels'; it
// needs no atomics. The pipelining, turns and peeled first tile are the
// forward's (the comment before the dQ kernel).
// - dQ: items are (b * h, 128 query rows), heaviest first under `causal`;
//   warpgroup w owns 64 of the rows, with their Q and dO tiles and their lse
//   and delta (in registers). Per key tile of BK rows: S = Q K^T and dP =
//   dO V^T (wgmma m64nBK, all operands K-major), dS formed in registers and
//   fed as the register A operand of dQ += dS K (wgmma m64nDHP, K read
//   MN-major). BK = 64, 32 at DHP 256.
// - dK/dV: items are (b * h, key tile), the first key tiles (the heaviest)
//   first, each walking query tiles of BQ rows from the diagonal down; the
//   producer's first warp brings each tile's lse (times log2 e) and delta in
//   beside its Q and dO. Per query tile: S^T = K Q^T and dP^T = V dO^T (A =
//   the item's own K or V rows, B = the streamed tile, both K-major), P^T
//   and dS^T in registers as the A operands of dV += P^T dO and dK += dS^T Q
//   (B read MN-major). Up to DHP 128 each warpgroup owns 64 key rows and all
//   of Dh (BQ = 64 at DHP 64, 32 at 128); at DHP 256 both own the same 64
//   key rows and split Dh (BQ = 32), computing S^T and dP^T twice, so that
//   dK and dV (DHP / 2 registers a thread each, or DHP / 4 at 256) and the
//   tile intermediates fit in 232 registers.
// Shared memory 113-195 KB a block by kernel and DHP. At DHP 256 a few
// values spill to local memory (136 bytes a thread in dQ, 8 in dK/dV); the
// Dh-64 kernels of the models keep everything in registers.

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// dQ: the Q and dO tiles of the block's query rows (kOwnBufs items in
// flight), then K and V of each stage of the ring, then the barriers.
template <int DHP>
struct DqPlan {
  static constexpr int kRows = kConsumers * kWgRows;       // query rows an item
  static constexpr int kBK = DHP == 256 ? 32 : 64;         // key rows a tile
  static constexpr int kStages = DHP == 64 ? 3 : 2;
  static constexpr int kOwnBufs = DHP == 256 ? 1 : 2;
  static constexpr uint32_t kOwnBytes = kRows * DHP * 2;   // one of Q, dO
  static constexpr uint32_t kTileBytes = kBK * DHP * 2;    // one of K, V
  static constexpr uint32_t kRing = kOwnBufs * 2 * kOwnBytes;
  static constexpr uint32_t kBar = kRing + 2 * kStages * kTileBytes;
  static constexpr size_t kBytes = kBar + 2 * (kOwnBufs + kStages) * 8 + 1024;   // + alignment
};

// dK/dV: the K and V tiles of the block's key rows (two items in flight),
// then per stage the Q and dO tiles and their rows' lse and delta, then the
// barriers.
template <int DHP>
struct DkvPlan {
  static constexpr int kSplit = DHP == 256 ? 2 : 1;              // warpgroups per key row
  static constexpr int kRows = kConsumers / kSplit * kWgRows;    // key rows an item
  static constexpr int kCols = DHP / kSplit;                     // dK/dV columns a warpgroup
  static constexpr int kBQ = DHP == 64 ? 64 : 32;                // query rows a tile
  static constexpr int kStages = DHP == 64 ? 3 : 2;
  static constexpr int kOwnBufs = 2;
  static constexpr uint32_t kOwnBytes = kRows * DHP * 2;         // one of K, V
  static constexpr uint32_t kTileBytes = kBQ * DHP * 2;          // one of Q, dO
  static constexpr uint32_t kStage = (2 * kTileBytes + 2 * kBQ * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t kRing = kOwnBufs * 2 * kOwnBytes;
  static constexpr uint32_t kBar = kRing + kStages * kStage;
  static constexpr size_t kBytes = kBar + 2 * (kOwnBufs + kStages) * 8 + 1024;
};

// Both kernels are persistent (a block an SM, walking work items in
// hopper.cuh::snake_item order, heaviest first under `causal`) and pipelined
// alike: per streamed tile t, the two score products of tile t (group A) are
// issued beside the accumulating products of tile t - 1 (group C), and tile
// t's element-wise work runs while group C is still on the tensor cores; the
// two consumer warpgroups take turns to issue (hopper.cuh::Turns), so both
// walk every tile of an item, the few wholly masked ones included. The first
// tile is peeled off the loop, so that no branch on the tile index separates
// a wgmma from its wait (ptxas would serialise every wgmma of the kernel).

template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int BH, int L,
                    int dh, float scale, float scale_log2, int causal) {
  typedef DqPlan<DHP> P;
  constexpr int BK = P::kBK;
  constexpr int NO = P::kOwnBufs;
  constexpr int NS = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* own_empty = own_full + NO;
  uint64_t* full = own_empty + NO;
  uint64_t* empty = full + NS;
  auto sQ = [&](int b) { return reinterpret_cast<bf16*>(smem + 2 * b * P::kOwnBytes); };
  auto sDO = [&](int b) { return sQ(b) + P::kRows * DHP; };
  auto sK = [&](int s) { return reinterpret_cast<bf16*>(smem + P::kRing + 2 * s * P::kTileBytes); };
  auto sV = [&](int s) { return sK(s) + BK * DHP; };

  const int nqt = (L + P::kRows - 1) / P::kRows;
  const int total = BH * nqt;
  const int G = gridDim.x;

  if (threadIdx.x == 0) {
    for (int b = 0; b < NO; ++b) {
      mbar_init(&own_full[b], 1);
      mbar_init(&own_empty[b], kConsumers * 128);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      int kv = 0;
      for (int it = 0;; ++it) {
        const int item = snake_item(it, blockIdx.x, G);
        if (item >= total) break;
        int bh, q0;
        tile_item(item, BH, nqt, causal, P::kRows, bh, q0);
        const int ob = it % NO;
        if (it >= NO) mbar_wait(&own_empty[ob], (it / NO - 1) & 1);
        mbar_arrive_tx(&own_full[ob], 2 * P::kOwnBytes);
        tma_load_tile<DHP>(sQ(ob), &q_map, &own_full[ob], P::kRows, q0, bh);
        tma_load_tile<DHP>(sDO(ob), &do_map, &own_full[ob], P::kRows, q0, bh);
        const int num_kb = key_tiles(L, BK, q0, P::kRows, causal);
        for (int j = 0; j < num_kb; ++j, ++kv) {
          const int s = kv % NS;
          if (kv >= NS) mbar_wait(&empty[s], (kv / NS - 1) & 1);
          mbar_arrive_tx(&full[s], 2 * P::kTileBytes);
          tma_load_tile<DHP>(sK(s), &k_map, &full[s], BK, j * BK, bh);
          tma_load_tile<DHP>(sV(s), &v_map, &full[s], BK, j * BK, bh);
        }
      }
    }
    return;
  }
  regs_alloc<kConsumerRegs>();

  // Consumers: warpgroup wg owns query rows row_lo..row_lo+63 of each item,
  // this thread rows r0 and r0 + 8, with their lse (times log2 e) and delta.
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const Turns turns{wg};
  float acc[DHP / 2], sc[BK / 2], dp[BK / 2];
  uint32_t da[BK / 16][4];   // dS of the previous tile, the A operand of its dQ += dS K
  int kv = 0;
  turns.start();
  for (int it = 0;; ++it) {
    const int item = snake_item(it, blockIdx.x, G);
    if (item >= total) break;
    const bool last_item = snake_item(it + 1, blockIdx.x, G) >= total;
    int bh, q0;
    tile_item(item, BH, nqt, causal, P::kRows, bh, q0);
    const int num_kb = key_tiles(L, BK, q0, P::kRows, causal);
    const int ob = it % NO;
    const int r0 = q0 + wg * kWgRows + (tid / 32) * 16 + lane / 4;
    float row_lse2[2], row_delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      row_lse2[h] = row < L ? lse[(size_t)bh * L + row] * kLog2e : 0.f;
      row_delta[h] = row < L ? delta[(size_t)bh * L + row] : 0.f;
    }
    auto stage = [&](int j) { return (kv + j) % NS; };
    auto issue_a = [&](int j) {   // S = Q K^T, dP = dO V^T
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk)
        Wgmma<BK>::ss(sc, kmajor_desc(sQ(ob), P::kRows, wg * kWgRows, kk),
                      kmajor_desc(sK(stage(j)), BK, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk)
        Wgmma<BK>::ss(dp, kmajor_desc(sDO(ob), P::kRows, wg * kWgRows, kk),
                      kmajor_desc(sV(stage(j)), BK, 0, kk), kk > 0);
      wg_commit();
    };
    auto issue_c = [&](int j) {   // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<DHP>::rs(acc, da[kk], mnmajor_desc(sK(stage(j)), BK, kk, 0), 1);
      wg_commit();
    };
    auto scores = [&](int j) {   // dS in place of S, in f32
      reg_fence(sc);
      reg_fence(dp);
      const int c0 = j * BK + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int row = r0 + 8 * h;
        const int col = c0 + 8 * (i >> 2) + (i & 1);
        const bool valid = row < L && col < L && (!causal || row >= col);
        const float p = valid ? exp2_approx(fmaf(sc[i], scale_log2, -row_lse2[h])) : 0.f;
        sc[i] = __fmul_rn(__fmul_rn(p, dp[i] - row_delta[h]), scale);
      }
    };

#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
    mbar_wait(&own_full[ob], (it / NO) & 1);
    mbar_wait(&full[stage(0)], ((kv) / NS) & 1);
    turns.mine();
    wg_fence();
    issue_a(0);
    turns.theirs(false);
    wg_wait<0>();
    scores(0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_a_frag(sc, kk, da[kk]);
    for (int j = 1; j < num_kb; ++j) {
      mbar_wait(&full[stage(j)], ((kv + j) / NS) & 1);
      turns.mine();
      wg_fence();
      issue_a(j);
      issue_c(j - 1);
      turns.theirs(false);
      wg_wait<1>();
      scores(j);
      wg_wait<0>();
      reg_fence(acc);
      mbar_arrive(&empty[stage(j - 1)]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a_frag(sc, kk, da[kk]);
    }
    mbar_arrive(&own_empty[ob]);   // every product reading Q and dO has retired
    turns.mine();
    wg_fence();
    issue_c(num_kb - 1);
    turns.theirs(last_item);
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(&empty[stage(num_kb - 1)]);
    kv += num_kb;

    const size_t base = (size_t)bh * L * dh;
#pragma unroll
    for (int i = 0; i < DHP / 2; i += 2) {
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane % 4);
      if (row < L && col < dh)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row * dh + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int BH, int L, int dh, float scale,
                     float scale_log2, int causal) {
  typedef DkvPlan<DHP> P;
  constexpr int BQ = P::kBQ;
  constexpr int NC = P::kCols;
  constexpr int NO = P::kOwnBufs;
  constexpr int NS = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + P::kBar);
  uint64_t* own_empty = own_full + NO;
  uint64_t* full = own_empty + NO;
  uint64_t* empty = full + NS;
  auto sK = [&](int b) { return reinterpret_cast<bf16*>(smem + 2 * b * P::kOwnBytes); };
  auto sV = [&](int b) { return sK(b) + P::kRows * DHP; };
  auto stage_at = [&](int s) { return smem + P::kRing + s * P::kStage; };
  auto sQ = [&](int s) { return reinterpret_cast<bf16*>(stage_at(s)); };
  auto sDO = [&](int s) { return reinterpret_cast<bf16*>(stage_at(s) + P::kTileBytes); };
  auto sLse = [&](int s) { return reinterpret_cast<float*>(stage_at(s) + 2 * P::kTileBytes); };
  auto sDelta = [&](int s) { return sLse(s) + BQ; };

  const int nkt = (L + P::kRows - 1) / P::kRows;
  const int nqb = (L + BQ - 1) / BQ;
  const int total = BH * nkt;
  const int G = gridDim.x;
  auto first_tile = [&](int k0) { return causal ? k0 / BQ : 0; };   // none above k0

  if (threadIdx.x == 0) {
    for (int b = 0; b < NO; ++b) {
      mbar_init(&own_full[b], 1);
      mbar_init(&own_empty[b], kConsumers * 128);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 33);   // the TMA thread's expect_tx and the warp's 32 arrivals
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {
    // Producer: the first warp's lane 0 issues the TMA loads, its every lane
    // copies lse (times log2 e) and delta of the tile's rows (0 past L) and
    // arrives; the other three warps only give their registers back.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    int kv = 0;
    for (int it = 0;; ++it) {
      const int item = snake_item(it, blockIdx.x, G);
      if (item >= total) break;
      int bh, k0;
      // The first key tiles, which see the most queries, first.
      tile_item(item, BH, nkt, false, P::kRows, bh, k0);
      const int ob = it % NO;
      if (lane == 0) {
        if (it >= NO) mbar_wait(&own_empty[ob], (it / NO - 1) & 1);
        mbar_arrive_tx(&own_full[ob], 2 * P::kOwnBytes);
        tma_load_tile<DHP>(sK(ob), &k_map, &own_full[ob], P::kRows, k0, bh);
        tma_load_tile<DHP>(sV(ob), &v_map, &own_full[ob], P::kRows, k0, bh);
      }
      for (int qb = first_tile(k0); qb < nqb; ++qb, ++kv) {
        const int s = kv % NS;
        const int row0 = qb * BQ;
        if (kv >= NS) mbar_wait(&empty[s], (kv / NS - 1) & 1);
        if (lane == 0) {
          mbar_arrive_tx(&full[s], 2 * P::kTileBytes);
          tma_load_tile<DHP>(sQ(s), &q_map, &full[s], BQ, row0, bh);
          tma_load_tile<DHP>(sDO(s), &do_map, &full[s], BQ, row0, bh);
        }
        for (int i = lane; i < BQ; i += 32) {
          const int row = row0 + i;
          sLse(s)[i] = row < L ? lse[(size_t)bh * L + row] * kLog2e : 0.f;
          sDelta(s)[i] = row < L ? delta[(size_t)bh * L + row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  regs_alloc<kConsumerRegs>();

  // Consumers: warpgroup wg owns key rows key_lo..key_lo+63 of each item
  // (its own rows of the item's tile, or all of them when the warpgroups
  // split Dh) and dK/dV columns from column block cb0 on; this thread key
  // rows kr and kr + 8.
  const int tid = threadIdx.x % 128;
  const int own_row = P::kSplit == 1 ? wg * kWgRows : 0;
  const int cb0 = P::kSplit == 1 ? 0 : wg * (NC / 64);
  const Turns turns{wg};
  float acc_k[NC / 2], acc_v[NC / 2], st[BQ / 2], dpt[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];   // P^T and dS^T of the previous tile
  int kv = 0;
  turns.start();
  for (int it = 0;; ++it) {
    const int item = snake_item(it, blockIdx.x, G);
    if (item >= total) break;
    const bool last_item = snake_item(it + 1, blockIdx.x, G) >= total;
    int bh, k0;
    tile_item(item, BH, nkt, false, P::kRows, bh, k0);
    const int qb0 = first_tile(k0);
    const int num_t = nqb - qb0;
    const int ob = it % NO;
    const int kr = k0 + own_row + (tid / 32) * 16 + lane / 4;
    auto stage = [&](int t) { return (kv + t) % NS; };
    auto issue_a = [&](int t) {   // S^T = K Q^T, dP^T = V dO^T
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk)
        Wgmma<BQ>::ss(st, kmajor_desc(sK(ob), P::kRows, own_row, kk),
                      kmajor_desc(sQ(stage(t)), BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk)
        Wgmma<BQ>::ss(dpt, kmajor_desc(sV(ob), P::kRows, own_row, kk),
                      kmajor_desc(sDO(stage(t)), BQ, 0, kk), kk > 0);
      wg_commit();
    };
    auto issue_c = [&](int t) {   // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<NC>::rs(acc_v, pa[kk], mnmajor_desc(sDO(stage(t)), BQ, kk, cb0), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        Wgmma<NC>::rs(acc_k, da[kk], mnmajor_desc(sQ(stage(t)), BQ, kk, cb0), 1);
      wg_commit();
    };
    auto scores = [&](int t) {   // P^T over S^T and dS^T over dP^T, in f32
      reg_fence(st);
      reg_fence(dpt);
      const float* tl = sLse(stage(t));
      const float* td = sDelta(stage(t));
      const int row0 = (qb0 + t) * BQ;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int key = kr + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + (i & 1) + 2 * (lane % 4);
        const int qi = row0 + c;
        const bool valid = qi < L && key < L && (!causal || qi >= key);
        const float p = valid ? exp2_approx(fmaf(st[i], scale_log2, -tl[c])) : 0.f;
        dpt[i] = __fmul_rn(__fmul_rn(p, dpt[i] - td[c]), scale);
        st[i] = p;
      }
    };
    auto to_frags = [&]() {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        to_a_frag(st, kk, pa[kk]);
        to_a_frag(dpt, kk, da[kk]);
      }
    };

#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(&own_full[ob], (it / NO) & 1);
    mbar_wait(&full[stage(0)], (kv / NS) & 1);
    turns.mine();
    wg_fence();
    issue_a(0);
    turns.theirs(false);
    wg_wait<0>();
    scores(0);
    to_frags();
    for (int t = 1; t < num_t; ++t) {
      mbar_wait(&full[stage(t)], ((kv + t) / NS) & 1);
      turns.mine();
      wg_fence();
      issue_a(t);
      issue_c(t - 1);
      turns.theirs(false);
      wg_wait<1>();
      scores(t);
      wg_wait<0>();
      reg_fence(acc_v);
      reg_fence(acc_k);
      mbar_arrive(&empty[stage(t - 1)]);
      to_frags();
    }
    mbar_arrive(&own_empty[ob]);   // every product reading this item's K and V has retired
    turns.mine();
    wg_fence();
    issue_c(num_t - 1);
    turns.theirs(last_item);
    wg_wait<0>();
    reg_fence(acc_v);
    reg_fence(acc_k);
    mbar_arrive(&empty[stage(num_t - 1)]);
    kv += num_t;

    const size_t base = (size_t)bh * L * dh;
#pragma unroll
    for (int i = 0; i < NC / 2; i += 2) {
      const int row = kr + 8 * ((i >> 1) & 1);
      const int col = cb0 * 64 + 8 * (i >> 2) + 2 * (lane % 4);
      if (row < L && col < dh) {
        const size_t at = base + (size_t)row * dh + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(acc_k[i], acc_k[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
      }
    }
  }
}

// Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32, and the
// same times log2 e: the forward kernel's factors.
float head_scale(int dh) { return (float)std::pow((double)dh, -0.5); }
float head_scale_log2(int dh) { return head_scale(dh) * kLog2e; }

template <int DHP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int L, int dh, int causal, void* stream) {
  typedef DqPlan<DHP> P;
  CUtensorMap q_map, do_map, k_map, v_map;
  int err = make_tile_map(&q_map, q, BH, L, dh, P::kRows);
  if (err == 0) err = make_tile_map(&do_map, dout, BH, L, dh, P::kRows);
  if (err == 0) err = make_tile_map(&k_map, k, BH, L, dh, P::kBK);
  if (err == 0) err = make_tile_map(&v_map, v, BH, L, dh, P::kBK);
  if (err != 0) return err;
  cudaError_t cerr = allow_smem(flash_dq_kernel<DHP>, P::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = persistent_grid((long long)BH * ((L + P::kRows - 1) / P::kRows));
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  flash_dq_kernel<DHP><<<grid, kThreads, P::kBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), BH, L, dh, head_scale(dh),
      head_scale_log2(dh), causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int L, int dh, int causal,
               void* stream) {
  typedef DkvPlan<DHP> P;
  CUtensorMap k_map, v_map, q_map, do_map;
  int err = make_tile_map(&k_map, k, BH, L, dh, P::kRows);
  if (err == 0) err = make_tile_map(&v_map, v, BH, L, dh, P::kRows);
  if (err == 0) err = make_tile_map(&q_map, q, BH, L, dh, P::kBQ);
  if (err == 0) err = make_tile_map(&do_map, dout, BH, L, dh, P::kBQ);
  if (err != 0) return err;
  cudaError_t cerr = allow_smem(flash_dkv_kernel<DHP>, P::kBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = persistent_grid((long long)BH * ((L + P::kRows - 1) / P::kRows));
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  flash_dkv_kernel<DHP><<<grid, kThreads, P::kBytes, static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, q_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, L,
      dh, head_scale(dh), head_scale_log2(dh), causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int L, int dh) {
  return BH <= 0 || L <= 0 || dh <= 0 || dh % 8 || dh > 256 ||
         (long long)BH * ((L + 63) / 64) > 0x7fffffff;
}

}  // namespace

int flash_fwd_resources(int dh, int* out);                // flash_attention.cu
int flash_f32_resources(int kernel, int dh, int* out);   // flash_attention_f32.cu

// Resources of the flash kernel `kernel` (bf16: 0 forward, 1 dQ, 2 dK/dV;
// f32: 3 forward, 4 dQ, 5 dK/dV) at head width dh: out[0..4] = registers a
// thread, shared memory a block (bytes), resident blocks an SM, threads a
// block, spilled bytes a thread. Returns the CUDA error.
extern "C" int apertis_flash_attention_resources(int kernel, int dh, int* out) {
  if (dh <= 0 || dh % 8 || dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch (kernel) {
    case 0:
      return flash_fwd_resources(dh, out);
    case 1:
      if (dh <= 64) return kernel_resources(flash_dq_kernel<64>, kThreads, DqPlan<64>::kBytes, out);
      if (dh <= 128)
        return kernel_resources(flash_dq_kernel<128>, kThreads, DqPlan<128>::kBytes, out);
      return kernel_resources(flash_dq_kernel<256>, kThreads, DqPlan<256>::kBytes, out);
    case 2:
      if (dh <= 64)
        return kernel_resources(flash_dkv_kernel<64>, kThreads, DkvPlan<64>::kBytes, out);
      if (dh <= 128)
        return kernel_resources(flash_dkv_kernel<128>, kThreads, DkvPlan<128>::kBytes, out);
      return kernel_resources(flash_dkv_kernel<256>, kThreads, DkvPlan<256>::kBytes, out);
    case 3:
    case 4:
    case 5:
      return flash_f32_resources(kernel - 3, dh, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dQ of BH = B * H (L, dh) attentions; dh a multiple of 8 up to 256. Returns
// cudaGetLastError(), or cudaErrorInvalidResourceHandle if a tensor map
// cannot be made.
extern "C" int apertis_flash_attention_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int BH, int L, int dh, int causal,
                                          void* stream) {
  if (bad_shape(BH, L, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, stream);
  if (dh <= 128) return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, stream);
  return launch_dq<256>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, stream);
}

// dK and dV of BH = B * H (L, dh) attentions; dh a multiple of 8 up to 256.
// Returns what apertis_flash_attention_dq returns.
extern "C" int apertis_flash_attention_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int BH, int L,
                                           int dh, int causal, void* stream) {
  if (bad_shape(BH, L, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, stream);
  if (dh <= 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, stream);
  return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, stream);
}
