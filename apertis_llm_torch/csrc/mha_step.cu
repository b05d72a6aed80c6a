// mha_decode_ctx: decode attention of one query per row over one layer of
// the flat KV cache, plus the fresh token's self-term.
//
// Replaces: apertis_llm_tpu/ops/pallas/mha_step.py::mha_decode_ctx, with a
// bf16 cache (apertis_mha_decode_ctx) and an int8 cache with f32
// per-(head, slot) scales (apertis_mha_decode_ctx_int8), and their f32
// forms (apertis_mha_decode_ctx_f32: f32 q, k_new, v_new and output over an
// f32 cache, or over an int8 cache with its scales), which the TPU kernel
// serves by taking the cache as it is (mha_step.py:131) and writing q's
// dtype. The f32 forms are the same kernel instantiated on f32: q is scaled
// without a rounding, a 16-byte chunk of the cache holds 4 values instead
// of 8, and the output is f32.
//
// Layout: q, k_new, v_new (B, D) bf16 with D = H * Dh; the cache k, v
// (B, L, D), slot l of row b holding the head-flat projection row, so one
// head of one slot is Dh contiguous values; bias (B, L) f32 additive (0 or
// -1e30); the int8 scales ks, vs (B, H, L).
//
// Semantics (mha_step.py:54-127, 146-215), per row b and head h, in f32:
//   qs = bf16(q * Dh^-1/2)                       (rounded back to q's type)
//   s_self = sum_d qs * k_new
//   bf16:  s_l = sum_d qs * k[l]
//   int8:  qscale = max(max|qs|, 1e-8) * (1/127); qi = clip(rint(qs / qscale))
//          s_l = f32(int32 sum_d qi * k[l]) * (ks[l] * qscale)
//   s_l += bias[l];  m = max(max_l s_l, s_self)
//   p_l = exp(s_l - m);  p_self = exp(s_self - m);  denom = sum p_l + p_self
//   int8:  p_l *= vs[l]
//   out = bf16((sum_l p_l * v[l] + p_self * v_new) * (1 / denom))
// The masked stale slot still gets a score, but its p is exactly 0.
//
// Bound on the H100: bytes. Every score reads a whole K head of one slot and
// the context a whole V head, so the kernel streams the layer's cache once:
// 2 * B * L * D bytes in bf16 (59.8 MB at B = 64, L = 96 of the 1.5B model,
// 17.8 us at 3.35 TB/s), half that plus the scales in int8. Its FLOPs (4 per
// cached element) are far below the tensor-core line, so the levers are the
// bytes in flight and the SMs in use.
//
// Design (a split over slots, warps streaming tiles through shared memory):
// - Each (row, head) takes `split` blocks of four warps (the plan:
//   ops/kernels/mha_step.py::mha_plan), block r of them the contiguous slots
//   [r * L / split, (r + 1) * L / split), and each warp a contiguous quarter
//   of its block's: one block where B * H blocks fill the card or L is
//   short, up to 16 at batch 1 over a long cache (B = 1, H = 11, L = 2048:
//   16 blocks a head, 176 in all).
// - Each warp streams its slots in tiles of kTile slots (about 1 KB of K
//   heads, 2 KB in f32, as much of V, the bias and, int8, the scales) by
//   16-byte cp.async copies into a ring of its own, `stages` stages (the
//   plan's: its tiles, within a shared-memory budget a block), and waits on
//   its own copies: no block barrier until the combine. q, k_new and v_new
//   are read before the copies are issued, so that they do not queue
//   behind them.
// - A tile's scores: kGroup lanes a slot, each dotting the slot's 16-byte
//   chunks g, g + kGroup, ... with q held in registers (f32 FMAs; __dp4a on
//   the packed int8 q for an int8 cache, an exact int32 sum), summed over
//   the group by shuffles. The group's chunks are contiguous across a
//   quarter warp, or the slots' rows fall on distinct banks (Dh * bytes is
//   an odd multiple of the group's span), so the reads are free of bank
//   conflicts with no padding.
// - Where the ring holds all of a warp's tiles, every score of them, one
//   max, the probabilities (int8: times vs) and the context; else an online
//   softmax over the tiles: the running max, sum and context rescaled by
//   exp(m_old - m_new) a tile, stages - 1 tiles in flight while one is
//   computed.
// - The context: lane (r, c) owns 16-byte chunk c (and c + 32, ...) of the V
//   head over slots r, r + kCtxRows, ..., read conflict-free (consecutive
//   lanes, consecutive chunks); the rows' partials are added in row order
//   at the end. Shared memory does not grow with L past the budget.
// - The combine: the `split` blocks of one (row, head) are one thread-block
//   cluster (more than 8: the non-portable size); each warp pushes its max,
//   sum and unnormalised context into rank 0's shared memory (distributed
//   shared memory), and after a cluster barrier rank 0 adds the 4 x split
//   parts in (rank, warp) order with weights exp(m_p - m), m = max(m_p...,
//   s_self), plus the self-term, and writes the output. Every sum runs in a
//   fixed order, so results repeat bit for bit. A part whose slots are all
//   masked adds exactly 0 (exp(-1e30 - m) is 0), as a part without slots
//   does (m_p = -inf); a row whose cache is all masked gives v_new.

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarpsHere = kThreads / 32;
constexpr int kStages = 8;            // ring stages a warp at most
constexpr int kMaxSplit = 16;         // blocks a (row, head): a non-portable cluster above 8
constexpr size_t kSmemLimit = 232448;

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// The tile geometry of one instance (ops/kernels/mha_step.py::mha_tile,
// mha_stages and mha_smem compute the same).
template <int DH, typename CacheT, bool QUANT>
struct Geo {
  static constexpr int kRowBytes = DH * (int)sizeof(CacheT);   // a slot's head
  static constexpr int kChunks = kRowBytes / 16;               // its 16-byte chunks
  static constexpr int kGroup = (kChunks & -kChunks) > 32 ? 32 : (kChunks & -kChunks);
  static constexpr int kPerLane = kChunks / kGroup;            // score chunks a lane
  static constexpr int kVals = 16 / (int)sizeof(CacheT);       // values a chunk
  static constexpr int kSlotsPass = 32 / kGroup;               // score slots a pass
  // Context: lane (r, c) takes chunk c (and c + 32, ...) of slots r, r +
  // kCtxRows, ...
  static constexpr int kCtxRows = kChunks <= 32 ? 32 / kChunks : 1;
  static constexpr int kCtxChunks = kChunks <= 32 ? 1 : (kChunks + 31) / 32;
  // About 1 KB of K heads a warp's tile (2 KB of f32), at least one score
  // pass.
  static constexpr int kTileBytes = sizeof(CacheT) == 4 ? 2048 : 1024;
  static constexpr int kTile = pow2_floor(kTileBytes / kRowBytes) > kSlotsPass
                                   ? pow2_floor(kTileBytes / kRowBytes) : kSlotsPass;
  static constexpr int kPasses = kTile / kSlotsPass;
  static constexpr int kScal = round16(kTile * 4);             // bytes of a tile's bias (or scales)
  static constexpr int kStageBytes = 2 * kTile * kRowBytes + (QUANT ? 3 : 1) * kScal;
  // A warp's region: the scores and probabilities of the slots its ring
  // holds, the scaled q (and its int8 levels), then its ring of `stages`
  // stages (the plan's: mha_step.py::mha_plan).
  __host__ __device__ static int sq_off(int stages) { return round16(stages * kTile * 4); }
  __host__ __device__ static int ring_off(int stages) {
    return sq_off(stages) + DH * 4 + (QUANT ? DH : 0);
  }
  // Shared memory: rank 0's combine slots (max and sum, then the context,
  // of each of the cluster's split x 4 warps), then each warp's region.
  __host__ __device__ static size_t comb_bytes(int split) {
    return (size_t)round16(split * kWarpsHere * (2 + DH) * 4);
  }
  __host__ __device__ static size_t warp_bytes(int stages) {
    return ring_off(stages) + (size_t)stages * kStageBytes;
  }
  __host__ __device__ static size_t smem(int split, int stages) {
    return comb_bytes(split) + kWarpsHere * warp_bytes(stages);
  }
  static_assert(kChunks >= 2 && kChunks <= 64, "a head of 32 to 1024 bytes");
  static_assert(kTile % kSlotsPass == 0, "whole score passes a tile");
  // The context partials (kCtxRows x DH floats) reuse the warp's ring.
  static_assert(kCtxRows * DH * 4 <= kStageBytes, "partials fit one stage");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Wait until at most `n` (0 to 7) of the newest groups are pending.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// A cluster barrier in halves: every thread of the cluster's blocks arrives
// (relaxed at the start, where nothing is to be published; with release
// semantics after the pushes) and later waits (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The values of a 16-byte chunk as floats: 16 int8 levels (exactly, by the
// 2^23 + 128 bias trick: a byte permute and a subtraction each), 8 bf16 or
// 4 f32 values.
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = words[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}

// q's value rounded to q's dtype T (bf16), or as it is (f32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, bf16>::value) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// Eight blocks an SM (64 registers a thread) where the heads allow it: rows
// that fill the card keep a block within MHA_FULL_SMEM for that.
template <int DH, bool QUANT, typename T>
__global__ void __launch_bounds__(kThreads, DH <= 128 ? 8 : 6) mha_split_kernel(
    const T* __restrict__ q, const void* __restrict__ kc, const void* __restrict__ vc,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const float* __restrict__ bias, const float* __restrict__ ks,
    const float* __restrict__ vs, T* __restrict__ out, int L, int H, int split, int stages,
    float scale) {
  typedef typename std::conditional<QUANT, int8_t, T>::type CacheT;
  typedef Geo<DH, CacheT, QUANT> G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int parts = split * kWarpsHere;
  float* comb = reinterpret_cast<float*>(smem);   // [m, l] x parts, then parts x DH
  unsigned char* mine = smem + G::comb_bytes(split) + warp * G::warp_bytes(stages);
  float* sp = reinterpret_cast<float*>(mine);
  float* sq = reinterpret_cast<float*>(mine + G::sq_off(stages));
  int8_t* sqi = reinterpret_cast<int8_t*>(mine + G::sq_off(stages) + DH * 4);
  unsigned char* ring = mine + G::ring_off(stages);

  const int rank = blockIdx.x % split;
  const int bh = blockIdx.x / split;
  const int b = bh / H;
  const int h = bh % H;
  const int d_model = H * DH;
  // This block's slots, then this warp's contiguous part of them.
  const int b_start = (int)((long long)rank * L / split);
  const int b_n = (int)((long long)(rank + 1) * L / split) - b_start;
  const int start = b_start + warp * b_n / kWarpsHere;
  const int end = b_start + (warp + 1) * b_n / kWarpsHere;
  const int n = end - start;
  const int tiles = (n + G::kTile - 1) / G::kTile;
  const size_t head0 = (size_t)b * d_model + (size_t)h * DH;
  const size_t row_bytes = (size_t)d_model * sizeof(CacheT);   // one slot of the cache
  const char* kbase = static_cast<const char*>(kc) +
                      ((size_t)b * L * d_model + (size_t)h * DH) * sizeof(CacheT);
  const char* vbase = static_cast<const char*>(vc) +
                      ((size_t)b * L * d_model + (size_t)h * DH) * sizeof(CacheT);
  const float* brow = bias + (size_t)b * L;
  const size_t srow = ((size_t)b * H + h) * L;   // row of ks / vs

  // Matched by the wait before the push into rank 0: every block of the
  // cluster has started by then.
  if (split > 1) cluster_arrive_relaxed();

  // q, k_new and (rank 0) v_new first: loads issued after the tiles' copies
  // would queue behind them, and the scores wait for q. Each warp takes q
  // for itself (the other warps' reads hit L1).
  constexpr int kQ = (DH + 31) / 32;
  float qv[kQ], kv[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int d = lane + 32 * k;
    qv[k] = d < DH ? to_f32(q[head0 + d]) : 0.f;
    kv[k] = d < DH ? to_f32(k_new[head0 + d]) : 0.f;
  }
  constexpr int kOuts = (DH + kThreads - 1) / kThreads;
  float vn[kOuts];
#pragma unroll
  for (int k = 0; k < kOuts; ++k) {
    const int d = tid + k * kThreads;
    vn[k] = rank == 0 && d < DH ? to_f32(v_new[head0 + d]) : 0.f;
  }

  // Tile t of this warp's slots into its stage, by the warp's lanes: the K
  // and V heads, the bias and (int8) the scales.
  auto load_tile = [&](int t) {
    unsigned char* st = ring + (t % stages) * G::kStageBytes;
    const int base = start + t * G::kTile;
    const int cnt = min(G::kTile, end - base);
    for (int x = lane; x < cnt * G::kChunks; x += 32) {
      const int i = x / G::kChunks;
      const int c = x - i * G::kChunks;
      const size_t off = (size_t)(base + i) * row_bytes + c * 16;
      cp_async16(st + i * G::kRowBytes + c * 16, kbase + off);
      cp_async16(st + (G::kTile + i) * G::kRowBytes + c * 16, vbase + off);
    }
    float* sc = reinterpret_cast<float*>(st + 2 * G::kTile * G::kRowBytes);
    for (int x = lane; x < cnt; x += 32) {
      cp_async4(sc + x, brow + base + x);
      if constexpr (QUANT) {
        cp_async4(sc + G::kScal / 4 + x, ks + srow + base + x);
        cp_async4(sc + 2 * G::kScal / 4 + x, vs + srow + base + x);
      }
    }
  };
  // Every tile where the ring holds them all; else stages - 1 in flight
  // while one is computed.
  const bool streamed = tiles > stages;
  const int ahead = streamed ? stages - 1 : tiles;
#pragma unroll 1
  for (int t = 0; t < ahead; ++t) {
    load_tile(t);
    cp_async_commit();
  }

  // The scaled q, the self-term score and (int8) the quantized q.
  float s_self = 0.f, amax = 0.f;
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int d = lane + 32 * k;
    if (d < DH) {
      const float v = round_to<T>(__fmul_rn(qv[k], scale));
      sq[d] = v;
      s_self = __fadd_rn(s_self, __fmul_rn(v, kv[k]));
      amax = fmaxf(amax, fabsf(v));
    }
  }
  s_self = warp_sum(s_self);
  float qscale = 0.f;
  if constexpr (QUANT) {
    qscale = fmaxf(warp_max(amax), 1e-8f) * (1.f / 127.f);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int d = lane + 32 * k;
      if (d < DH) sqi[d] = quant_level(__fdiv_rn(sq[d], qscale));
    }
  }
  __syncwarp();

  // This lane's part of q: chunks g, g + kGroup, ... of the head.
  const int g = lane & (G::kGroup - 1);
  float qf[QUANT ? 1 : G::kPerLane * G::kVals];
  int qw[QUANT ? G::kPerLane * 4 : 1];
#pragma unroll
  for (int j = 0; j < G::kPerLane; ++j) {
    const int chunk = j * G::kGroup + g;
    if constexpr (QUANT) {
#pragma unroll
      for (int w = 0; w < 4; ++w) qw[4 * j + w] = reinterpret_cast<const int*>(sqi)[4 * chunk + w];
    } else {
#pragma unroll
      for (int e = 0; e < G::kVals; ++e) qf[j * G::kVals + e] = sq[chunk * G::kVals + e];
    }
  }

  float m_run = -INFINITY, l_run = 0.f;
  float acc[G::kCtxChunks * G::kVals];
#pragma unroll
  for (int e = 0; e < G::kCtxChunks * G::kVals; ++e) acc[e] = 0.f;
  const int r = G::kChunks <= 32 ? lane / G::kChunks : 0;   // context row of this lane
  const int c = G::kChunks <= 32 ? lane - r * G::kChunks : lane;
  const bool ctx_lane = r < G::kCtxRows;

  // The scores of the tile in stage st (cnt slots): kGroup lanes a slot,
  // pass p's slot in s[p] (-inf past cnt); returns the lanes' max.
  auto scores = [&](const unsigned char* st, int cnt, float (&s_mine)[G::kPasses]) {
    const float* sc = reinterpret_cast<const float*>(st + 2 * G::kTile * G::kRowBytes);
    float wmax = -INFINITY;
#pragma unroll
    for (int p = 0; p < G::kPasses; ++p) {
      const int i = p * G::kSlotsPass + lane / G::kGroup;
      const bool live = i < cnt;
      const uint4* krow = reinterpret_cast<const uint4*>(st + (live ? i : 0) * G::kRowBytes);
      float s;
      if constexpr (QUANT) {
        int a = 0;
#pragma unroll
        for (int j = 0; j < G::kPerLane; ++j) {
          const uint4 w = krow[j * G::kGroup + g];
          a = __dp4a((int)w.x, qw[4 * j + 0], a);
          a = __dp4a((int)w.y, qw[4 * j + 1], a);
          a = __dp4a((int)w.z, qw[4 * j + 2], a);
          a = __dp4a((int)w.w, qw[4 * j + 3], a);
        }
#pragma unroll
        for (int off = G::kGroup / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        s = __fmul_rn((float)a, __fmul_rn(sc[G::kScal / 4 + (live ? i : 0)], qscale));
      } else {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < G::kPerLane; ++j) {
          float v[G::kVals];
          unpack(krow[j * G::kGroup + g], v);
#pragma unroll
          for (int e = 0; e < G::kVals; ++e) a = fmaf(qf[j * G::kVals + e], v[e], a);
        }
#pragma unroll
        for (int off = G::kGroup / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        s = a;
      }
      s = live ? __fadd_rn(s, sc[live ? i : 0]) : -INFINITY;
      s_mine[p] = s;
      wmax = fmaxf(wmax, s);
    }
    return wmax;
  };
  // The context of the tile in stage st (cnt slots, probabilities at pt):
  // chunk c (and c + 32, ...) of the V heads of slots r, r + kCtxRows, ...
  auto context = [&](const unsigned char* st, int cnt, const float* pt) {
    const unsigned char* vt = st + G::kTile * G::kRowBytes;
#pragma unroll(G::kVals > 8 ? 2 : 4)
    for (int i = r; i < cnt; i += G::kCtxRows) {
      const float pi = pt[i];
#pragma unroll
      for (int j = 0; j < G::kCtxChunks; ++j) {
        const int cc = c + 32 * j;
        if (G::kCtxChunks == 1 || cc < G::kChunks) {
          float v[G::kVals];
          unpack(*reinterpret_cast<const uint4*>(vt + i * G::kRowBytes + cc * 16), v);
#pragma unroll
          for (int e = 0; e < G::kVals; ++e)
            acc[j * G::kVals + e] = fmaf(pi, v[e], acc[j * G::kVals + e]);
        }
      }
    }
  };

  if (!streamed) {
    // The ring holds every tile: each tile's scores as it lands, one max
    // over the warp's slots, their probabilities, then the context.
    float wmax = -INFINITY;
#pragma unroll 1
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait_at_most(tiles - 1 - t);
      __syncwarp();             // tile t has landed
      const int cnt = min(G::kTile, n - t * G::kTile);
      float s_mine[G::kPasses];
      wmax = fmaxf(wmax, scores(ring + t * G::kStageBytes, cnt, s_mine));
#pragma unroll
      for (int p = 0; p < G::kPasses; ++p) {
        const int i = p * G::kSlotsPass + lane / G::kGroup;
        if (g == 0 && i < cnt) sp[t * G::kTile + i] = s_mine[p];
      }
    }
    m_run = warp_max(wmax);
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sp[i] - m_run);
      l_run += e;
      if constexpr (QUANT) {
        const float* sc = reinterpret_cast<const float*>(
            ring + (i / G::kTile) * G::kStageBytes + 2 * G::kTile * G::kRowBytes);
        sp[i] = __fmul_rn(e, sc[2 * G::kScal / 4 + i % G::kTile]);
      } else {
        sp[i] = e;
      }
    }
    __syncwarp();
    if (ctx_lane) {
#pragma unroll 1
      for (int t = 0; t < tiles; ++t)
        context(ring + t * G::kStageBytes, min(G::kTile, n - t * G::kTile), sp + t * G::kTile);
    }
  } else {
    // Streamed: an online softmax over the tiles.
#pragma unroll 1
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait_at_most(stages - 2);
      __syncwarp();             // tile t has landed; tile t - 1's stage is free
      if (t + stages - 1 < tiles) load_tile(t + stages - 1);
      cp_async_commit();
      const unsigned char* st = ring + (t % stages) * G::kStageBytes;
      const float* sc = reinterpret_cast<const float*>(st + 2 * G::kTile * G::kRowBytes);
      const int cnt = min(G::kTile, n - t * G::kTile);
      float s_mine[G::kPasses];
      const float m_new = fmaxf(m_run, warp_max(scores(st, cnt, s_mine)));
      const float alpha = expf(m_run - m_new);   // 0 on the first tile
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int p = 0; p < G::kPasses; ++p) {
        const int i = p * G::kSlotsPass + lane / G::kGroup;
        if (g == 0 && i < cnt) {
          const float e = expf(s_mine[p] - m_new);
          l_run += e;
          if constexpr (QUANT) {
            sp[i] = __fmul_rn(e, sc[2 * G::kScal / 4 + i]);
          } else {
            sp[i] = e;
          }
        }
      }
      __syncwarp();
      if (ctx_lane) {
#pragma unroll
        for (int e = 0; e < G::kCtxChunks * G::kVals; ++e) acc[e] *= alpha;
        context(st, cnt, sp);
      }
      __syncwarp();             // sp is read before the next tile writes it
    }
  }
  cp_async_wait<0>();
  __syncwarp();               // the ring is free: the context partials go there

  // This warp's sum and context (its rows added in row order).
  float* part = reinterpret_cast<float*>(ring);
  if (ctx_lane) {
#pragma unroll
    for (int j = 0; j < G::kCtxChunks; ++j) {
      const int cc = c + 32 * j;
      if (G::kCtxChunks == 1 || cc < G::kChunks) {
#pragma unroll
        for (int e = 0; e < G::kVals; ++e)
          part[r * DH + cc * G::kVals + e] = acc[j * G::kVals + e];
      }
    }
  }
  const float l_warp = warp_sum(l_run);
  __syncwarp();

  // Into rank 0's slots, as part rank * 4 + warp.
  const int pi_ = rank * kWarpsHere + warp;
  float* dst = comb;
  if (split > 1) {
    cluster_wait();
    dst = cg::this_cluster().map_shared_rank(comb, 0);
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int d = lane + 32 * k;
    if (d < DH) {
      float cs = part[d];
#pragma unroll
      for (int rr = 1; rr < G::kCtxRows; ++rr) cs += part[rr * DH + d];
      dst[2 * parts + pi_ * DH + d] = cs;
    }
  }
  if (lane == 0) {
    dst[2 * pi_] = m_run;
    dst[2 * pi_ + 1] = l_warp;
  }
  if (split > 1) {
    cluster_arrive();
    cluster_wait();
    if (rank != 0) return;
  } else {
    __syncthreads();
  }

  // Rank 0: the parts in order (rank, then warp), then the self-term; each
  // part's weight exp(m_p - m) once, by thread p (0 for a part without
  // slots, m_p = -inf), in place of its max.
  float m = s_self;
  for (int s = 0; s < parts; ++s) m = fmaxf(m, comb[2 * s]);
  __syncthreads();            // every thread has read the maxima
  for (int s = tid; s < parts; s += kThreads) comb[2 * s] = expf(comb[2 * s] - m);
  __syncthreads();
  float cv[kOuts];
#pragma unroll
  for (int k = 0; k < kOuts; ++k) cv[k] = 0.f;
  float denom = 0.f;
  for (int s = 0; s < parts; ++s) {
    const float w = comb[2 * s];
    denom = fmaf(w, comb[2 * s + 1], denom);
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      const int d = tid + k * kThreads;
      if (d < DH) cv[k] = fmaf(w, comb[2 * parts + s * DH + d], cv[k]);
    }
  }
  const float p_self = expf(s_self - m);
  const float inv = 1.f / (denom + p_self);
#pragma unroll
  for (int k = 0; k < kOuts; ++k) {
    const int d = tid + k * kThreads;
    if (d < DH) {
      const float cval = fmaf(p_self, vn[k], cv[k]);
      out[head0 + d] = from_f32<T>(__fmul_rn(cval, inv));
    }
  }
}

// Allow `kernel` `smem` bytes of dynamic shared memory (and, with
// `nonportable`, clusters above 8 blocks) on the current device, calling the
// runtime only where the kernel needs more than it was allowed: a decode
// step launches it every layer, and each runtime call costs host time.
template <typename Kern>
cudaError_t allow(Kern kernel, size_t smem, bool nonportable) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, std::pair<size_t, bool>> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = allowed.find(key);
  if (it != allowed.end()) {
    if (it->second.first >= smem && (it->second.second || !nonportable)) return cudaSuccess;
    smem = std::max(smem, it->second.first);
    nonportable = nonportable || it->second.second;
  }
  err = allow_smem(kernel, smem);
  if (err == cudaSuccess && nonportable)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) allowed[key] = std::make_pair(smem, nonportable);
  return err;
}

template <int DH, bool QUANT, typename T>
int launch(const void* q, const void* k, const void* v, const void* k_new, const void* v_new,
           const void* bias, const void* ks, const void* vs, void* out, int B, int L, int H,
           int split, int stages, void* stream) {
  typedef typename std::conditional<QUANT, int8_t, T>::type CacheT;
  typedef Geo<DH, CacheT, QUANT> G;
  // A warp with more tiles than its ring streams them through two stages
  // or more.
  const int warp_tiles = ((L + split - 1) / split + kWarpsHere * G::kTile - 1) /
                         (kWarpsHere * G::kTile);
  if (split < 1 || split > kMaxSplit || split > L || stages < 1 || stages > kStages ||
      (stages == 1 && warp_tiles > 1) || (long long)B * H * split > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = G::smem(split, stages);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mha_split_kernel<DH, QUANT, T>;
  cudaError_t err = allow(kernel, smem, split > 8);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32.
  const float scale = (float)std::pow((double)DH, -0.5);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), k, v,
                           static_cast<const T*>(k_new), static_cast<const T*>(v_new),
                           static_cast<const float*>(bias), static_cast<const float*>(ks),
                           static_cast<const float*>(vs), static_cast<T*>(out), L, H, split,
                           stages, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the card gives the instance at `split` and `stages`: registers,
// dynamic shared memory, resident blocks an SM, threads, spilled bytes a
// thread.
template <int DH, bool QUANT, typename T>
int resources(int split, int stages, int* out) {
  typedef typename std::conditional<QUANT, int8_t, T>::type CacheT;
  const size_t smem = Geo<DH, CacheT, QUANT>::smem(split, stages);
  auto kernel = mha_split_kernel<DH, QUANT, T>;
  cudaError_t err = allow(kernel, smem, split > 8);
  cudaFuncAttributes attr;
  int blocks = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

#define APERTIS_MHA_HEAD_DIMS(X) X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)

template <bool QUANT, typename T = bf16>
int dispatch(const void* q, const void* k, const void* v, const void* k_new, const void* v_new,
             const void* bias, const void* ks, const void* vs, void* out, int B, int L, int H,
             int head_dim, int split, int stages, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
#define APERTIS_MHA_CASE(dh)                                                                \
  case dh:                                                                                  \
    return launch<dh, QUANT, T>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, split, \
                                stages, stream);
    APERTIS_MHA_HEAD_DIMS(APERTIS_MHA_CASE)
#undef APERTIS_MHA_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool QUANT, typename T>
int dispatch_resources(int head_dim, int split, int stages, int* out) {
  switch (head_dim) {
#define APERTIS_MHA_CASE(dh) \
  case dh: return resources<dh, QUANT, T>(split, stages, out);
    APERTIS_MHA_HEAD_DIMS(APERTIS_MHA_CASE)
#undef APERTIS_MHA_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16 cache, `split` blocks a (row, head) and a ring of `stages` stages a
// warp (mha_step.py::mha_plan). Returns cudaGetLastError().
extern "C" int apertis_mha_decode_ctx(const void* q, const void* k, const void* v,
                                      const void* k_new, const void* v_new, const void* bias,
                                      void* out, int B, int L, int H, int head_dim, int split,
                                      int stages, void* stream) {
  return dispatch<false>(q, k, v, k_new, v_new, bias, nullptr, nullptr, out, B, L, H, head_dim,
                         split, stages, stream);
}

// int8 cache with f32 per-(head, slot) scales ks, vs (B, H, L).
extern "C" int apertis_mha_decode_ctx_int8(const void* q, const void* k, const void* v,
                                           const void* k_new, const void* v_new,
                                           const void* bias, const void* ks, const void* vs,
                                           void* out, int B, int L, int H, int head_dim,
                                           int split, int stages, void* stream) {
  return dispatch<true>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, head_dim, split,
                        stages, stream);
}

// The f32 forms: f32 q, k_new, v_new and output over an f32 cache (ks, vs
// null) or over an int8 cache with its f32 scales ks, vs (B, H, L).
extern "C" int apertis_mha_decode_ctx_f32(const void* q, const void* k, const void* v,
                                          const void* k_new, const void* v_new,
                                          const void* bias, const void* ks, const void* vs,
                                          void* out, int B, int L, int H, int head_dim,
                                          int split, int stages, void* stream) {
  if (ks == nullptr)
    return dispatch<false, float>(q, k, v, k_new, v_new, bias, nullptr, nullptr, out, B, L, H,
                                  head_dim, split, stages, stream);
  return dispatch<true, float>(q, k, v, k_new, v_new, bias, ks, vs, out, B, L, H, head_dim,
                               split, stages, stream);
}

// The resources of form 0 (bf16 cache), 1 (int8 cache), 2 (f32) or 3 (f32
// over an int8 cache) at `head_dim`, `split` and `stages`: registers, shared
// bytes, blocks an SM, threads, spilled bytes (out: 5 ints).
extern "C" int apertis_mha_decode_ctx_resources(int form, int head_dim, int split, int stages,
                                                int* out) {
  if (split < 1 || split > kMaxSplit || stages < 1 || stages > kStages)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case 0: return dispatch_resources<false, bf16>(head_dim, split, stages, out);
    case 1: return dispatch_resources<true, bf16>(head_dim, split, stages, out);
    case 2: return dispatch_resources<false, float>(head_dim, split, stages, out);
    case 3: return dispatch_resources<true, float>(head_dim, split, stages, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
