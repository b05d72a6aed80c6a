// flash_attention_fwd_f32 / flash_attention_dq_f32 / flash_attention_dkv_f32:
// causal flash attention over full sequences with f32 q, k, v, and its
// backward, for models that train in f32, on the tensor cores in split TF32.
//
// Replaces: apertis_llm_tpu/ops/pallas/flash_attention.py::flash_attention
// with f32 operands: _fwd_kernel (:34) and its pallas_call (:102), _dq_kernel
// (:131, pallas_call :257), _dkv_kernel (:167, pallas_call :282). The TPU
// kernels compute in f32 for every input dtype; these take f32 in and out,
// beside the bf16 kernels of flash_attention.cu and flash_attention_bwd.cu.
//
// Layout: q, k, v, dout, out, dq, dk, dv (B, H, L, Dh) f32, contiguous, 16-byte
// aligned (TMA); lse and delta = sum_d out * dout (B, H, L) f32.
//
// Semantics (flash_attention.py:34-77, 131-204), per (b, h), in f32:
//   s_ij = (q_i . k_j) Dh^-1/2, masked where j >= L or (causal) i < j;
//   forward, online over key tiles: m' = max(m, max_j s_ij); p = exp(s - m');
//     alpha = exp(m - m'); l = l alpha + sum_j p; acc = acc alpha + p V;
//     out_i = acc / max(l, 1e-30); lse_i = m + log(max(l, 1e-30));
//   backward: p_ij = exp(s_ij - lse_i) (0 where masked); dp_ij = dout_i . v_j;
//     ds_ij = p_ij (dp_ij - delta_i) Dh^-1/2; dq_i = sum_j ds_ij k_j;
//     dk_j = sum_i ds_ij q_i; dv_j = sum_i p_ij dout_i.
// The exponentials are the bf16 kernels' (flash_attention.cu): the scale
// folded into base 2, p = 2^(fma(q . k, Dh^-1/2 log2 e, -m)) on the
// special-function unit (ex2.approx, relative error about 2^-22), lse = (m +
// log2 l) ln 2; masked scores are -inf in the forward. Tiles wholly above
// the diagonal are skipped (the TPU dQ kernel visits and masks them: the same
// sums). No atomics: a run repeats bit for bit.
//
// Arithmetic: split TF32 ("3xTF32"), the rule of CUTLASS's FastF32
// operator. Every f32 operand x of a product is split into hi = x rounded to
// TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32) and lo = x -
// hi, itself rounded to TF32 (hopper.cuh::tf32_hi, tf32_lo); both have their
// low 13 bits zero, so the tensor core reads them exactly, and hi + lo
// carries x to about 2^-22 of it. A product X Y is X_lo Y_hi + X_hi Y_lo +
// X_hi Y_hi, each a TF32 wgmma product in f32, the dropped X_lo Y_lo about
// 2^-22 of it: a score product as X_lo Y_hi (N = B) and X_hi [Y_lo; Y_hi]
// (N = 2B), summed in registers as (lo hi + hi lo) + hi hi; an accumulating
// product as lo hi, hi lo, hi hi into one accumulator. One-pass TF32 misses
// f32 by about 2^-11 of each term, several times the checks' 1e-5
// (chip_smoke.py F32_FLASH_TOL; tests/test_torch_flash_f32_split.py
// emulates both); the split kernels stay well inside it on the card.
//
// Products and operand layouts (TF32 wgmma takes both shared-memory operands
// K-major: the reduction axis along the stored row, with no transpose flag):
//   forward: S = Q K^T (Q, K as stored); O += P V (P from registers, V^T: a
//     copy of V transposed);
//   dQ: S = Q K^T, dP = dO V^T (as stored); dQ += dS K (K^T copy);
//   dK/dV: S^T = K Q^T, dP^T = V dO^T (as stored); dV += P^T dO (dO^T copy),
//     dK += dS^T Q (Q^T copy).
// The register A operand (P, dS, P^T, dS^T) comes from the accumulator of
// the score product; TF32 k8 fragments hold columns l % 4 and l % 4 + 4 of
// lane l's rows where the accumulator gives it 2 (l % 4) and 2 (l % 4) + 1,
// so a fragment is {d[4kk], d[4kk + 2], d[4kk + 1], d[4kk + 3]} and the
// transposed copy writes key k of each group of 8 at slot tf32_slot(k) (even
// keys in slots 0-3, odd ones in 4-7): the sum over the group is the same.
//
// Bound on the H100: operations. At (4, 38, 1024, 64) the causal half is
// 79.8 M pairs of 2 Dh flops a product: 20.4 GFLOP in the forward (2
// products), 30.6 in dQ (3), 40.8 in dK/dV (4); split TF32 runs each 3 times
// on the tensor cores (495 TFLOP/s TF32): 0.124, 0.186, 0.247 ms. (On the
// CUDA cores, 67 TFLOP/s f32, the same work takes 0.305, 0.457, 0.610 ms.)
// Bytes: 79.7, 101 and 121 MB, 24-36 us at 3.35 TB/s.
//
// Design (Hopper, sm_90a), the bf16 kernels' blocks (hopper.cuh):
// persistent blocks of 384 threads, one an SM, walking work items in
// snake_item order (heaviest first under `causal`); two consumer warpgroups
// that take Turns issuing their wgmma products; a producer warpgroup
// (setmaxnreg: 40 registers, consumers 232). Each streamed tile takes a
// consumer two turns: its score products, then (scores and fragments made
// in registers meanwhile) its accumulating products. The bf16 kernels
// overlap a tile's scores with the previous tile's accumulating products;
// here that keeps the fragments of two tiles live, spilled dK/dV's
// registers and ran slower on the card, while the other warpgroup's turn
// fills the tensor cores anyway.
// - Each tile's accumulating products start a fresh accumulator (`part`),
//   added to the running O, dQ, dK or dV with f32 adds: the tensor cores'
//   own f32 sum over the hundreds of k8 steps of a long row drifted past
//   the checks' 1e-5 in dV (key 0, where the late terms are small).
// - An item's own rows (Q in the forward, Q and dO in dQ, K and V in dK/dV)
//   arrive by TMA into their hi tile; the producer's 128 threads clear their
//   low bits in place and write their lo tile.
// - Streamed tiles of B rows (K and V; Q and dO) arrive by TMA into raw
//   slots ahead of use (one producer thread issues them, two slots where
//   shared memory allows); the 128 producer threads split each into a stage
//   of the two-stage ring: hi and lo of the operands read as stored, and hi
//   and lo of the transposed copies, and (dK/dV) the tile's lse times log2 e
//   and delta. They run fence.proxy.async and arrive on the stage's ready
//   barrier; consumers release the stage on its empty barrier. A transposed
//   copy of B < 32 rows is folded so that its rows fill whole 128-byte
//   swizzle rows: with R = DHP B / 32 tile rows, Dh row n goes to tile row
//   n % R, k columns (n / R) B on, and a product reads one fold segment (R
//   output columns) at a time.
// - Scores, probabilities and their gradients stay in registers; P and dS
//   are split into hi and lo there. A score product stacks the stream tile's
//   lo and hi rows into one operand of 2B rows, so that A hi [B_lo; B_hi]^T
//   is one product of N = 2B (product_ss).
// - Tile plans (Dh padded to DHP = 32, 64, 128, 256; rows an item; B rows a
//   streamed tile; raw slots; shared memory a block, all within 232,448
//   bytes):
//     forward: 128 / 64 / 2 slots (DHP 32), 128 / 64 / 1 (64), 128 / 16 / 2
//       (128), 64 / 8 / 2 (256);
//     dQ: 128 / 32 / 2 (32), 128 / 16 / 2 (64), 64 / 8 / 2 (128), 16 / 8 / 2
//       (256);
//     dK/dV: 128 / 32 / 2 (32), 128 / 16 / 2 (64), 64 / 8 / 2 (128), 16 / 8
//       / 2 (256).
//   With 128 rows each consumer warpgroup owns 64 of them; with 64 or fewer
//   both take the same rows, each computing the score products and half of
//   the output columns. Items of 16 rows (DHP 256: their own hi and lo tiles
//   alone take 64 KB) still run 64-row products: the rows past the item's
//   read other tiles, and their results are dropped (p and ds are 0 there).

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSplitThreads = 128;   // the producer warpgroup, which splits the tiles
constexpr int kProducerRegsF = 40;
constexpr int kConsumerRegsF = 232;
constexpr uint32_t kSmemMax = 232448;   // shared memory a block may use
constexpr float kLn2 = 0.6931471805599453f;

// Element offset of (r, c) in a K-major swizzled f32 tile of `rows` rows.
__device__ __forceinline__ int kmajor_at(int rows, int r, int c) {
  return (c >> 5) * rows * 32 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// The transposed copy of a stream tile of B rows and DHP columns: K-major
// over the B rows, with B < 32 folded (the comment at the top).
template <int DHP, int B>
struct TTile {
  static constexpr int kFold = B < 32 ? 32 / B : 1;
  static constexpr int kRows = DHP / kFold;
  // Element offset of slots s0..s0 + 3 (s0 = 0 or 4) of key group q8 of Dh
  // row n: 16 bytes inside one swizzle chunk.
  static __device__ __forceinline__ int at4(int n, int q8, int s0) {
    const int tr = n % kRows;
    const int vc = (n / kRows) * B + 8 * q8 + s0;
    return (vc >> 5) * kRows * 32 + tr * 32 + ((((vc & 31) >> 2) ^ (tr & 7)) << 2);
  }
  // Descriptor of the B operand that gives output Dh rows n0.. (inside one
  // fold segment) at k8 step kk of the B rows.
  static __device__ __forceinline__ uint64_t desc(const float* t, int n0, int kk) {
    const int g = (n0 / kRows) * (B / 8) + kk;
    return sw128_desc(t + (g >> 2) * kRows * 32 + (n0 % kRows) * 32 + (g & 3) * 8, 16, 1024);
  }
};

// Shared-memory plan: OWN operands of ROWS rows (hi tiles, then lo tiles),
// two stages of TILES stream tiles of B x DHP, the raw slots (two TMA
// tiles each), per-stage lse and delta (dK/dV), the barriers.
template <int DHP, int ROWS, int B, int OWN, int TILES>
struct PlanF {
  static constexpr int kDhp = DHP, kRows = ROWS, kB = B, kOwn = OWN;
  static constexpr int kSplit = ROWS <= kWgRows ? 2 : 1;   // warpgroups on the same rows
  static constexpr int kCols = DHP / kSplit;               // output columns a warpgroup
  static constexpr int kStages = 2;
  static constexpr uint32_t kOwnTile = ROWS * DHP * 4;
  static constexpr uint32_t kTile = B * DHP * 4;
  static constexpr uint32_t kStageBytes = TILES * kTile;
  static constexpr uint32_t kStageOff = 2 * OWN * kOwnTile;
  static constexpr uint32_t kRawOff = kStageOff + kStages * kStageBytes;
  static constexpr uint32_t kRawSlot = 2 * kTile;
  // The vectors, the barriers and the alignment slack.
  static constexpr uint32_t kTail = kStages * 2 * B * 4 + 16 * 8 + 1024;
  static constexpr int kRaw = kRawOff + 2 * kRawSlot + kTail <= kSmemMax ? 2 : 1;
  static constexpr uint32_t kVecOff = kRawOff + kRaw * kRawSlot;
  static constexpr uint32_t kBarOff = kVecOff + kStages * 2 * B * 4;
  static constexpr size_t kBytes = kBarOff + 16 * 8 + 1024;
  // Output columns of one accumulating product: within a fold segment.
  static constexpr int kW = kCols < TTile<DHP, B>::kRows ? kCols : TTile<DHP, B>::kRows;
  static_assert(kBytes <= kSmemMax, "shared memory");
  static_assert(DHP % 32 == 0 && B % 8 == 0 && ROWS % 8 == 0, "tile shapes");
};

template <int DHP>
using FwdPlan = PlanF<DHP, DHP <= 128 ? 128 : 64, DHP <= 64 ? 64 : DHP == 128 ? 16 : 8, 1, 4>;
template <int DHP>
using DqPlan = PlanF<DHP, DHP <= 64 ? 128 : DHP == 128 ? 64 : 16,
                     DHP == 32 ? 32 : DHP == 64 ? 16 : 8, 2, 6>;
template <int DHP>
using DkvPlan = PlanF<DHP, DHP <= 64 ? 128 : DHP == 128 ? 64 : 16,
                      DHP == 32 ? 32 : DHP == 64 ? 16 : 8, 2, 8>;

// The block's buffers and barriers (barrier 0 own tiles landed, 1 own tiles
// split, 2 own tiles free, 3.. raw slot landed, then stage ready, stage
// empty).
template <class P>
struct Smem {
  unsigned char* base;
  __device__ float* own(int op, int lo) const {
    return reinterpret_cast<float*>(base + (lo * P::kOwn + op) * P::kOwnTile);
  }
  __device__ float* tile(int s, int t) const {
    return reinterpret_cast<float*>(base + P::kStageOff + s * P::kStageBytes + t * P::kTile);
  }
  __device__ float* raw(int r, int x) const {
    return reinterpret_cast<float*>(base + P::kRawOff + r * P::kRawSlot + x * P::kTile);
  }
  __device__ float* vec(int s, int which) const {
    return reinterpret_cast<float*>(base + P::kVecOff + (2 * s + which) * P::kB * 4);
  }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + P::kBarOff) + i;
  }
  __device__ uint64_t* own_full() const { return bar(0); }
  __device__ uint64_t* own_ready() const { return bar(1); }
  __device__ uint64_t* own_empty() const { return bar(2); }
  __device__ uint64_t* raw_full(int r) const { return bar(3 + r); }
  __device__ uint64_t* ready(int s) const { return bar(3 + P::kRaw + s); }
  __device__ uint64_t* empty(int s) const { return bar(3 + P::kRaw + P::kStages + s); }

  __device__ void init() const {
    mbar_init(own_full(), 1);
    mbar_init(own_ready(), kSplitThreads);
    mbar_init(own_empty(), kConsumers * 128);
    for (int r = 0; r < P::kRaw; ++r) mbar_init(raw_full(r), 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(ready(s), kSplitThreads);
      mbar_init(empty(s), kConsumers * 128);
    }
    mbar_fence_init();
  }
};

// Work items. Forward and dQ: (b * h, ROWS query rows), the last tiles first
// under `causal`, streaming the key tiles they see. dK/dV: (b * h, ROWS key
// rows), the first tiles first, streaming the query tiles from the
// diagonal down. Stream tile t of an item starts at row (t0 + t) B.
struct Items {
  int BH, L, rows, B, causal, keys, nt, total, G;
  __device__ Items(int BH_, int L_, int rows_, int B_, int causal_, bool keys_)
      : BH(BH_), L(L_), rows(rows_), B(B_), causal(causal_), keys(keys_),
        nt((L_ + rows_ - 1) / rows_), total(BH_ * ((L_ + rows_ - 1) / rows_)), G(gridDim.x) {}
  __device__ bool has(int it) const { return snake_item(it, blockIdx.x, G) < total; }
  __device__ bool get(int it, int& bh, int& row0, int& t0, int& n) const {
    const int i = snake_item(it, blockIdx.x, G);
    if (i >= total) return false;
    tile_item(i, BH, nt, causal && !keys, rows, bh, row0);
    if (keys) {
      t0 = causal ? row0 / B : 0;
      n = (L + B - 1) / B - t0;
    } else {
      t0 = 0;
      n = key_tiles(L, B, row0, rows, causal);
    }
    return true;
  }
};

// hi (in place) and lo of the n floats of an own tile, 16 bytes a thread
// at a time.
__device__ __forceinline__ void split_own(float* tile, float* lo, int n, int ptid) {
  for (int i = 4 * ptid; i < n; i += 4 * kSplitThreads) {
    const float4 x = *reinterpret_cast<const float4*>(tile + i);
    const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
    *reinterpret_cast<float4*>(lo + i) =
        make_float4(tf32_lo(x.x, h.x), tf32_lo(x.y, h.y), tf32_lo(x.z, h.z), tf32_lo(x.w, h.w));
    *reinterpret_cast<float4*>(tile + i) = h;
  }
}

// lo and hi of a B x DHP K-major stream tile, stacked into one K-major tile
// of 2B rows (lo in rows 0..B-1, hi in B..2B-1), so that one product
// against it gives A hi B_lo^T and A hi B_hi^T side by side. Row r and row
// B + r swizzle alike (B is a multiple of 8): a 16-byte chunk keeps its
// place in the row.
template <int DHP, int B>
__device__ __forceinline__ void split_stacked(const float* src, float* dst, int ptid) {
  for (int i = ptid; i < B * DHP / 4; i += kSplitThreads) {
    const int blk = i / (B * 8), r = (i / 8) % B, ch = i % 8;
    const float4 x = *reinterpret_cast<const float4*>(src + 4 * i);
    const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
    float* at = dst + blk * 2 * B * 32 + r * 32 + ch * 4;
    *reinterpret_cast<float4*>(at) =
        make_float4(tf32_lo(x.x, h.x), tf32_lo(x.y, h.y), tf32_lo(x.z, h.z), tf32_lo(x.w, h.w));
    *reinterpret_cast<float4*>(at + B * 32) = h;
  }
}

// hi and lo of the transposed copy of a B x DHP K-major tile: thread item
// (Dh row n, key group q8) reads the group's 8 values of column n (lanes on
// consecutive n: one 128-byte row) and writes 16 bytes of each half of the
// group (even keys, then odd ones: tf32_slot) to row n's chunks (lanes on
// consecutive rows: distinct banks within each 8).
template <int DHP, int B>
__device__ __forceinline__ void split_transposed(const float* src, float* hi, float* lo,
                                                 int ptid) {
  typedef TTile<DHP, B> T;
  for (int i = ptid; i < DHP * (B / 8); i += kSplitThreads) {
    const int n = i % DHP, q8 = i / DHP;
    float x[8], h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = src[kmajor_at(B, 8 * q8 + j, n)];
      h[j] = tf32_hi(x[j]);
    }
    static_assert(tf32_slot(2) == 1 && tf32_slot(1) == 4, "even keys first, then odd");
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int a = T::at4(n, q8, 4 * half);
      *reinterpret_cast<float4*>(hi + a) =
          make_float4(h[half], h[half + 2], h[half + 4], h[half + 6]);
      *reinterpret_cast<float4*>(lo + a) =
          make_float4(tf32_lo(x[half], h[half]), tf32_lo(x[half + 2], h[half + 2]),
                      tf32_lo(x[half + 4], h[half + 4]), tf32_lo(x[half + 6], h[half + 6]));
    }
  }
}

// The producer warpgroup. Thread 0 issues the TMA loads: each item's own
// tiles once the previous item's are free, and the stream tiles into raw
// slots as soon as a slot is split (kRaw tiles ahead). All 128 threads
// split: the own tiles, then each stream tile into its stage (`split(s, r,
// tile row0)`) once the stage is free.
template <class P, class LoadOwn, class LoadRaw, class Split>
__device__ __forceinline__ void produce(const Smem<P>& sm, const Items& items, LoadOwn load_own,
                                        LoadRaw load_raw, Split split) {
  const int ptid = threadIdx.x - kConsumers * 128;
  // Thread 0's cursor over the stream tiles of successive items.
  int c_it = 0, c_t = 0, c_bh = 0, c_row = 0, c_t0 = 0, c_n = 0, issued = 0;
  bool c_ok = items.get(0, c_bh, c_row, c_t0, c_n);
  auto issue = [&]() {
    const int r = issued % P::kRaw;
    mbar_arrive_tx(sm.raw_full(r), 2 * P::kTile);
    load_raw(sm, r, (c_t0 + c_t) * P::kB, c_bh);
    ++issued;
    if (++c_t == c_n) {
      c_t = 0;
      c_ok = items.get(++c_it, c_bh, c_row, c_t0, c_n);
    }
  };
  if (ptid == 0)
    while (c_ok && issued < P::kRaw) issue();
  int g = 0;   // stream tiles split so far
  for (int it = 0;; ++it) {
    int bh, row0, t0, n;
    if (!items.get(it, bh, row0, t0, n)) break;
    if (it > 0) mbar_wait(sm.own_empty(), (it - 1) & 1);
    if (ptid == 0) {
      mbar_arrive_tx(sm.own_full(), P::kOwn * P::kOwnTile);
      load_own(sm, row0, bh);
    }
    mbar_wait(sm.own_full(), it & 1);
    for (int op = 0; op < P::kOwn; ++op)
      split_own(sm.own(op, 0), sm.own(op, 1), P::kRows * P::kDhp, ptid);
    fence_proxy_async();
    mbar_arrive(sm.own_ready());
    for (int t = 0; t < n; ++t, ++g) {
      const int r = g % P::kRaw, s = g % P::kStages;
      mbar_wait(sm.raw_full(r), (g / P::kRaw) & 1);
      if (g >= P::kStages) mbar_wait(sm.empty(s), (g / P::kStages - 1) & 1);
      split(s, r, (t0 + t) * P::kB, bh, ptid);
      fence_proxy_async();
      mbar_arrive(sm.ready(s));
      named_sync(3, kSplitThreads);   // every thread is done with the raw slot
      if (ptid == 0 && c_ok) issue();
    }
  }
}

// An accumulating product of the 64 x B register operand (hi and lo
// fragments, B / 8 k8 steps) with a transposed copy (hi, lo), into output
// columns c_lo..c_lo + kCols of `acc`: lo hi, then hi lo, then hi hi; FRESH
// overwrites `acc` first.
template <class P, bool FRESH, int R>
__device__ __forceinline__ void product_rs(float (&acc)[R], const uint32_t (&fh)[P::kB / 8][4],
                                           const uint32_t (&fl)[P::kB / 8][4], const float* t_hi,
                                           const float* t_lo, int c_lo) {
  typedef TTile<P::kDhp, P::kB> T;
  constexpr int W = P::kW;
#pragma unroll
  for (int part = 0; part < 3; ++part) {
#pragma unroll
    for (int kk = 0; kk < P::kB / 8; ++kk) {
#pragma unroll
      for (int x = 0; x < P::kCols; x += W) {
        float(&chunk)[W / 2] = *reinterpret_cast<float(*)[W / 2]>(acc + x / 2);
        WgmmaTf32<W>::rs(chunk, part == 0 ? fl[kk] : fh[kk],
                         T::desc(part == 1 ? t_lo : t_hi, c_lo + x, kk),
                         !FRESH || part > 0 || kk > 0);
      }
    }
  }
}

// A score product (N = B): the 64-row slice at own_row of an own operand
// (hi, lo tiles of ROWS rows) times a stacked stream tile (split_stacked),
// over DHP: A lo B_hi^T into `acc` and A hi [B_lo; B_hi]^T into `acc2` (N =
// 2B), each overwritten; add_score sums them once they retire. (Stacking B's
// parts along N issues a third fewer wgmma than three N = B products and
// reads A hi once.)
template <class P>
__device__ __forceinline__ void product_ss(float (&acc)[P::kB / 2], float (&acc2)[P::kB],
                                           const float* a_hi, const float* a_lo,
                                           const float* stacked, int own_row) {
  constexpr int KS = P::kDhp / 8, B = P::kB;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    WgmmaTf32<B>::ss(acc, kmajor_desc(a_lo, P::kRows, own_row, kk),
                     kmajor_desc(stacked, 2 * B, B, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    WgmmaTf32<2 * B>::ss(acc2, kmajor_desc(a_hi, P::kRows, own_row, kk),
                         kmajor_desc(stacked, 2 * B, 0, kk), kk > 0);
}

// The score: (A lo B_hi + A hi B_lo) + A hi B_hi. Columns c and B + c of a
// 64 x 2B accumulator are registers i and i + B / 2.
template <int B>
__device__ __forceinline__ void add_score(float (&acc)[B / 2], float (&acc2)[B]) {
  reg_fence(acc);
  reg_fence(acc2);
#pragma unroll
  for (int i = 0; i < B / 2; ++i) acc[i] = (acc[i] + acc2[i]) + acc2[i + B / 2];
}

template <class P>
__device__ __forceinline__ void load_own_tiles(const Smem<P>& sm, const CUtensorMap* m0,
                                               const CUtensorMap* m1, int row0, int bh) {
  tma_load_tile<P::kDhp>(sm.own(0, 0), m0, sm.own_full(), P::kRows, row0, bh);
  if (P::kOwn == 2) tma_load_tile<P::kDhp>(sm.own(1, 0), m1, sm.own_full(), P::kRows, row0, bh);
}

template <class P>
__device__ __forceinline__ void load_raw_tiles(const Smem<P>& sm, const CUtensorMap* m0,
                                               const CUtensorMap* m1, int r, int row0, int bh) {
  tma_load_tile<P::kDhp>(sm.raw(r, 0), m0, sm.raw_full(r), P::kB, row0, bh);
  tma_load_tile<P::kDhp>(sm.raw(r, 1), m1, sm.raw_full(r), P::kB, row0, bh);
}

// ---- forward ------------------------------------------------------------------
// Stage tiles: 0-1 K stacked (lo, hi), 2 V^T hi, 3 V^T lo.

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                         float* __restrict__ lse, int BH, int L, int dh, float scale_log2,
                         int causal) {
  constexpr int B = P::kB, DHP = P::kDhp;
  extern __shared__ unsigned char smem_raw[];
  const Smem<P> sm{align_1024(smem_raw)};
  const Items items(BH, L, P::kRows, B, causal, false);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegsF>();
    produce<P>(
        sm, items,
        [&](const Smem<P>& s, int row0, int bh) { load_own_tiles(s, &q_map, &q_map, row0, bh); },
        [&](const Smem<P>& s, int r, int row0, int bh) {
          load_raw_tiles(s, &k_map, &v_map, r, row0, bh);
        },
        [&](int s, int r, int, int, int ptid) {
          split_stacked<DHP, B>(sm.raw(r, 0), sm.tile(s, 0), ptid);
          split_transposed<DHP, B>(sm.raw(r, 1), sm.tile(s, 2), sm.tile(s, 3), ptid);
        });
    return;
  }
  regs_alloc<kConsumerRegsF>();

  // Consumers: warpgroup wg takes rows own_row..own_row+63 of each item and
  // output columns c_lo..c_lo+kCols; this thread rows r0 and r0 + 8.
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int own_row = P::kSplit == 1 ? wg * kWgRows : 0;
  const int c_lo = P::kSplit == 1 ? 0 : wg * P::kCols;
  // o sums the tiles' P V (part, each a fresh tensor-core sum) with f32
  // operations, as dQ and dK/dV do.
  float o[P::kCols / 2], part[P::kCols / 2], sc[B / 2], sc2[B];
  float m[2], l[2], alpha[2];
  uint32_t ph[B / 8][4], pl[B / 8][4];   // P of the tile, hi and lo
  int g = 0;                             // stream tiles consumed so far
  const Turns turns{wg};
  turns.start();
  for (int it = 0;; ++it) {
    int bh, q0, t0, num_kb;
    if (!items.get(it, bh, q0, t0, num_kb)) break;
    const bool last_item = !items.has(it + 1);
    const int row_lo = q0 + own_row;
    const int r0 = row_lo + (tid / 32) * 16 + lane / 4;
    auto stage = [&](int j) { return (g + j) % P::kStages; };
    auto phase = [&](int j) { return ((g + j) / P::kStages) & 1; };
    auto issue_s = [&](int j) {
      product_ss<P>(sc, sc2, sm.own(0, 0), sm.own(0, 1), sm.tile(stage(j), 0), own_row);
      wg_commit();
    };
    auto issue_pv = [&](int j) {
      product_rs<P, true>(part, ph, pl, sm.tile(stage(j), 2), sm.tile(stage(j), 3), c_lo);
      wg_commit();
    };
    auto to_frags = [&]() {
#pragma unroll
      for (int kk = 0; kk < B / 8; ++kk) to_tf32_frags(sc, kk, ph[kk], pl[kk]);
    };

#pragma unroll
    for (int i = 0; i < P::kCols / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    mbar_wait(sm.own_ready(), it & 1);
    for (int j = 0; j < num_kb; ++j) {
      mbar_wait(sm.ready(stage(j)), phase(j));
      turns.mine();
      wg_fence();
      issue_s(j);
      turns.theirs(false);
      wg_wait<0>();
      if (j == num_kb - 1) mbar_arrive(sm.own_empty());   // every S of this item has retired
      add_score<B>(sc, sc2);
      online_softmax<B>(sc, m, l, alpha, j, L, r0, row_lo, lane, causal, scale_log2);
#pragma unroll
      for (int i = 0; i < P::kCols / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_frags();
      turns.mine();
      wg_fence();
      issue_pv(j);
      turns.theirs(last_item && j == num_kb - 1);
      wg_wait<0>();
      reg_fence(part);
#pragma unroll
      for (int i = 0; i < P::kCols / 2; ++i) o[i] += part[i];
      mbar_arrive(sm.empty(stage(j)));
    }
    g += num_kb;

    const size_t base = (size_t)bh * L * dh;
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < P::kCols / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const int row = r0 + 8 * h;
      const int col = c_lo + 8 * (i >> 2) + 2 * (lane % 4);
      if (row < L && col < dh)
        *reinterpret_cast<float2*>(out + base + (size_t)row * dh + col) =
            make_float2(o[i] / l[h], o[i + 1] / l[h]);
    }
    if (lane % 4 == 0 && (P::kSplit == 1 || wg == 0)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < L) lse[(size_t)bh * L + r0 + 8 * h] = (m[h] + log2f(l[h])) * kLn2;
    }
  }
}

// ---- dQ -----------------------------------------------------------------------
// Own operands: 0 Q, 1 dO. Stage tiles: 0-1 K stacked (lo, hi), 2-3 V
// stacked, 4 K^T hi, 5 K^T lo.

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int BH, int L,
                        int dh, float scale, float scale_log2, int causal) {
  constexpr int B = P::kB, DHP = P::kDhp;
  extern __shared__ unsigned char smem_raw[];
  const Smem<P> sm{align_1024(smem_raw)};
  const Items items(BH, L, P::kRows, B, causal, false);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegsF>();
    produce<P>(
        sm, items,
        [&](const Smem<P>& s, int row0, int bh) { load_own_tiles(s, &q_map, &do_map, row0, bh); },
        [&](const Smem<P>& s, int r, int row0, int bh) {
          load_raw_tiles(s, &k_map, &v_map, r, row0, bh);
        },
        [&](int s, int r, int, int, int ptid) {
          split_stacked<DHP, B>(sm.raw(r, 0), sm.tile(s, 0), ptid);
          split_stacked<DHP, B>(sm.raw(r, 1), sm.tile(s, 2), ptid);
          split_transposed<DHP, B>(sm.raw(r, 0), sm.tile(s, 4), sm.tile(s, 5), ptid);
        });
    return;
  }
  regs_alloc<kConsumerRegsF>();

  // Consumers: as the forward's; this thread's rows' lse (times log2 e) and
  // delta in registers.
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int own_row = P::kSplit == 1 ? wg * kWgRows : 0;
  const int c_lo = P::kSplit == 1 ? 0 : wg * P::kCols;
  // acc sums the tiles' products (part, each a fresh tensor-core sum) with
  // f32 adds: a sum over hundreds of wgmma steps in the tensor core drifts
  // where the late terms are small (the comment at the top).
  float acc[P::kCols / 2], part[P::kCols / 2], sc[B / 2], sc2[B], dp[B / 2], dp2[B];
  uint32_t dh_[B / 8][4], dl[B / 8][4];   // dS of the tile, hi and lo
  int g = 0;
  const Turns turns{wg};
  turns.start();
  for (int it = 0;; ++it) {
    int bh, q0, t0, num_kb;
    if (!items.get(it, bh, q0, t0, num_kb)) break;
    const bool last_item = !items.has(it + 1);
    const int r0 = q0 + own_row + (tid / 32) * 16 + lane / 4;
    float row_lse2[2], row_delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      row_lse2[h] = row < L ? lse[(size_t)bh * L + row] * kLog2e : 0.f;
      row_delta[h] = row < L ? delta[(size_t)bh * L + row] : 0.f;
    }
    auto stage = [&](int j) { return (g + j) % P::kStages; };
    auto phase = [&](int j) { return ((g + j) / P::kStages) & 1; };
    auto issue_a = [&](int j) {   // S = Q K^T, dP = dO V^T
      product_ss<P>(sc, sc2, sm.own(0, 0), sm.own(0, 1), sm.tile(stage(j), 0), own_row);
      product_ss<P>(dp, dp2, sm.own(1, 0), sm.own(1, 1), sm.tile(stage(j), 2), own_row);
      wg_commit();
    };
    auto issue_c = [&](int j) {   // dQ += dS K
      product_rs<P, true>(part, dh_, dl, sm.tile(stage(j), 4), sm.tile(stage(j), 5), c_lo);
      wg_commit();
    };
    auto add_part = [&]() {
      reg_fence(part);
#pragma unroll
      for (int i = 0; i < P::kCols / 2; ++i) acc[i] += part[i];
    };
    auto scores = [&](int j) {   // dS in place of S, in f32; 0 off the item's rows
      add_score<B>(sc, sc2);
      add_score<B>(dp, dp2);
      const int c0 = j * B + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < B / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int row = r0 + 8 * h;
        const int col = c0 + 8 * (i >> 2) + (i & 1);
        const bool valid =
            row < L && row - q0 < P::kRows && col < L && (!causal || row >= col);
        const float p = exp2_approx(fmaf(sc[i], scale_log2, -row_lse2[h]));
        sc[i] = valid ? __fmul_rn(__fmul_rn(p, dp[i] - row_delta[h]), scale) : 0.f;
      }
    };
    auto to_frags = [&]() {
#pragma unroll
      for (int kk = 0; kk < B / 8; ++kk) to_tf32_frags(sc, kk, dh_[kk], dl[kk]);
    };

#pragma unroll
    for (int i = 0; i < P::kCols / 2; ++i) acc[i] = 0.f;
    mbar_wait(sm.own_ready(), it & 1);
    for (int j = 0; j < num_kb; ++j) {
      mbar_wait(sm.ready(stage(j)), phase(j));
      turns.mine();
      wg_fence();
      issue_a(j);
      turns.theirs(false);
      wg_wait<0>();
      if (j == num_kb - 1) mbar_arrive(sm.own_empty());
      scores(j);
      to_frags();
      turns.mine();
      wg_fence();
      issue_c(j);
      turns.theirs(last_item && j == num_kb - 1);
      wg_wait<0>();
      add_part();
      mbar_arrive(sm.empty(stage(j)));
    }
    g += num_kb;
    const size_t base = (size_t)bh * L * dh;
#pragma unroll
    for (int i = 0; i < P::kCols / 2; i += 2) {
      const int row = r0 + 8 * ((i >> 1) & 1);
      const int col = c_lo + 8 * (i >> 2) + 2 * (lane % 4);
      if (row < L && row - q0 < P::kRows && col < dh)
        *reinterpret_cast<float2*>(dq + base + (size_t)row * dh + col) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
}

// ---- dK/dV --------------------------------------------------------------------
// Own operands: 0 K, 1 V. Stage tiles: 0-1 Q stacked (lo, hi), 2-3 dO
// stacked, 4 Q^T hi, 5 Q^T lo, 6 dO^T hi, 7 dO^T lo; the stage's vectors:
// lse times log2 e and delta of the tile's rows (0 past L).

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_f32_kernel(const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int BH, int L, int dh,
                         float scale, float scale_log2, int causal) {
  constexpr int B = P::kB, DHP = P::kDhp;
  extern __shared__ unsigned char smem_raw[];
  const Smem<P> sm{align_1024(smem_raw)};
  const Items items(BH, L, P::kRows, B, causal, true);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegsF>();
    produce<P>(
        sm, items,
        [&](const Smem<P>& s, int row0, int bh) { load_own_tiles(s, &k_map, &v_map, row0, bh); },
        [&](const Smem<P>& s, int r, int row0, int bh) {
          load_raw_tiles(s, &q_map, &do_map, r, row0, bh);
        },
        [&](int s, int r, int row0, int bh, int ptid) {
          // The tile's lse and delta from global memory first, so that
          // their latency runs under the split.
          static_assert(B <= kSplitThreads, "one row a thread");
          const int row = row0 + ptid;
          const bool has = ptid < B && row < L;
          const float l2 = has ? lse[(size_t)bh * L + row] * kLog2e : 0.f;
          const float dl = has ? delta[(size_t)bh * L + row] : 0.f;
          split_stacked<DHP, B>(sm.raw(r, 0), sm.tile(s, 0), ptid);
          split_stacked<DHP, B>(sm.raw(r, 1), sm.tile(s, 2), ptid);
          split_transposed<DHP, B>(sm.raw(r, 0), sm.tile(s, 4), sm.tile(s, 5), ptid);
          split_transposed<DHP, B>(sm.raw(r, 1), sm.tile(s, 6), sm.tile(s, 7), ptid);
          if (ptid < B) {
            sm.vec(s, 0)[ptid] = l2;
            sm.vec(s, 1)[ptid] = dl;
          }
        });
    return;
  }
  regs_alloc<kConsumerRegsF>();

  // Consumers: warpgroup wg takes key rows own_row..own_row+63 of each item
  // and dK/dV columns c_lo..c_lo+kCols; this thread key rows kr and kr + 8.
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int own_row = P::kSplit == 1 ? wg * kWgRows : 0;
  const int c_lo = P::kSplit == 1 ? 0 : wg * P::kCols;
  // The dK and dV sums, and each tile's products (fresh), as in dQ.
  float acc_k[P::kCols / 2], acc_v[P::kCols / 2], part_k[P::kCols / 2], part_v[P::kCols / 2];
  float st[B / 2], st2[B], dpt[B / 2], dpt2[B];
  uint32_t ph[B / 8][4], pl[B / 8][4], dh_[B / 8][4], dl[B / 8][4];   // P^T, dS^T of the tile
  int g = 0;
  const Turns turns{wg};
  turns.start();
  for (int it = 0;; ++it) {
    int bh, k0, t0, num_t;
    if (!items.get(it, bh, k0, t0, num_t)) break;
    const bool last_item = !items.has(it + 1);
    const int kr = k0 + own_row + (tid / 32) * 16 + lane / 4;
    auto stage = [&](int t) { return (g + t) % P::kStages; };
    auto phase = [&](int t) { return ((g + t) / P::kStages) & 1; };
    auto issue_a = [&](int t) {   // S^T = K Q^T, dP^T = V dO^T
      product_ss<P>(st, st2, sm.own(0, 0), sm.own(0, 1), sm.tile(stage(t), 0), own_row);
      product_ss<P>(dpt, dpt2, sm.own(1, 0), sm.own(1, 1), sm.tile(stage(t), 2), own_row);
      wg_commit();
    };
    auto issue_c = [&](int t) {   // dV += P^T dO, dK += dS^T Q
      product_rs<P, true>(part_v, ph, pl, sm.tile(stage(t), 6), sm.tile(stage(t), 7), c_lo);
      product_rs<P, true>(part_k, dh_, dl, sm.tile(stage(t), 4), sm.tile(stage(t), 5), c_lo);
      wg_commit();
    };
    auto add_parts = [&]() {
      reg_fence(part_v);
      reg_fence(part_k);
#pragma unroll
      for (int i = 0; i < P::kCols / 2; ++i) {
        acc_v[i] += part_v[i];
        acc_k[i] += part_k[i];
      }
    };
    auto scores = [&](int t) {   // P^T and dS^T, in f32; 0 off the item's rows
      add_score<B>(st, st2);
      add_score<B>(dpt, dpt2);
      const float* tl = sm.vec(stage(t), 0);
      const float* td = sm.vec(stage(t), 1);
      const int row0 = (t0 + t) * B;
#pragma unroll
      for (int i = 0; i < B / 2; ++i) {
        const int key = kr + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + (i & 1) + 2 * (lane % 4);
        const int qi = row0 + c;
        const bool valid =
            qi < L && key < L && key - k0 < P::kRows && (!causal || qi >= key);
        const float p = exp2_approx(fmaf(st[i], scale_log2, -tl[c]));
        dpt[i] = valid ? __fmul_rn(__fmul_rn(p, dpt[i] - td[c]), scale) : 0.f;
        st[i] = valid ? p : 0.f;
      }
    };
    auto to_frags = [&]() {
#pragma unroll
      for (int kk = 0; kk < B / 8; ++kk) {
        to_tf32_frags(st, kk, ph[kk], pl[kk]);
        to_tf32_frags(dpt, kk, dh_[kk], dl[kk]);
      }
    };

#pragma unroll
    for (int i = 0; i < P::kCols / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(sm.own_ready(), it & 1);
    for (int t = 0; t < num_t; ++t) {
      mbar_wait(sm.ready(stage(t)), phase(t));
      turns.mine();
      wg_fence();
      issue_a(t);
      turns.theirs(false);
      wg_wait<0>();
      if (t == num_t - 1) mbar_arrive(sm.own_empty());   // the item's K and V are read
      scores(t);
      to_frags();
      turns.mine();
      wg_fence();
      issue_c(t);
      turns.theirs(last_item && t == num_t - 1);
      wg_wait<0>();
      add_parts();
      mbar_arrive(sm.empty(stage(t)));
    }
    g += num_t;

    const size_t base = (size_t)bh * L * dh;
#pragma unroll
    for (int i = 0; i < P::kCols / 2; i += 2) {
      const int row = kr + 8 * ((i >> 1) & 1);
      const int col = c_lo + 8 * (i >> 2) + 2 * (lane % 4);
      if (row < L && row - k0 < P::kRows && col < dh) {
        const size_t at = base + (size_t)row * dh + col;
        *reinterpret_cast<float2*>(dk + at) = make_float2(acc_k[i], acc_k[i + 1]);
        *reinterpret_cast<float2*>(dv + at) = make_float2(acc_v[i], acc_v[i + 1]);
      }
    }
  }
}

// ---- launch -------------------------------------------------------------------

// Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32.
float scale_f32(int dh) { return (float)std::pow((double)dh, -0.5); }

int f32_map(CUtensorMap* map, const void* base, int BH, int L, int dh, int rows) {
  return make_tile_map(map, base, BH, L, dh, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
}

// Opt the kernel into its shared memory and size its persistent grid; 0 or
// the CUDA error.
template <class P, class K>
int prepare(K kernel, int BH, int L, int* grid) {
  const cudaError_t err = allow_smem(kernel, P::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = persistent_grid((long long)BH * ((L + P::kRows - 1) / P::kRows));
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorInvalidDevice);
}

template <int DHP>
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int L,
            int dh, int causal, cudaStream_t s) {
  typedef FwdPlan<DHP> P;
  CUtensorMap q_map, k_map, v_map;
  int res = f32_map(&q_map, q, BH, L, dh, P::kRows);
  if (res == 0) res = f32_map(&k_map, k, BH, L, dh, P::kB);
  if (res == 0) res = f32_map(&v_map, v, BH, L, dh, P::kB);
  int grid = 0;
  if (res == 0) res = prepare<P>(flash_fwd_f32_kernel<P>, BH, L, &grid);
  if (res != 0) return res;
  flash_fwd_f32_kernel<P><<<grid, kThreads, P::kBytes, s>>>(
      q_map, k_map, v_map, static_cast<float*>(out), static_cast<float*>(lse), BH, L, dh,
      scale_f32(dh) * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int L, int dh, int causal, cudaStream_t s) {
  typedef DqPlan<DHP> P;
  CUtensorMap q_map, do_map, k_map, v_map;
  int res = f32_map(&q_map, q, BH, L, dh, P::kRows);
  if (res == 0) res = f32_map(&do_map, dout, BH, L, dh, P::kRows);
  if (res == 0) res = f32_map(&k_map, k, BH, L, dh, P::kB);
  if (res == 0) res = f32_map(&v_map, v, BH, L, dh, P::kB);
  int grid = 0;
  if (res == 0) res = prepare<P>(flash_dq_f32_kernel<P>, BH, L, &grid);
  if (res != 0) return res;
  flash_dq_f32_kernel<P><<<grid, kThreads, P::kBytes, s>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), BH, L, dh, scale_f32(dh),
      scale_f32(dh) * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int L, int dh, int causal,
            cudaStream_t s) {
  typedef DkvPlan<DHP> P;
  CUtensorMap k_map, v_map, q_map, do_map;
  int res = f32_map(&k_map, k, BH, L, dh, P::kRows);
  if (res == 0) res = f32_map(&v_map, v, BH, L, dh, P::kRows);
  if (res == 0) res = f32_map(&q_map, q, BH, L, dh, P::kB);
  if (res == 0) res = f32_map(&do_map, dout, BH, L, dh, P::kB);
  int grid = 0;
  if (res == 0) res = prepare<P>(flash_dkv_f32_kernel<P>, BH, L, &grid);
  if (res != 0) return res;
  flash_dkv_f32_kernel<P><<<grid, kThreads, P::kBytes, s>>>(
      k_map, v_map, q_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), BH, L,
      dh, scale_f32(dh), scale_f32(dh) * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int resources_f32(int kernel, int* out) {
  switch (kernel) {
    case 0:
      return kernel_resources(flash_fwd_f32_kernel<FwdPlan<DHP>>, kThreads, FwdPlan<DHP>::kBytes,
                              out);
    case 1:
      return kernel_resources(flash_dq_f32_kernel<DqPlan<DHP>>, kThreads, DqPlan<DHP>::kBytes,
                              out);
    default:
      return kernel_resources(flash_dkv_f32_kernel<DkvPlan<DHP>>, kThreads,
                              DkvPlan<DHP>::kBytes, out);
  }
}

bool bad_shape_f32(int BH, int L, int dh) {
  return BH <= 0 || L <= 0 || dh <= 0 || dh % 8 || dh > 256 ||
         (long long)BH * ((L + 15) / 16) > 0x7fffffff;
}

}  // namespace

// The f32 kernel `kernel` (0 forward, 1 dQ, 2 dK/dV)'s resources at head
// width dh (hopper.cuh::kernel_resources); read by
// apertis_flash_attention_resources.
int flash_f32_resources(int kernel, int dh, int* out) {
  if (dh <= 32) return resources_f32<32>(kernel, out);
  if (dh <= 64) return resources_f32<64>(kernel, out);
  if (dh <= 128) return resources_f32<128>(kernel, out);
  return resources_f32<256>(kernel, out);
}

// The forward of BH = B * H (L, dh) f32 attentions; dh a multiple of 8 up to
// 256. Returns cudaGetLastError(), or cudaErrorInvalidResourceHandle if a
// tensor map cannot be made.
extern "C" int apertis_flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                               void* out, void* lse, int BH, int L, int dh,
                                               int causal, void* stream) {
  if (bad_shape_f32(BH, L, dh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32) return fwd_f32<32>(q, k, v, out, lse, BH, L, dh, causal, s);
  if (dh <= 64) return fwd_f32<64>(q, k, v, out, lse, BH, L, dh, causal, s);
  if (dh <= 128) return fwd_f32<128>(q, k, v, out, lse, BH, L, dh, causal, s);
  return fwd_f32<256>(q, k, v, out, lse, BH, L, dh, causal, s);
}

// dQ of BH = B * H (L, dh) f32 attentions. Returns what
// apertis_flash_attention_fwd_f32 returns.
extern "C" int apertis_flash_attention_dq_f32(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dq, int BH, int L, int dh,
                                              int causal, void* stream) {
  if (bad_shape_f32(BH, L, dh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32) return dq_f32<32>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, s);
  if (dh <= 64) return dq_f32<64>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, s);
  if (dh <= 128) return dq_f32<128>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, s);
  return dq_f32<256>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, s);
}

// dK and dV of BH = B * H (L, dh) f32 attentions. Returns what
// apertis_flash_attention_fwd_f32 returns.
extern "C" int apertis_flash_attention_dkv_f32(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dk, void* dv, int BH,
                                               int L, int dh, int causal, void* stream) {
  if (bad_shape_f32(BH, L, dh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 32) return dkv_f32<32>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, s);
  if (dh <= 64) return dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, s);
  if (dh <= 128) return dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, s);
  return dkv_f32<256>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, s);
}
