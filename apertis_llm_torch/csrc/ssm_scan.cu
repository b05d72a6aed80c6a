// selective_scan_fwd / selective_scan_bwd: the selective-SSM scan over a whole
// sequence (prefill and training) and its gradient.
//
// Replaces: apertis_llm_tpu/ops/pallas/ssm_scan.py::gated_scan_2d, forward
// and custom-VJP backward (:302-321), with the reverse scan that backward
// runs through selective_scan_pallas's core (_scan_2d, :87-97). Its caller
// ops/ssm.py::ssm_mix builds exp(delta*A) and the mask outside the kernel and
// relayouts every operand time-minor first; here both are folded in.
//
// Forward, for every batch row b and channel c = head * N + n:
//   h[t] = exp(delta[b,t,head] * A[c]) * h[t-1] + B[b,t,c]     (f32 carry)
//   y[b,t,c] = C[b,t,c] * h[t]                                  (out dtype)
//   h_last[b,c] = h[L-1]; with a gradient to come, every h[t] in f32 too.
// A masked step (mask[b,t] == 0) is the identity: a = 1, b = 0, so h_last is
// the state after each row's last real token.
//
// Backward (the scan adjoint), from gy = dL/dy and g_last = dL/dh_last:
//   dh[t] = gy[t] * C[t] (+ g_last at t = L-1)
//   lam[t] = dh[t] + a[t+1] * lam[t+1]                  (reverse scan)
//   dC[t] = gy[t] * h[t];  dB[t] = lam[t];  da[t] = lam[t] * h[t-1]
// and, through a = exp(delta * A), the gradients of this kernel's own
// inputs: d_delta[b,t,head] = sum_n da * a * A[c], dA[c] = sum_{b,t} da * a *
// delta. A masked step contributes nothing to d_delta, dA or dB (its a and b
// are constants) and lam passes through it with a = 1.
//
// Bound on the H100: bytes. A forward step of a channel reads B and C and
// writes y (6 bytes in bf16; 10 more with h in f32) for one multiply-add; a
// backward step reads gy, C and h and writes dB and dC (14 bytes in bf16) for
// a few flops: both far below the card's operations-per-byte line. The
// recurrence is sequential in t, so both directions cut the time axis into
// K chunks and run B * K * H * N threads.
//
// Design of the forward: the TPU kernel's in-tile scan over the time axis
// (ssm_scan.py:208-246, pallas_call :274) becomes chunks of `chunk` steps
// (ops/kernels/ssm_scan.py::FWD_CHUNK), one thread a (b, chunk, c). One
// thread a (b, c) walking the whole L would leave the card mostly idle at
// the training shapes (76 blocks of 128 threads for 132 SMs at (4, 1024,
// 38, 16), 8 at the MoE mixer's 11 heads), each thread waiting on its
// loads for 1,024 dependent steps. The recurrence is linear, so
// h[t1 - 1] = local + prod * h[t0 - 1] for a chunk [t0, t1), where local is
// the chunk's own scan from h = 0 and prod = a[t0] ... a[t1 - 1]:
//   1. scan_fwd_local_kernel: local and prod of every chunk but the last,
//      into a (2, B, K, C) f32 scratch (reads delta and B only);
//   2. selective_scan_fwd_kernel: each thread resolves its chunk's carry
//      h[t0 - 1] from 0 and the earlier chunks' (local, prod), j = 0 up to
//      k - 1, the same order for every k (chunk_scan.cuh, shared with
//      scan_carry.cu: loads in batches of kFold ahead of the fused
//      multiply-adds, no launch and no wait on other blocks), reruns the
//      chunk from it and writes y, every h with want_h, and, in the last
//      chunk, h_last.
// With one chunk (L <= chunk) only pass 2 runs, from h = 0: the sequential
// scan, step for step. Elsewhere the chunked carry reassociates
// h's sums (about an f32 ulp of h a chunk boundary). No atomics: the same
// bits from run to run. Lanes (b, c) are numbered across the batch, so no
// block idles on a row's ragged last channels (176 channels a row of the
// MoE mixer). Within a chunk a thread loads chunk_scan::kTile steps of
// delta, B, C (and the mask) before the first enters its dependent chain, so
// a tile's loads are in flight together: at the prefill shape (64, 32, 38,
// 16), K = 1, two rounds of load latency for the 32 steps. A step's offsets
// are 32-bit multiples of the strides from the thread's base pointers, so
// a tile holds little more than its loaded values in registers (56-90 a
// thread; 64-bit offsets took 148-200, too few resident threads to hide
// the loads at the prefill shape). Neighbouring threads
// read neighbouring channels of the natural (B, L, H*N) layout, so every
// load and store coalesces without the TPU kernel's time-minor relayout,
// its 128-lane padding, or the exp(delta*A) tensor in device memory: delta
// is a broadcast load shared by the N threads of a head and the
// exponential is computed in the thread. Bytes: pass 1 reads delta and B again, about 5.6
// MB more than the 25.5 MB the forward must move at (4, 1024, 38, 16) with
// want_h.
//
// Design of the backward: one thread a (b, c) alone would leave the card
// mostly idle (2,432 threads at the 1.5B training shape, each waiting on
// its loads step after step for 1,024 steps), so the time axis is cut into
// K chunks of `chunk` steps (ops/kernels/ssm_scan.py::BWD_CHUNK, 32) and a
// thread owns one (b, chunk, c). The adjoint is a linear recurrence, so
// lam[t0] = lam0 + prod * lam[t1] for a chunk [t0, t1), where lam0 is the
// chunk's own reverse scan from lam = 0 and prod the decays lam passes
// through:
//   1. scan_bwd_local_kernel: lam0 and prod of every chunk but the first,
//      into a (B, K, C) f32 scratch (reads gy, C and delta);
//   2. each thread of pass 3 resolves its chunk's carry lam[t1] from the
//      later chunks' (lam0, prod), in a fixed order (K - 1 - k loads and
//      fused multiply-adds: no launch and no wait on other blocks);
//   3. selective_scan_bwd(_smem)_kernel reruns the chunk's reverse scan
//      from its carry and writes dB, dC and d_delta as a whole-L scan would,
//      keeping h[t-1] and a[t] in registers for the next step down, and a dA
//      partial a (b, chunk, c) that sum_rows_kernel adds over (b, chunk) in
//      order.
// No atomics, so the result is the same from run to run; the chunked carry
// reassociates lam's sums (about an f32 ulp of lam a chunk boundary).
// d_delta sums a head's N channels at every step, in a fixed order either
// way:
//   * N a power of two up to 32 (selective_scan_bwd_kernel): a head is N
//     neighbouring lanes of one warp, and a butterfly of warp shuffles sums
//     them;
//   * any other N (selective_scan_bwd_smem_kernel, up to 1024): a block
//     holds whole heads (128 / N of them, or one), each thread stores its
//     term in shared memory, and the head's first thread adds the N terms
//     in channel order between two block barriers.
// Bytes: pass 1 reads gy and C again, about 10 MB more than the 30 MB the
// gradient must move at the 1.5B training shape (4, 1024, 38, 16).

#include "chunk_scan.cuh"
#include "common.cuh"

namespace {

constexpr int kScanThreads = 128;

// One thread's view of its lane (b, c) from step t on: delta (stride H), B,
// C, y and h (stride C), the mask (stride 1, or null); a step's offsets are
// 32-bit multiples of the strides from these bases, and the loads go
// through the read-only path (__ldg).
template <typename TIn, typename TOut>
struct FwdLane {
  const float* delta;
  const TIn* b;
  const TIn* c;
  const int* mask;
  TOut* y;
  float* h;
  int heads, channels;
  float a_c;

  __device__ __forceinline__ void advance(int steps) {
    delta += steps * heads;
    b += steps * channels;
    if (c != nullptr) c += steps * channels;
    if (mask != nullptr) mask += steps;
    if (y != nullptr) y += steps * channels;
    if (h != nullptr) h += steps * channels;
  }
};

// kSteps steps of the recurrence from `h` (masked step: a = 1, b = 0): all
// their loads first, then the chain. With kOut, y = C * h (and h itself
// where the lane has an h pointer) is written at each step; without, `prod`
// collects the decays.
template <int kSteps, bool kOut, typename TIn, typename TOut>
__device__ __forceinline__ float fwd_steps(const FwdLane<TIn, TOut>& ln, float h, float& prod) {
  float dt[kSteps];
  TIn u[kSteps], gate[kSteps];
  bool on[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    dt[s] = __ldg(ln.delta + s * ln.heads);
    u[s] = __ldg(ln.b + s * ln.channels);
    if constexpr (kOut) gate[s] = __ldg(ln.c + s * ln.channels);
    on[s] = ln.mask == nullptr || __ldg(ln.mask + s) != 0;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float decay = on[s] ? expf(dt[s] * ln.a_c) : 1.f;
    h = fmaf(decay, h, on[s] ? to_f32(u[s]) : 0.f);
    if constexpr (kOut) {
      ln.y[s * ln.channels] = from_f32<TOut>(to_f32(gate[s]) * h);
      if (ln.h != nullptr) ln.h[s * ln.channels] = h;
    } else {
      prod *= decay;
    }
  }
  return h;
}

// The steps [t0, t1) of a lane from `h`: whole tiles, then one step at a
// time.
template <bool kOut, typename TIn, typename TOut>
__device__ __forceinline__ float fwd_chunk(FwdLane<TIn, TOut> ln, int t0, int t1, float h,
                                           float& prod) {
  int t = t0;
  for (; t + chunk_scan::kTile <= t1; t += chunk_scan::kTile) {
    h = fwd_steps<chunk_scan::kTile, kOut>(ln, h, prod);
    ln.advance(chunk_scan::kTile);
  }
  for (; t < t1; ++t) {
    h = fwd_steps<1, kOut>(ln, h, prod);
    ln.advance(1);
  }
  return h;
}

// Lane i = (b, c) of the forward at step t0, and its row b.
template <typename TIn, typename TOut>
__device__ __forceinline__ FwdLane<TIn, TOut> fwd_lane(
    long long i, int t0, const float* delta, const float* a_cont, const TIn* b_term,
    const TIn* c_mod, const int* mask, TOut* y, float* h_all, int seq_len, int heads,
    int d_state, int& b) {
  const int channels = heads * d_state;
  b = static_cast<int>(i / channels);
  const int c = static_cast<int>(i - (long long)b * channels);
  const size_t rt = (size_t)b * seq_len + t0;
  const size_t off = rt * channels + c;
  FwdLane<TIn, TOut> ln;
  ln.delta = delta + rt * heads + c / d_state;
  ln.b = b_term + off;
  ln.c = c_mod != nullptr ? c_mod + off : nullptr;
  ln.mask = mask != nullptr ? mask + rt : nullptr;
  ln.y = y != nullptr ? y + off : nullptr;
  ln.h = h_all != nullptr ? h_all + off : nullptr;
  ln.heads = heads;
  ln.channels = channels;
  ln.a_c = a_cont[c];
  return ln;
}

// Pass 1 of the chunked forward, for chunk k = blockIdx.y (the last chunk's
// are never read) of lane i = (b, c): the scan over the chunk's steps
// [t0, t1) from h = 0 (`local`) and the product of its decays, a[t0] ...
// a[t1 - 1] (`prod`; a = 1 at a masked step), so that the true h[t1 - 1] =
// local + prod * h[t0 - 1].
template <typename TIn>
__global__ void __launch_bounds__(kScanThreads) scan_fwd_local_kernel(
    const float* __restrict__ delta,   // (B, L, H)
    const float* __restrict__ a_cont,  // (H, N) == (C,)
    const TIn* __restrict__ b_term,    // (B, L, C)
    const int* __restrict__ mask,      // (B, L) or nullptr
    float* __restrict__ local,         // (B, K, C)
    float* __restrict__ prod,          // (B, K, C)
    long long lanes, int seq_len, int heads, int d_state, int chunk) {
  const long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= lanes) return;
  const int k = blockIdx.y, chunks = gridDim.y + 1;
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  int b;
  const FwdLane<TIn, float> ln = fwd_lane<TIn, float>(
      i, t0, delta, a_cont, b_term, nullptr, mask, nullptr, nullptr, seq_len, heads, d_state, b);
  float p = 1.f;
  const float h = fwd_chunk<false>(ln, t0, t1, 0.f, p);
  const int channels = heads * d_state;
  const size_t o = ((size_t)b * chunks + k) * channels + (i - (long long)b * channels);
  local[o] = h;
  prod[o] = p;
}

// The carry's combine, prod * carry + local, as a step's: one fused
// multiply-add.
struct FmaCombine {
  __device__ __forceinline__ float operator()(float p, float h, float l) const {
    return fmaf(p, h, l);
  }
};

// Pass 2, chunk k = blockIdx.y of lane i = (b, c): the carry h[t0 - 1],
// resolved from h = 0 and the earlier chunks' pass-1 results, j = 0 up to
// k - 1 (chunk_scan::resolve_carry); then the chunk's own steps from it.
// A masked step (mask[b,t] == 0) is the identity: a = 1, b = 0, so h_last
// is the state after each row's last real token. With one chunk this is
// the whole-L sequential scan.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kScanThreads) selective_scan_fwd_kernel(
    const float* __restrict__ delta,   // (B, L, H)
    const float* __restrict__ a_cont,  // (H, N) == (C,)
    const TIn* __restrict__ b_term,    // (B, L, C)
    const TIn* __restrict__ c_mod,     // (B, L, C)
    const int* __restrict__ mask,      // (B, L) or nullptr
    const float* __restrict__ local,   // (B, K, C) pass 1; unread with one chunk
    const float* __restrict__ prod,    // (B, K, C) pass 1
    TOut* __restrict__ y,              // (B, L, C)
    float* __restrict__ h_last,        // (B, C)
    float* __restrict__ h_all,         // (B, L, C) or nullptr
    long long lanes, int seq_len, int heads, int d_state, int chunk) {
  const long long i = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= lanes) return;
  const int k = blockIdx.y, chunks = gridDim.y;
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  int b;
  const FwdLane<TIn, TOut> ln = fwd_lane<TIn, TOut>(
      i, t0, delta, a_cont, b_term, c_mod, mask, y, h_all, seq_len, heads, d_state, b);
  const int channels = heads * d_state;
  float h = 0.f;
  if (k > 0) {
    const size_t sum0 = (size_t)b * chunks * channels + (i - (long long)b * channels);
    h = chunk_scan::resolve_carry(local + sum0, prod + sum0, channels, k, h, FmaCombine());
  }
  float unused = 1.f;
  h = fwd_chunk<true>(ln, t0, t1, h, unused);
  if (k == chunks - 1) h_last[i] = h;
}

// Sum of v over the `width` neighbouring lanes of a group (width a power of
// two up to 32), by a butterfly of shuffles: every lane of the group gets the
// same sum, in the same order on every run.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The decay a[t] of one (b, c): exp(delta * A), 1 at a masked step.
__device__ __forceinline__ float scan_decay(const float* __restrict__ delta,
                                            const int* __restrict__ mask, size_t row, int t,
                                            int heads, int head, float a_c) {
  if (mask != nullptr && mask[row + t] == 0) return 1.f;
  return expf(delta[(row + t) * heads + head] * a_c);
}

// Pass 1 of the chunked backward, for chunk k = blockIdx.z + 1 (chunk 0's
// are never read) of one (b, c): the reverse scan over the chunk's steps
// [t0, t1) from lam = 0, kept only at t0 (`lam0`), and the product of the
// decays lam passes through from t1 down to t0, a[t1] a[t1 - 1] ... a[t0 + 1]
// (`prod`; a[L] = 1), so that the true lam[t0] = lam0 + prod * lam[t1].
template <typename TIn, typename TG>
__global__ void __launch_bounds__(kScanThreads) scan_bwd_local_kernel(
    const float* __restrict__ delta,   // (B, L, H)
    const float* __restrict__ a_cont,  // (C,)
    const TIn* __restrict__ c_mod,     // (B, L, C)
    const int* __restrict__ mask,      // (B, L) or nullptr
    const TG* __restrict__ gy,         // (B, L, C)
    const float* __restrict__ g_last,  // (B, C) or nullptr
    float* __restrict__ lam0,          // (B, K, C)
    float* __restrict__ prod,          // (B, K, C)
    int seq_len, int heads, int d_state, int chunk, int chunks) {
  const int channels = heads * d_state;
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int k = blockIdx.z + 1;
  if (c >= channels) return;
  const int head = c / d_state;
  const float a_c = a_cont[c];
  const size_t row = (size_t)b * seq_len;
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  float a_next = t1 < seq_len ? scan_decay(delta, mask, row, t1, heads, head, a_c) : 1.f;
  float lam = 0.f, p = a_next;
#pragma unroll 4
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t off = (row + t) * channels + c;
    float dh = to_f32(gy[off]) * to_f32(c_mod[off]);
    if (t == seq_len - 1 && g_last != nullptr) dh += g_last[(size_t)b * channels + c];
    lam = fmaf(a_next, lam, dh);
    a_next = scan_decay(delta, mask, row, t, heads, head, a_c);
    if (t > t0) p *= a_next;
  }
  const size_t o = ((size_t)b * chunks + k) * channels + c;
  lam0[o] = lam;
  prod[o] = p;
}

// Pass 3, the reverse scan of chunk k = blockIdx.z of one (b, c), shared by
// both backward kernels; only the sum over a head's N channels differs
// (kSmem: through `red`, one float a thread of the block). The carry into
// the chunk, lam[t1], is resolved first from the later chunks' pass-1
// results, j = K-1 down to k+1: carry = lam0[j] + prod[j] * carry (from 0 =
// lam[L]); the same j order for every k, so every chunk's carry is the one
// its neighbour's run would give.
template <typename TIn, typename TG, bool kSmem>
__device__ __forceinline__ void scan_bwd_body(
    const float* __restrict__ delta,   // (B, L, H)
    const float* __restrict__ a_cont,  // (C,)
    const TIn* __restrict__ c_mod,     // (B, L, C)
    const int* __restrict__ mask,      // (B, L) or nullptr
    const float* __restrict__ h_all,   // (B, L, C) f32, the forward's states
    const TG* __restrict__ gy,         // (B, L, C) dL/dy
    const float* __restrict__ g_last,  // (B, C) dL/dh_last or nullptr
    const float* __restrict__ lam0,    // (B, K, C) pass 1
    const float* __restrict__ prod,    // (B, K, C) pass 1
    float* __restrict__ d_delta,       // (B, L, H)
    TIn* __restrict__ db,              // (B, L, C)
    TIn* __restrict__ dc,              // (B, L, C)
    float* __restrict__ da_part,       // (B, K, C) per-(row, chunk) partial of dA
    int seq_len, int heads, int d_state, int chunk, float* red) {
  const int channels = heads * d_state;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  const int k = blockIdx.z, chunks = gridDim.z;
  // Threads past the last channel stay in the loop with zeros, so that the
  // shuffles of a head always see a whole warp and every thread reaches the
  // block barriers; a block starts on a head, so no head mixes live and idle
  // threads.
  const bool live = c < channels;
  const int cc = live ? c : channels - 1;
  const int head = cc / d_state;
  const bool leader = live && (cc % d_state) == 0;
  const float a_c = live ? a_cont[cc] : 0.f;
  const size_t row = (size_t)b * seq_len;
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  float lam = 0.f;                          // lam[t1]; lam[L] = 0
  for (int j = chunks - 1; j > k && live; --j) {
    const size_t o = ((size_t)b * chunks + j) * channels + cc;
    lam = fmaf(prod[o], lam, lam0[o]);
  }
  float a_next = t1 < seq_len ? scan_decay(delta, mask, row, t1, heads, head, a_c) : 1.f;
  float dA = 0.f;
  float h_t = live ? h_all[(row + t1 - 1) * channels + cc] : 0.f;
#pragma unroll 2
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t off = (row + t) * channels + cc;
    const float g = live ? to_f32(gy[off]) : 0.f;
    const float gate = live ? to_f32(c_mod[off]) : 0.f;
    const float h_prev = (live && t > 0) ? h_all[off - channels] : 0.f;
    const bool masked = mask != nullptr && mask[row + t] == 0;
    const float dt = delta[(row + t) * heads + head];
    const float a_t = masked ? 1.f : expf(dt * a_c);
    float dh = g * gate;
    if (t == seq_len - 1 && g_last != nullptr && live) dh += g_last[(size_t)b * channels + cc];
    lam = fmaf(a_next, lam, dh);
    const float da = lam * h_prev;
    const float chain = masked ? 0.f : da * a_t;   // dL/d(delta * A)
    dA = fmaf(chain, dt, dA);
    float dd;
    if constexpr (kSmem) {
      red[threadIdx.x] = chain * a_c;
      __syncthreads();
      dd = 0.f;
      if (leader)
        for (int i = 0; i < d_state; ++i) dd += red[threadIdx.x + i];
      __syncthreads();   // the terms are read before the next step writes them
    } else {
      dd = group_sum(chain * a_c, d_state);
    }
    if (live) {
      dc[off] = from_f32<TIn>(g * h_t);
      db[off] = from_f32<TIn>(masked ? 0.f : lam);
    }
    if (leader) d_delta[(row + t) * heads + head] = dd;
    a_next = a_t;
    h_t = h_prev;
  }
  if (live) da_part[((size_t)b * chunks + k) * channels + c] = dA;
}

// N a power of two up to 32: blocks of kScanThreads channels.
template <typename TIn, typename TG>
__global__ void __launch_bounds__(kScanThreads) selective_scan_bwd_kernel(
    const float* __restrict__ delta, const float* __restrict__ a_cont,
    const TIn* __restrict__ c_mod, const int* __restrict__ mask,
    const float* __restrict__ h_all, const TG* __restrict__ gy,
    const float* __restrict__ g_last, const float* __restrict__ lam0,
    const float* __restrict__ prod, float* __restrict__ d_delta, TIn* __restrict__ db,
    TIn* __restrict__ dc, float* __restrict__ da_part, int seq_len, int heads, int d_state,
    int chunk) {
  scan_bwd_body<TIn, TG, false>(delta, a_cont, c_mod, mask, h_all, gy, g_last, lam0, prod,
                                d_delta, db, dc, da_part, seq_len, heads, d_state, chunk,
                                nullptr);
}

// Any other N up to kMaxSmemState: blocks of whole heads, blockDim.x floats
// of dynamic shared memory.
constexpr int kMaxSmemState = 1024;

template <typename TIn, typename TG>
__global__ void __launch_bounds__(kMaxSmemState) selective_scan_bwd_smem_kernel(
    const float* __restrict__ delta, const float* __restrict__ a_cont,
    const TIn* __restrict__ c_mod, const int* __restrict__ mask,
    const float* __restrict__ h_all, const TG* __restrict__ gy,
    const float* __restrict__ g_last, const float* __restrict__ lam0,
    const float* __restrict__ prod, float* __restrict__ d_delta, TIn* __restrict__ db,
    TIn* __restrict__ dc, float* __restrict__ da_part, int seq_len, int heads, int d_state,
    int chunk) {
  extern __shared__ float red[];
  scan_bwd_body<TIn, TG, true>(delta, a_cont, c_mod, mask, h_all, gy, g_last, lam0, prod,
                               d_delta, db, dc, da_part, seq_len, heads, d_state, chunk, red);
}

// dA[c] = sum over the (row, chunk) partials, in order.
__global__ void __launch_bounds__(kScanThreads) sum_rows_kernel(
    const float* __restrict__ part, float* __restrict__ out, int rows, int channels) {
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  if (c >= channels) return;
  float s = 0.f;
  for (int b = 0; b < rows; ++b) s += part[(size_t)b * channels + c];
  out[c] = s;
}

inline unsigned scan_blocks(long long lanes) {
  return static_cast<unsigned>((lanes + kScanThreads - 1) / kScanThreads);
}

template <typename TIn, typename TOut>
void launch_scan(const void* delta, const void* a_cont, const void* b_term,
                 const void* c_mod, const void* mask, void* y, void* h_last, void* h_all,
                 void* scratch, int batch, int seq_len, int heads, int d_state, int chunk,
                 cudaStream_t stream) {
  const long long lanes = (long long)batch * heads * d_state;
  const int chunks = (seq_len + chunk - 1) / chunk;
  const auto* delta_ = static_cast<const float*>(delta);
  const auto* a_ = static_cast<const float*>(a_cont);
  const auto* b_ = static_cast<const TIn*>(b_term);
  const auto* mask_ = static_cast<const int*>(mask);
  float* local = chunks > 1 ? static_cast<float*>(scratch) : nullptr;
  float* prod = chunks > 1 ? local + (size_t)lanes * chunks : nullptr;
  if (chunks > 1)
    scan_fwd_local_kernel<TIn><<<dim3(scan_blocks(lanes), chunks - 1), kScanThreads, 0,
                                 stream>>>(delta_, a_, b_, mask_, local, prod, lanes, seq_len,
                                           heads, d_state, chunk);
  selective_scan_fwd_kernel<TIn, TOut>
      <<<dim3(scan_blocks(lanes), chunks), kScanThreads, 0, stream>>>(
          delta_, a_, b_, static_cast<const TIn*>(c_mod), mask_, local, prod,
          static_cast<TOut*>(y), static_cast<float*>(h_last), static_cast<float*>(h_all),
          lanes, seq_len, heads, d_state, chunk);
}

template <typename TIn, typename TG>
void launch_scan_bwd(const void* delta, const void* a_cont, const void* c_mod,
                     const void* mask, const void* h_all, const void* gy, const void* g_last,
                     void* d_delta, void* da, void* db, void* dc, void* scratch, int batch,
                     int seq_len, int heads, int d_state, int chunk, bool smem,
                     cudaStream_t stream) {
  const int channels = heads * d_state;
  const int chunks = (seq_len + chunk - 1) / chunk;
  const size_t part = (size_t)batch * chunks * channels;
  const auto* delta_ = static_cast<const float*>(delta);
  const auto* a_ = static_cast<const float*>(a_cont);
  const auto* c_ = static_cast<const TIn*>(c_mod);
  const auto* mask_ = static_cast<const int*>(mask);
  const auto* h_ = static_cast<const float*>(h_all);
  const auto* gy_ = static_cast<const TG*>(gy);
  const auto* gl_ = static_cast<const float*>(g_last);
  auto* dd_ = static_cast<float*>(d_delta);
  auto* db_ = static_cast<TIn*>(db);
  auto* dc_ = static_cast<TIn*>(dc);
  auto* da_part = static_cast<float*>(scratch);
  float* lam0 = da_part + part;
  float* prod = lam0 + part;
  if (chunks > 1)
    scan_bwd_local_kernel<TIn, TG>
        <<<dim3((channels + kScanThreads - 1) / kScanThreads, batch, chunks - 1), kScanThreads,
            0, stream>>>(delta_, a_, c_, mask_, gy_, gl_, lam0, prod, seq_len, heads, d_state,
                         chunk, chunks);
  if (smem) {
    const int heads_per_block = d_state <= kScanThreads ? kScanThreads / d_state : 1;
    const int threads = heads_per_block * d_state;
    const dim3 grid((heads + heads_per_block - 1) / heads_per_block, batch, chunks);
    selective_scan_bwd_smem_kernel<TIn, TG><<<grid, threads, threads * sizeof(float), stream>>>(
        delta_, a_, c_, mask_, h_, gy_, gl_, lam0, prod, dd_, db_, dc_, da_part, seq_len, heads,
        d_state, chunk);
  } else {
    const dim3 grid((channels + kScanThreads - 1) / kScanThreads, batch, chunks);
    selective_scan_bwd_kernel<TIn, TG><<<grid, kScanThreads, 0, stream>>>(
        delta_, a_, c_, mask_, h_, gy_, gl_, lam0, prod, dd_, db_, dc_, da_part, seq_len, heads,
        d_state, chunk);
  }
  sum_rows_kernel<<<(channels + kScanThreads - 1) / kScanThreads, kScanThreads, 0, stream>>>(
      da_part, static_cast<float*>(da), batch * chunks, channels);
}

int scan_bwd(const void* delta, const void* a_cont, const void* c_mod, const void* mask,
             const void* h_all, const void* gy, const void* g_last, void* d_delta, void* da,
             void* db, void* dc, void* scratch, int batch, int seq_len, int heads, int d_state,
             int chunk, int bc_bf16, int gy_bf16, bool smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_bf16 && gy_bf16)
    launch_scan_bwd<bf16, bf16>(delta, a_cont, c_mod, mask, h_all, gy, g_last, d_delta, da,
                                db, dc, scratch, batch, seq_len, heads, d_state, chunk, smem, s);
  else if (bc_bf16)
    launch_scan_bwd<bf16, float>(delta, a_cont, c_mod, mask, h_all, gy, g_last, d_delta, da,
                                 db, dc, scratch, batch, seq_len, heads, d_state, chunk, smem, s);
  else if (gy_bf16)
    launch_scan_bwd<float, bf16>(delta, a_cont, c_mod, mask, h_all, gy, g_last, d_delta, da,
                                 db, dc, scratch, batch, seq_len, heads, d_state, chunk, smem, s);
  else
    launch_scan_bwd<float, float>(delta, a_cont, c_mod, mask, h_all, gy, g_last, d_delta, da,
                                  db, dc, scratch, batch, seq_len, heads, d_state, chunk, smem,
                                  s);
  return static_cast<int>(cudaGetLastError());
}

// The arguments both entry points take, and their chunk count's bound (a
// grid's z extent).
bool bwd_args_ok(int batch, int seq_len, int heads, int chunk) {
  return batch > 0 && batch <= 65535 && seq_len > 0 && heads > 0 && chunk > 0 &&
         (seq_len + chunk - 1) / chunk <= 65535;
}

bool pow2_state(int d_state) { return d_state <= 32 && (d_state & (d_state - 1)) == 0; }

}  // namespace

// The forward over chunks of `chunk` steps (ops/kernels/ssm_scan.py::
// FWD_CHUNK; one chunk of L is the plain sequential scan). b_term / c_mod
// are bf16 when bc_bf16 else f32; y is bf16 when y_bf16 else f32; h_all
// (B, L, C) f32 is written when not null; scratch is 2 x (B, K, C) f32 for
// K = ceil(L / chunk) chunks (pass 1's local and prod; unused, and may be
// null, when K is 1). Two launches where K > 1 (pass 1, pass 2), else one.
// Returns cudaGetLastError() after the launches.
extern "C" int apertis_selective_scan_fwd(const void* delta, const void* a_cont,
                                          const void* b_term, const void* c_mod,
                                          const void* mask, void* y, void* h_last,
                                          void* h_all, void* scratch, int batch, int seq_len,
                                          int heads, int d_state, int chunk, int bc_bf16,
                                          int y_bf16, void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0 || d_state <= 0 || chunk <= 0 ||
      (seq_len + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_bf16 && y_bf16)
    launch_scan<bf16, bf16>(delta, a_cont, b_term, c_mod, mask, y, h_last, h_all, scratch,
                            batch, seq_len, heads, d_state, chunk, s);
  else if (bc_bf16)
    launch_scan<bf16, float>(delta, a_cont, b_term, c_mod, mask, y, h_last, h_all, scratch,
                             batch, seq_len, heads, d_state, chunk, s);
  else if (y_bf16)
    launch_scan<float, bf16>(delta, a_cont, b_term, c_mod, mask, y, h_last, h_all, scratch,
                             batch, seq_len, heads, d_state, chunk, s);
  else
    launch_scan<float, float>(delta, a_cont, b_term, c_mod, mask, y, h_last, h_all, scratch,
                              batch, seq_len, heads, d_state, chunk, s);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of apertis_selective_scan_fwd, over chunks of `chunk` steps
// (ops/kernels/ssm_scan.py::BWD_CHUNK; one chunk of L is the plain
// sequential scan). c_mod, db and dc are bf16 when bc_bf16 else f32; gy is
// bf16 when gy_bf16 else f32; g_last (B, C) f32 may be null; scratch is 3 x
// (B, K, C) f32 for K = ceil(L / chunk) chunks (dA's partials, then pass
// 1's lam0 and prod). d_state must be a power of two up to 32 (a head's
// channels share one warp). Three launches (pass 1 where K > 1, pass 3,
// dA's sum). Returns cudaGetLastError().
extern "C" int apertis_selective_scan_bwd(const void* delta, const void* a_cont,
                                          const void* c_mod, const void* mask,
                                          const void* h_all, const void* gy,
                                          const void* g_last, void* d_delta, void* da,
                                          void* db, void* dc, void* scratch, int batch,
                                          int seq_len, int heads, int d_state, int chunk,
                                          int bc_bf16, int gy_bf16, void* stream) {
  if (d_state <= 0 || !pow2_state(d_state) || !bwd_args_ok(batch, seq_len, heads, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return scan_bwd(delta, a_cont, c_mod, mask, h_all, gy, g_last, d_delta, da, db, dc, scratch,
                  batch, seq_len, heads, d_state, chunk, bc_bf16, gy_bf16, false, stream);
}

// The same gradient for a d_state that is not a power of two up to 32 (at
// most 1024): a head's d_delta is summed through shared memory. The same
// arguments and launches. Returns cudaGetLastError().
extern "C" int apertis_selective_scan_bwd_smem(const void* delta, const void* a_cont,
                                               const void* c_mod, const void* mask,
                                               const void* h_all, const void* gy,
                                               const void* g_last, void* d_delta, void* da,
                                               void* db, void* dc, void* scratch, int batch,
                                               int seq_len, int heads, int d_state, int chunk,
                                               int bc_bf16, int gy_bf16, void* stream) {
  if (d_state <= 0 || d_state > kMaxSmemState || pow2_state(d_state) ||
      !bwd_args_ok(batch, seq_len, heads, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return scan_bwd(delta, a_cont, c_mod, mask, h_all, gy, g_last, d_delta, da, db, dc, scratch,
                  batch, seq_len, heads, d_state, chunk, bc_bf16, gy_bf16, true, stream);
}
