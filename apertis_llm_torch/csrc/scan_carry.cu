// selective_scan_carry_fwd / selective_scan_carry_bwd: the plain linear scan
// h[t] = a[t] * h[t-1] + b[t] over given decays and inputs, from a carried
// state, and its gradient.
//
// Replaces: apertis_llm_tpu/ops/pallas/ssm_scan.py::selective_scan_pallas
// (:184), whose forward and custom-VJP backward (:129-181) both run the
// Pallas scan _scan_2d (:87, pallas_call :97). The JAX package reaches it
// from sequence parallelism (parallel/sequence.py): a chunk's scan from a
// zero state, and its cumulative decay, the scan of (a, 0) from h_init = 1.
//
// Layout (B, H, L, N), the JAX function's own: row r = b * H + head, element
// (r, t, n) at (r * L + t) * N + n; h_init and h_last are (B, H, N).
//
// Forward, for every (r, n), in f32:
//   h[-1] = h_init (0 without one);  h[t] = a[t] * h[t-1] + b[t]
//   h is written in b's dtype (the f32 carry goes on unrounded), h_last =
//   h[L-1] in b's dtype, and, when asked (b in bf16 and a gradient to come),
//   every f32 state, which the backward reads.
// Backward (ssm_scan.py:153-178), from g = dL/dh (f32) and g_last =
// dL/dh_last, as a reverse scan from lam[L] = g_last (0 without one) with
// a[L] = 1:
//   lam[t] = g[t] + a[t+1] * lam[t+1]
//   da[t] = lam[t] * h[t-1] (h_init as h[-1]);  db[t] = lam[t]
//   dh_init = lam[0] * a[0]
// where the TPU kernel scans reversed, index-shifted copies of a and g.
//
// Both round every product and every sum once (__fmul_rn, __fadd_rn: no
// fused multiply-add), in the order of the plain versions in
// ops/kernels/ssm_scan.py. Both run over chunks of the time axis, whose
// carries reassociate the sums, so each agrees with its plain version bit
// for bit only where L fits one chunk (about an f32 ulp of h or lam a chunk
// boundary elsewhere; chip_smoke.py holds the forward to CARRY_TOL, 1e-5,
// and the backward to CARRY_BWD_TOL, 1e-4).
//
// Bound on the H100: bytes. A step of a channel reads a and b and writes h
// (12 bytes in f32) for one multiply and one add; the backward reads a, g
// and h and writes da and db (20 bytes) for two multiplies and one add: far
// below the card's operations-per-byte line. At the 1.5B model's per-rank
// shape (4, 38, 512, 16) the backward's arrays are 5 MB each: 25 MB, 0.0074
// ms at 3.35 TB/s; the forward's 15 MB, 0.0045 ms.
//
// Design of the forward: the TPU kernel's in-tile Hillis-Steele scan over
// the time axis (ssm_scan.py:53-77, pallas_call :97) becomes chunks of
// `chunk` steps (ops/kernels/ssm_scan.py::CARRY_FWD_CHUNK), one thread a
// (r, chunk, n). One thread a (r, n) walking the whole L would give the
// per-rank shape 19 blocks of 128 threads for 132 SMs, each thread waiting
// on its loads for 512 dependent steps. For a chunk [t0, t1),
// h[t1 - 1] = local + prod * h[t0 - 1], where local is the chunk's own scan
// from h = 0 and prod = a[t0] ... a[t1 - 1]:
//   1. scan_carry_fwd_local_kernel: local and prod of every chunk but the
//      last into a (2, R, K, N) f32 scratch (reads a and b);
//   2. scan_carry_fwd_kernel: each thread resolves its chunk's carry
//      h[t0 - 1] from h_init (0 without one) and the earlier chunks' (local,
//      prod), j = 0 up to k - 1, in that fixed order (chunk_scan.cuh,
//      shared with ssm_scan.cu: loads in batches of kFold ahead of the
//      chain, no wait on other blocks), reruns the chunk from it and writes
//      h, the f32 states when asked, and, in the last chunk, h_last.
// With one chunk (L <= chunk) only pass 2 runs: the sequential scan, the
// plain version's bits. Consecutive threads take consecutive n and
// then the next head, so each step's loads and stores are contiguous runs of
// N floats (two heads of 16 a warp at the 1.5B model's N = 16); a thread
// loads chunk_scan::kTile steps of a and b before the first enters its
// dependent chain. Bytes: pass 1 reads a and b again, about 25 MB at the per-rank
// shape (4, 38, 512, 16) in f32 where 15 MB must move.
//
// Design of the backward: one thread a (r, n) alone would leave the card
// mostly idle (2,432 threads at the per-rank shape, each waiting on its
// loads for 512 dependent steps), so the time axis is cut into K chunks of
// `chunk` steps (ops/kernels/ssm_scan.py::CARRY_BWD_CHUNK, 16) and a thread owns
// one (r, chunk, n), consecutive threads on consecutive n as above. The
// adjoint is a linear recurrence, so lam[t0] = lam0 + prod * lam[t1] for a
// chunk [t0, t1), where lam0 is the chunk's own reverse scan from lam = 0
// and prod the decays lam passes through, a[t1] a[t1 - 1] ... a[t0 + 1]:
//   1. scan_carry_bwd_local_kernel: lam0 and prod of every chunk but the
//      first into a (2, R, K, N) f32 scratch (reads a and g);
//   2. scan_carry_bwd_kernel: each thread resolves its chunk's carry
//      lam[t1] from g_last and the later chunks' (lam0, prod), j = K-1 down
//      to k+1, in that fixed order (independent loads and a chain of at most
//      K - 1 multiply-adds: no wait on other blocks), reruns the chunk from
//      it and writes da and db, keeping a[t] for the next step down; chunk
//      0's thread writes dh_init. It reads a, g and h and writes da and db.
// No atomics: the result is the same from run to run. The design moves
// about 35 MB at the per-rank shape (pass 1 reads a and g again), 0.0104 ms.

#include "chunk_scan.cuh"
#include "common.cuh"

namespace {

constexpr int kCarryThreads = 128;

// kSteps steps of h = a * h + b from `carry` through one lane's a and b
// (stride N from the step's base): all their loads first (read-only path),
// then the chain, every product and sum rounded once. With kOut, h (and the
// f32 state, where `st` is not null) is written at each step; without,
// `prod` collects the decays.
template <int kSteps, bool kOut, typename TB>
__device__ __forceinline__ float carry_steps(const float* a, const TB* b, TB* h, float* st,
                                             int d_state, float carry, float& prod) {
  float av[kSteps];
  TB bv[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    av[s] = __ldg(a + s * d_state);
    bv[s] = __ldg(b + s * d_state);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    carry = __fadd_rn(__fmul_rn(av[s], carry), to_f32(bv[s]));
    if constexpr (kOut) {
      h[s * d_state] = from_f32<TB>(carry);
      if (st != nullptr) st[s * d_state] = carry;
    } else {
      prod = __fmul_rn(prod, av[s]);
    }
  }
  return carry;
}

// The steps [t0, t1) of lane i = (r, n) from `carry`: whole tiles, then one
// step at a time. a, b, h and st point at the lane's step t0.
template <bool kOut, typename TB>
__device__ __forceinline__ float carry_chunk(const float* a, const TB* b, TB* h, float* st,
                                             int d_state, int t0, int t1, float carry,
                                             float& prod) {
  int t = t0;
  for (; t + chunk_scan::kTile <= t1; t += chunk_scan::kTile) {
    carry = carry_steps<chunk_scan::kTile, kOut>(a, b, h, st, d_state, carry, prod);
    const int step = chunk_scan::kTile * d_state;
    a += step;
    b += step;
    if constexpr (kOut) {
      h += step;
      if (st != nullptr) st += step;
    }
  }
  for (; t < t1; ++t) {
    carry = carry_steps<1, kOut>(a, b, h, st, d_state, carry, prod);
    a += d_state;
    b += d_state;
    if constexpr (kOut) {
      h += d_state;
      if (st != nullptr) st += d_state;
    }
  }
  return carry;
}

// Pass 1 of the forward, for chunk k = blockIdx.y (the last chunk's are
// never read) of lane i = (r, n): the scan over the chunk's steps [t0, t1)
// from h = 0 (local) and the product of its decays a[t0] ... a[t1 - 1]
// (prod), so that the true h[t1 - 1] = local + prod * h[t0 - 1].
template <typename TB>
__global__ void __launch_bounds__(kCarryThreads) scan_carry_fwd_local_kernel(
    const float* __restrict__ a,       // (R, L, N)
    const TB* __restrict__ b,          // (R, L, N)
    float* __restrict__ local,         // (R, K, N)
    float* __restrict__ prod,          // (R, K, N)
    long long lanes, int seq_len, int d_state, int chunk) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= lanes) return;
  const int k = blockIdx.y, chunks = gridDim.y + 1;
  const long long r = i / d_state;
  const int n = (int)(i - r * d_state);
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  const size_t off = ((size_t)r * seq_len + t0) * d_state + n;
  float p = 1.f;
  const float carry = carry_chunk<false, TB>(a + off, b + off, nullptr, nullptr, d_state, t0,
                                             t1, 0.f, p);
  const size_t o = ((size_t)r * chunks + k) * d_state + n;
  local[o] = carry;
  prod[o] = p;
}

// The carry's combine, prod * carry + local, as a step's: the product and
// the sum each rounded once.
struct RoundedCombine {
  __device__ __forceinline__ float operator()(float p, float h, float l) const {
    return __fadd_rn(__fmul_rn(p, h), l);
  }
};

// Pass 2, chunk k = blockIdx.y of lane i = (r, n): the carry h[t0 - 1],
// resolved from h_init (0 without one) and the earlier chunks' pass-1
// results, j = 0 up to k - 1 (chunk_scan::resolve_carry); then the chunk's
// own steps from it. With one chunk it is the
// whole-L scan.
template <typename TB>
__global__ void __launch_bounds__(kCarryThreads) scan_carry_fwd_kernel(
    const float* __restrict__ a,       // (R, L, N)
    const TB* __restrict__ b,          // (R, L, N)
    const float* __restrict__ h_init,  // (R, N) or nullptr
    const float* __restrict__ local,   // (R, K, N) pass 1; unread with one chunk
    const float* __restrict__ prod,    // (R, K, N) pass 1
    TB* __restrict__ h,                // (R, L, N)
    TB* __restrict__ h_last,           // (R, N)
    float* __restrict__ states,        // (R, L, N) f32 or nullptr
    long long lanes, int seq_len, int d_state, int chunk) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= lanes) return;
  const int k = blockIdx.y, chunks = gridDim.y;
  const long long r = i / d_state;
  const int n = (int)(i - r * d_state);
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  float carry = h_init != nullptr ? h_init[i] : 0.f;
  if (k > 0) {
    const size_t sum0 = (size_t)r * chunks * d_state + n;   // (r, 0, n)
    carry = chunk_scan::resolve_carry(local + sum0, prod + sum0, d_state, k, carry,
                                      RoundedCombine());
  }
  const size_t off = ((size_t)r * seq_len + t0) * d_state + n;
  float unused = 1.f;
  carry = carry_chunk<true, TB>(a + off, b + off, h + off,
                                states != nullptr ? states + off : nullptr, d_state, t0, t1,
                                carry, unused);
  if (k == chunks - 1) h_last[i] = from_f32<TB>(carry);
}

// Pass 1 of the backward, for chunk k = blockIdx.y + 1 (chunk 0's are never
// read) of lane i = (r, n): the reverse scan over the chunk's steps [t0, t1)
// from lam = 0, kept only at t0 (lam0), and the product of the decays lam
// passes through from t1 down to t0 (prod; a[L] = 1), so that the true
// lam[t0] = lam0 + prod * lam[t1].
__global__ void __launch_bounds__(kCarryThreads) scan_carry_bwd_local_kernel(
    const float* __restrict__ a,       // (R, L, N)
    const float* __restrict__ g,       // (R, L, N) dL/dh
    float* __restrict__ lam0,          // (R, K, N)
    float* __restrict__ prod,          // (R, K, N)
    long long lanes, int seq_len, int d_state, int chunk) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= lanes) return;
  const int k = blockIdx.y + 1, chunks = gridDim.y + 1;
  const long long r = i / d_state;
  const int n = (int)(i - r * d_state);
  const size_t base = (size_t)r * seq_len * d_state + n;
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  float a_next = t1 < seq_len ? a[base + (size_t)t1 * d_state] : 1.f;
  float lam = 0.f, p = a_next;
#pragma unroll 8
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t off = base + (size_t)t * d_state;
    lam = __fadd_rn(g[off], __fmul_rn(a_next, lam));
    a_next = a[off];
    if (t > t0) p = __fmul_rn(p, a_next);
  }
  const size_t o = ((size_t)r * chunks + k) * d_state + n;
  lam0[o] = lam;
  prod[o] = p;
}

// Pass 2, the reverse scan of chunk k = blockIdx.y of lane i = (r, n) from
// its carry lam[t1], resolved first from lam[L] = g_last and the later
// chunks' pass-1 results, j = K-1 down to k+1: carry = lam0[j] + prod[j] *
// carry; the same j order for every k, so every chunk's carry is the one
// its neighbour's run would give. With one chunk it is the whole-L scan.
__global__ void __launch_bounds__(kCarryThreads) scan_carry_bwd_kernel(
    const float* __restrict__ a,       // (R, L, N)
    const float* __restrict__ g,       // (R, L, N) dL/dh
    const float* __restrict__ h,       // (R, L, N) the forward's f32 states
    const float* __restrict__ h_init,  // (R, N) or nullptr
    const float* __restrict__ g_last,  // (R, N) dL/dh_last or nullptr
    const float* __restrict__ lam0,    // (R, K, N) pass 1
    const float* __restrict__ prod,    // (R, K, N) pass 1
    float* __restrict__ da,            // (R, L, N)
    float* __restrict__ db,            // (R, L, N)
    float* __restrict__ dh_init,       // (R, N) or nullptr
    long long lanes, int seq_len, int d_state, int chunk) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= lanes) return;
  const int k = blockIdx.y, chunks = gridDim.y;
  const long long r = i / d_state;
  const int n = (int)(i - r * d_state);
  const size_t base = (size_t)r * seq_len * d_state + n;
  const int t0 = k * chunk, t1 = min(t0 + chunk, seq_len);
  float lam = g_last != nullptr ? g_last[i] : 0.f;   // lam[L]
  for (int j = chunks - 1; j > k; --j) {
    const size_t o = ((size_t)r * chunks + j) * d_state + n;
    lam = __fadd_rn(lam0[o], __fmul_rn(prod[o], lam));
  }
  float a_next = t1 < seq_len ? a[base + (size_t)t1 * d_state] : 1.f;   // a[t + 1]
  const float h_first = h_init != nullptr ? h_init[i] : 0.f;
#pragma unroll 8
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t off = base + (size_t)t * d_state;
    const float a_t = a[off];
    const float h_prev = t > 0 ? h[off - d_state] : h_first;
    lam = __fadd_rn(g[off], __fmul_rn(a_next, lam));
    da[off] = __fmul_rn(lam, h_prev);
    db[off] = lam;
    a_next = a_t;
  }
  if (k == 0 && dh_init != nullptr) dh_init[i] = __fmul_rn(lam, a_next);
}

inline unsigned blocks_for(long long lanes) {
  return static_cast<unsigned>((lanes + kCarryThreads - 1) / kCarryThreads);
}

}  // namespace

// The forward over chunks of `chunk` steps (ops/kernels/ssm_scan.py::
// CARRY_FWD_CHUNK; one chunk of L is the plain sequential scan). a
// (R, L, N) f32 with R = B * H; b, h (R, L, N) and h_last (R, N) bf16 when
// b_bf16 else f32; h_init (R, N) f32 and states (R, L, N) f32 may be null;
// scratch (2, R, K, N) f32 for K = ceil(L / chunk) chunks (pass 1's local
// and prod; unused, and may be null, when K is 1). Two launches where K > 1
// (pass 1, pass 2), else one. Returns cudaGetLastError().
extern "C" int apertis_scan_carry_fwd(const void* a, const void* b, const void* h_init, void* h,
                                      void* h_last, void* states, void* scratch, int rows,
                                      int seq_len, int d_state, int chunk, int b_bf16,
                                      void* stream) {
  if (rows <= 0 || seq_len <= 0 || d_state <= 0 || chunk <= 0 ||
      (seq_len + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = (long long)rows * d_state;
  const int chunks = (seq_len + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* h0 = static_cast<const float*>(h_init);
  float* st = static_cast<float*>(states);
  float* local = chunks > 1 ? static_cast<float*>(scratch) : nullptr;
  float* prod = chunks > 1 ? local + (size_t)lanes * chunks : nullptr;
  const dim3 grid1(blocks_for(lanes), chunks - 1), grid2(blocks_for(lanes), chunks);
  if (b_bf16) {
    const auto* bb = static_cast<const bf16*>(b);
    if (chunks > 1)
      scan_carry_fwd_local_kernel<bf16><<<grid1, kCarryThreads, 0, s>>>(
          af, bb, local, prod, lanes, seq_len, d_state, chunk);
    scan_carry_fwd_kernel<bf16><<<grid2, kCarryThreads, 0, s>>>(
        af, bb, h0, local, prod, static_cast<bf16*>(h), static_cast<bf16*>(h_last), st, lanes,
        seq_len, d_state, chunk);
  } else {
    const auto* bf = static_cast<const float*>(b);
    if (chunks > 1)
      scan_carry_fwd_local_kernel<float><<<grid1, kCarryThreads, 0, s>>>(
          af, bf, local, prod, lanes, seq_len, d_state, chunk);
    scan_carry_fwd_kernel<float><<<grid2, kCarryThreads, 0, s>>>(
        af, bf, h0, local, prod, static_cast<float*>(h), static_cast<float*>(h_last), st, lanes,
        seq_len, d_state, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward over chunks of `chunk` steps (one chunk of L is the plain
// sequential scan). Every array f32: a, g, h, da, db (R, L, N); h_init,
// g_last and dh_init (R, N), each may be null (dh_init is written only when
// given); scratch (2, R, K, N) for K = ceil(L / chunk) chunks (pass 1's
// lam0 and prod; unused, and may be null, when K is 1). Two launches (pass 1
// where K > 1, pass 2). Returns cudaGetLastError().
extern "C" int apertis_scan_carry_bwd(const void* a, const void* g, const void* h,
                                      const void* h_init, const void* g_last, void* da, void* db,
                                      void* dh_init, void* scratch, int rows, int seq_len,
                                      int d_state, int chunk, void* stream) {
  if (rows <= 0 || seq_len <= 0 || d_state <= 0 || chunk <= 0 ||
      (seq_len + chunk - 1) / chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = (long long)rows * d_state;
  const int chunks = (seq_len + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* gf = static_cast<const float*>(g);
  float* lam0 = static_cast<float*>(scratch);
  float* prod = chunks > 1 ? lam0 + (size_t)lanes * chunks : nullptr;
  if (chunks > 1)
    scan_carry_bwd_local_kernel<<<dim3(blocks_for(lanes), chunks - 1), kCarryThreads, 0, s>>>(
        af, gf, lam0, prod, lanes, seq_len, d_state, chunk);
  scan_carry_bwd_kernel<<<dim3(blocks_for(lanes), chunks), kCarryThreads, 0, s>>>(
      af, gf, static_cast<const float*>(h), static_cast<const float*>(h_init),
      static_cast<const float*>(g_last), lam0, prod, static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh_init), lanes, seq_len, d_state, chunk);
  return static_cast<int>(cudaGetLastError());
}
