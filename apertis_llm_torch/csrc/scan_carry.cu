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
// Backward (ssm_scan.py:153-178), in one reverse pass, from g = dL/dh (f32)
// and g_last = dL/dh_last:
//   lam[L-1] = g[L-1] + g_last;  lam[t] = g[t] + a[t+1] * lam[t+1]
//   da[t] = lam[t] * h[t-1] (h_init as h[-1]);  db[t] = lam[t]
//   dh_init = lam[0] * a[0]
// where the TPU kernel scans reversed, index-shifted copies of a and g.
//
// Both round every product and every sum once (__fmul_rn, __fadd_rn: no
// fused multiply-add), in the order of the plain versions in
// ops/kernels/ssm_scan.py, so the kernels and the plain versions agree bit
// for bit.
//
// Bound on the H100: bytes. A step of a channel reads a and b and writes h
// (12 bytes in f32) for one multiply and one add; the backward reads a, g
// and h and writes da and db (20 bytes) for two multiplies and one add: far
// below the card's operations-per-byte line. The recurrence is sequential in
// t, so the parallelism is B * H * N threads.
//
// Design: one thread owns one (r, n) and walks L (the backward from L-1
// down) with its carry in a register. Consecutive threads take consecutive n
// and then the next head, so each step's loads and stores are contiguous
// runs of N floats (two heads of 16 a warp at the 1.5B model's N = 16). The
// loads of a step do not depend on the carry, so the unrolled loop issues
// them ahead of the dependent multiply-adds. The backward keeps a[t] in a
// register for step t - 1 and reads h[t-1] directly, so every array is read
// once. At the 1.5B model's per-rank shape (4, 38, 512, 16) that is only
// 2,432 threads: the card is mostly idle, and splitting L into chunks is
// later work.

#include "common.cuh"

namespace {

constexpr int kCarryThreads = 128;

template <typename TB>
__global__ void __launch_bounds__(kCarryThreads) scan_carry_fwd_kernel(
    const float* __restrict__ a,       // (R, L, N)
    const TB* __restrict__ b,          // (R, L, N)
    const float* __restrict__ h_init,  // (R, N) or nullptr
    TB* __restrict__ h,                // (R, L, N)
    TB* __restrict__ h_last,           // (R, N)
    float* __restrict__ states,        // (R, L, N) f32 or nullptr
    long long lanes, int seq_len, int d_state) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= lanes) return;
  const long long r = i / d_state;
  const size_t base = (size_t)r * seq_len * d_state + (size_t)(i - r * d_state);
  float carry = h_init != nullptr ? h_init[i] : 0.f;
#pragma unroll 8
  for (int t = 0; t < seq_len; ++t) {
    const size_t off = base + (size_t)t * d_state;
    carry = __fadd_rn(__fmul_rn(a[off], carry), to_f32(b[off]));
    h[off] = from_f32<TB>(carry);
    if (states != nullptr) states[off] = carry;
  }
  h_last[i] = from_f32<TB>(carry);
}

__global__ void __launch_bounds__(kCarryThreads) scan_carry_bwd_kernel(
    const float* __restrict__ a,       // (R, L, N)
    const float* __restrict__ g,       // (R, L, N) dL/dh
    const float* __restrict__ h,       // (R, L, N) the forward's f32 states
    const float* __restrict__ h_init,  // (R, N) or nullptr
    const float* __restrict__ g_last,  // (R, N) dL/dh_last or nullptr
    float* __restrict__ da,            // (R, L, N)
    float* __restrict__ db,            // (R, L, N)
    float* __restrict__ dh_init,       // (R, N) or nullptr
    long long lanes, int seq_len, int d_state) {
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= lanes) return;
  const long long r = i / d_state;
  const size_t base = (size_t)r * seq_len * d_state + (size_t)(i - r * d_state);
  const float h_first = h_init != nullptr ? h_init[i] : 0.f;
  float lam = g_last != nullptr ? g_last[i] : 0.f;
  float a_next = 1.f;   // a[t + 1]; 1 past the end, where lam starts as g_last
#pragma unroll 8
  for (int t = seq_len - 1; t >= 0; --t) {
    const size_t off = base + (size_t)t * d_state;
    const float a_t = a[off];
    const float h_prev = t > 0 ? h[off - d_state] : h_first;
    lam = __fadd_rn(g[off], __fmul_rn(a_next, lam));
    da[off] = __fmul_rn(lam, h_prev);
    db[off] = lam;
    a_next = a_t;
  }
  if (dh_init != nullptr) dh_init[i] = __fmul_rn(lam, a_next);
}

inline unsigned blocks_for(long long lanes) {
  return static_cast<unsigned>((lanes + kCarryThreads - 1) / kCarryThreads);
}

}  // namespace

// The forward. a (R, L, N) f32 with R = B * H; b, h (R, L, N) and h_last
// (R, N) bf16 when b_bf16 else f32; h_init (R, N) f32 and states (R, L, N)
// f32 may be null. One launch. Returns cudaGetLastError().
extern "C" int apertis_scan_carry_fwd(const void* a, const void* b, const void* h_init, void* h,
                                      void* h_last, void* states, int rows, int seq_len,
                                      int d_state, int b_bf16, void* stream) {
  if (rows <= 0 || seq_len <= 0 || d_state <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = (long long)rows * d_state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* h0 = static_cast<const float*>(h_init);
  float* st = static_cast<float*>(states);
  if (b_bf16)
    scan_carry_fwd_kernel<bf16><<<blocks_for(lanes), kCarryThreads, 0, s>>>(
        af, static_cast<const bf16*>(b), h0, static_cast<bf16*>(h), static_cast<bf16*>(h_last),
        st, lanes, seq_len, d_state);
  else
    scan_carry_fwd_kernel<float><<<blocks_for(lanes), kCarryThreads, 0, s>>>(
        af, static_cast<const float*>(b), h0, static_cast<float*>(h),
        static_cast<float*>(h_last), st, lanes, seq_len, d_state);
  return static_cast<int>(cudaGetLastError());
}

// The backward. Every array f32: a, g, h, da, db (R, L, N); h_init, g_last
// and dh_init (R, N), each may be null (dh_init is written only when given).
// One launch. Returns cudaGetLastError().
extern "C" int apertis_scan_carry_bwd(const void* a, const void* g, const void* h,
                                      const void* h_init, const void* g_last, void* da, void* db,
                                      void* dh_init, int rows, int seq_len, int d_state,
                                      void* stream) {
  if (rows <= 0 || seq_len <= 0 || d_state <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long lanes = (long long)rows * d_state;
  scan_carry_bwd_kernel<<<blocks_for(lanes), kCarryThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g), static_cast<const float*>(h),
      static_cast<const float*>(h_init), static_cast<const float*>(g_last),
      static_cast<float*>(da), static_cast<float*>(db), static_cast<float*>(dh_init), lanes,
      seq_len, d_state);
  return static_cast<int>(cudaGetLastError());
}
