// selective_scan_fwd: the selective-SSM scan over a whole sequence (prefill).
//
// Replaces: apertis_llm_tpu/ops/pallas/ssm_scan.py::gated_scan_2d (forward;
// its caller ops/ssm.py::ssm_mix builds exp(delta*A) and the mask outside the
// kernel and relayouts every operand time-minor first).
//
// Computes, for every batch row b and channel c = head * N + n:
//   h[t] = exp(delta[b,t,head] * A[c]) * h[t-1] + B[b,t,c]     (f32 carry)
//   y[b,t,c] = C[b,t,c] * h[t]                                  (out dtype)
//   h_last[b,c] = h[L-1]
// A masked step (mask[b,t] == 0) is the identity: a = 1, b = 0, so h_last is
// the state after each row's last real token.
//
// Bound on the H100: bytes. Each step of each channel reads B and C and writes
// y (6 bytes in bf16) for one multiply-add of carry; the whole scan is far
// below the card's operations-per-byte line. The recurrence is sequential in
// t, so the parallelism is B * H * N threads.
//
// Design: one thread owns one (b, c) and walks L with its carry in a register.
// At each step neighbouring threads read neighbouring channels of the natural
// (B, L, H*N) layout, so every load and store coalesces without the TPU
// kernel's time-minor relayout, its 128-lane padding, or the exp(delta*A)
// tensor in device memory: delta is a broadcast load shared by the N threads
// of a head and the exponential is computed in the thread. The mask is folded
// in the same way. At batch 1 the 1.5B model has only 608 channels, so the
// card is mostly idle; splitting the time axis into chunks is later work.

#include "common.cuh"

namespace {

constexpr int kScanThreads = 128;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kScanThreads) selective_scan_fwd_kernel(
    const float* __restrict__ delta,   // (B, L, H)
    const float* __restrict__ a_cont,  // (H, N) == (C,)
    const TIn* __restrict__ b_term,    // (B, L, C)
    const TIn* __restrict__ c_mod,     // (B, L, C)
    const int* __restrict__ mask,      // (B, L) or nullptr
    TOut* __restrict__ y,              // (B, L, C)
    float* __restrict__ h_last,        // (B, C)
    int seq_len, int heads, int d_state) {
  const int channels = heads * d_state;
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= channels) return;
  const int head = c / d_state;
  const float a = a_cont[c];
  const size_t row = (size_t)b * seq_len;
  float h = 0.f;
#pragma unroll 4
  for (int t = 0; t < seq_len; ++t) {
    const size_t off = (row + t) * channels + c;
    float decay = expf(delta[(row + t) * heads + head] * a);
    float u = to_f32(b_term[off]);
    const float gate = to_f32(c_mod[off]);
    if (mask != nullptr && mask[row + t] == 0) {
      decay = 1.f;
      u = 0.f;
    }
    h = fmaf(decay, h, u);
    y[off] = from_f32<TOut>(gate * h);
  }
  h_last[(size_t)b * channels + c] = h;
}

template <typename TIn, typename TOut>
void launch_scan(const void* delta, const void* a_cont, const void* b_term,
                 const void* c_mod, const void* mask, void* y, void* h_last,
                 int batch, int seq_len, int heads, int d_state, cudaStream_t stream) {
  const int channels = heads * d_state;
  const dim3 grid((channels + kScanThreads - 1) / kScanThreads, batch);
  selective_scan_fwd_kernel<TIn, TOut><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const float*>(delta), static_cast<const float*>(a_cont),
      static_cast<const TIn*>(b_term), static_cast<const TIn*>(c_mod),
      static_cast<const int*>(mask), static_cast<TOut*>(y),
      static_cast<float*>(h_last), seq_len, heads, d_state);
}

}  // namespace

// b_term / c_mod are bf16 when bc_bf16 else f32; y is bf16 when y_bf16 else
// f32. Returns cudaGetLastError() after the launch.
extern "C" int apertis_selective_scan_fwd(const void* delta, const void* a_cont,
                                          const void* b_term, const void* c_mod,
                                          const void* mask, void* y, void* h_last,
                                          int batch, int seq_len, int heads,
                                          int d_state, int bc_bf16, int y_bf16,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_bf16 && y_bf16)
    launch_scan<bf16, bf16>(delta, a_cont, b_term, c_mod, mask, y, h_last, batch,
                            seq_len, heads, d_state, s);
  else if (bc_bf16)
    launch_scan<bf16, float>(delta, a_cont, b_term, c_mod, mask, y, h_last, batch,
                             seq_len, heads, d_state, s);
  else if (y_bf16)
    launch_scan<float, bf16>(delta, a_cont, b_term, c_mod, mask, y, h_last, batch,
                             seq_len, heads, d_state, s);
  else
    launch_scan<float, float>(delta, a_cont, b_term, c_mod, mask, y, h_last, batch,
                              seq_len, heads, d_state, s);
  return static_cast<int>(cudaGetLastError());
}
