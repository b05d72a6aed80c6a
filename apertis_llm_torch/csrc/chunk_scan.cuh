// What the two forward linear scans over chunks of the time axis,
// h[t] = a[t] * h[t-1] + b[t], share: selective_scan_fwd (ssm_scan.cu) and
// selective_scan_carry_fwd (scan_carry.cu). Pass 2 of each resolves a
// chunk's carry from the earlier chunks' pass-1 summaries (local, prod) in
// one fixed order; the two differ only in the combine (a fused
// multiply-add in ssm_scan.cu, a product and a sum rounded once each in
// scan_carry.cu) and in their layouts' strides. Each file keeps its own
// walk over a chunk's steps: behind one lane type (one copy of the walk)
// the carried scan's pass 2 ran 4-13 % slower on the H100, its bf16 pass 1
// 30 %.
#pragma once

namespace chunk_scan {

// Steps a thread of either forward loads before the first of them enters
// its dependent chain, and chunk summaries the carry resolution loads ahead
// of its combines.
constexpr int kTile = 16;
constexpr int kFold = 8;

// The carry into chunk k: from `carry` (the state before step 0), chunks
// j = 0 up to k - 1 folded in that order, carry = combine(prod[j], carry,
// local[j]), the same order for every k, so every chunk's carry is the one
// its neighbour's run would give. `local` and `prod` point at the lane's
// chunk 0, chunk j at j * stride; loads go in batches of kFold ahead of the
// combines, with no wait on other blocks.
template <typename Combine>
__device__ __forceinline__ float resolve_carry(const float* local, const float* prod, int stride,
                                               int k, float carry, Combine combine) {
  int j = 0;
  for (; j + kFold <= k; j += kFold) {
    float lv[kFold], pv[kFold];
#pragma unroll
    for (int s = 0; s < kFold; ++s) {
      lv[s] = local[(j + s) * stride];
      pv[s] = prod[(j + s) * stride];
    }
#pragma unroll
    for (int s = 0; s < kFold; ++s) carry = combine(pv[s], carry, lv[s]);
  }
  for (; j < k; ++j) carry = combine(prod[j * stride], carry, local[j * stride]);
  return carry;
}

}  // namespace chunk_scan
