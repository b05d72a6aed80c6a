// flash_attention_fwd: causal attention over full sequences with an online
// softmax, returning the output and the log-sum-exp of every query row.
//
// Replaces: the forward of apertis_llm_tpu/ops/pallas/flash_attention.py::
// flash_attention (_fwd_kernel, _fwd); the backward kernels are later work.
//
// Layout: q, k, v, out (B, H, L, Dh) bf16, contiguous; lse (B, H, L) f32.
//
// Semantics (flash_attention.py:34-77), per (b, h) and query row i, in f32:
//   s_ij = (q_i . k_j) * Dh^-1/2, set to -1e30 where j >= L or (causal) i < j
//   online over key tiles: m' = max(m, max_j s_ij); p_ij = exp(s_ij - m');
//     alpha = exp(m - m'); l = l * alpha + sum_j p_ij; acc = acc * alpha + p V
//   l = max(l, 1e-30);  out_i = bf16(acc / l);  lse_i = m + log(l)
// Key tiles wholly above the diagonal are skipped. Two differences of order
// and rounding from the TPU kernel, both below a bf16 ulp of the output: the
// scale multiplies the f32 scores after the bf16 tensor-core product of q and
// k (bf16(q * scale) would not be exact for every Dh), and P V runs on the
// tensor cores with p rounded to bf16 (the TPU kernel keeps p in f32); l sums
// the f32 p.
//
// Bound on the H100: at L = 1024, B = 4, H = 38, Dh = 64 the function reads
// q, k, v and writes out, 79.7 MB (23.8 us at 3.35 TB/s), and does 20.4 GFLOP
// of causal products (20.6 us at 989 TFLOP/s bf16): bytes by a little, with
// the operations close behind as L grows.
//
// Design: one block of four warps per (b * h, 64-row query tile); the TPU
// kernel's sequential key-block loop stays a loop inside the block. Each key
// tile of 64 rows of K and V is staged in shared memory with 16-byte loads
// (rows past L and columns past Dh zero-filled; Dh is padded to the next of
// 32, 64, 128, 256). Warp w owns query rows 16w..16w+15: S = Q K^T by bf16
// WMMA 16x16x16 with f32 accumulators into shared memory, then the online
// softmax of its rows (a warp per row, two columns a lane), then O += P V by
// WMMA on the running f32 O, which stays in shared memory (so any Dh up to
// 256 fits without register pressure). The rows of a warp are its own, so
// only the K/V staging needs block barriers.

#include <mma.h>

#include <cmath>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;              // query rows per block (4 warps x 16)
constexpr int kBK = 64;              // key rows per tile
constexpr int kFlashThreads = 128;
constexpr float kNegInf = -1e30f;    // flash_attention.py:31

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared-memory plan for a padded head width DHP; every region starts on a
// 128-byte boundary and every stride keeps WMMA's 32-byte fragment alignment.
template <int DHP>
struct Plan {
  static constexpr int kLd = DHP + 8;     // bf16 row stride of the Q, K, V tiles
  static constexpr int kLdS = kBK + 4;    // f32 row stride of S
  static constexpr int kLdP = kBK + 8;    // bf16 row stride of P
  static constexpr int kLdO = DHP + 4;    // f32 row stride of O
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + (size_t)kBQ * kLd * 2;
  static constexpr size_t kV = kK + (size_t)kBK * kLd * 2;
  static constexpr size_t kS = kV + (size_t)kBK * kLd * 2;
  static constexpr size_t kP = kS + (size_t)kBQ * kLdS * 4;
  static constexpr size_t kO = kP + (size_t)kBQ * kLdP * 2;
  static constexpr size_t kM = kO + (size_t)kBQ * kLdO * 4;
  static constexpr size_t kL = kM + (size_t)kBQ * 4;
  static constexpr size_t kBytes = kL + (size_t)kBQ * 4;
};

// Copy rows [row0, row0 + 64) of one (b, h) matrix (L, dh) into a tile of
// stride kLd, 16 bytes at a time; rows past L and columns past dh are zero.
template <int DHP>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, int row0, int L,
                                           int dh, bf16* dst) {
  constexpr int kChunks = DHP / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kFlashThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && c < dh)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * dh + c);
    *reinterpret_cast<uint4*>(dst + r * Plan<DHP>::kLd + c) = val;
  }
}

template <int DHP>
__global__ void __launch_bounds__(kFlashThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int L, int dh, float scale, int causal) {
  typedef Plan<DHP> P;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + P::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + P::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + P::kV);
  float* sS = reinterpret_cast<float*>(smem + P::kS);
  bf16* sP = reinterpret_cast<bf16*>(smem + P::kP);
  float* sO = reinterpret_cast<float*>(smem + P::kO);
  float* sM = reinterpret_cast<float*>(smem + P::kM);
  float* sL = reinterpret_cast<float*>(smem + P::kL);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const size_t base = (size_t)bh * L * dh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;   // this warp's first row of the tile

  stage_tile<DHP>(q + base, q0, L, dh, sQ);
  for (int i = threadIdx.x; i < kBQ * P::kLdO; i += kFlashThreads) sO[i] = 0.f;
  if (threadIdx.x < kBQ) {
    sM[threadIdx.x] = kNegInf;
    sL[threadIdx.x] = 0.f;
  }
  int num_kb = (L + kBK - 1) / kBK;
  if (causal) num_kb = min(num_kb, (q0 + kBQ + kBK - 1) / kBK);

  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();   // the previous tile's K and V are no longer read
    stage_tile<DHP>(k + base, kb * kBK, L, dh, sK);
    stage_tile<DHP>(v + base, kb * kBK, L, dh, sV);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows (K read column-major is K^T).
#pragma unroll
    for (int cb = 0; cb < kBK / 16; ++cb) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, sQ + r0 * P::kLd + kk * 16, P::kLd);
        wmma::load_matrix_sync(b, sK + cb * 16 * P::kLd + kk * 16, P::kLd);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + r0 * P::kLdS + cb * 16, acc, P::kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax of the warp's rows.
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = kb * kBK + lane + 32 * j;
        const bool valid = col < L && (!causal || qi >= col);
        s[j] = valid ? __fmul_rn(sS[r * P::kLdS + lane + 32 * j], scale) : kNegInf;
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new);
      const float p1 = expf(s[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      sP[r * P::kLdP + lane] = __float2bfloat16(p0);
      sP[r * P::kLdP + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < DHP; d += 32) sO[r * P::kLdO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
    }
    __syncwarp();

    // O += P V for the warp's rows.
#pragma unroll
    for (int nb = 0; nb < DHP / 16; ++nb) {
      FragC o;
      wmma::load_matrix_sync(o, sO + r0 * P::kLdO + nb * 16, P::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA a;
        FragBRow b;
        wmma::load_matrix_sync(a, sP + r0 * P::kLdP + kk * 16, P::kLdP);
        wmma::load_matrix_sync(b, sV + kk * 16 * P::kLd + nb * 16, P::kLd);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(sO + r0 * P::kLdO + nb * 16, o, P::kLdO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= L) break;
    const float l = fmaxf(sL[r], 1e-30f);
    for (int d = lane; d < dh; d += 32)
      out[base + (size_t)qi * dh + d] = __float2bfloat16(sO[r * P::kLdO + d] / l);
    if (lane == 0) lse[(size_t)bh * L + qi] = sM[r] + logf(l);
  }
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int L,
           int dh, int causal, void* stream) {
  const size_t smem = Plan<DHP>::kBytes;
  cudaError_t err = allow_smem(flash_fwd_kernel<DHP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32.
  const float scale = (float)std::pow((double)dh, -0.5);
  const dim3 grid(BH, (L + kBQ - 1) / kBQ);
  flash_fwd_kernel<DHP><<<grid, kFlashThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), L, dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Attention of BH = B * H (L, dh) matrices; dh a multiple of 8 up to 256.
// Returns cudaGetLastError().
extern "C" int apertis_flash_attention_fwd(const void* q, const void* k, const void* v,
                                           void* out, void* lse, int BH, int L, int dh,
                                           int causal, void* stream) {
  if (BH <= 0 || L <= 0 || dh <= 0 || dh % 8 || (L + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 32) return launch<32>(q, k, v, out, lse, BH, L, dh, causal, stream);
  if (dh <= 64) return launch<64>(q, k, v, out, lse, BH, L, dh, causal, stream);
  if (dh <= 128) return launch<128>(q, k, v, out, lse, BH, L, dh, causal, stream);
  if (dh <= 256) return launch<256>(q, k, v, out, lse, BH, L, dh, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
