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
//          tensor-core product, then the scale in f32 (so exp(s - lse) is the
//          forward's p);
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
// Design: as the forward kernel (csrc/flash_attention.cu), WMMA 16x16x16 with
// f32 accumulators and each warp owning 16 rows, so only the tile staging
// needs block barriers. dQ: a block per (b * h, query tile of R rows) stages
// its q and dout rows once and loops over 64-row key tiles; S and dP of the
// warp's rows go to shared memory, ds is formed row by row (a warp per row,
// two columns a lane) in bf16, and dQ += dS K accumulates in an f32 tile in
// shared memory. dK/dV: a block per (b * h, key tile of R rows) stages its k
// and v rows once and loops over 64-row query tiles from the diagonal down,
// forming the transposed S^T = K Q^T and dP^T = V dout^T so that dV += P^T
// dout and dK += dS^T Q are row-major products of the warp's own rows. R is
// 64 for Dh up to 128 and 32 for Dh 256, which keeps every plan under the
// 227 KB a block may use. No atomics: results repeat from run to run.

#include <mma.h>

#include <cmath>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kTile = 64;   // key rows per step of the dQ kernel, query rows of the dK/dV one

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared-memory plan of both kernels for a padded head width DHP: R rows
// owned by the block (queries in dQ, keys in dK/dV) and kTile rows streamed.
// Every region starts on a 128-byte boundary and every stride keeps WMMA's
// 32-byte fragment alignment.
template <int DHP>
struct Plan {
  static constexpr int kRows = DHP <= 128 ? 64 : 32;
  static constexpr int kThreads = kRows * 2;   // a warp per 16 rows
  static constexpr int kLd = DHP + 8;          // bf16 stride of the q, k, v, dout tiles
  static constexpr int kLdS = kTile + 4;       // f32 stride of S and dP
  static constexpr int kLdP = kTile + 8;       // bf16 stride of P and dS
  static constexpr int kLdO = DHP + 4;         // f32 stride of the accumulators
  static constexpr size_t kOwnTile = (size_t)kRows * kLd * 2;
  static constexpr size_t kStreamTile = (size_t)kTile * kLd * 2;
  static constexpr size_t kS = (size_t)kRows * kLdS * 4;
  static constexpr size_t kP = (size_t)kRows * kLdP * 2;
  static constexpr size_t kAcc = (size_t)kRows * kLdO * 4;
  // dQ: q, dout (own); k, v (streamed); S, dP; dS; dQ; lse, delta (own rows).
  static constexpr size_t kDqBytes =
      2 * kOwnTile + 2 * kStreamTile + 2 * kS + kP + kAcc + 2 * (size_t)kRows * 4;
  // dK/dV: k, v (own); q, dout (streamed); S^T, dP^T; P^T, dS^T; dK, dV; lse,
  // delta (streamed rows).
  static constexpr size_t kDkvBytes =
      2 * kOwnTile + 2 * kStreamTile + 2 * kS + 2 * kP + 2 * kAcc + 2 * (size_t)kTile * 4;
};

// Copy rows [row0, row0 + rows) of one (b, h) matrix (L, dh) into a tile of
// stride DHP + 8, 16 bytes at a time; rows past L and columns past dh are 0.
template <int DHP, int NT>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, int row0, int rows,
                                           int L, int dh, bf16* dst) {
  constexpr int kChunks = DHP / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && c < dh)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * dh + c);
    *reinterpret_cast<uint4*>(dst + r * (DHP + 8) + c) = val;
  }
}

// Per-row f32 values (lse or delta) of rows [row0, row0 + rows); 0 past L.
template <int NT>
__device__ __forceinline__ void stage_vec(const float* __restrict__ src, int row0, int rows,
                                          int L, float* dst) {
  for (int i = threadIdx.x; i < rows; i += NT) dst[i] = row0 + i < L ? src[row0 + i] : 0.f;
}

// acc (16 x 16 at rows a_rows of A, columns b_cols of B^T) = A B^T over DHP:
// A row-major with stride lda, B row-major with stride ldb read column-major.
template <int DHP>
__device__ __forceinline__ void product_abt(const bf16* a, int lda, const bf16* b, int ldb,
                                            FragC& acc) {
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    FragA fa;
    FragBCol fb;
    wmma::load_matrix_sync(fa, a + kk * 16, lda);
    wmma::load_matrix_sync(fb, b + kk * 16, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// acc (16 rows x DHP, f32 in shared memory with stride ldo) += A (16 x 64,
// bf16 row-major, stride lda) B (64 x DHP, bf16 row-major, stride ldb).
template <int DHP>
__device__ __forceinline__ void accumulate_ab(float* acc, int ldo, const bf16* a, int lda,
                                              const bf16* b, int ldb) {
#pragma unroll
  for (int nb = 0; nb < DHP / 16; ++nb) {
    FragC o;
    wmma::load_matrix_sync(o, acc + nb * 16, ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, a + kk * 16, lda);
      wmma::load_matrix_sync(fb, b + kk * 16 * ldb + nb * 16, ldb);
      wmma::mma_sync(o, fa, fb, o);
    }
    wmma::store_matrix_sync(acc + nb * 16, o, ldo, wmma::mem_row_major);
  }
}

template <int DHP>
__global__ void __launch_bounds__(Plan<DHP>::kThreads) flash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int L, int dh, float scale,
    int causal) {
  typedef Plan<DHP> P;
  constexpr int NT = P::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + P::kOwnTile);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * P::kOwnTile);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * P::kOwnTile + P::kStreamTile);
  unsigned char* rest = smem + 2 * P::kOwnTile + 2 * P::kStreamTile;
  float* sS = reinterpret_cast<float*>(rest);
  float* sDP = reinterpret_cast<float*>(rest + P::kS);
  bf16* sDS = reinterpret_cast<bf16*>(rest + 2 * P::kS);
  float* sAcc = reinterpret_cast<float*>(rest + 2 * P::kS + P::kP);
  float* sLse = reinterpret_cast<float*>(rest + 2 * P::kS + P::kP + P::kAcc);
  float* sDelta = sLse + P::kRows;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * P::kRows;
  const size_t base = (size_t)bh * L * dh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  stage_rows<DHP, NT>(q + base, q0, P::kRows, L, dh, sQ);
  stage_rows<DHP, NT>(dout + base, q0, P::kRows, L, dh, sDO);
  stage_vec<NT>(lse + (size_t)bh * L, q0, P::kRows, L, sLse);
  stage_vec<NT>(delta + (size_t)bh * L, q0, P::kRows, L, sDelta);
  for (int i = threadIdx.x; i < P::kRows * P::kLdO; i += NT) sAcc[i] = 0.f;
  int num_kb = (L + kTile - 1) / kTile;
  if (causal) num_kb = min(num_kb, (q0 + P::kRows + kTile - 1) / kTile);

  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();   // the previous tile's K and V are no longer read
    stage_rows<DHP, NT>(k + base, kb * kTile, kTile, L, dh, sK);
    stage_rows<DHP, NT>(v + base, kb * kTile, kTile, L, dh, sV);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows.
#pragma unroll
    for (int cb = 0; cb < kTile / 16; ++cb) {
      FragC acc;
      product_abt<DHP>(sQ + r0 * P::kLd, P::kLd, sK + cb * 16 * P::kLd, P::kLd, acc);
      wmma::store_matrix_sync(sS + r0 * P::kLdS + cb * 16, acc, P::kLdS, wmma::mem_row_major);
      product_abt<DHP>(sDO + r0 * P::kLd, P::kLd, sV + cb * 16 * P::kLd, P::kLd, acc);
      wmma::store_matrix_sync(sDP + r0 * P::kLdS + cb * 16, acc, P::kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // ds of the warp's rows, in bf16.
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int col = kb * kTile + c;
        const bool valid = qi < L && col < L && (!causal || qi >= col);
        const float s = __fmul_rn(sS[r * P::kLdS + c], scale);
        const float p = valid ? expf(s - sLse[r]) : 0.f;
        const float ds = __fmul_rn(__fmul_rn(p, sDP[r * P::kLdS + c] - sDelta[r]), scale);
        sDS[r * P::kLdP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ += dS K for the warp's rows.
    accumulate_ab<DHP>(sAcc + r0 * P::kLdO, P::kLdO, sDS + r0 * P::kLdP, P::kLdP, sK, P::kLd);
  }
  __syncwarp();

  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= L) break;
    for (int d = lane; d < dh; d += 32)
      dq[base + (size_t)qi * dh + d] = __float2bfloat16(sAcc[r * P::kLdO + d]);
  }
}

template <int DHP>
__global__ void __launch_bounds__(Plan<DHP>::kThreads) flash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
    int dh, float scale, int causal) {
  typedef Plan<DHP> P;
  constexpr int NT = P::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + P::kOwnTile);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * P::kOwnTile);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 2 * P::kOwnTile + P::kStreamTile);
  unsigned char* rest = smem + 2 * P::kOwnTile + 2 * P::kStreamTile;
  float* sS = reinterpret_cast<float*>(rest);                    // S^T
  float* sDP = reinterpret_cast<float*>(rest + P::kS);           // dP^T
  bf16* sP = reinterpret_cast<bf16*>(rest + 2 * P::kS);          // P^T
  bf16* sDS = reinterpret_cast<bf16*>(rest + 2 * P::kS + P::kP);  // dS^T
  float* sDK = reinterpret_cast<float*>(rest + 2 * P::kS + 2 * P::kP);
  float* sDV = reinterpret_cast<float*>(rest + 2 * P::kS + 2 * P::kP + P::kAcc);
  float* sLse = reinterpret_cast<float*>(rest + 2 * P::kS + 2 * P::kP + 2 * P::kAcc);
  float* sDelta = sLse + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * P::kRows;
  const size_t base = (size_t)bh * L * dh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  stage_rows<DHP, NT>(k + base, k0, P::kRows, L, dh, sK);
  stage_rows<DHP, NT>(v + base, k0, P::kRows, L, dh, sV);
  for (int i = threadIdx.x; i < P::kRows * P::kLdO; i += NT) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  const int num_qb = (L + kTile - 1) / kTile;
  const int qb0 = causal ? k0 / kTile : 0;   // query tiles wholly above k0 see no key here

  for (int qb = qb0; qb < num_qb; ++qb) {
    __syncthreads();   // the previous query tile is no longer read
    stage_rows<DHP, NT>(q + base, qb * kTile, kTile, L, dh, sQ);
    stage_rows<DHP, NT>(dout + base, qb * kTile, kTile, L, dh, sDO);
    stage_vec<NT>(lse + (size_t)bh * L, qb * kTile, kTile, L, sLse);
    stage_vec<NT>(delta + (size_t)bh * L, qb * kTile, kTile, L, sDelta);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 key rows.
#pragma unroll
    for (int cb = 0; cb < kTile / 16; ++cb) {
      FragC acc;
      product_abt<DHP>(sK + r0 * P::kLd, P::kLd, sQ + cb * 16 * P::kLd, P::kLd, acc);
      wmma::store_matrix_sync(sS + r0 * P::kLdS + cb * 16, acc, P::kLdS, wmma::mem_row_major);
      product_abt<DHP>(sV + r0 * P::kLd, P::kLd, sDO + cb * 16 * P::kLd, P::kLd, acc);
      wmma::store_matrix_sync(sDP + r0 * P::kLdS + cb * 16, acc, P::kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // p and ds of the warp's key rows against this tile's queries, in bf16.
    for (int r = r0; r < r0 + 16; ++r) {
      const int kj = k0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int qi = qb * kTile + c;
        const bool valid = qi < L && kj < L && (!causal || qi >= kj);
        const float s = __fmul_rn(sS[r * P::kLdS + c], scale);
        const float p = valid ? expf(s - sLse[c]) : 0.f;
        const float ds = __fmul_rn(__fmul_rn(p, sDP[r * P::kLdS + c] - sDelta[c]), scale);
        sP[r * P::kLdP + c] = __float2bfloat16(p);
        sDS[r * P::kLdP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q for the warp's key rows.
    accumulate_ab<DHP>(sDV + r0 * P::kLdO, P::kLdO, sP + r0 * P::kLdP, P::kLdP, sDO, P::kLd);
    accumulate_ab<DHP>(sDK + r0 * P::kLdO, P::kLdO, sDS + r0 * P::kLdP, P::kLdP, sQ, P::kLd);
  }
  __syncwarp();

  for (int r = r0; r < r0 + 16; ++r) {
    const int kj = k0 + r;
    if (kj >= L) break;
    for (int d = lane; d < dh; d += 32) {
      dk[base + (size_t)kj * dh + d] = __float2bfloat16(sDK[r * P::kLdO + d]);
      dv[base + (size_t)kj * dh + d] = __float2bfloat16(sDV[r * P::kLdO + d]);
    }
  }
}

// Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32 (the
// forward kernel's scale).
float head_scale(int dh) { return (float)std::pow((double)dh, -0.5); }

template <int DHP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int L, int dh, int causal, void* stream) {
  typedef Plan<DHP> P;
  cudaError_t err = allow_smem(flash_dq_kernel<DHP>, P::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (L + P::kRows - 1) / P::kRows);
  flash_dq_kernel<DHP><<<grid, P::kThreads, P::kDqBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), L, dh, head_scale(dh), causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int L, int dh, int causal,
               void* stream) {
  typedef Plan<DHP> P;
  cudaError_t err = allow_smem(flash_dkv_kernel<DHP>, P::kDkvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (L + P::kRows - 1) / P::kRows);
  flash_dkv_kernel<DHP><<<grid, P::kThreads, P::kDkvBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, dh,
      head_scale(dh), causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int L, int dh) {
  return BH <= 0 || L <= 0 || dh <= 0 || dh % 8 || dh > 256 || (L + 31) / 32 > 65535;
}

}  // namespace

// dQ of BH = B * H (L, dh) attentions; dh a multiple of 8 up to 256. Returns
// cudaGetLastError().
extern "C" int apertis_flash_attention_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int BH, int L, int dh, int causal,
                                          void* stream) {
  if (bad_shape(BH, L, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 32) return launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, stream);
  if (dh <= 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, stream);
  if (dh <= 128) return launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, stream);
  return launch_dq<256>(q, k, v, dout, lse, delta, dq, BH, L, dh, causal, stream);
}

// dK and dV of BH = B * H (L, dh) attentions; dh a multiple of 8 up to 256.
// Returns cudaGetLastError().
extern "C" int apertis_flash_attention_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int BH, int L,
                                           int dh, int causal, void* stream) {
  if (bad_shape(BH, L, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, stream);
  if (dh <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, stream);
  if (dh <= 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, stream);
  return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, BH, L, dh, causal, stream);
}
