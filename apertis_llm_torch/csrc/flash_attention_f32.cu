// flash_attention_fwd_f32 / flash_attention_dq_f32 / flash_attention_dkv_f32:
// causal flash attention over full sequences with f32 q, k, v, and its
// backward, for models that train in f32.
//
// Replaces: apertis_llm_tpu/ops/pallas/flash_attention.py::flash_attention
// with f32 operands: _fwd_kernel (:34) and its pallas_call (:102), _dq_kernel
// (:131, pallas_call :257), _dkv_kernel (:167, pallas_call :282). The TPU
// kernels compute in f32 for every input dtype; these take f32 in and out,
// beside the bf16 kernels of flash_attention.cu and flash_attention_bwd.cu.
//
// Layout: q, k, v, dout, out, dq, dk, dv (B, H, L, Dh) f32, contiguous; lse
// and delta = sum_d out * dout (B, H, L) f32.
//
// Semantics (flash_attention.py:34-77, 131-204), per (b, h), all in f32 with
// f32 fused multiply-adds and no TF32:
//   s_ij = (q_i * Dh^-1/2) . k_j, -1e30 where j >= L or (causal) i < j;
//   forward, online over key tiles: m' = max(m, max_j s_ij); p = exp(s - m');
//     alpha = exp(m - m'); l = l alpha + sum_j p; acc = acc alpha + p V;
//     out_i = acc / max(l, 1e-30); lse_i = m + log(max(l, 1e-30));
//   backward: p_ij = exp(s_ij - lse_i) (0 where masked); dp_ij = dout_i . v_j;
//     ds_ij = p_ij (dp_ij - delta_i) Dh^-1/2; dq_i = sum_j ds_ij k_j;
//     dk_j = sum_i ds_ij q_i; dv_j = sum_i p_ij dout_i.
// Tiles wholly above the diagonal are skipped (the TPU dQ kernel visits and
// masks them: the same sums). The dot products sum over d in order, the
// tile products over the tile's rows in order: no atomics, so a run repeats
// bit for bit.
//
// Bound on the H100: operations. The f32 products run on the CUDA cores
// (67 TFLOP/s); at (4, 38, 1024, 64) the causal half is 79.8 M pairs of
// 2 Dh flops a product: the forward's two products 20.4 GFLOP (0.31 ms)
// against 79.7 MB read and written (24 us at 3.35 TB/s).
//
// Design: SIMT, one block of 8 warps per (b * h, tile of R rows it owns:
// query rows for the forward and dQ, key rows for dK/dV), R = 64 for Dh up
// to 128 and 32 for Dh 256, so each warp owns R / 8 rows. The owned rows
// (Q, dout; K, V) sit in shared memory and are read by broadcast; the
// streamed rows come 32 at a time (K and V; Q and dout) into shared tiles
// of stride Dh + 1, so that lane j reading row j is free of bank conflicts.
// Each lane computes the scores of its warp's rows against streamed row
// `lane` (a dot product over Dh with the row's operand in a register, reused
// across the warp's rows), the softmax statistics are warp reductions, and
// the tile products run with each lane owning the output columns lane + 32i
// of its warp's rows in registers, p or ds broadcast from shared memory.
// Shared memory: up to 138 KB a block (dK/dV at Dh 256), above the default
// 48 KB, so each launch opts in first (cudaFuncSetAttribute).

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarpsF = 8;
constexpr int kThreadsF = kWarpsF * 32;
constexpr int kStreamRows = 32;        // streamed rows per step: one a lane
constexpr float kNegInfF = -1e30f;     // flash_attention.py:31

template <int DHP>
struct PlanF {
  static constexpr int kRowsPerWarp = DHP <= 128 ? 8 : 4;
  static constexpr int kRows = kWarpsF * kRowsPerWarp;   // rows the block owns
  static constexpr int kCols = DHP / 32;                   // output columns a lane
  static constexpr int kLd = DHP + 1;                      // stride of streamed tiles
  static constexpr size_t kOwn = (size_t)kRows * DHP * 4;
  static constexpr size_t kStream = (size_t)kStreamRows * kLd * 4;
  static constexpr size_t kTile = (size_t)kRows * kStreamRows * 4;   // p or ds
  static constexpr size_t kFwdBytes = kOwn + 2 * kStream + kTile;
  static constexpr size_t kDqBytes = 2 * kOwn + 2 * kStream + kTile;
  static constexpr size_t kDkvBytes = 2 * kOwn + 2 * kStream + 2 * kTile + 2 * kStreamRows * 4;
};

// Rows [row0, row0 + rows) of one (b, h) matrix (L, dh) into a tile of stride
// ld, times `mul`; rows past L and columns past dh are 0.
template <int DHP>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, int row0, int rows,
                                          int L, int dh, int ld, float mul, float* dst) {
  for (int i = threadIdx.x; i < rows * DHP; i += kThreadsF) {
    const int r = i / DHP;
    const int c = i % DHP;
    dst[r * ld + c] = (row0 + r < L && c < dh) ? src[(size_t)(row0 + r) * dh + c] * mul : 0.f;
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreadsF) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int L, int dh, float scale, int causal) {
  typedef PlanF<DHP> P;
  constexpr int RW = P::kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + P::kOwn);
  float* sV = reinterpret_cast<float*>(smem + P::kOwn + P::kStream);
  float* sP = reinterpret_cast<float*>(smem + P::kOwn + 2 * P::kStream);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * P::kRows;
  const size_t base = (size_t)bh * L * dh;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RW;   // the warp's first row of the tile

  // q * Dh^-1/2, as the TPU kernel scales q before its product.
  stage_f32<DHP>(q + base, q0, P::kRows, L, dh, DHP, scale, sQ);
  float m[RW], l[RW], acc[RW][P::kCols];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = kNegInfF;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < P::kCols; ++i) acc[rr][i] = 0.f;
  }
  int num_kb = (L + kStreamRows - 1) / kStreamRows;
  if (causal) num_kb = min(num_kb, (q0 + P::kRows + kStreamRows - 1) / kStreamRows);

  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();   // the previous tile's K, V and P are no longer read
    stage_f32<DHP>(k + base, kb * kStreamRows, kStreamRows, L, dh, P::kLd, 1.f, sK);
    stage_f32<DHP>(v + base, kb * kStreamRows, kStreamRows, L, dh, P::kLd, 1.f, sV);
    __syncthreads();

    // s of the warp's rows against key row `lane` of the tile.
    float s[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) s[rr] = 0.f;
    for (int d = 0; d < DHP; ++d) {
      const float kd = sK[lane * P::kLd + d];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) s[rr] = fmaf(sQ[(r0 + rr) * DHP + d], kd, s[rr]);
    }
    const int col = kb * kStreamRows + lane;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int qi = q0 + r0 + rr;
      const bool valid = col < L && (!causal || qi >= col);
      const float sv = valid ? s[rr] : kNegInfF;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float p = expf(sv - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < P::kCols; ++i) acc[rr][i] *= alpha;
      sP[(r0 + rr) * kStreamRows + lane] = p;
    }
    __syncwarp();

    // acc += P V over the tile's 32 keys, in order.
    for (int j = 0; j < kStreamRows; ++j) {
      float vj[P::kCols];
#pragma unroll
      for (int i = 0; i < P::kCols; ++i) vj[i] = sV[j * P::kLd + lane + 32 * i];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const float p = sP[(r0 + rr) * kStreamRows + j];
#pragma unroll
        for (int i = 0; i < P::kCols; ++i) acc[rr][i] = fmaf(p, vj[i], acc[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= L) break;
    const float ll = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < P::kCols; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) out[base + (size_t)qi * dh + d] = acc[rr][i] / ll;
    }
    if (lane == 0) lse[(size_t)bh * L + qi] = m[rr] + logf(ll);
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreadsF) flash_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int L, int dh, float scale,
    int causal) {
  typedef PlanF<DHP> P;
  constexpr int RW = P::kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = reinterpret_cast<float*>(smem + P::kOwn);
  float* sK = reinterpret_cast<float*>(smem + 2 * P::kOwn);
  float* sV = reinterpret_cast<float*>(smem + 2 * P::kOwn + P::kStream);
  float* sDS = reinterpret_cast<float*>(smem + 2 * P::kOwn + 2 * P::kStream);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * P::kRows;
  const size_t base = (size_t)bh * L * dh;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RW;

  stage_f32<DHP>(q + base, q0, P::kRows, L, dh, DHP, scale, sQ);
  stage_f32<DHP>(dout + base, q0, P::kRows, L, dh, DHP, 1.f, sDO);
  float row_lse[RW], row_delta[RW], acc[RW][P::kCols];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int qi = q0 + r0 + rr;
    row_lse[rr] = qi < L ? lse[(size_t)bh * L + qi] : 0.f;
    row_delta[rr] = qi < L ? delta[(size_t)bh * L + qi] : 0.f;
#pragma unroll
    for (int i = 0; i < P::kCols; ++i) acc[rr][i] = 0.f;
  }
  int num_kb = (L + kStreamRows - 1) / kStreamRows;
  if (causal) num_kb = min(num_kb, (q0 + P::kRows + kStreamRows - 1) / kStreamRows);

  for (int kb = 0; kb < num_kb; ++kb) {
    __syncthreads();   // the previous tile's K, V and dS are no longer read
    stage_f32<DHP>(k + base, kb * kStreamRows, kStreamRows, L, dh, P::kLd, 1.f, sK);
    stage_f32<DHP>(v + base, kb * kStreamRows, kStreamRows, L, dh, P::kLd, 1.f, sV);
    __syncthreads();

    float s[RW], dp[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) s[rr] = dp[rr] = 0.f;
    for (int d = 0; d < DHP; ++d) {
      const float kd = sK[lane * P::kLd + d];
      const float vd = sV[lane * P::kLd + d];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        s[rr] = fmaf(sQ[(r0 + rr) * DHP + d], kd, s[rr]);
        dp[rr] = fmaf(sDO[(r0 + rr) * DHP + d], vd, dp[rr]);
      }
    }
    const int col = kb * kStreamRows + lane;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int qi = q0 + r0 + rr;
      const bool valid = qi < L && col < L && (!causal || qi >= col);
      const float p = valid ? expf(s[rr] - row_lse[rr]) : 0.f;
      sDS[(r0 + rr) * kStreamRows + lane] = p * (dp[rr] - row_delta[rr]) * scale;
    }
    __syncwarp();

    // dq += dS K over the tile's 32 keys, in order.
    for (int j = 0; j < kStreamRows; ++j) {
      float kj[P::kCols];
#pragma unroll
      for (int i = 0; i < P::kCols; ++i) kj[i] = sK[j * P::kLd + lane + 32 * i];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const float ds = sDS[(r0 + rr) * kStreamRows + j];
#pragma unroll
        for (int i = 0; i < P::kCols; ++i) acc[rr][i] = fmaf(ds, kj[i], acc[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= L) break;
#pragma unroll
    for (int i = 0; i < P::kCols; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) dq[base + (size_t)qi * dh + d] = acc[rr][i];
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreadsF) flash_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int L,
    int dh, float scale, int causal) {
  typedef PlanF<DHP> P;
  constexpr int RW = P::kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + P::kOwn);
  float* sQ = reinterpret_cast<float*>(smem + 2 * P::kOwn);
  float* sDO = reinterpret_cast<float*>(smem + 2 * P::kOwn + P::kStream);
  float* sP = reinterpret_cast<float*>(smem + 2 * P::kOwn + 2 * P::kStream);
  float* sDS = reinterpret_cast<float*>(smem + 2 * P::kOwn + 2 * P::kStream + P::kTile);
  float* sLse = reinterpret_cast<float*>(smem + 2 * P::kOwn + 2 * P::kStream + 2 * P::kTile);
  float* sDelta = sLse + kStreamRows;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * P::kRows;
  const size_t base = (size_t)bh * L * dh;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * RW;

  stage_f32<DHP>(k + base, k0, P::kRows, L, dh, DHP, 1.f, sK);
  stage_f32<DHP>(v + base, k0, P::kRows, L, dh, DHP, 1.f, sV);
  float acc_k[RW][P::kCols], acc_v[RW][P::kCols];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int i = 0; i < P::kCols; ++i) acc_k[rr][i] = acc_v[rr][i] = 0.f;
  const int num_qb = (L + kStreamRows - 1) / kStreamRows;
  const int qb0 = causal ? k0 / kStreamRows : 0;   // query tiles wholly above k0 see no key here

  for (int qb = qb0; qb < num_qb; ++qb) {
    __syncthreads();   // the previous query tile, P and dS are no longer read
    // q * Dh^-1/2, as the TPU kernel scales q before its product; dK sums
    // ds against the unscaled q.
    stage_f32<DHP>(q + base, qb * kStreamRows, kStreamRows, L, dh, P::kLd, 1.f, sQ);
    stage_f32<DHP>(dout + base, qb * kStreamRows, kStreamRows, L, dh, P::kLd, 1.f, sDO);
    if (threadIdx.x < kStreamRows) {
      const int qi = qb * kStreamRows + threadIdx.x;
      sLse[threadIdx.x] = qi < L ? lse[(size_t)bh * L + qi] : 0.f;
      sDelta[threadIdx.x] = qi < L ? delta[(size_t)bh * L + qi] : 0.f;
    }
    __syncthreads();

    // s and dp of the warp's key rows against query row `lane` of the tile.
    float s[RW], dp[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) s[rr] = dp[rr] = 0.f;
    for (int d = 0; d < DHP; ++d) {
      const float qd = sQ[lane * P::kLd + d] * scale;
      const float dod = sDO[lane * P::kLd + d];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        s[rr] = fmaf(qd, sK[(r0 + rr) * DHP + d], s[rr]);
        dp[rr] = fmaf(dod, sV[(r0 + rr) * DHP + d], dp[rr]);
      }
    }
    const int qi = qb * kStreamRows + lane;
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int kj = k0 + r0 + rr;
      const bool valid = qi < L && kj < L && (!causal || qi >= kj);
      const float p = valid ? expf(s[rr] - sLse[lane]) : 0.f;
      sP[(r0 + rr) * kStreamRows + lane] = p;
      sDS[(r0 + rr) * kStreamRows + lane] = p * (dp[rr] - sDelta[lane]) * scale;
    }
    __syncwarp();

    // dv += P^T dout and dk += dS^T q over the tile's 32 queries, in order.
    for (int j = 0; j < kStreamRows; ++j) {
      float qj[P::kCols], doj[P::kCols];
#pragma unroll
      for (int i = 0; i < P::kCols; ++i) {
        qj[i] = sQ[j * P::kLd + lane + 32 * i];
        doj[i] = sDO[j * P::kLd + lane + 32 * i];
      }
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const float p = sP[(r0 + rr) * kStreamRows + j];
        const float ds = sDS[(r0 + rr) * kStreamRows + j];
#pragma unroll
        for (int i = 0; i < P::kCols; ++i) {
          acc_v[rr][i] = fmaf(p, doj[i], acc_v[rr][i]);
          acc_k[rr][i] = fmaf(ds, qj[i], acc_k[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int kj = k0 + r0 + rr;
    if (kj >= L) break;
#pragma unroll
    for (int i = 0; i < P::kCols; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) {
        dk[base + (size_t)kj * dh + d] = acc_k[rr][i];
        dv[base + (size_t)kj * dh + d] = acc_v[rr][i];
      }
    }
  }
}

// Dh^-1/2 as Python's head_dim ** -0.5 gives it, rounded to f32.
float scale_f32(int dh) { return (float)std::pow((double)dh, -0.5); }

dim3 grid_f32(int BH, int L, int rows) { return dim3(BH, (L + rows - 1) / rows); }

template <int DHP>
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int L,
            int dh, int causal, cudaStream_t s) {
  typedef PlanF<DHP> P;
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<DHP>, P::kFwdBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32_kernel<DHP><<<grid_f32(BH, L, P::kRows), kThreadsF, P::kFwdBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), L, dh, scale_f32(dh), causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int BH, int L, int dh, int causal, cudaStream_t s) {
  typedef PlanF<DHP> P;
  cudaError_t err = allow_smem(flash_dq_f32_kernel<DHP>, P::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dq_f32_kernel<DHP><<<grid_f32(BH, L, P::kRows), kThreadsF, P::kDqBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), L, dh, scale_f32(dh), causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BH, int L, int dh, int causal,
            cudaStream_t s) {
  typedef PlanF<DHP> P;
  cudaError_t err = allow_smem(flash_dkv_f32_kernel<DHP>, P::kDkvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_f32_kernel<DHP><<<grid_f32(BH, L, P::kRows), kThreadsF, P::kDkvBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), L, dh,
      scale_f32(dh), causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape_f32(int BH, int L, int dh) {
  return BH <= 0 || L <= 0 || dh <= 0 || dh % 8 || dh > 256 || (L + 31) / 32 > 65535;
}

}  // namespace

// The forward of BH = B * H (L, dh) f32 attentions; dh a multiple of 8 up to
// 256. Returns cudaGetLastError().
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

// dQ of BH = B * H (L, dh) f32 attentions. Returns cudaGetLastError().
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

// dK and dV of BH = B * H (L, dh) f32 attentions. Returns cudaGetLastError().
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
