// Flash attention for Hopper (sm_90a), fp32 and bf16: forward, dK/dV and
// dQ, three kernels.
//
// Replaces the six Pallas TPU kernel bodies of
// easyparallellibrary_tpu/kernels/flash_attention.py:
//   forward  <- `_fwd_kernel_resident` (:89) and `_fwd_kernel_stream`
//               (:241), launched by `_fwd`;
//   dK/dV    <- `_bwd_dkv_kernel_resident` (:133) and
//               `_bwd_dkv_kernel_stream` (:363), launched by
//               `_bwd_kernels`;
//   dQ       <- `_bwd_dq_kernel_resident` (:172) and
//               `_bwd_dq_kernel_stream` (:404), launched by
//               `_bwd_kernels`.
// The resident/streaming pairs exist only for the TPU's ~16 MB VMEM
// budget; here one tiled kernel covers every length.  Same functions as
// the Pallas kernels, on [B*H, S, D] row-major tensors:
//   scores s = (q . k) accumulated in fp32, times scale = 1/sqrt(D) as an
//   fp32 constant; causal entries (k_pos > q_pos) are -1e30, as the
//   Pallas kernels' NEG_INF; key rows past Skv do not exist.
//   forward: online softmax (fp32 running max m, denominator l and
//   accumulator) over KV tiles up to the causal diagonal; p is rounded to
//   V's dtype before the PV product; O = acc / max(l, 1e-30) in the input
//   dtype, lse = m + log(max(l, 1e-30)) in fp32 [B*H, S].
//   dK/dV: per KV tile, over the Q tiles from the diagonal on,
//   p = exp(s - lse), dV += round(p) . dO, dP = dO . V^T,
//   dS = p * (dP - delta), dK += round(dS) . Q, dK scaled once at the end.
//   dQ: per Q tile, over the live KV tiles, dQ += round(dS) . K, scaled
//   once.  dQ is its own kernel (no atomics), so gradients are
//   deterministic from run to run.
//
// What bounds it on this card: operations.  At the training shape
// (S = 1024, D = 64) a Q tile does 64 multiply-adds per byte it reads,
// far above the H100's ~295 bf16 tensor-core operations per byte of
// device memory, so the design spends its effort on the products:
//   * bf16 at D in {32, 64, 128} (the training path) runs on the tensor
//     cores: warp-level mma.sync m16n8k16, 4 warps a CTA, each warp 16
//     rows of a 64-row tile; scores, probabilities and gradients stay in
//     registers, re-packed as the next product's operand (namespace tc
//     below);
//   * fp32, and bf16 at other head dims, run on the CUDA cores as IEEE
//     fp32 FMAs (no TF32): 256 threads a CTA, tiles converted to fp32 in
//     shared memory at row stride D + 1 (odd: column walks are free of
//     bank conflicts), each thread a 4 x 4 register micro-tile of the
//     64 x 64 score tile, so each shared-memory value feeds 4 FMAs;
//   * one CTA per (b * h, 64-row tile); causal tiles past the diagonal are
//     skipped, and the forward and dQ grids run their Q tiles from the
//     last (the longest) to the first so that the heaviest CTAs start
//     first.
// Not yet: wgmma, TMA, pipelined (double-buffered) loads, and a
// persistent schedule; the mma.sync path reaches only part of the bf16
// peak that the bound uses.
//
// Interface: plain C, pointers and sizes, launched on the caller's
// stream; each entry returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kInner = 64;     // rows of the tile a CTA loops over
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

// Row r < valid of a [rows, D] tile of `src` (row-major, D per row) into
// shared memory at stride D + 1, converted to fp32; rows past `valid`
// are zeros.  16-byte loads (D is a multiple of 8).
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows,
                                          int valid, int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = D / VEC;
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * VEC;
    float vals[VEC];
    if (r < valid) {
      load_vec(src + static_cast<size_t>(r) * D + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * ld + c + i] = vals[i];
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (the Pallas kernels' `.astype(dtype)` before a
// product with storage-dtype operands).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Sum / max over the 16 lanes that share a row (lanes differ in bits 0-3).
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  }
  return x;
}

// The score entry for (row, col) after scaling and masking.
__device__ __forceinline__ float masked_score(float dot, int row, int col,
                                              int Skv, bool causal,
                                              float scale) {
  if (col >= Skv) return -INFINITY;  // no such key: weight exactly 0
  const float s = dot * scale;
  return (causal && col > row) ? kNegInf : s;
}

// Number of KV tiles of width kInner that rows [q0, q_end) attend.
__device__ __forceinline__ int live_kv_tiles(int q_end, int Skv,
                                             bool causal) {
  const int all = (Skv + kInner - 1) / kInner;
  return causal ? min(all, (q_end - 1) / kInner + 1) : all;
}

// ------------------------------------------------------------- forward --
// CTA: 64 query rows of one (b, h).  Thread (ty, tx) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 c (c < NC, those < D).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Skv, int D, int causal,
                 float scale) {
  constexpr int RM = 4;
  constexpr int BQ = 16 * RM;
  constexpr int BK = kInner;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sK = sQ + BQ * ld;
  float* sV = sK + BK * ld;
  float* sP = sV + BK * ld;  // [BQ][BK + 1]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  load_tile(sQ, qb + static_cast<size_t>(q0) * D, BQ, min(BQ, S - q0), D);

  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = live_kv_tiles(min(q0 + BQ, S), Skv, causal != 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's sK, sV, sP are consumed
    load_tile(sK, kb + static_cast<size_t>(k0) * D, BK, min(BK, Skv - k0), D);
    load_tile(sV, vb + static_cast<size_t>(k0) * D, BK, min(BK, Skv - k0), D);
    __syncthreads();

    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], row, k0 + tx + 16 * j, Skv,
                               causal != 0, scale);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RM], vv[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = sP[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? sV[kk * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = from_float<T>(acc[i][c] / l_safe);
    }
    if (tx == 0) lse[bh * S + row] = m[i] + logf(l_safe);
  }
}

// --------------------------------------------------------- dK / dV -----
// CTA: BKo = 16 * RM key rows of one (b, h), looping over Q tiles of 64.
// Score tile (64 queries x BKo keys): thread owns queries ty + 16 i
// (i < 4) and keys tx + 16 j (j < RM).  Accumulators: keys ty + 16 i
// (i < RM) x columns tx + 16 c (c < NC).
template <typename T, int NC, int RM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Skv, int D, int causal,
                     float scale) {
  constexpr int BKo = 16 * RM;
  constexpr int BQ = kInner;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sK = smem;
  float* sV = sK + BKo * ld;
  float* sQ = sV + BKo * ld;
  float* sO = sQ + BQ * ld;        // dO
  float* sP = sO + BQ * ld;        // [BQ][BKo + 1], p rounded to dO's type
  float* sS = sP + BQ * (BKo + 1);  // [BQ][BKo + 1], dS rounded to Q's type
  float* sL = sS + BQ * (BKo + 1);  // [BQ] lse
  float* sD = sL + BQ;              // [BQ] delta
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BKo;
  const T* qb = q + bh * S * D;
  const T* ob = dout + bh * S * D;
  const float* lb = lse + bh * S;
  const float* db = delta + bh * S;

  load_tile(sK, k + (bh * Skv + k0) * D, BKo, min(BKo, Skv - k0), D);
  load_tile(sV, v + (bh * Skv + k0) * D, BKo, min(BKo, Skv - k0), D);

  float acc_k[RM][NC], acc_v[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }
  }

  // Causal: query rows below k0 see none of these keys.
  const int first = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = first; q0 < S; q0 += BQ) {
    const int valid = min(BQ, S - q0);
    __syncthreads();  // the previous tile's shared data are consumed
    load_tile(sQ, qb + static_cast<size_t>(q0) * D, BQ, valid, D);
    load_tile(sO, ob + static_cast<size_t>(q0) * D, BQ, valid, D);
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x;
      sL[r] = r < valid ? lb[q0 + r] : 0.f;
      sD[r] = r < valid ? db[q0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][RM], dp[4][RM];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    }
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[RM], vv[RM];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * ld + d];
        ov[i] = sO[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        kv[j] = sK[(tx + 16 * j) * ld + d];
        vv[j] = sV[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int c = tx + 16 * j;
        const float x =
            masked_score(s[i][j], row, k0 + c, Skv, causal != 0, scale);
        const float p = row < S ? expf(x - sL[r]) : 0.f;
        const float ds = p * (dp[i][j] - sD[r]);
        sP[r * (BKo + 1) + c] = round_to<T>(p);
        sS[r * (BKo + 1) + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < BQ; ++qq) {
      float pv[RM], sv[RM], ov[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pv[i] = sP[qq * (BKo + 1) + ty + 16 * i];
        sv[i] = sS[qq * (BKo + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        ov[c] = col < D ? sO[qq * ld + col] : 0.f;
        qv[c] = col < D ? sQ[qq * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(sv[i], qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Skv) continue;
    T* krow = dk + (bh * Skv + key) * D;
    T* vrow = dv + (bh * Skv + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        krow[col] = from_float<T>(acc_k[i][c] * scale);
        vrow[col] = from_float<T>(acc_v[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------- dQ ---
// CTA: BQo = 16 * RM query rows of one (b, h), looping over KV tiles of
// 64.  Score tile (BQo x 64): thread owns queries ty + 16 i (i < RM) and
// keys tx + 16 j (j < 4); accumulator: its queries x columns tx + 16 c.
template <typename T, int NC, int RM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int Skv, int D, int causal, float scale) {
  constexpr int BQo = 16 * RM;
  constexpr int BK = kInner;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sO = sQ + BQo * ld;  // dO
  float* sK = sO + BQo * ld;
  float* sV = sK + BK * ld;
  float* sS = sV + BK * ld;  // [BQo][BK + 1], dS rounded to K's type
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQo;  // longest rows first
  const int valid = min(BQo, S - q0);
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  load_tile(sQ, q + (bh * S + q0) * D, BQo, valid, D);
  load_tile(sO, dout + (bh * S + q0) * D, BQo, valid, D);
  float row_lse[RM], row_delta[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    row_lse[i] = r < valid ? lse[bh * S + q0 + r] : 0.f;
    row_delta[i] = r < valid ? delta[bh * S + q0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = live_kv_tiles(q0 + valid, Skv, causal != 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile(sK, kb + static_cast<size_t>(k0) * D, BK, min(BK, Skv - k0), D);
    load_tile(sV, vb + static_cast<size_t>(k0) * D, BK, min(BK, Skv - k0), D);
    __syncthreads();

    float s[RM][4], dp[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    }
    for (int d = 0; d < D; ++d) {
      float qv[RM], ov[RM], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = sQ[(ty + 16 * i) * ld + d];
        ov[i] = sO[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * ld + d];
        vv[j] = sV[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x =
            masked_score(s[i][j], q0 + r, k0 + c, Skv, causal != 0, scale);
        const float p = r < valid ? expf(x - row_lse[i]) : 0.f;
        sS[r * (BK + 1) + c] = round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float sv[RM], kv[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) sv[i] = sS[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < D ? sK[kk * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (r >= valid) continue;
    T* qrow = dq + (bh * S + q0 + r) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) qrow[col] = from_float<T>(acc[i][c] * scale);
    }
  }
}

// ------------------------------------------- tensor-core path (bf16) --
// The same three functions for bf16 at D in {32, 64, 128}, with the
// products on the tensor cores: warp-level mma.sync m16n8k16 (bf16
// operands, fp32 accumulation, the Pallas kernels' contract).  A CTA is
// 4 warps; each warp owns 16 rows of the CTA's 64-row tile, so no
// reduction crosses warps.  Tiles stay bf16 in shared memory (row stride
// D + 8, which makes the fragment loads free of bank conflicts); a
// product's accumulator fragment is re-packed in registers as the next
// product's A operand (the FlashAttention-2 layout trick), which is where
// p and dS are rounded to bf16, as the Pallas kernels round them; B
// operands that need the transpose of a row-major tile come from
// `ldmatrix .trans`.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kTile = 64;  // CTA rows, and the inner tile
constexpr int kPad = 8;    // bf16 of padding per shared-memory row

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major) at x[r0.., k0..] of a tile with row
// stride ld: lane (g, t) holds rows g and g + 8, columns 2t, 2t + 1 and
// 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* x, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = x + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (16 x 8, column-major) whose column n is row n0 + n of the
// row-major tile x (so the product is against x^T): lane (g, t) holds
// column g, rows 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* x, int ld,
                                       int n0, int k0, int g, int t) {
  const bf16* p = x + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (16 x 8) taken straight from the row-major tile x: rows
// k0..k0+15 are the product's K dimension, columns n0..n0+7 its N.
__device__ __forceinline__ void load_b_trans(uint32_t* b, const bf16* x,
                                             int ld, int k0, int n0,
                                             int lane) {
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(x + (k0 + (lane & 15)) * ld + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

// A [64, D] tile of src rows (row-major, D per row) into shared memory
// at stride D + kPad; rows past `valid` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int valid) {
  constexpr int per_row = D / 8;
  for (int idx = threadIdx.x; idx < kTile * per_row; idx += kTcThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) {
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D +
                                          c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = v;
  }
}

// The A operand of the next product from the accumulators of 16 rows x
// 64 columns (8 n-tiles): columns 16 kk .. 16 kk + 15, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (*c)[4],
                                         int kk) {
  a[0] = pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Reductions over the 4 lanes that share a row of a fragment.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int Skv, int causal,
                    float scale) {
  constexpr int ld = D + kPad;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = sQ + kTile * ld;
  bf16* sV = sK + kTile * ld;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int r0 = 16 * w;  // this warp's rows of the tile
  const bf16* kb = k + bh * Skv * D;
  const bf16* vb = v + bh * Skv * D;
  load_tile<D>(sQ, q + (bh * S + q0) * D, min(kTile, S - q0));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const int n_tiles = live_kv_tiles(min(q0 + kTile, S), Skv, causal != 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // the previous tile's sK, sV are consumed
    load_tile<D>(sK, kb + static_cast<size_t>(k0) * D, min(kTile, Skv - k0));
    load_tile<D>(sV, vb + static_cast<size_t>(k0) * D, min(kTile, Skv - k0));
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, ld, r0, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        load_b(b, sK, ld, 8 * n, 16 * kk, g, t);
        mma(s[n], a, b);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = masked_score(s[n][j], rows[j >> 1], k0 + 8 * n + 2 * t +
                               (j & 1), Skv, causal != 0, scale);
        mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = expf(s[n][j] - m[j >> 1]);
        psum[j >> 1] += s[n][j];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(psum[h]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] *= corr[j >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);  // p rounded to V's type
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b[2];
        load_b_trans(b, sV, ld, 16 * kk, 8 * n, lane);
        mma(acc[n], a, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= S) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    bf16* orow = o + (bh * S + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack(acc[n][2 * h] / l_safe, acc[n][2 * h + 1] / l_safe);
    }
    if (t == 0) lse[bh * S + row] = m[h] + logf(l_safe);
  }
}

// dK/dV: a CTA per 64 keys (warp w owns keys 16 w ..), looping over the
// Q tiles from the diagonal on.  Per tile the warp forms S^T = K Q^T and
// dP^T = V dO^T (16 keys x 64 queries), then dV += P^T dO and
// dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                        int Skv, int causal, float scale) {
  constexpr int ld = D + kPad;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + kTile * ld;
  bf16* sQ = sV + kTile * ld;
  bf16* sO = sQ + kTile * ld;  // dO
  float* sL = reinterpret_cast<float*>(sO + kTile * ld);
  float* sD = sL + kTile;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int r0 = 16 * w;
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const bf16* qb = q + bh * S * D;
  const bf16* ob = dout + bh * S * D;
  load_tile<D>(sK, k + (bh * Skv + k0) * D, min(kTile, Skv - k0));
  load_tile<D>(sV, v + (bh * Skv + k0) * D, min(kTile, Skv - k0));

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_k[n][j] = 0.f;
      acc_v[n][j] = 0.f;
    }
  }

  for (int q0 = causal ? k0 : 0; q0 < S; q0 += kTile) {
    const int valid = min(kTile, S - q0);
    __syncthreads();
    load_tile<D>(sQ, qb + static_cast<size_t>(q0) * D, valid);
    load_tile<D>(sO, ob + static_cast<size_t>(q0) * D, valid);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x;
      sL[r] = r < valid ? lse[bh * S + q0 + r] : 0.f;
      sD[r] = r < valid ? delta[bh * S + q0 + r] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[n][j] = 0.f;
        dpt[n][j] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, sK, ld, r0, 16 * kk, g, t);
      load_a(av, sV, ld, r0, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        load_b(b, sQ, ld, 8 * n, 16 * kk, g, t);
        mma(st[n], ak, b);
        load_b(b, sO, ld, 8 * n, 16 * kk, g, t);
        mma(dpt[n], av, b);
      }
    }
    // st becomes P^T, dpt becomes dS^T (fp32).
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * n + 2 * t + (j & 1);  // query within the tile
        const float x = masked_score(st[n][j], q0 + c, keys[j >> 1], Skv,
                                     causal != 0, scale);
        const float p = c < valid ? expf(x - sL[c]) : 0.f;
        st[n][j] = p;
        dpt[n][j] = p * (dpt[n][j] - sD[c]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, st, kk);   // p rounded to dO's type
      acc_to_a(as, dpt, kk);  // dS rounded to Q's type
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b[2];
        load_b_trans(b, sO, ld, 16 * kk, 8 * n, lane);
        mma(acc_v[n], ap, b);
        load_b_trans(b, sQ, ld, 16 * kk, 8 * n, lane);
        mma(acc_k[n], as, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= Skv) continue;
    bf16* krow = dk + (bh * Skv + keys[h]) * D;
    bf16* vrow = dv + (bh * Skv + keys[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + 8 * n + 2 * t) =
          pack(acc_k[n][2 * h] * scale, acc_k[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n + 2 * t) =
          pack(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

// dQ: a CTA per 64 queries (warp w owns rows 16 w ..), looping over the
// live KV tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int S, int Skv, int causal,
                       float scale) {
  constexpr int ld = D + kPad;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sO = sQ + kTile * ld;  // dO
  bf16* sK = sO + kTile * ld;
  bf16* sV = sK + kTile * ld;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int r0 = 16 * w;
  const int valid = min(kTile, S - q0);
  const bf16* kb = k + bh * Skv * D;
  const bf16* vb = v + bh * Skv * D;
  load_tile<D>(sQ, q + (bh * S + q0) * D, valid);
  load_tile<D>(sO, dout + (bh * S + q0) * D, valid);
  const int rows[2] = {r0 + g, r0 + g + 8};  // within the tile
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = rows[h] < valid ? lse[bh * S + q0 + rows[h]] : 0.f;
    row_delta[h] = rows[h] < valid ? delta[bh * S + q0 + rows[h]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  }

  const int n_tiles = live_kv_tiles(q0 + valid, Skv, causal != 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    load_tile<D>(sK, kb + static_cast<size_t>(k0) * D, min(kTile, Skv - k0));
    load_tile<D>(sV, vb + static_cast<size_t>(k0) * D, min(kTile, Skv - k0));
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = 0.f;
        dp[n][j] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, ld, r0, 16 * kk, g, t);
      load_a(ao, sO, ld, r0, 16 * kk, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        load_b(b, sK, ld, 8 * n, 16 * kk, g, t);
        mma(s[n], aq, b);
        load_b(b, sV, ld, 8 * n, 16 * kk, g, t);
        mma(dp[n], ao, b);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1;
        const float x = masked_score(s[n][j], q0 + rows[h],
                                     k0 + 8 * n + 2 * t + (j & 1), Skv,
                                     causal != 0, scale);
        const float p = rows[h] < valid ? expf(x - row_lse[h]) : 0.f;
        dp[n][j] = p * (dp[n][j] - row_delta[h]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp, kk);  // dS rounded to K's type
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b[2];
        load_b_trans(b, sK, ld, 16 * kk, 8 * n, lane);
        mma(acc[n], a, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= valid) continue;
    bf16* qrow = dq + (bh * S + q0 + rows[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(qrow + 8 * n + 2 * t) =
          pack(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// Calls f(D) with D as a compile-time constant when the tensor-core
// kernels take this head dim; returns false (f not called) otherwise.
template <typename F>
bool with_head_dim(int D, F f) {
  using std::integral_constant;
  switch (D) {
    case 32: f(integral_constant<int, 32>{}); return true;
    case 64: f(integral_constant<int, 64>{}); return true;
    case 128: f(integral_constant<int, 128>{}); return true;
    default: return false;
  }
}

constexpr size_t tile_bytes(int D) { return sizeof(bf16) * kTile * (D + kPad); }

}  // namespace tc

// ---------------------------------------------------------- launchers --

// Output columns per thread, NC (D <= 16 * NC), and for the backward
// kernels the outer rows per thread, RM (RM = 2 at the widest heads keeps
// the two accumulators in registers and the tiles within shared memory).
// Calls f(NC, RM) with both as compile-time constants.
template <typename F>
cudaError_t with_tiles(int D, F f) {
  using std::integral_constant;
  if (D <= 32) return f(integral_constant<int, 2>{}, integral_constant<int, 4>{});
  if (D <= 64) return f(integral_constant<int, 4>{}, integral_constant<int, 4>{});
  if (D <= 128) return f(integral_constant<int, 8>{}, integral_constant<int, 4>{});
  return f(integral_constant<int, 16>{}, integral_constant<int, 2>{});
}

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v,
                         void* o, float* lse, int BH, int S, int Skv, int D,
                         int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaSuccess;
    if (tc::with_head_dim(D, [&](auto d) {
          constexpr int kD = decltype(d)::value;
          auto kernel = tc::flash_fwd_tc_kernel<kD>;
          const size_t smem = 3 * tc::tile_bytes(kD);
          err = allow_smem(kernel, smem);
          if (err != cudaSuccess) return;
          const dim3 grid((S + tc::kTile - 1) / tc::kTile, BH);
          kernel<<<grid, tc::kTcThreads, smem, stream>>>(
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<T*>(o), lse, S, Skv,
              causal, scale);
          err = cudaGetLastError();
        })) {
      return err;
    }
  }
  return with_tiles(D, [&](auto nc, auto) {
    constexpr int BQ = 64;
    const size_t smem =
        sizeof(float) * ((BQ + 2 * kInner) * (D + 1) + BQ * (kInner + 1));
    auto kernel = flash_fwd_kernel<T, decltype(nc)::value>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, BH);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, S, Skv, D,
        causal, scale);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dkv_dispatch(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int BH,
                         int S, int Skv, int D, int causal, float scale,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaSuccess;
    if (tc::with_head_dim(D, [&](auto d) {
          constexpr int kD = decltype(d)::value;
          auto kernel = tc::flash_bwd_dkv_tc_kernel<kD>;
          const size_t smem =
              4 * tc::tile_bytes(kD) + 2 * tc::kTile * sizeof(float);
          err = allow_smem(kernel, smem);
          if (err != cudaSuccess) return;
          const dim3 grid((Skv + tc::kTile - 1) / tc::kTile, BH);
          kernel<<<grid, tc::kTcThreads, smem, stream>>>(
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const T*>(dout), lse,
              delta, static_cast<T*>(dk), static_cast<T*>(dv), S, Skv,
              causal, scale);
          err = cudaGetLastError();
        })) {
      return err;
    }
  }
  return with_tiles(D, [&](auto nc, auto rm) {
    constexpr int BKo = 16 * decltype(rm)::value;
    const size_t smem =
        sizeof(float) * ((2 * BKo + 2 * kInner) * (D + 1) +
                         2 * kInner * (BKo + 1) + 2 * kInner);
    auto kernel = flash_bwd_dkv_kernel<T, decltype(nc)::value,
                                       decltype(rm)::value>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Skv + BKo - 1) / BKo, BH);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), S, Skv, D, causal, scale);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dq_dispatch(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int BH, int S, int Skv,
                        int D, int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaSuccess;
    if (tc::with_head_dim(D, [&](auto d) {
          constexpr int kD = decltype(d)::value;
          auto kernel = tc::flash_bwd_dq_tc_kernel<kD>;
          const size_t smem = 4 * tc::tile_bytes(kD);
          err = allow_smem(kernel, smem);
          if (err != cudaSuccess) return;
          const dim3 grid((S + tc::kTile - 1) / tc::kTile, BH);
          kernel<<<grid, tc::kTcThreads, smem, stream>>>(
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const T*>(dout), lse,
              delta, static_cast<T*>(dq), S, Skv, causal, scale);
          err = cudaGetLastError();
        })) {
      return err;
    }
  }
  return with_tiles(D, [&](auto nc, auto rm) {
    constexpr int BQo = 16 * decltype(rm)::value;
    const size_t smem = sizeof(float) * ((2 * BQo + 2 * kInner) * (D + 1) +
                                         BQo * (kInner + 1));
    auto kernel = flash_bwd_dq_kernel<T, decltype(nc)::value,
                                      decltype(rm)::value>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQo - 1) / BQo, BH);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), S, Skv, D, causal, scale);
    return cudaGetLastError();
  });
}

bool bad_sizes(int BH, int S, int Skv, int D) {
  return BH <= 0 || BH > 65535 || S <= 0 || Skv <= 0 || D <= 0 || D > 256 ||
         D % 8 != 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/o [BH, S, D], k/v [BH, Skv, D],
// lse [BH, S] fp32; all contiguous and 16-byte aligned; D a multiple of 8,
// at most 256.
int epl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int S, int Skv, int D, int causal,
                  int dtype, float scale, void* stream) {
  if (bad_sizes(BH, S, Skv, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    return fwd_dispatch<float>(q, k, v, o, l, BH, S, Skv, D, causal, scale, s);
  }
  if (dtype == 1) {
    return fwd_dispatch<__nv_bfloat16>(q, k, v, o, l, BH, S, Skv, D, causal,
                                       scale, s);
  }
  return cudaErrorInvalidValue;
}

// dout [BH, S, D] in q's type; lse, delta [BH, S] fp32; dk, dv [BH, Skv, D].
int epl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int BH, int S, int Skv, int D,
                      int causal, int dtype, float scale, void* stream) {
  if (bad_sizes(BH, S, Skv, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    return dkv_dispatch<float>(q, k, v, dout, l, dl, dk, dv, BH, S, Skv, D,
                               causal, scale, s);
  }
  if (dtype == 1) {
    return dkv_dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, BH, S,
                                       Skv, D, causal, scale, s);
  }
  return cudaErrorInvalidValue;
}

// dq [BH, S, D] in q's type.
int epl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int BH, int S, int Skv, int D, int causal,
                     int dtype, float scale, void* stream) {
  if (bad_sizes(BH, S, Skv, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    return dq_dispatch<float>(q, k, v, dout, l, dl, dq, BH, S, Skv, D, causal,
                              scale, s);
  }
  if (dtype == 1) {
    return dq_dispatch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, BH, S, Skv, D,
                                      causal, scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* epl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
