// Flash attention for Hopper (sm_90a), fp32, bf16 and fp16: forward, dK/dV
// and dQ.
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
// budget; here one tiled kernel covers every length.  Which build runs:
//   bf16, D in {64, 128}: forward, dK/dV and dQ on wgmma with TMA-fed,
//     double-buffered tiles (namespace wg below);
//   everything else (fp32 at every D; bf16 at any other D, 32 included;
//     fp16 at every D): IEEE fp32 FMAs on the CUDA cores.  fp16 tiles are
//     converted to fp32 as they are loaded, so scores, the running max
//     and the accumulators stay in fp32 (fp16's range ends at 65504); p
//     and dS are rounded to fp16 only where the products read them.
// Same functions as the Pallas kernels, on [B*H, S, D] row-major tensors:
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
// What bounds it on this card, at the training shape (B = 16, H = 16,
// S = 1024, D = 64, causal, bf16; H100 SXM, 3.35 TB/s, 989 TFLOP/s):
//   forward: bytes, 0.0404 ms (q, k, v, o and lse once: 135 MB) against
//     0.0347 ms of operations (34.4 GFLOP);
//   dK/dV: operations, 0.0695 ms (68.7 GFLOP) against 0.0202 ms of bytes;
//   dQ: operations, 0.0521 ms (51.5 GFLOP).
// So the design keeps every operand on chip once loaded and spends its
// effort on feeding the tensor cores:
//   * wg (forward, dK/dV, dQ): a CTA is two consumer warpgroups and one
//     producer warp.  The producer's TMA loads stream the K/V (forward,
//     dQ) or Q/dO (dK/dV) tiles through a two-stage ring of
//     128-byte-swizzled shared memory, with mbarriers for "full" (TMA
//     bytes landed) and "empty" (both consumers done), so the next tile's
//     copy overlaps the current tile's products.  Products are warpgroup
//     wgmma: scores (and dP) from two shared-memory operands, then P.V
//     (forward), P^T.dO and dS^T.Q (dK/dV) or dS.K (dQ) with P / dS
//     packed to bf16 in registers as the A operand, which is where the
//     Pallas kernels' roundings of p and dS happen.  The softmax runs on
//     the accumulator fragments in registers, in base 2 with log2(e)
//     folded into the score scale; only tiles that cross the causal
//     diagonal or the key count are masked, and tiles past the diagonal
//     are skipped.
//   * fp32, and bf16 at the head dims above not taken, run on the CUDA
//     cores as IEEE fp32 FMAs (no TF32): 256 threads a CTA, tiles
//     converted to fp32 in shared memory at row stride D + 1 (odd: column
//     walks are free of bank conflicts), each thread a 4 x 4 register
//     micro-tile of the 64 x 64 score tile.
//   * The forward and dQ grids run their Q tiles from the last (the
//     longest, under causal masking) to the first, and dK/dV its KV tiles
//     from the first, so that the heaviest CTAs start first.  They do so
//     within each head (the Q or KV block is the grid's fastest index):
//     a head's CTAs then run side by side and share its K/V (forward) or
//     Q/dO (dK/dV) in L2, which measured faster than ordering the blocks
//     longest first across all heads.
//
// Interface: plain C, pointers and sizes, launched on the caller's
// stream; each entry returns the cudaError_t of its launch (or
// kTensorMapError when cuTensorMapEncodeTiled refuses a TMA tensor map).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

__device__ __forceinline__ void load_vec(const __half* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
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
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
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

// Two floats rounded to bf16 and packed as one 32-bit operand register
// (lo in the low half): a tensor-core A fragment entry.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --------------------------------- wgmma forward and dK/dV (bf16, wg::) --
// The forward and dK/dV for bf16 at D in {64, 128}.  A CTA is two
// consumer warpgroups (threads 0-255), each owning 64 rows of the CTA's
// 128-row block (query rows in the forward, key rows in dK/dV), and one
// producer warp (threads 256-287) whose lane 0 issues the TMA loads.
// Shared-memory tiles are in the B128 layout of hopper.cuh.
namespace wg {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kRows = 64;  // a consumer warpgroup's rows: wgmma's M
constexpr int kConsumers = 2;
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kStages = 2;                       // depth of the TMA ring
constexpr int kFwdQ = kRows * kConsumers;        // query rows a forward CTA
constexpr int kFwdK = 64;                        // keys a forward KV tile
constexpr int kBwdK = kRows * kConsumers;        // keys a dK/dV CTA
constexpr int kBwdQ = 64;                        // query rows a dK/dV Q tile
constexpr int kDqQ = kRows * kConsumers;         // query rows a dQ CTA
constexpr int kDqK = 64;                         // keys a dQ KV tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Bytes of a [rows, D] bf16 tile.
__host__ __device__ constexpr uint32_t tile_bytes(int rows, int D) {
  return rows * D * 2;
}

// The dynamic shared memory from its first 1024-byte boundary, the
// alignment of the swizzle pattern (launches allocate 1024 bytes extra).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
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

// 2^x on the special-function unit, one instruction (exp2f adds a
// denormal path).  Flushing a p below 2^-126 to 0 moves the row's sum,
// which is at least 1, by less than 2^-126.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's step of the online softmax, on 64 rows x N keys of scores
// in the wgmma fragment layout (masked entries already -1e30 or -inf).
// m holds each row's running max of score * scale_log2, l this thread's
// part of the row's denominator.  sc becomes p = 2^(s * scale_log2 - m),
// one FFMA and one exp2 each; corr is the factor for what was summed
// before.
template <int K>
__device__ __forceinline__ void online_softmax(float (&sc)[K], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < K; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]) * scale_log2);
    corr[h] = exp2_ftz(m[h] - m_new);
    m[h] = m_new;
  }
  // Four partial sums per row: shorter dependency chains.
  float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < K; ++i) {
    sc[i] = exp2_ftz(fmaf(sc[i], scale_log2, -m[(i / 2) & 1]));
    part[(i / 2) & 1][(i / 4) & 1] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + (part[h][0] + part[h][1]);
}

// The A operand of k-step kk of a product whose reduction runs over the
// columns of accumulator d (columns 16 kk .. 16 kk + 15), rounded to bf16.
template <int K>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&d)[K], int kk) {
#pragma unroll
  for (int x = 0; x < 4; ++x) a[x] = pack(d[8 * kk + 2 * x], d[8 * kk + 2 * x + 1]);
}

// Descriptors of the k-th 16-wide reduction slice of a B128 tile of
// `rows` rows at shared address `base`: K-major (the reduction runs over
// the columns) and MN-major (over the rows).
__device__ __forceinline__ uint64_t k_major(uint32_t base, int rows, int k) {
  return desc_b128(base + (k / 4) * rows * 128 + (k % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mn_major(uint32_t base, int rows, int k) {
  return desc_b128(base + k * 16 * 128, rows * 128, 1024);
}

// -------------------------------------------------------------- forward --
// CTA: kFwdQ query rows of one (b, h).  The producer loads the Q block
// once and the K/V tiles of kFwdK keys, up to the causal diagonal,
// through the ring.  Per tile a consumer warpgroup forms S = Q K^T (64 x
// 64, SS wgmma), updates the online softmax on the fragments, and adds
// P V (RS wgmma, V MN-major).  64-key tiles keep the D = 64 build at
// about 95 registers a thread, so two CTAs (four consumer warpgroups)
// share an SM, which measured faster than one CTA with 128-key tiles
// (about 157 registers); D = 128 holds twice the output accumulators and
// runs one CTA an SM.
template <int D>
struct FwdLayout {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + tile_bytes(kFwdQ, D);
  static constexpr uint32_t kV = kK + kStages * tile_bytes(kFwdK, D);
  static constexpr uint32_t kBar = kV + kStages * tile_bytes(kFwdK, D);
  // Barriers: Q landed, then full[kStages], empty[kStages].
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                       __grid_constant__ const CUtensorMap k_map,
                       __grid_constant__ const CUtensorMap v_map,
                       bf16* __restrict__ o, float* __restrict__ lse, int S,
                       int Skv, int causal, float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int kTile = tile_bytes(kFwdK, D);
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* smem = align_1024(wg_smem);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdQ;  // longest first
  const int all_tiles = (Skv + kFwdK - 1) / kFwdK;
  const int n_tiles =
      causal ? min(all_tiles, (min(q0 + kFwdQ, S) - 1) / kFwdK + 1)
             : all_tiles;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warp
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(bar_q, tile_bytes(kFwdQ, D));
      tma_load_tile<D>(smem + L::kQ, &q_map, bar_q, q0, bh, kFwdQ);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, 2 * kTile);
        tma_load_tile<D>(smem + L::kK + s * kTile, &k_map, full + s,
                         t * kFwdK, bh, kFwdK);
        tma_load_tile<D>(smem + L::kV + s * kTile, &v_map, full + s,
                         t * kFwdK, bh, kFwdK);
      }
    }
    return;
  }

  const int w = threadIdx.x / 128;           // consumer warpgroup
  const int warp = (threadIdx.x / 32) & 3;   // warp within it
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int wg_row0 = q0 + kRows * w;        // the warpgroup's first row
  const int row = wg_row0 + 16 * warp + g;   // this thread's rows: +0, +8
  const uint32_t q_base = smem_addr(smem + L::kQ) + kRows * 128 * w;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // Running max (of scores times log2 e) and denominator, per row.
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kFwdK;
    const uint32_t k_base = smem_addr(smem + L::kK + s * kTile);
    const uint32_t v_base = smem_addr(smem + L::kV + s * kTile);
    mbar_wait(full + s, (t / kStages) & 1);
    if (causal && k0 > wg_row0 + kRows - 1) {  // every key is in the future
      mbar_arrive(empty + s);
      continue;
    }

    float sc[kFwdK / 2];  // S = Q K^T, 64 rows x kFwdK keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kFwdK>(sc, k_major(q_base, kFwdQ, kk),
                      k_major(k_base, kFwdK, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // Masked only where the tile crosses the key count or (causal) the
    // diagonal of this warpgroup's rows.
    if (k0 + kFwdK > Skv || (causal && k0 + kFwdK - 1 > wg_row0)) {
#pragma unroll
      for (int i = 0; i < kFwdK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        if (col >= Skv) {
          sc[i] = -INFINITY;  // no such key: weight exactly 0
        } else if (causal && col > row + 8 * ((i / 2) & 1)) {
          sc[i] = kNegInf;
        }
      }
    }
    float corr[2];
    online_softmax(sc, m, l, corr, scale_log2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) & 1];

    // O += P V, p rounded to V's type in the A operand.
    uint32_t pa[kFwdK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kFwdK / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdK / 16; ++kk) {
      wgmma_rs_mn<D>(acc, pa[kk], mn_major(v_base, kFwdK, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(empty + s);
  }

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_safe[h] = fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= S) continue;
    bf16* orow = o + (static_cast<size_t>(bh) * S + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          pack(acc[4 * j + 2 * h] / l_safe[h],
               acc[4 * j + 2 * h + 1] / l_safe[h]);
    }
    if (t4 == 0) {
      lse[static_cast<size_t>(bh) * S + r] = (m[h] + log2f(l_safe[h])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------- dK/dV --
// CTA: kBwdK keys of one (b, h); K and V are loaded once.  The producer
// streams the Q and dO tiles of kBwdQ rows from the causal diagonal on,
// with their lse (times log2 e) and delta, through the ring.  Per tile a
// consumer warpgroup forms S^T = K Q^T and dP^T = V dO^T (64 keys x 64
// queries, SS wgmma), then P^T and dS^T on the fragments, then dV += P^T
// dO and dK += dS^T Q (RS wgmma, dO and Q MN-major).
template <int D>
struct DkvLayout {
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + tile_bytes(kBwdK, D);
  static constexpr uint32_t kQ = kV + tile_bytes(kBwdK, D);
  static constexpr uint32_t kO = kQ + kStages * tile_bytes(kBwdQ, D);  // dO
  // Per stage: lse * log2 e, then delta, kBwdQ floats each.
  static constexpr uint32_t kRowStats = kO + kStages * tile_bytes(kBwdQ, D);
  static constexpr uint32_t kBar = kRowStats + kStages * 2 * kBwdQ * 4;
  // Barriers: K/V landed, then full[kStages], empty[kStages].
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                           __grid_constant__ const CUtensorMap k_map,
                           __grid_constant__ const CUtensorMap v_map,
                           __grid_constant__ const CUtensorMap do_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int S, int Skv, int causal, float scale,
                           float scale_log2) {
  using L = DkvLayout<D>;
  constexpr int kTile = tile_bytes(kBwdQ, D);
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* smem = align_1024(wg_smem);
  float* stats = reinterpret_cast<float*>(smem + L::kRowStats);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBwdK;  // causal: the heaviest CTAs first
  // Causal: query rows below k0 see none of these keys.
  const int first = causal ? (k0 / kBwdQ) * kBwdQ : 0;
  const int n_q = first < S ? (S - first + kBwdQ - 1) / kBwdQ : 0;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);  // every producer lane: it writes the stats
      mbar_init(empty + s, kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (n_q > 0 && lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * tile_bytes(kBwdK, D));
      tma_load_tile<D>(smem + L::kK, &k_map, bar_kv, k0, bh, kBwdK);
      tma_load_tile<D>(smem + L::kV, &v_map, bar_kv, k0, bh, kBwdK);
    }
    for (int i = 0; i < n_q; ++i) {
      const int s = i % kStages;
      const int q0 = first + i * kBwdQ;
      mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
      float* st = stats + s * 2 * kBwdQ;
      for (int r = lane; r < kBwdQ; r += 32) {
        const bool live = q0 + r < S;
        const size_t idx = static_cast<size_t>(bh) * S + q0 + r;
        // A row past S gets lse = +inf: its probabilities are exactly 0.
        st[r] = live ? lse[idx] * kLog2e : INFINITY;
        st[kBwdQ + r] = live ? delta[idx] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + s, 2 * kTile);
        tma_load_tile<D>(smem + L::kQ + s * kTile, &q_map, full + s, q0, bh,
                         kBwdQ);
        tma_load_tile<D>(smem + L::kO + s * kTile, &do_map, full + s, q0, bh,
                         kBwdQ);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  const int w = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int key0 = k0 + kRows * w;          // the warpgroup's first key
  const int key = key0 + 16 * warp + g;     // this thread's keys: +0, +8
  const uint32_t k_base = smem_addr(smem + L::kK) + kRows * 128 * w;
  const uint32_t v_base = smem_addr(smem + L::kV) + kRows * 128 * w;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_k[i] = 0.f;
    acc_v[i] = 0.f;
  }

  if (n_q > 0) mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_q; ++i) {
    const int s = i % kStages;
    const int q0 = first + i * kBwdQ;
    mbar_wait(full + s, (i / kStages) & 1);
    if (causal && q0 + kBwdQ - 1 < key0) {  // every query precedes every key
      mbar_arrive(empty + s);
      continue;
    }
    const uint32_t q_base = smem_addr(smem + L::kQ + s * kTile);
    const uint32_t o_base = smem_addr(smem + L::kO + s * kTile);
    const float* lse2 = stats + s * 2 * kBwdQ;
    const float* dlt = lse2 + kBwdQ;

    float st[kBwdQ / 2], dpt[kBwdQ / 2];  // S^T and dP^T: keys x queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kBwdQ>(st, k_major(k_base, kBwdK, kk),
                      k_major(q_base, kBwdQ, kk), kk > 0);
      wgmma_ss<kBwdQ>(dpt, k_major(v_base, kBwdK, kk),
                      k_major(o_base, kBwdQ, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    // st becomes P^T = exp(S^T - lse), dpt dS^T = P^T (dP^T - delta); a
    // column is a query.  Only the diagonal tile is masked.
    const bool masked = causal && key0 + kRows - 1 > q0;
#pragma unroll
    for (int j = 0; j < kBwdQ / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 lj = *reinterpret_cast<const float2*>(lse2 + c);
      const float2 dj = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i_ = 4 * j + e;
        float p = exp2_ftz(fmaf(st[i_], scale_log2, -((e & 1) ? lj.y : lj.x)));
        if (masked && key + 8 * (e >> 1) > q0 + c + (e & 1)) p = 0.f;
        st[i_] = p;
        dpt[i_] = p * (dpt[i_] - ((e & 1) ? dj.y : dj.x));
      }
    }

    // dV += P^T dO (p rounded to dO's type), dK += dS^T Q (dS rounded to
    // Q's type), both roundings in the A operands.
    uint32_t pa[kBwdQ / 16][4], da[kBwdQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBwdQ / 16; ++kk) {
      acc_to_a(pa[kk], st, kk);
      acc_to_a(da[kk], dpt, kk);
    }
    fence_operands(acc_v);
    fence_operands(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdQ / 16; ++kk) {
      wgmma_rs_mn<D>(acc_v, pa[kk], mn_major(o_base, kBwdQ, kk), 1);
      wgmma_rs_mn<D>(acc_k, da[kk], mn_major(q_base, kBwdQ, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_v);
    fence_operands(acc_k);
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = key + 8 * h;
    if (kr >= Skv) continue;
    bf16* krow = dk + (static_cast<size_t>(bh) * Skv + kr) * D;
    bf16* vrow = dv + (static_cast<size_t>(bh) * Skv + kr) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j + 2 * t4) =
          pack(acc_k[4 * j + 2 * h] * scale, acc_k[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j + 2 * t4) =
          pack(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------------- dQ --
// dK/dV's design with queries and keys swapped.  CTA: kDqQ query rows of
// one (b, h); the producer loads the Q and dO blocks once and streams the
// K/V tiles of kDqK keys, up to the causal diagonal, through the ring.
// Each query row's lse (times log2 e) and delta are fixed for the CTA, so
// a thread keeps its two rows' values in registers.  Per tile a consumer
// warpgroup forms S = Q K^T and dP = dO V^T (64 queries x 64 keys, SS
// wgmma), then P and dS = P (dP - delta) on the fragments, then dQ += dS K
// (RS wgmma, dS rounded to K's type in the A operand, K MN-major).  dQ is
// scaled once at the end.
template <int D>
struct DqLayout {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kO = kQ + tile_bytes(kDqQ, D);  // dO
  static constexpr uint32_t kK = kO + tile_bytes(kDqQ, D);
  static constexpr uint32_t kV = kK + kStages * tile_bytes(kDqK, D);
  static constexpr uint32_t kBar = kV + kStages * tile_bytes(kDqK, D);
  // Barriers: Q and dO landed, then full[kStages], empty[kStages].
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                          __grid_constant__ const CUtensorMap k_map,
                          __grid_constant__ const CUtensorMap v_map,
                          __grid_constant__ const CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int S, int Skv, int causal,
                          float scale, float scale_log2) {
  using L = DqLayout<D>;
  constexpr int kTile = tile_bytes(kDqK, D);
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* smem = align_1024(wg_smem);
  uint64_t* bar_qo = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_qo + 1;
  uint64_t* empty = full + kStages;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqQ;  // longest first
  const int all_tiles = (Skv + kDqK - 1) / kDqK;
  const int n_tiles =
      causal ? min(all_tiles, (min(q0 + kDqQ, S) - 1) / kDqK + 1)
             : all_tiles;
  if (threadIdx.x == 0) {
    mbar_init(bar_qo, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warp
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(bar_qo, 2 * tile_bytes(kDqQ, D));
      tma_load_tile<D>(smem + L::kQ, &q_map, bar_qo, q0, bh, kDqQ);
      tma_load_tile<D>(smem + L::kO, &do_map, bar_qo, q0, bh, kDqQ);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, 2 * kTile);
        tma_load_tile<D>(smem + L::kK + s * kTile, &k_map, full + s,
                         t * kDqK, bh, kDqK);
        tma_load_tile<D>(smem + L::kV + s * kTile, &v_map, full + s,
                         t * kDqK, bh, kDqK);
      }
    }
    return;
  }

  const int w = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int wg_row0 = q0 + kRows * w;        // the warpgroup's first row
  const int row = wg_row0 + 16 * warp + g;   // this thread's rows: +0, +8
  const uint32_t q_base = smem_addr(smem + L::kQ) + kRows * 128 * w;
  const uint32_t o_base = smem_addr(smem + L::kO) + kRows * 128 * w;

  // A row past S gets lse = +inf: its probabilities are exactly 0.
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const size_t idx = static_cast<size_t>(bh) * S + r;
    lse2[h] = r < S ? lse[idx] * kLog2e : INFINITY;
    dlt[h] = r < S ? delta[idx] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_qo, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kDqK;
    mbar_wait(full + s, (t / kStages) & 1);
    if (causal && k0 > wg_row0 + kRows - 1) {  // every key is in the future
      mbar_arrive(empty + s);
      continue;
    }
    const uint32_t k_base = smem_addr(smem + L::kK + s * kTile);
    const uint32_t v_base = smem_addr(smem + L::kV + s * kTile);

    float sc[kDqK / 2], dp[kDqK / 2];  // S and dP: queries x keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kDqK>(sc, k_major(q_base, kDqQ, kk),
                     k_major(k_base, kDqK, kk), kk > 0);
      wgmma_ss<kDqK>(dp, k_major(o_base, kDqQ, kk),
                     k_major(v_base, kDqK, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // dp becomes dS = P (dP - delta), P = 2^(S scale log2 e - lse log2 e);
    // masked only where the tile crosses the key count or the diagonal.
    const bool masked =
        k0 + kDqK > Skv || (causal && k0 + kDqK - 1 > wg_row0);
#pragma unroll
    for (int i = 0; i < kDqK / 2; ++i) {
      const int h = (i / 2) & 1;
      float p = exp2_ftz(fmaf(sc[i], scale_log2, -lse2[h]));
      if (masked) {
        const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        if (col >= Skv || (causal && col > row + 8 * h)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dlt[h]);
    }

    // dQ += dS K, dS rounded to K's type in the A operand.
    uint32_t da[kDqK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDqK / 16; ++kk) acc_to_a(da[kk], dp, kk);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqK / 16; ++kk) {
      wgmma_rs_mn<D>(acc, da[kk], mn_major(k_base, kDqK, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= S) continue;
    bf16* qrow = dq + (static_cast<size_t>(bh) * S + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(qrow + 8 * j + 2 * t4) =
          pack(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

// Calls f(D) with D as a compile-time constant when these kernels take
// this head dim; returns false (f not called) otherwise.
template <typename F>
bool with_head_dim(int D, F f) {
  using std::integral_constant;
  switch (D) {
    case 64: f(integral_constant<int, 64>{}); return true;
    case 128: f(integral_constant<int, 128>{}); return true;
    default: return false;
  }
}

}  // namespace wg

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

// Returned when cuTensorMapEncodeTiled refuses a TMA tensor map (not a
// cudaError_t value the runtime uses).
constexpr cudaError_t kTensorMapError = static_cast<cudaError_t>(9001);

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Which build takes a call: the three kernels run their wgmma builds for
// bf16 at D in {64, 128}; everything else runs the CUDA-core kernels.  A
// refused tensor map or launch is returned, never retried on another
// build.
template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v,
                         void* o, float* lse, int BH, int S, int Skv, int D,
                         int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = cudaSuccess;
    if (wg::with_head_dim(D, [&](auto d) {
          constexpr int kD = decltype(d)::value;
          CUtensorMap q_map, k_map, v_map;
          if (!hopper::encode_bf16_rows(&q_map, q, BH, S, kD, wg::kFwdQ) ||
              !hopper::encode_bf16_rows(&k_map, k, BH, Skv, kD, wg::kFwdK) ||
              !hopper::encode_bf16_rows(&v_map, v, BH, Skv, kD, wg::kFwdK)) {
            err = kTensorMapError;
            return;
          }
          auto kernel = wg::flash_fwd_wgmma_kernel<kD>;
          const size_t smem = wg::FwdLayout<kD>::kBytes + 1024;
          err = allow_smem(kernel, smem);
          if (err != cudaSuccess) return;
          const dim3 grid((S + wg::kFwdQ - 1) / wg::kFwdQ, BH);
          kernel<<<grid, wg::kThreads, smem, stream>>>(
              q_map, k_map, v_map, static_cast<T*>(o), lse, S, Skv, causal,
              scale * wg::kLog2e);
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
    if (wg::with_head_dim(D, [&](auto d) {
          constexpr int kD = decltype(d)::value;
          CUtensorMap q_map, k_map, v_map, do_map;
          if (!hopper::encode_bf16_rows(&q_map, q, BH, S, kD, wg::kBwdQ) ||
              !hopper::encode_bf16_rows(&k_map, k, BH, Skv, kD, wg::kBwdK) ||
              !hopper::encode_bf16_rows(&v_map, v, BH, Skv, kD, wg::kBwdK) ||
              !hopper::encode_bf16_rows(&do_map, dout, BH, S, kD,
                                        wg::kBwdQ)) {
            err = kTensorMapError;
            return;
          }
          auto kernel = wg::flash_bwd_dkv_wgmma_kernel<kD>;
          const size_t smem = wg::DkvLayout<kD>::kBytes + 1024;
          err = allow_smem(kernel, smem);
          if (err != cudaSuccess) return;
          const dim3 grid((Skv + wg::kBwdK - 1) / wg::kBwdK, BH);
          kernel<<<grid, wg::kThreads, smem, stream>>>(
              q_map, k_map, v_map, do_map, lse, delta, static_cast<T*>(dk),
              static_cast<T*>(dv), S, Skv, causal, scale,
              scale * wg::kLog2e);
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
    if (wg::with_head_dim(D, [&](auto d) {
          constexpr int kD = decltype(d)::value;
          CUtensorMap q_map, k_map, v_map, do_map;
          if (!hopper::encode_bf16_rows(&q_map, q, BH, S, kD, wg::kDqQ) ||
              !hopper::encode_bf16_rows(&k_map, k, BH, Skv, kD, wg::kDqK) ||
              !hopper::encode_bf16_rows(&v_map, v, BH, Skv, kD, wg::kDqK) ||
              !hopper::encode_bf16_rows(&do_map, dout, BH, S, kD,
                                        wg::kDqQ)) {
            err = kTensorMapError;
            return;
          }
          auto kernel = wg::flash_bwd_dq_wgmma_kernel<kD>;
          const size_t smem = wg::DqLayout<kD>::kBytes + 1024;
          err = allow_smem(kernel, smem);
          if (err != cudaSuccess) return;
          const dim3 grid((S + wg::kDqQ - 1) / wg::kDqQ, BH);
          kernel<<<grid, wg::kThreads, smem, stream>>>(
              q_map, k_map, v_map, do_map, lse, delta, static_cast<T*>(dq),
              S, Skv, causal, scale, scale * wg::kLog2e);
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q/o [BH, S, D], k/v [BH, Skv, D],
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
  if (dtype == 2) {
    return fwd_dispatch<__half>(q, k, v, o, l, BH, S, Skv, D, causal, scale,
                                s);
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
  if (dtype == 2) {
    return dkv_dispatch<__half>(q, k, v, dout, l, dl, dk, dv, BH, S, Skv, D,
                                causal, scale, s);
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
  if (dtype == 2) {
    return dq_dispatch<__half>(q, k, v, dout, l, dl, dq, BH, S, Skv, D,
                               causal, scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* epl_cuda_error_string(int err) {
  if (err == kTensorMapError) {
    return "cuTensorMapEncodeTiled refused a TMA tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
