// Paged-attention decode for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (easyparallellibrary_tpu/kernels/paged_attention.py, launched by
// `paged_attention_pallas`).  Same function: each (token, head) query
// attends its causal prefix, rows j <= positions[t], each row read
// through the token's block table (pool row = table[t][j / bs] * bs +
// j % bs), with an fp32 online softmax; the probabilities are rounded to
// V's dtype before the V product, as the Pallas kernel does.
//
// What bounds it on this card: bytes.  A token reads (pos + 1) * H * hd
// * 2 * itemsize bytes of K/V and does about 4 operations per element
// read, far below the H100's ~20 (fp32) or ~295 (bf16 tensor-core)
// operations per byte of device memory.  The design therefore spends
// its effort on the loads:
//   * one warp per (token, head); the TPU grid's sequential block axis
//     becomes a loop inside the warp, over the live rows only
//     (j <= min(pos, MB * bs - 1)), so a token costs its own context
//     length, not the table width;
//   * each K/V row of hd values is read by hd / VEC lanes with 16-byte
//     loads (VEC = 8 bf16 or 4 fp32 values), so one warp step covers
//     32 * VEC / hd rows and neighbouring lanes read neighbouring
//     addresses; K and V of a step are loaded together, before the
//     softmax arithmetic that depends on them;
//   * the block id is loaded by the warp itself (there is no scalar
//     prefetch on this card); a table entry outside the pool reads the
//     null block 0, so a bad table can never read out of bounds.
// Tensor cores, TMA and a split of long contexts over several warps are
// not used yet; they are later work.
//
// Interface: plain C, pointers and sizes, launched on the caller's
// stream; returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// p rounded to the value type (the Pallas kernel's p.astype(v.dtype)).
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// One warp per (token, head).  The head dim is cut into nvec = hd / VEC
// 16-byte chunks; LPR = 1 << lpr_log2 lanes share one row (each owns CPL
// consecutive chunks, LPR * CPL = nvec), and the warp's 32 / LPR lane
// groups take 32 / LPR consecutive rows per step.
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions, T* __restrict__ out,
                       int num_tokens, int H, int hd, int NB, int bs, int MB,
                       int lpr_log2, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int D = CPL * VEC;  // head-dim values owned by one lane
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= num_tokens * H) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int t = warp / H;
  const int h = warp - t * H;
  const int lpr = 1 << lpr_log2;
  const int rows_per_step = 32 >> lpr_log2;
  const int sub = lane & (lpr - 1);  // which slice of the head dim
  const int rsub = lane >> lpr_log2;  // which row of the step
  const int d0 = sub * D;

  float qv[D];
  const T* qrow = q + (static_cast<size_t>(t) * H + h) * hd + d0;
#pragma unroll
  for (int c = 0; c < CPL; ++c) load16(qrow + c * VEC, qv + c * VEC);

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int last = min(positions[t], MB * bs - 1);
  const int* tab = tables + static_cast<size_t>(t) * MB;
  const size_t row_stride = static_cast<size_t>(H) * hd;
  const size_t head_off = static_cast<size_t>(h) * hd + d0;

  for (int j0 = 0; j0 <= last; j0 += rows_per_step) {
    const int j = j0 + rsub;
    const bool live = j <= last;
    float kv[D];
    float vv[D];
    if (live) {
      int blk = tab[j / bs];
      if (blk < 0 || blk >= NB) blk = 0;
      const size_t off =
          (static_cast<size_t>(blk) * bs + (j % bs)) * row_stride + head_off;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        load16(k_pages + off + c * VEC, kv + c * VEC);
        load16(v_pages + off + c * VEC, vv + c * VEC);
      }
    }
    float part = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < D; ++i) part = fmaf(qv[i], kv[i], part);
    }
    for (int o = lpr >> 1; o > 0; o >>= 1) {
      part += __shfl_xor_sync(kFullMask, part, o);
    }
    const float s = live ? part * scale : kNegInf;
    float step_max = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      step_max = fmaxf(step_max, __shfl_xor_sync(kFullMask, step_max, o));
    }
    // Row j0 is live, so m_new is finite from the first step on.
    const float m_new = fmaxf(m, step_max);
    const float corr = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    float psum = sub == 0 ? p : 0.f;  // one copy of each row's p
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      psum += __shfl_xor_sync(kFullMask, psum, o);
    }
    l = l * corr + psum;
    m = m_new;
    const float pr = round_to(p, q);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      acc[i] = live ? fmaf(pr, vv[i], acc[i] * corr) : acc[i] * corr;
    }
  }

  // Lanes with the same `sub` hold the same head-dim slice for different
  // rows: sum them.
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] += __shfl_xor_sync(kFullMask, acc[i], o);
  }
  if (rsub == 0) {
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] = acc[i] / l_safe;
    T* orow = out + (static_cast<size_t>(t) * H + h) * hd + d0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) store16(orow + c * VEC, acc + c * VEC);
  }
}

template <typename T, int CPL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* positions, void* out,
                   int num_tokens, int H, int hd, int NB, int bs, int MB,
                   int lpr_log2, float scale, cudaStream_t stream) {
  const long long warps = static_cast<long long>(num_tokens) * H;
  const unsigned blocks =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  paged_attention_kernel<T, CPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, positions, static_cast<T*>(out),
      num_tokens, H, hd, NB, bs, MB, lpr_log2, scale);
  return cudaGetLastError();
}

// nvec = LPR * CPL with LPR the largest power of two dividing nvec (at
// most 32): for hd a multiple of 8 up to 256, CPL is odd and at most 31,
// or 2 (fp32, hd = 256).
#define EPL_CPL_CASES(X) \
  X(1) X(2) X(3) X(5) X(7) X(9) X(11) X(13) X(15) X(17) X(19) X(21) X(23) \
  X(25) X(27) X(29) X(31)

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* tables, const int* positions, void* out,
                     int num_tokens, int H, int hd, int NB, int bs, int MB,
                     float scale, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (hd <= 0 || hd % VEC != 0) return cudaErrorInvalidValue;
  const int nvec = hd / VEC;
  int lpr_log2 = 0;
  while (lpr_log2 < 5 && nvec % (2 << lpr_log2) == 0) ++lpr_log2;
  const int cpl = nvec >> lpr_log2;
  switch (cpl) {
#define EPL_CASE(C)                                                         \
  case C:                                                                   \
    return launch<T, C>(q, k, v, tables, positions, out, num_tokens, H, hd, \
                        NB, bs, MB, lpr_log2, scale, stream);
    EPL_CPL_CASES(EPL_CASE)
#undef EPL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous; q, the
// pools and out 16-byte aligned; hd a multiple of 8, at most 256.
int epl_paged_attention(const void* q, const void* k_pages,
                        const void* v_pages, const void* tables_tok,
                        const void* positions, void* out, int num_tokens,
                        int H, int hd, int NB, int bs, int MB, int dtype,
                        float scale, void* stream) {
  if (num_tokens == 0 || H == 0) return cudaSuccess;
  if (num_tokens < 0 || H < 0 || NB <= 0 || bs <= 0 || MB <= 0 ||
      hd > 256) {
    return cudaErrorInvalidValue;
  }
  const int* tab = static_cast<const int*>(tables_tok);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k_pages, v_pages, tab, pos, out, num_tokens, H,
                           hd, NB, bs, MB, scale, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, tab, pos, out,
                                   num_tokens, H, hd, NB, bs, MB, scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* epl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
