// Paged attention for Hopper (sm_90a), fp32, bf16 and fp16: two builds.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (easyparallellibrary_tpu/kernels/paged_attention.py, launched by
// `paged_attention_pallas`).  Same function: each (token, head) query
// attends its causal prefix, rows j <= min(positions[t], MB * bs - 1),
// each row read through the token's block table (pool row =
// table[t][j / bs] * bs + j % bs; an entry outside [0, NB) reads the
// null block 0), scores times scale = 1/sqrt(hd) as an fp32 constant,
// an fp32 online softmax, the probabilities rounded to V's dtype before
// the V product, as the Pallas kernel does, and output = acc / max(l,
// 1e-30).
//
// Which build runs: bf16 at hd in {64, 128} takes the slot-tiled build
// (namespace tiled, below); fp32, fp16, and bf16 at other head dims,
// take the warp build that follows here.  The warp build converts fp16
// K/V and q to fp32 as it loads them, keeps scores, the running max and
// the accumulator in fp32, and rounds p to fp16 before the V product.
//
// What bounds it on this card: bytes.  A token reads (pos + 1) * H * hd
// * 2 * itemsize bytes of K/V and does about 4 operations per element
// read, far below the H100's ~20 (fp32) or ~295 (bf16 tensor-core)
// operations per byte of device memory.
//
// Warp build.  It spends its effort on the loads of one token:
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
// But the tokens of one slot's prefill chunk share one block table and
// consecutive positions, so a warp per token reads the slot's context
// once per token: up to 128 times what the chunk needs.
//
// Slot-tiled build (bf16, hd in {64, 128}).  A query tile is a run of
// flat tokens of one slot with consecutive positions, at most 64 rows: a
// prefill chunk cut into tiles, or one decode token.  The host plans the
// tiles once per engine step (kernels/paged_attention.py) and cuts each
// tile's context into splits of 256 keys (tiles of up to 16 rows) or 128
// keys (longer tiles); a work item is one split of one tile.  Padding
// tokens (slot 0, position 0) share a table row and are tiled too.
//   * Grid (work item, head), 4 warps a CTA; warp w owns tile rows
//     16 w .. 16 w + 15, so no reduction crosses warps.
//   * Loads: the tile's K/V rows of this head come 64 keys a stage, one
//     16-byte cp.async per chunk (each row through the block table kept in
//     shared memory), into two stages of padded shared memory: the next
//     stage's copies are in flight while the current stage's products run.
//     Each K/V row of the split is read once for all rows of the tile.
//   * Products on the tensor cores: mma.sync m16n8k16, bf16 operands,
//     fp32 accumulation.  S = Q K^T from fragments (K's rows are the
//     columns of the B operand), P V with P repacked from the score
//     fragments to bf16 in registers (where the Pallas kernel rounds p)
//     and V through ldmatrix.trans.  mma.sync, not wgmma: a tile has 1 to
//     64 rows and a warp owns 16 of them, so a decode tile uses one row of
//     one warp's MMA and no warpgroup waits on rows it does not have; the
//     kernel is bytes-bound, and 16-row MMAs waste no loads, only tensor
//     cycles that are idle anyway.  (Letting the four warps of a decode
//     tile split each stage's keys and merge at the end measured slower
//     on an H100: the merge costs more than the products it spreads.)
//   * Split contexts (flash-decoding): one engine step holds about 4
//     prefill tiles and 8 decode tokens per head, fewer CTAs than SMs, so
//     a long context runs over several CTAs.  Each writes its (m, l, acc)
//     to scratch; the last CTA of a (tile, head) to finish, found with an
//     atomic counter, combines them in the same launch and sets the
//     counter back to 0 for the next layer's launch.
//
// Interface: plain C, pointers and sizes, launched on the caller's
// stream; each entry returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
template <>
struct Vec<__half> {
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

__device__ __forceinline__ void load16(const __half* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
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

__device__ __forceinline__ void store16(__half* p, const float* in) {
  uint4 v;
  __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// p rounded to the value type (the Pallas kernel's p.astype(v.dtype)).
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_to(float p, const __half*) {
  return __half2float(__float2half_rn(p));
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

// ------------------------------------------- slot-tiled build (bf16) --
namespace tiled {

using bf16 = __nv_bfloat16;
using hopper::smem_addr;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of a query tile, at most
constexpr int kKeys = 64;           // keys of a shared-memory stage
constexpr int kPad = 8;             // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// One work item: a split of one query tile (the planner's int32 x 8).
struct Item {
  int t0;       // the tile's first flat token
  int rows;     // its tokens, 1 .. kRows
  int k_begin;  // the split's first key (a multiple of kKeys)
  int k_end;    // its end key; -1: the tile's context end
  int split;    // its index among the tile's splits; the tile's first
                // item is this item's index minus `split`
  int splits;   // the tile's number of splits
  int prow;     // first scratch row of the tile's partials (splits > 1)
  int unused;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  // src-size 0 writes 16 zero bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one special-function instruction; exp2(-inf) = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// mma.sync m16n8k16 fragments, lane = 4 g + t.  A (16 x 16, row-major)
// at x[r0.., k0..]: rows g, g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* x, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = x + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B (16 x 8) whose column n is row n0 + n of the row-major tile x (a
// product against x^T).
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* x, int ld,
                                       int n0, int k0, int g, int t) {
  const bf16* p = x + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B (16 x 8) straight from the row-major tile x: rows k0 .. k0 + 15 are
// the reduction, columns n0 .. n0 + 7 the output.
__device__ __forceinline__ void load_b_trans(uint32_t* b, const bf16* x,
                                             int ld, int k0, int n0,
                                             int lane) {
  const uint32_t addr = smem_addr(x + (k0 + (lane & 15)) * ld + n0);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

template <int HD>
struct Layout {
  static constexpr int kLd = HD + kPad;  // bf16 per shared-memory row
  static constexpr int kTileBytes = kKeys * kLd * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kLd * 2;
  static constexpr int kV = kK + 2 * kTileBytes;
  static constexpr int kPos = kV + 2 * kTileBytes;  // kRows ints
  static constexpr int kTable = kPos + kRows * 4;   // MB ints
  static int bytes(int MB) { return kTable + 4 * MB; }
};

// hd = 64 fits four CTAs an SM (at most 128 registers a thread), so a
// step's CTAs, most of them decode splits, run in one wave.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 4 : 2)
paged_attention_tiled_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k_pages,
                             const bf16* __restrict__ v_pages,
                             const int* __restrict__ tables,
                             const int* __restrict__ positions,
                             const Item* __restrict__ items,
                             float* __restrict__ partial, int partial_rows,
                             int* __restrict__ counters,
                             bf16* __restrict__ out, int T, int H, int NB,
                             int bs, int MB, float scale_log2) {
  using L = Layout<HD>;
  constexpr int ld = L::kLd;
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  int* s_pos = reinterpret_cast<int*>(smem + L::kPos);
  int* s_table = reinterpret_cast<int*>(smem + L::kTable);
  __shared__ int s_last;

  const Item it = items[blockIdx.x];
  const int h = blockIdx.y;
  if (it.rows < 1 || it.rows > kRows || it.t0 < 0 || it.t0 + it.rows > T) {
    return;  // not an item of the planner's
  }
  const int tid = threadIdx.x;
  const int L_rows = MB * bs;
  const size_t row_stride = static_cast<size_t>(H) * HD;

  // Q rows of this head (zeros past the tile, up to the last warp that
  // has rows), positions, block table.
  const int q_rows = (it.rows + 15) / 16 * 16;
  for (int idx = tid; idx < q_rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool live = r < it.rows;
    const bf16* src =
        live ? q + (it.t0 + r) * row_stride + static_cast<size_t>(h) * HD + c
             : q;
    cp_async16(sQ + r * ld + c, src, live);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    s_pos[r] = r < it.rows ? min(positions[it.t0 + r], L_rows - 1) : -1;
  }
  for (int i = tid; i < MB; i += kThreads) {
    const int blk = tables[static_cast<size_t>(it.t0) * MB + i];
    s_table[i] = (blk < 0 || blk >= NB) ? 0 : blk;
  }
  __syncthreads();
  int ctx = 0;  // the tile's context: keys 0 .. ctx - 1
  for (int r = 0; r < it.rows; ++r) ctx = max(ctx, s_pos[r] + 1);
  const int k_begin = it.k_begin;
  const int k_end = it.k_end < 0 ? ctx : min(it.k_end, ctx);
  const int n_stages = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                       : 0;

  // Keys [k0, k0 + kKeys) of this head into stage s; keys past the split
  // are zeros.
  auto load_stage = [&](int s, int k0) {
    bf16* dk = sK + s * kKeys * ld;
    bf16* dv = sV + s * kKeys * ld;
    for (int idx = tid; idx < kKeys * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx - r * kChunks) * 8;
      const int j = k0 + r;
      const bool live = j < k_end;
      const size_t off =
          live ? (static_cast<size_t>(s_table[j / bs]) * bs + j % bs) *
                         row_stride +
                     static_cast<size_t>(h) * HD + c
               : 0;
      cp_async16(dk + r * ld + c, k_pages + off, live);
      cp_async16(dv + r * ld + c, v_pages + off, live);
    }
  };

  const int lane = tid & 31;
  const int w = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * w;
  const bool active = r0 < it.rows;
  // This thread's rows r0 + g and r0 + g + 8: their last key; and the
  // last key of any of the warp's rows (a stage past it is skipped).
  const int my_pos[2] = {s_pos[r0 + g], s_pos[r0 + g + 8]};
  int warp_last = -1;
  for (int r = r0; r < min(r0 + 16, it.rows); ++r) {
    warp_last = max(warp_last, s_pos[r]);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max of score * scale_log2
  float l[2] = {0.f, 0.f};               // this thread's part of the sum
  uint32_t qa[HD / 16][4];

  if (n_stages > 0) load_stage(0, k_begin);
  cp_async_commit();  // group 0: Q and the first stage
  for (int st = 0; st < n_stages; ++st) {
    const int k0 = k_begin + st * kKeys;
    if (st + 1 < n_stages) load_stage((st + 1) & 1, k0 + kKeys);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the stage just started
    __syncthreads();
    if (active && st == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) load_a(qa[kk], sQ, ld, r0, 16 * kk,
                                                  g, t);
    }
    if (active && k0 <= warp_last) {
      const bf16* cK = sK + (st & 1) * kKeys * ld;
      const bf16* cV = sV + (st & 1) * kKeys * ld;
      float s[kKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          uint32_t b[2];
          load_b(b, cK, ld, 8 * n, 16 * kk, g, t);
          mma(s[n], qa[kk], b);
        }
      }
      // Mask (key past the split or past the row's position), then one
      // step of the online softmax in base 2.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          const int hh = e >> 1;
          const bool live = j < k_end && j <= my_pos[hh];
          s[n][e] = live ? s[n][e] * scale_log2 : -INFINITY;
          mx[hh] = fmaxf(mx[hh], s[n][e]);
        }
      }
      float m_use[2], corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
        corr[hh] = exp2_ftz(m[hh] - m_use[hh]);
        m[hh] = m_new;
      }
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_ftz(s[n][e] - m_use[e >> 1]);
          part[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + part[hh];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      }
      // O += P V, p rounded to bf16 in the A operand.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t b[2];
          load_b_trans(b, cV, ld, 16 * kk, 8 * n, lane);
          mma(acc[n], a, b);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);

  if (it.splits == 1) {
    if (!active) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      if (r >= it.rows) continue;
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
      bf16* orow = out + (it.t0 + r) * row_stride + static_cast<size_t>(h) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
            pack(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
      }
    }
    return;
  }

  // Split: this CTA's partials into scratch, (m, l) as [slot][H] and acc
  // as [slot][H][HD]; row r of split sp is slot prow + r * splits + sp.
  const size_t n_part = static_cast<size_t>(partial_rows) * H;
  float* p_acc = partial;
  float* p_m = partial + n_part * HD;
  float* p_l = p_m + n_part;
  const int first = blockIdx.x - it.split;
  if (active) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      if (r >= it.rows) continue;
      const size_t pr =
          static_cast<size_t>(it.prow + r * it.splits + it.split) * H + h;
      float* arow = p_acc + pr * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(arow + 8 * n + 2 * t) =
            make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
      }
      if (t == 0) {
        p_m[pr] = m[hh];
        p_l[pr] = l[hh];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + static_cast<size_t>(first) * H + h, 1);
    s_last = done == it.splits - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The last CTA of this (tile, head): combine every split's partials.
  constexpr int kQuads = HD / 4;
  for (int idx = tid; idx < it.rows * kQuads; idx += kThreads) {
    const int r = idx / kQuads;
    const int c = (idx - r * kQuads) * 4;
    const size_t base = static_cast<size_t>(it.prow + r * it.splits) * H + h;
    // One online pass over the splits; a split's loads do not depend on
    // the running sums, so unrolled iterations issue them together.
    float big = -INFINITY, lsum = 0.f;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int sp = 0; sp < it.splits; ++sp) {
      const size_t pr = base + static_cast<size_t>(sp) * H;
      const float ms = __ldcg(p_m + pr);
      const float ls = __ldcg(p_l + pr);
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(p_acc + pr * HD + c));
      const float big_new = fmaxf(big, ms);
      const float ref = big_new == -INFINITY ? 0.f : big_new;
      const float f_old = exp2_ftz(big - ref);
      const float f_new = exp2_ftz(ms - ref);
      lsum = lsum * f_old + ls * f_new;
      o[0] = o[0] * f_old + a.x * f_new;
      o[1] = o[1] * f_old + a.y * f_new;
      o[2] = o[2] * f_old + a.z * f_new;
      o[3] = o[3] * f_old + a.w * f_new;
      big = big_new;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    bf16* orow =
        out + (it.t0 + r) * row_stride + static_cast<size_t>(h) * HD + c;
    *reinterpret_cast<uint32_t*>(orow) = pack(o[0] * inv, o[1] * inv);
    *reinterpret_cast<uint32_t*>(orow + 2) = pack(o[2] * inv, o[3] * inv);
  }
  if (tid == 0) counters[static_cast<size_t>(first) * H + h] = 0;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* positions, const void* items,
                   int n_items, void* partial, int partial_rows,
                   int* counters, void* out, int T, int H, int NB, int bs,
                   int MB, float scale, cudaStream_t stream) {
  auto kernel = paged_attention_tiled_kernel<HD>;
  const int smem = Layout<HD>::bytes(MB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_items, H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), tables, positions,
      static_cast<const Item*>(items), static_cast<float*>(partial),
      partial_rows, counters, static_cast<bf16*>(out), T, H, NB, bs, MB,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tiled

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  All tensors contiguous;
// q, the pools and out 16-byte aligned; hd a multiple of 8, at most 256.
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
  if (dtype == 2) {
    return dispatch<__half>(q, k_pages, v_pages, tab, pos, out, num_tokens, H,
                            hd, NB, bs, MB, scale, s);
  }
  return cudaErrorInvalidValue;
}

// The slot-tiled build: bf16 only, hd in {64, 128}.  items int32
// [n_items, 8] (tiled::Item); partial fp32 scratch of partial_rows * H *
// (hd + 2) floats (may be null when no tile is split); counters int32
// [n_items * H], zero on entry and left zero on exit.
int epl_paged_attention_tiled(const void* q, const void* k_pages,
                              const void* v_pages, const void* tables_tok,
                              const void* positions, const void* items,
                              int n_items, void* partial, int partial_rows,
                              void* counters, void* out, int num_tokens,
                              int H, int hd, int NB, int bs, int MB,
                              float scale, void* stream) {
  if (n_items == 0 || H == 0) return cudaSuccess;
  if (n_items < 0 || num_tokens <= 0 || H < 0 || NB <= 0 || bs <= 0 ||
      MB <= 0 || partial_rows < 0) {
    return cudaErrorInvalidValue;
  }
  const int* tab = static_cast<const int*>(tables_tok);
  const int* pos = static_cast<const int*>(positions);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    return tiled::launch<64>(q, k_pages, v_pages, tab, pos, items, n_items,
                             partial, partial_rows, cnt, out, num_tokens, H,
                             NB, bs, MB, scale, s);
  }
  if (hd == 128) {
    return tiled::launch<128>(q, k_pages, v_pages, tab, pos, items, n_items,
                              partial, partial_rows, cnt, out, num_tokens, H,
                              NB, bs, MB, scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* epl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
