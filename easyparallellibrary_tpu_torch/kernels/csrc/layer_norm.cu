// LayerNorm for Hopper (sm_90a), K3: one forward kernel and one backward
// kernel (with a small second kernel that sums the backward's dgamma and
// dbeta partials), in fp32, bf16 and fp16, input and output types chosen
// apart.
//
// Replaces no TPU kernel.  The JAX package leaves flax's LayerNorm to
// XLA, which fuses it into a loop or two; eager PyTorch ran the same
// formula as 14 launches forward and 29 in its autograd backward, each
// reading and writing full-size fp32 tensors.  This source computes
// flax's LayerNorm as the port's plain version does
// (kernels/layer_norm.py, `layer_norm_reference`):
//   mean = E[x], var = max(E[x^2] - mean^2, 0), both in fp32,
//   y = (x - mean) * (rsqrt(var + eps) * gamma) + beta in fp32,
// rounded once to the output type; gamma and beta are fp32.  The
// backward gives the gradient of that formula.  With g = dy * gamma,
// xm = x - mean, r = rsqrt(var + eps) and d the row width:
//   dx = r * (g - sum(g) / d - [E[x^2] - mean^2 >= 0] * xm * r^2 *
//             sum(g * xm) / d),
//   dgamma = sum over rows of dy * xm * r, dbeta = sum over rows of dy.
// The bracket is clamp's mask (`>= 0`, as PyTorch's clamp backward): the
// clipped variance passes nothing back.
//
// What bounds it on this card: bytes.  A row does about 10 operations per
// element, far below the ~20 fp32 operations per byte at which the
// H100's CUDA cores would become the limit.  So the design keeps every
// byte it can out of device memory:
//   * A row is read once.  It is held in registers by one warp (rows of
//     up to 1024 elements: 32 lanes x 4 chunks of 8) or by a team of 2 to
//     8 warps of one CTA for wider rows (up to 8192 elements).  A lane
//     loads a chunk of 8 elements as one 16-byte load (two for fp32)
//     where the width is a multiple of 8 and every pointer is 16-byte
//     aligned, and element by element up to the row's end otherwise.
//   * Statistics are reduced with warp shuffles (and, across a team's
//     warps, through shared memory); the forward stores y and nothing
//     else.  The backward recomputes mean and rstd from x, which it reads
//     anyway: 2 bytes an element of a bf16 x instead of saved fp32
//     statistics the forward would have to write.
//   * The backward is persistent: a few CTAs an SM (as many as fit)
//     walk the rows, each lane keeping the dgamma and dbeta sums of the
//     columns it owns in fp32 registers (a lane owns the same columns in
//     every row).  Each CTA writes one row of a [grid, d] fp32 slab for
//     each, and a second kernel sums the slab's columns in a fixed order:
//     the result is the same on every run, with no atomics.
//
// Interface: plain C, pointers and sizes, launched on the caller's
// stream; each entry returns the cudaError_t of its launches.  Type
// codes: 0 = float32, 1 = bfloat16, 2 = float16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 8;           // elements a lane loads at once
constexpr int kChunksPerLane = 4;   // chunks of a row a lane holds
constexpr int kMinWarps = 4;        // warps a CTA, at the least
constexpr int kMaxWarpsPerRow = 8;
constexpr int kMaxThreads = 32 * kMaxWarpsPerRow;
constexpr int kMaxWidth = 32 * kMaxWarpsPerRow * kChunksPerLane * kChunk;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Elem<__half> {
  static __device__ __forceinline__ float get(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half put(float v) {
    return __float2half_rn(v);
  }
};

// Elements e0 .. e0 + 7 of a row, as fp32: 16-byte loads when `vec` (the
// width a multiple of 8, the pointer 16-byte aligned), else one element
// at a time, 0 past the row's end (width d).
template <typename T>
__device__ __forceinline__ void load8(const T* p, int e0, int d, bool vec,
                                      float (&v)[kChunk]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = reinterpret_cast<const float4*>(p + e0)[0];
      const float4 b = reinterpret_cast<const float4*>(p + e0)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + e0);
      const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = Elem<T>::get(h[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      v[i] = e0 + i < d ? Elem<T>::get(p[e0 + i]) : 0.f;
    }
  }
}

// Stores v, rounded to T, at elements e0 .. e0 + 7 (those below d).
template <typename T>
__device__ __forceinline__ void store8(T* p, int e0, int d, bool vec,
                                       const float (&v)[kChunk]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(p + e0)[0] =
          make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p + e0)[1] =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 raw;
      T* h = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) h[i] = Elem<T>::put(v[i]);
      *reinterpret_cast<uint4*>(p + e0) = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (e0 + i < d) p[e0 + i] = Elem<T>::put(v[i]);
    }
  }
}

// Eight elements of a row as loaded, kept packed in registers: two
// float4 of fp32, one uint4 of 16-bit values (half the registers of
// their fp32 values, which the kernels convert at each use).
template <typename T, bool kWide = sizeof(T) == 4>
struct Raw8;
template <typename T>
struct Raw8<T, true> {
  float v[kChunk];
  __device__ __forceinline__ float get(int i) const { return v[i]; }
  __device__ __forceinline__ void load(const T* p, int e0, int d, bool vec) {
    load8(p, e0, d, vec, v);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) v[i] = 0.f;
  }
};
template <typename T>
struct Raw8<T, false> {
  uint4 u;
  __device__ __forceinline__ float get(int i) const {
    return Elem<T>::get(reinterpret_cast<const T*>(&u)[i]);
  }
  __device__ __forceinline__ void load(const T* p, int e0, int d, bool vec) {
    if (vec) {
      u = *reinterpret_cast<const uint4*>(p + e0);
    } else {
      T* h = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        h[i] = e0 + i < d ? p[e0 + i] : Elem<T>::put(0.f);
      }
    }
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
};

// Where this thread sits: its row's team of `wpr` warps (a CTA holds
// `teams` of them), its lane within the team, and the chunks it owns:
// chunk c = tlane + k * lanes, k < kChunksPerLane, below nchunks.
struct Team {
  int wpr, teams, team, tlane, lanes, nchunks;
  __device__ Team(int d, int wpr_) : wpr(wpr_) {
    const int warp = threadIdx.x >> 5;
    teams = (blockDim.x >> 5) / wpr;
    team = warp / wpr;
    tlane = (warp % wpr) * 32 + (threadIdx.x & 31);
    lanes = 32 * wpr;
    nchunks = (d + kChunk - 1) / kChunk;
  }
  __device__ int chunk(int k) const { return tlane + k * lanes; }
};

// The sums of a and b over the team, the same bits in every lane.  Every
// thread of the CTA calls it (its barriers are the CTA's).
__device__ __forceinline__ float2 team_sum(float a, float b, const Team& t,
                                           float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFullMask, a, o);
    b += __shfl_xor_sync(kFullMask, b, o);
  }
  if (t.wpr == 1) return make_float2(a, b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const int first = warp - warp % t.wpr;
  float2 s = red[first];
  for (int w = 1; w < t.wpr; ++w) {
    s.x += red[first + w].x;
    s.y += red[first + w].y;
  }
  __syncthreads();
  return s;
}

// mean, the unclipped variance E[x^2] - mean^2 and rstd of a row from its
// sums, each operation rounded as the plain version's separate ops are.
struct Stats {
  float mean, raw_var, rstd;
  __device__ Stats(float2 sums, int d, float eps) {
    mean = __fdiv_rn(sums.x, static_cast<float>(d));
    raw_var = __fsub_rn(__fdiv_rn(sums.y, static_cast<float>(d)),
                        __fmul_rn(mean, mean));
    rstd = rsqrtf(__fadd_rn(fmaxf(raw_var, 0.f), eps));
  }
};

template <typename TI, typename TO>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_fwd_kernel(const TI* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, TO* __restrict__ y,
                          int64_t rows, int d, int wpr, float eps, bool vec) {
  __shared__ float2 red[kMaxWarpsPerRow];
  const Team t(d, wpr);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * t.teams + t.team;
  const bool live = row < rows;
  Raw8<TI> xr[kChunksPerLane];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kChunksPerLane; ++k) {
    const int c = t.chunk(k);
    if (live && c < t.nchunks) {
      xr[k].load(x + row * d, c * kChunk, d, vec);
    } else {
      xr[k].zero();
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float v = xr[k].get(i);
      s += v;
      s2 += v * v;
    }
  }
  const Stats st(team_sum(s, s2, t, red), d, eps);
  if (!live) return;
  TO* yr = y + row * d;
#pragma unroll
  for (int k = 0; k < kChunksPerLane; ++k) {
    const int c = t.chunk(k);
    if (c >= t.nchunks) continue;
    float g[kChunk], b[kChunk], out[kChunk];
    load8(gamma, c * kChunk, d, vec, g);
    load8(beta, c * kChunk, d, vec, b);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      out[i] = __fadd_rn(__fmul_rn(__fsub_rn(xr[k].get(i), st.mean),
                                   __fmul_rn(st.rstd, g[i])),
                         b[i]);
    }
    store8(yr, c * kChunk, d, vec, out);
  }
}

// dx for the rows of this CTA's walk, and this CTA's row of the dgamma
// slab part[0 : G] and of the dbeta slab part[G : 2G] (G = gridDim.x).
// x and dy stay packed in registers; g = dy * gamma and x - mean are
// recomputed where the last pass needs them (gamma from L1), which keeps
// the registers to x, dy and the dgamma and dbeta sums, and the CTAs an
// SM to as many as those allow.  Dynamic shared memory: teams * 2 * d
// floats where a CTA holds more than one team (their sums are combined
// there in team order), else none.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_bwd_kernel(const TI* __restrict__ x,
                          const TO* __restrict__ dy,
                          const float* __restrict__ gamma,
                          TI* __restrict__ dx, float* __restrict__ part,
                          int64_t rows, int d, int wpr, float eps, bool vec) {
  extern __shared__ float comb[];
  __shared__ float2 red[kMaxWarpsPerRow];
  const Team t(d, wpr);
  float dg[kChunksPerLane][kChunk], db[kChunksPerLane][kChunk];
#pragma unroll
  for (int k = 0; k < kChunksPerLane; ++k) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) dg[k][i] = db[k][i] = 0.f;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * t.teams;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * t.teams;
       base < rows; base += stride) {
    const int64_t row = base + t.team;
    const bool live = row < rows;
    Raw8<TI> xr[kChunksPerLane];
    Raw8<TO> dr[kChunksPerLane];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kChunksPerLane; ++k) {
      const int c = t.chunk(k);
      if (live && c < t.nchunks) {
        xr[k].load(x + row * d, c * kChunk, d, vec);
        dr[k].load(dy + row * d, c * kChunk, d, vec);
      } else {
        xr[k].zero();
        dr[k].zero();
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float v = xr[k].get(i);
        s += v;
        s2 += v * v;
      }
    }
    const Stats st(team_sum(s, s2, t, red), d, eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < kChunksPerLane; ++k) {
      const int c = t.chunk(k);
      if (!live || c >= t.nchunks) continue;
      float gm[kChunk];
      load8(gamma, c * kChunk, d, vec, gm);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float xm = xr[k].get(i) - st.mean;
        const float dyv = dr[k].get(i);
        const float g = dyv * gm[i];
        dg[k][i] += dyv * xm * st.rstd;
        db[k][i] += dyv;
        sg += g;
        sgx += g * xm;
      }
    }
    const float2 gs = team_sum(sg, sgx, t, red);
    if (!live) continue;
    const float c1 = gs.x / d;
    const float c2 =
        st.raw_var >= 0.f ? st.rstd * st.rstd * gs.y / d : 0.f;
#pragma unroll
    for (int k = 0; k < kChunksPerLane; ++k) {
      const int c = t.chunk(k);
      if (c >= t.nchunks) continue;
      float gm[kChunk], out[kChunk];
      load8(gamma, c * kChunk, d, vec, gm);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float xm = xr[k].get(i) - st.mean;
        const float g = dr[k].get(i) * gm[i];
        out[i] = st.rstd * (g - c1 - xm * c2);
      }
      store8(dx + row * d, c * kChunk, d, vec, out);
    }
  }
  float* pg = part + static_cast<int64_t>(blockIdx.x) * d;
  float* pb = part + (static_cast<int64_t>(gridDim.x) + blockIdx.x) * d;
  float* own_g = pg;
  float* own_b = pb;
  if (t.teams > 1) {
    own_g = comb + 2 * t.team * d;
    own_b = own_g + d;
  }
#pragma unroll
  for (int k = 0; k < kChunksPerLane; ++k) {
    const int c = t.chunk(k);
    if (c >= t.nchunks) continue;
    store8(own_g, c * kChunk, d, vec, dg[k]);
    store8(own_b, c * kChunk, d, vec, db[k]);
  }
  if (t.teams == 1) return;
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int m = 0; m < t.teams; ++m) {
      a += comb[2 * m * d + col];
      b += comb[(2 * m + 1) * d + col];
    }
    pg[col] = a;
    pb[col] = b;
  }
}

// out[col] = sum over the G rows of part's slab blockIdx.y (0: dgamma
// into dgamma, 1: dbeta into dbeta), in a fixed order: warp w of a CTA
// sums rows w, w + 8, ... of 32 columns, and warp 0 adds the 8 warps'
// sums in warp order.
constexpr int kSumWarps = 8;

__global__ void __launch_bounds__(32 * kSumWarps)
    layer_norm_colsum_kernel(const float* __restrict__ part,
                             float* __restrict__ dgamma,
                             float* __restrict__ dbeta, int G, int d) {
  __shared__ float sums[kSumWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  const float* slab = part + static_cast<int64_t>(blockIdx.y) * G * d;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int g = warp; g < G; g += kSumWarps) {
      s += slab[static_cast<int64_t>(g) * d + col];
    }
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= d) return;
  float total = sums[0][lane];
  for (int w = 1; w < kSumWarps; ++w) total += sums[w][lane];
  (blockIdx.y == 0 ? dgamma : dbeta)[col] = total;
}

// ---------------------------------------------------------- launchers --

// Warps a row takes at width d: the fewest (a power of two) whose lanes
// hold its chunks; 0 past kMaxWidth.
int warps_per_row(int d) {
  const int nchunks = (d + kChunk - 1) / kChunk;
  int wpr = 1;
  while (wpr * 32 * kChunksPerLane < nchunks) wpr *= 2;
  return wpr <= kMaxWarpsPerRow ? wpr : 0;
}

int threads_of(int wpr) { return 32 * (wpr > kMinWarps ? wpr : kMinWarps); }

int teams_of(int wpr) { return threads_of(wpr) / 32 / wpr; }

size_t bwd_smem(int wpr, int d) {
  const int teams = teams_of(wpr);
  return teams > 1 ? sizeof(float) * 2 * teams * d : 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_sizes(int64_t rows, int d) {
  return rows < 0 || d <= 0 || d > kMaxWidth;
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<TI>, Tag<TO>) for the type codes; cudaErrorInvalidValue for
// a code there is not.
template <typename F>
cudaError_t with_types(int in_code, int out_code, F f) {
  auto outer = [&](auto in_tag) -> cudaError_t {
    switch (out_code) {
      case 0: return f(in_tag, Tag<float>{});
      case 1: return f(in_tag, Tag<__nv_bfloat16>{});
      case 2: return f(in_tag, Tag<__half>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (in_code) {
    case 0: return outer(Tag<float>{});
    case 1: return outer(Tag<__nv_bfloat16>{});
    case 2: return outer(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y [rows, d] in type out_dtype from x [rows, d] in type in_dtype and
// fp32 gamma, beta [d].  All contiguous.
int epl_layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                       void* y, int64_t rows, int d, int in_dtype,
                       int out_dtype, float eps, void* stream) {
  if (bad_sizes(rows, d)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int wpr = warps_per_row(d);
  const int64_t blocks = (rows + teams_of(wpr) - 1) / teams_of(wpr);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const bool vec = d % kChunk == 0 && aligned16(x) && aligned16(gamma) &&
                   aligned16(beta) && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(in_dtype, out_dtype, [&](auto ti, auto to) {
    using TI = typename decltype(ti)::type;
    using TO = typename decltype(to)::type;
    layer_norm_fwd_kernel<TI, TO>
        <<<static_cast<unsigned>(blocks), threads_of(wpr), 0, s>>>(
            static_cast<const TI*>(x), static_cast<const float*>(gamma),
            static_cast<const float*>(beta), static_cast<TO*>(y), rows, d,
            wpr, eps, vec);
    return cudaGetLastError();
  });
}

// The backward's grid at these sizes: as many CTAs as fit on the card at
// once, at most one a team of rows.  0 for no rows; negative: a
// cudaError_t, negated.  The caller sizes the [2, grid, d] fp32 slab that
// epl_layer_norm_bwd takes from it.
int epl_layer_norm_bwd_blocks(int64_t rows, int d, int in_dtype,
                              int out_dtype) {
  if (bad_sizes(rows, d)) return -cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int wpr = warps_per_row(d);
  int per_sm = 0, sms = 0, device = 0;
  cudaError_t err = with_types(in_dtype, out_dtype, [&](auto ti, auto to) {
    using TI = typename decltype(ti)::type;
    using TO = typename decltype(to)::type;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_norm_bwd_kernel<TI, TO>, threads_of(wpr),
        bwd_smem(wpr, d));
  });
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -cudaErrorInvalidConfiguration;
  const int64_t teams = (rows + teams_of(wpr) - 1) / teams_of(wpr);
  const int64_t full = static_cast<int64_t>(per_sm) * sms;
  return static_cast<int>(teams < full ? teams : full);
}

// dx [rows, d] in in_dtype, and fp32 dgamma, dbeta [d], from x [rows, d]
// in in_dtype, dy [rows, d] in out_dtype and fp32 gamma [d].  part: fp32
// scratch [2, grid, d], grid from epl_layer_norm_bwd_blocks.  Two
// launches: the rows, then the slab's column sums.
int epl_layer_norm_bwd(const void* x, const void* dy, const void* gamma,
                       void* dx, void* dgamma, void* dbeta, void* part,
                       int grid, int64_t rows, int d, int in_dtype,
                       int out_dtype, float eps, void* stream) {
  if (bad_sizes(rows, d) || grid < 1) return cudaErrorInvalidValue;
  const int wpr = warps_per_row(d);
  const size_t smem = bwd_smem(wpr, d);
  const bool vec = d % kChunk == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(gamma) && aligned16(dx) && aligned16(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_types(in_dtype, out_dtype, [&](auto ti, auto to) {
    using TI = typename decltype(ti)::type;
    using TO = typename decltype(to)::type;
    layer_norm_bwd_kernel<TI, TO><<<grid, threads_of(wpr), smem, s>>>(
        static_cast<const TI*>(x), static_cast<const TO*>(dy),
        static_cast<const float*>(gamma), static_cast<TI*>(dx),
        static_cast<float*>(part), rows, d, wpr, eps, vec);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const dim3 sum_grid((d + 31) / 32, 2);
  layer_norm_colsum_kernel<<<sum_grid, 32 * kSumWarps, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), grid, d);
  return cudaGetLastError();
}

const char* epl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
