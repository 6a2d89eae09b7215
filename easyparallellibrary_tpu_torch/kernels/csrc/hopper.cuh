// Hopper (sm_90a) building blocks for the port's kernels: shared-memory
// barriers (mbarrier), TMA tensor loads, warpgroup matrix products
// (wgmma) on 128-byte-swizzled shared-memory tiles, and the host-side
// encoding of the tensor maps that TMA reads through.
//
// Tile layout.  Every operand tile in shared memory is the layout that a
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes and that a wgmma
// descriptor of layout type B128 reads: a [rows, cols] 16-bit tile is
// stored as cols / 64 column blocks of [rows, 64] (one 128-byte row
// each), block c at byte offset c * rows * 128, each block 1024-byte
// aligned.  Within a block, the 16-byte chunk j of row r sits at chunk
// j ^ (r % 8): that is the swizzle, applied by the hardware on both sides.
//
// Descriptors (PTX ISA, "matrix descriptor"):
//   K-major operand (the reduction dim is the tile's columns): SBO = 1024
//     (the next 8 rows), LBO unused; the k-th 16-wide slice of the
//     reduction dim starts (k % 4) * 32 bytes into column block k / 4.
//   MN-major operand (the reduction dim is the tile's rows, the output
//     dim its columns; the instruction's transpose flag): SBO = 1024 (the
//     next 8 rows of the reduction dim), LBO = rows * 128 (the next column
//     block along the output dim); the k-th 16-row slice starts at
//     k * 16 * 128 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers --

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; a __syncthreads() follows it.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive, and expect `bytes` more to land through TMA in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spins until the barrier's phase of this parity has completed (a
// barrier starts in phase 0; waiting on parity 1 first returns at once).
// A wait past 10 s can only be a lost arrival or copy: the kernel traps,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - start > 10000000000ull) __trap();
  }
}

// ------------------------------------------------------------------ TMA --

// The box of `map` at coordinates (c0, c1, c2), innermost first, into
// shared memory at dst; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row0, row0 + rows) of matrix `mat` of a [depth, rows, cols] map
// whose box is (64, rows, 1): cols / 64 loads, one per column block.
template <int kCols>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0,
                                              int mat, int rows) {
#pragma unroll
  for (int c = 0; c < kCols / 64; ++c) {
    tma_load_3d(dst + c * rows * 128, map, bar, 64 * c, row0, mat);
  }
}

// ---------------------------------------------------------------- wgmma --

// Descriptor of a B128-swizzled operand at shared address `addr`.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator
// registers across an asynchronous wgmma's issue or completion.
template <int K>
__device__ __forceinline__ void fence_operands(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, N] (+)= A[64, 16] B[16, N], 16-bit operands of type T (bf16 or
// fp16: the instruction's .bf16.bf16 or .f16.f16 form, with the same
// fragment layouts and descriptors), fp32 accumulators in the wgmma
// fragment layout (thread (warp w, lane 4g + t) of the warpgroup holds
// rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1:
// d[4j + 2h + e] is row 16w + g + 8h, column 8j + 2t + e).  scale_d = 0
// overwrites D.
//
// wgmma_ss<T, 32 | 64 | 128>: A and B from shared memory, both K-major.
// wgmma_rs_mn<T, 64 | 128>: A from registers (the mma.sync m16n8k16 A
// layout within each warp's 16 rows), B from shared memory MN-major.

// The 16-bit operand types the products take.
template <typename T>
__host__ __device__ constexpr bool is_wgmma_operand() {
  return std::is_same<T, __nv_bfloat16>::value ||
         std::is_same<T, __half>::value;
}

#define HOPPER_D16 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15])

#define HOPPER_D32_HI \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
    "+f"(d[31])

#define HOPPER_D64_HI \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
    "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
    "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
    "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
    "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
    "+f"(d[62]), "+f"(d[63])

#define HOPPER_REGS16 \
  "%0, %1, %2, %3, %4, %5, %6, %7," \
  "%8, %9, %10, %11, %12, %13, %14, %15"

#define HOPPER_REGS32_HI \
  "%16, %17, %18, %19, %20, %21, %22, %23," \
  "%24, %25, %26, %27, %28, %29, %30, %31"

#define HOPPER_REGS64_HI \
  "%32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55," \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// TY: the PTX operand type, "bf16" or "f16".  The scale-d predicate, A
// and B follow the N / 2 accumulators.
#define HOPPER_WGMMA_SS_32(TY)                                            \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"        \
      HOPPER_REGS16 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                    \
      : HOPPER_D16                                                        \
      : "l"(a), "l"(b), "r"(scale_d))
#define HOPPER_WGMMA_SS_64(TY)                                            \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
      HOPPER_REGS16 "," HOPPER_REGS32_HI "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : HOPPER_D16, HOPPER_D32_HI                                         \
      : "l"(a), "l"(b), "r"(scale_d))
#define HOPPER_WGMMA_SS_128(TY)                                           \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
      HOPPER_REGS16 "," HOPPER_REGS32_HI "," HOPPER_REGS64_HI             \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                  \
      : HOPPER_D16, HOPPER_D32_HI, HOPPER_D64_HI                          \
      : "l"(a), "l"(b), "r"(scale_d))
#define HOPPER_WGMMA_RS_64(TY)                                            \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
      HOPPER_REGS16 "," HOPPER_REGS32_HI                                  \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                    \
      : HOPPER_D16, HOPPER_D32_HI                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))
#define HOPPER_WGMMA_RS_128(TY)                                           \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
      HOPPER_REGS16 "," HOPPER_REGS32_HI "," HOPPER_REGS64_HI             \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                    \
      : HOPPER_D16, HOPPER_D32_HI, HOPPER_D64_HI                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(is_wgmma_operand<T>() && (N == 32 || N == 64 || N == 128),
                "no such wgmma_ss");
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 32) {
    if constexpr (kHalf) {
      HOPPER_WGMMA_SS_32("f16");
    } else {
      HOPPER_WGMMA_SS_32("bf16");
    }
  } else if constexpr (N == 64) {
    if constexpr (kHalf) {
      HOPPER_WGMMA_SS_64("f16");
    } else {
      HOPPER_WGMMA_SS_64("bf16");
    }
  } else {
    if constexpr (kHalf) {
      HOPPER_WGMMA_SS_128("f16");
    } else {
      HOPPER_WGMMA_SS_128("bf16");
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  static_assert(is_wgmma_operand<T>() && (N == 64 || N == 128),
                "no such wgmma_rs_mn");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __half>::value) {
      HOPPER_WGMMA_RS_64("f16");
    } else {
      HOPPER_WGMMA_RS_64("bf16");
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      HOPPER_WGMMA_RS_128("f16");
    } else {
      HOPPER_WGMMA_RS_128("bf16");
    }
  }
}

#undef HOPPER_WGMMA_RS_128
#undef HOPPER_WGMMA_RS_64
#undef HOPPER_WGMMA_SS_128
#undef HOPPER_WGMMA_SS_64
#undef HOPPER_WGMMA_SS_32
#undef HOPPER_REGS64_HI
#undef HOPPER_REGS32_HI
#undef HOPPER_REGS16
#undef HOPPER_D64_HI
#undef HOPPER_D32_HI
#undef HOPPER_D16

// -------------------------------------------------------- tensor maps --

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is
// looked up once through the runtime, so the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor-map element type of a 16-bit operand type.
template <typename T>
constexpr CUtensorMapDataType tensor_map_type() {
  static_assert(is_wgmma_operand<T>(), "no tensor map type");
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A [depth, rows, cols] row-major tensor of 16-bit T (bf16 or fp16; cols
// a multiple of 64, the base 16-byte aligned) as a 3-D map read in boxes
// of (64 columns, box_rows rows, one matrix) into the B128 tile layout.
// Rows past `rows` read as zeros: a tail tile never sees the next
// matrix.  False if cuTensorMapEncodeTiled refuses the map.
template <typename T>
inline bool encode_rows(CUtensorMap* map, const void* base, int depth,
                        int rows, int cols, int box_rows) {
  static_assert(sizeof(T) == 2, "a 16-bit element: 64 columns, 128 bytes");
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * sizeof(T),
      static_cast<cuuint64_t>(rows) * cols * sizeof(T)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, tensor_map_type<T>(), 3, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
