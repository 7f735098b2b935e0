// Hopper (sm_90a) building blocks of the flash-attention kernels and the
// int8 convolution: warpgroup matrix products (`wgmma.mma_async`) in bf16,
// f16 and TF32 with f32 sums and in s8 with s32 sums, their shared-memory
// descriptors and the 128-byte swizzle they name, 16-byte `cp.async`
// copies, and the split of an f32 value into two TF32 halves (3xTF32).
//
// Operand tiles in shared memory. A tile holds `rows` rows of a matrix
// whose other axis (the tile's depth) is stored contiguously; it is cut
// into column blocks 128 bytes wide (64 bf16 or f16, or 32 f32 values), each
// block `rows * 128` bytes, one row after the other. Inside a block, the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8): the 128-byte
// swizzle, which the descriptors below name (layout type 1). Tiles start
// on 1024-byte boundaries, so the swizzle's phase is the row index.
//
// - K-major operand (A, or B stored as N rows of K): the product's depth
//   runs along the tile's depth. One wgmma step consumes 32 bytes of depth
//   (16 bf16 or f16, 8 TF32, 32 s8); the descriptor of step s starts s * 32
//   bytes in. s8 products take both operands K-major only.
// - MN-major B (bf16 and f16 only): the product's depth runs along the tile's rows
//   and N along its depth, e.g. V stored (keys, d) as B of P V. One step
//   consumes 16 rows; LBO is the stride between column blocks along N and
//   SBO the stride between groups of 8 rows.
//
// Accumulators (m64nN, f32 or s32): thread t of warp w in the warpgroup holds
// d[4 j + e] for j < N / 8 at row 16 w + t / 4 + 8 * (e / 2), column
// 8 j + 2 (t % 4) + e % 2. A register A fragment (bf16 or f16, m64nNk16) holds
// rows 16 w + t / 4 (+ 8) and columns 2 (t % 4) (+ 1, + 8, + 9), so the
// accumulator of one product packs, two values a register, into the A
// operand of the next. The TF32 fragment (m64nNk8) holds columns t % 4
// and t % 4 + 4 instead; its owner feeds d[4 j], d[4 j + 2], d[4 j + 1],
// d[4 j + 3] and stores the matching B with its depth permuted inside
// each group of 8: value m of a group sits at slot m / 2 (even m) or
// 4 + m / 2 (odd m).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace mx {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of byte `col` of row `r` in a swizzled tile of `rows` rows
__device__ __forceinline__ int swz(int rows, int r, int col) {
  return (col >> 7) * rows * 128 + r * 128 +
         ((((col >> 4) & 7) ^ (r & 7)) << 4) + (col & 15);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo,
                                              int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

// The steps below add their offset to the start-address field of the
// tile's descriptor: shared memory ends below 2^18 bytes, so the field
// does not overflow, and the tile's descriptor is computed once.

// K-major tile of `rows` rows, step s (32 bytes of depth)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int s) {
  return make_desc(tile, 16, 1024) +
         static_cast<uint64_t>(((s >> 2) * rows * 128 + (s & 3) * 32) >> 4);
}

// MN-major tile of `rows` rows (the product's depth), step s (16 rows)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int s) {
  return make_desc(tile, rows * 128, 1024) +
         static_cast<uint64_t>((s * 16 * 128) >> 4);
}

// ---- async copies ---------------------------------------------------------

// 16 bytes global -> shared; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most `n` of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// make this thread's shared-memory writes visible to wgmma (async proxy);
// a barrier must follow before another thread's wgmma reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or reuse of registers that an
// in-flight wgmma owns across the wait
template <int n>
__device__ __forceinline__ void hold(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void hold(uint32_t (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void hold(int (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// two f32 values rounded to T (bf16 or f16), `lo` in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// the operand type of a product: TF32 (f32 values), bf16 or f16
template <typename T>
constexpr bool kIsTf32 = std::is_same<T, float>::value;
template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;

#define MX_R16                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MX_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define MX_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define MX_F8(d, o)                                                         \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),               \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define MX_F16(d) MX_F8(d, 0), MX_F8(d, 8)
#define MX_F32(d) MX_F16(d), MX_F8(d, 16), MX_F8(d, 24)
#define MX_F64(d) \
  MX_F32(d), MX_F8(d, 32), MX_F8(d, 40), MX_F8(d, 48), MX_F8(d, 56)

// d (m64 x N, f32) += A (smem) B (smem), both K-major. T: float for TF32
// inputs (m64nNk8), else __nv_bfloat16 or __half (m64nNk16). N = 32 or 64.
template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b) {
  static_assert(N == 32 || N == 64, "mma_ss: N is 32 or 64");
  if constexpr (N == 32 && kIsTf32<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " MX_R16
        ", %16, %17, p, 1, 1;\n}\n"
        : MX_F16(d)
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 32 && kIsF16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " MX_R16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : MX_F16(d)
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MX_R16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : MX_F16(d)
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (kIsTf32<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MX_R32
        ", %32, %33, p, 1, 1;\n}\n"
        : MX_F32(d)
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (kIsF16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MX_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : MX_F32(d)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : MX_F32(d)
        : "l"(a), "l"(b), "r"(1));
  }
}

// d (m64 x N, f32) += A (registers, one step's fragment) B (smem). TF32: B
// K-major; bf16 and f16: B MN-major (transposed). N = 64 or 128.
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b) {
  static_assert(N == 64 || N == 128, "mma_rs: N is 64 or 128");
  if constexpr (N == 64 && kIsTf32<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " MX_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : MX_F32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  } else if constexpr (N == 64 && kIsF16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MX_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : MX_F32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : MX_F32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  } else if constexpr (kIsTf32<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " MX_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : MX_F64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  } else if constexpr (kIsF16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " MX_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : MX_F64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MX_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : MX_F64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
}

#define MX_I8(d, o)                                                         \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),               \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])
#define MX_I32(d) MX_I8(d, 0), MX_I8(d, 8), MX_I8(d, 16), MX_I8(d, 24)
#define MX_I64(d) \
  MX_I32(d), MX_I8(d, 32), MX_I8(d, 40), MX_I8(d, 48), MX_I8(d, 56)

// d (m64 x N, s32) += A (smem) B (smem), s8 x s8, both K-major, one k32
// step (32 bytes of depth: the same descriptors as a bf16 k16 step). The
// sums are exact (no .satfinite: int32 wraps, which no int8 product of
// a depth below 2^17 reaches). N = 64 or 128.
template <int N>
__device__ __forceinline__ void mma_ss_s8(int (&d)[N / 2], uint64_t a,
                                          uint64_t b) {
  static_assert(N == 64 || N == 128, "mma_ss_s8: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MX_R32
        ", %32, %33, p;\n}\n"
        : MX_I32(d)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " MX_R64
        ", %64, %65, p;\n}\n"
        : MX_I64(d)
        : "l"(a), "l"(b), "r"(1));
  }
}

#undef MX_I8
#undef MX_I32
#undef MX_I64
#undef MX_R16
#undef MX_R32
#undef MX_R64
#undef MX_F8
#undef MX_F16
#undef MX_F32
#undef MX_F64

}  // namespace sm90
}  // namespace mx
