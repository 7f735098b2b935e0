// Shared by the port's CUDA sources. Each source is compiled on its own
// into one shared library with a plain C interface, loaded from Python
// with ctypes (see ops/_build.py), so this header is included once per
// library.
//
// Besides the small helpers, it holds the LayerNorm row code that the
// LayerNorm kernels (layer_norm.cu) and the fused residual + dropout +
// LayerNorm kernels (fused_block.cu) share: one warp per row, 16-byte
// loads, f32 statistics, and a backward whose dgamma/dbeta are summed per
// block and then across blocks by a second kernel, in a fixed order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "philox.cuh"

#define MX_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes passed by the Python wrappers
enum MxDtype : int { kFloat32 = 0, kBFloat16 = 1 };

MX_EXPORT const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace mx {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// sum over the lanes of a group of `width` neighbouring lanes (a power of
// two up to 32); every lane of the warp must take part
template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int width>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// one 16-byte vector of T, converted to and from f32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// Above 48 KB of dynamic shared memory a kernel must opt in, once per
// device and size. `opted` is the caller's own static array (one per
// kernel instantiation); two threads that race here both make the same
// idempotent call.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, std::atomic<int>* opted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[dev].load(std::memory_order_acquire) < bytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted[dev].store(bytes, std::memory_order_release);
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// LayerNorm rows (layer_norm.cu, fused_block.cu)
// ---------------------------------------------------------------------

constexpr int kLnWarps = 4;     // forward rows per block (one warp each)
constexpr int kLnBwdWarps = 8;  // backward warps per block, at most
constexpr int kLnMaxCols = 4096;

// How a row's normalised input s is formed from x and h; the backward
// writes dh accordingly
enum LnMode : int {
  kLnX = 0,           // s = x (LayerNorm)
  kLnXPlusH = 1,      // s = x + h, dh = ds (residual, no dropout)
  kLnXPlusDropH = 2,  // s = x + keep * h * scale, dh = keep * ds * scale
};

// s for the 16-byte vector at flat offset `off` (a multiple of the vector
// width, so the dropout words start at a multiple of 4); `words` receives
// the vector's random words in kLnXPlusDropH mode
template <typename T, int kMode>
__device__ __forceinline__ void ln_load_s(const T* __restrict__ x,
                                          const T* __restrict__ h,
                                          long long off, const DropoutKey& key,
                                          float* s, unsigned* words) {
  using V = Vec16<T>;
  constexpr int E = V::n;
  V::load(x + off, s);
  if constexpr (kMode == kLnXPlusH || kMode == kLnXPlusDropH) {
    float hv[E];
    V::load(h + off, hv);
    if constexpr (kMode == kLnXPlusDropH) {
      philox_words<E>(static_cast<unsigned long long>(off), key, words);
#pragma unroll
      for (int e = 0; e < E; ++e)
        hv[e] = words[e] >= key.threshold ? hv[e] * key.scale : 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s[e] += hv[e];
  }
}

// Forward: y = (s - mean) * rstd * gamma + beta with mean first, then the
// centred variance, rstd = rsqrt(var + eps), all f32; y in T, the f32 row
// statistics saved for the backward. One warp per row holds its row in
// registers (NV vectors per lane), so each input is read once.
template <typename T, int NV, int kMode>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                  const T* __restrict__ gamma, const T* __restrict__ beta,
                  T* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int rows, int cols, float eps,
                  DropoutKey key) {
  using V = Vec16<T>;
  constexpr int E = V::n;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kLnWarps + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const long long base = row * cols;

  float v[NV][E];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    if (c < cols) {
      unsigned words[E];
      ln_load_s<T, kMode>(x, h, base + c, key, v[j], words);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[j][e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[j][e] = 0.f;
    }
  }
  const float mean = group_sum<32>(sum) / cols;

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    if (c < cols) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[j][e] -= mean;
        sq += v[j][e] * v[j][e];
      }
    }
  }
  const float rstd = rsqrtf(group_sum<32>(sq) / cols + eps);

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    if (c < cols) {
      float g[E], b[E], out[E];
      V::load(gamma + c, g);
      V::load(beta + c, b);
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = v[j][e] * rstd * g[e] + b[e];
      V::store(y + base + c, out);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int NV, int kMode>
cudaError_t ln_fwd_launch(const void* x, const void* h, const void* g,
                          const void* b, void* y, void* mean, void* rstd,
                          int rows, int cols, float eps, DropoutKey key,
                          cudaStream_t stream) {
  const int blocks = (rows + kLnWarps - 1) / kLnWarps;
  ln_fwd_kernel<T, NV, kMode><<<blocks, kLnWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(g), static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, cols, eps,
      key);
  return cudaGetLastError();
}

// the smallest power-of-two vector count per lane that covers `cols`
template <typename T, int kMode>
cudaError_t ln_fwd_dispatch(const void* x, const void* h, const void* g,
                            const void* b, void* y, void* mean, void* rstd,
                            int rows, int cols, float eps, DropoutKey key,
                            cudaStream_t s) {
  constexpr int E = Vec16<T>::n;
  if (rows <= 0 || cols <= 0 || cols > kLnMaxCols || cols % E)
    return cudaErrorInvalidValue;
  const int nv = (cols + 32 * E - 1) / (32 * E);
  if (nv <= 1)
    return ln_fwd_launch<T, 1, kMode>(x, h, g, b, y, mean, rstd, rows, cols, eps, key, s);
  if (nv <= 2)
    return ln_fwd_launch<T, 2, kMode>(x, h, g, b, y, mean, rstd, rows, cols, eps, key, s);
  if (nv <= 4)
    return ln_fwd_launch<T, 4, kMode>(x, h, g, b, y, mean, rstd, rows, cols, eps, key, s);
  if (nv <= 8)
    return ln_fwd_launch<T, 8, kMode>(x, h, g, b, y, mean, rstd, rows, cols, eps, key, s);
  if (nv <= 16)
    return ln_fwd_launch<T, 16, kMode>(x, h, g, b, y, mean, rstd, rows, cols, eps, key, s);
  if constexpr (E == 4) {
    if (nv <= 32)
      return ln_fwd_launch<T, 32, kMode>(x, h, g, b, y, mean, rstd, rows, cols, eps, key, s);
  }
  return cudaErrorInvalidValue;
}

// Backward, the formula of the reference's `_bwd_kernel`:
//   xhat = (s - mean) * rstd, wdy = dy * gamma,
//   c1 = sum(wdy) / C, c2 = sum(wdy * xhat) / C,
//   ds = (wdy - c1 - xhat * c2) * rstd,
// dx = ds, dh per the mode, and per-block partials of
// dgamma = sum_rows(dy * xhat), dbeta = sum_rows(dy).
// A block has blockDim.x / 32 warps (8, or fewer when C is so wide that
// 8 slots would not fit in shared memory). Each warp walks its rows
// (row = block * warps + warp, then strided by the grid) in two passes
// unrolled over the NV vectors of its lane: the first sums c1 and c2, the
// second writes dx and dh and adds dy * xhat and dy into the warp's own
// slot of shared memory, 16 bytes a lane, so no two threads ever add to
// one address. Up to 8 vectors a lane (C <= 1024 f32, 2048 bf16) the
// first pass keeps s and dy in registers for the second, so each input
// crosses device memory once; wider rows are read again (from L1/L2).
// The block then sums its warps' slots in warp order into
// partials[block] (2 x C f32), and ln_partials_reduce_kernel sums those in
// block order: dgamma and dbeta come out the same in every run, with no
// float atomics.
template <typename T, int NV, int kMode>
__global__ void __launch_bounds__(kLnBwdWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                  const T* __restrict__ dy, const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const T* __restrict__ gamma, T* __restrict__ dx,
                  T* __restrict__ dh, float* __restrict__ partials, int rows,
                  int cols, DropoutKey key) {
  using V = Vec16<T>;
  constexpr int E = V::n;
  constexpr bool kHold = NV <= 8;   // the row stays in registers
  constexpr int NH = kHold ? NV : 1;
  extern __shared__ __align__(16) float acc[];  // [warps][2][cols]
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  float* dg_acc = acc + warp * 2 * cols;
  float* db_acc = dg_acc + cols;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    if (c < cols)
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        *reinterpret_cast<float4*>(dg_acc + c + e) = make_float4(0, 0, 0, 0);
        *reinterpret_cast<float4*>(db_acc + c + e) = make_float4(0, 0, 0, 0);
      }
  }

  float hs[NH][E], hd[NH][E];  // the row's s and dy (kHold)
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp;
       row < rows; row += static_cast<long long>(gridDim.x) * warps) {
    const long long base = row * cols;
    const float mu = mean[row], rs = rstd[row];
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * E;
      if (c < cols) {
        float s[E], d[E], g[E];
        unsigned words[E];
        ln_load_s<T, kMode>(x, h, base + c, key, s, words);
        V::load(dy + base + c, d);
        V::load(gamma + c, g);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float w = d[e] * g[e];
          a1 += w;
          a2 += w * ((s[e] - mu) * rs);
          if constexpr (kHold) {
            hs[j % NH][e] = s[e];
            hd[j % NH][e] = d[e];
          }
        }
      }
    }
    const float c1 = group_sum<32>(a1) / cols;
    const float c2 = group_sum<32>(a2) / cols;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * E;
      if (c < cols) {
        float s[E], d[E], g[E], ds[E];
        unsigned words[E];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            s[e] = hs[j % NH][e];
            d[e] = hd[j % NH][e];
          }
          if constexpr (kMode == kLnXPlusDropH)
            philox_words<E>(static_cast<unsigned long long>(base + c), key,
                            words);
        } else {
          ln_load_s<T, kMode>(x, h, base + c, key, s, words);
          V::load(dy + base + c, d);
        }
        V::load(gamma + c, g);
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          float4 ag = *reinterpret_cast<float4*>(dg_acc + c + e);
          float4 ab = *reinterpret_cast<float4*>(db_acc + c + e);
          float* pg = reinterpret_cast<float*>(&ag);
          float* pb = reinterpret_cast<float*>(&ab);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float xh = (s[e + q] - mu) * rs;
            ds[e + q] = (d[e + q] * g[e + q] - c1 - xh * c2) * rs;
            pg[q] += d[e + q] * xh;
            pb[q] += d[e + q];
          }
          *reinterpret_cast<float4*>(dg_acc + c + e) = ag;
          *reinterpret_cast<float4*>(db_acc + c + e) = ab;
        }
        V::store(dx + base + c, ds);
        if constexpr (kMode == kLnXPlusDropH) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            ds[e] = words[e] >= key.threshold ? ds[e] * key.scale : 0.f;
        }
        if constexpr (kMode != kLnX) V::store(dh + base + c, ds);
      }
    }
  }
  __syncthreads();
  float* part = partials + static_cast<long long>(blockIdx.x) * 2 * cols;
  for (int c = threadIdx.x; c < 2 * cols; c += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) sum += acc[w * 2 * cols + c];
    part[c] = sum;
  }
}

// out[c] = sum over blocks b of partials[b][c], c over the 2 * cols
// entries (dgamma, then dbeta), in a fixed order: each block takes 32
// columns, its 8 warps sum every 8th partial row, then warp 0 adds the 8
// warp sums in order.
static __global__ void __launch_bounds__(256)
    ln_partials_reduce_kernel(const float* __restrict__ partials,
                              float* __restrict__ out, int nblocks,
                              int width) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (col < width)
    for (int b = w; b < nblocks; b += 8)
      a += partials[static_cast<long long>(b) * width + col];
  red[w][lane] = a;
  __syncthreads();
  if (w == 0 && col < width) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += red[i][lane];
    out[col] = sum;
  }
}

// warps of a backward block: kLnBwdWarps, or as many (2, cols) f32 slots
// as fit in a block's 227 KB of shared memory
inline int ln_bwd_warps(int cols) {
  const int fit = (227 * 1024) / (2 * cols * static_cast<int>(sizeof(float)));
  return fit < kLnBwdWarps ? fit : kLnBwdWarps;
}

// dx (and dh), and dgamma/dbeta as f32 (2, cols) in `dgb`; `partials` is
// the caller's (nblocks, 2, cols) f32 scratch
template <typename T, int NV, int kMode>
cudaError_t ln_bwd_launch(const void* x, const void* h, const void* dy,
                          const void* mean, const void* rstd,
                          const void* gamma, void* dx, void* dh,
                          void* partials, void* dgb, int rows, int cols,
                          int nblocks, DropoutKey key, cudaStream_t stream) {
  const int warps = ln_bwd_warps(cols);
  const int smem = warps * 2 * cols * static_cast<int>(sizeof(float));
  auto kernel = ln_bwd_kernel<T, NV, kMode>;
  static std::atomic<int> opted[kMaxDevices];
  cudaError_t err = opt_in_smem(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const T*>(gamma),
      static_cast<T*>(dx), static_cast<T*>(dh),
      static_cast<float*>(partials), rows, cols, key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_partials_reduce_kernel<<<(2 * cols + 31) / 32, 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dgb), nblocks,
      2 * cols);
  return cudaGetLastError();
}

// the smallest power-of-two vector count per lane that covers `cols`, as
// the forward
template <typename T, int kMode>
cudaError_t ln_bwd_dispatch(const void* x, const void* h, const void* dy,
                            const void* mean, const void* rstd,
                            const void* g, void* dx, void* dh,
                            void* partials, void* dgb, int rows, int cols,
                            int nblocks, DropoutKey key, cudaStream_t s) {
  constexpr int E = Vec16<T>::n;
  if (rows <= 0 || cols <= 0 || cols > kLnMaxCols || cols % E || nblocks <= 0)
    return cudaErrorInvalidValue;
  const int nv = (cols + 32 * E - 1) / (32 * E);
#define MX_LN_BWD(NV)                                                        \
  return ln_bwd_launch<T, NV, kMode>(x, h, dy, mean, rstd, g, dx, dh,        \
                                     partials, dgb, rows, cols, nblocks, key, \
                                     s)
  if (nv <= 1) MX_LN_BWD(1);
  if (nv <= 2) MX_LN_BWD(2);
  if (nv <= 4) MX_LN_BWD(4);
  if (nv <= 8) MX_LN_BWD(8);
  if (nv <= 16) MX_LN_BWD(16);
  if constexpr (E == 4) {
    if (nv <= 32) MX_LN_BWD(32);
  }
#undef MX_LN_BWD
  return cudaErrorInvalidValue;
}

}  // namespace mx
