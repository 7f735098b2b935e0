// Shared by the port's CUDA sources. Each source is compiled on its own
// into one shared library with a plain C interface, loaded from Python
// with ctypes (see ops/_build.py), so this header is included once per
// library.
//
// Besides the small helpers, it holds the LayerNorm row code that the
// LayerNorm kernels (layer_norm.cu) and the fused residual + dropout +
// LayerNorm kernels (fused_block.cu) share: one warp per row, 16-byte
// loads, f32 statistics; a forward whose warps issue every load of a row
// before its first reduction and walk rows with the next one in flight,
// on a grid the caller picks for the row count; and a backward on a grid
// sized for the card whose dgamma/dbeta are summed per warp, per block and
// then across blocks by a second kernel, in a fixed order.
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

// N elements of T (N a multiple of 4) to and from f32, in 16-byte accesses,
// or 8-byte ones for four bf16: a companion array read at the element
// offsets of another of a wider type (a bf16 h beside an f32 x, f32 gamma
// beside a bf16 x) keeps that array's lane-to-column map
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  static_assert(N % 4 == 0, "whole float4 vectors");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) Vec16<float>::load(p + 4 * i, out + 4 * i);
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  static_assert(N % 4 == 0, "whole 8-byte vectors");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      Vec16<__nv_bfloat16>::load(p + 8 * i, out + 8 * i);
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + 4 * i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      out[4 * i] = a.x;
      out[4 * i + 1] = a.y;
      out[4 * i + 2] = b.x;
      out[4 * i + 3] = b.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  static_assert(N % 4 == 0, "whole float4 vectors");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) Vec16<float>::store(p + 4 * i, in + 4 * i);
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  static_assert(N % 4 == 0, "whole 8-byte vectors");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      Vec16<__nv_bfloat16>::store(p + 8 * i, in + 8 * i);
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      uint2 v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
      h[0] = __floats2bfloat162_rn(in[4 * i], in[4 * i + 1]);
      h[1] = __floats2bfloat162_rn(in[4 * i + 2], in[4 * i + 3]);
      *reinterpret_cast<uint2*>(p + 4 * i) = v;
    }
  }
}

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

// Ask for the largest shared-memory share of the SM for `kernel`, once
// per device (`done` is the caller's own static array), so that as many
// of its blocks fit an SM as their registers allow.
template <typename Kernel>
cudaError_t prefer_shared(Kernel kernel, std::atomic<int>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    done[dev].store(1, std::memory_order_release);
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// LayerNorm rows (layer_norm.cu, fused_block.cu)
// ---------------------------------------------------------------------
//
// Three element types: TX for x, y, dy and dx; TH for h and dh (kLnX
// leaves it unused); TP for gamma, beta, dgamma and dbeta. All arithmetic
// is f32. The sources instantiate the layouts they take: all f32, all
// bf16, and AMP's two mixed ones, bf16 x with f32 gamma/beta (LayerNorm)
// and f32 x with bf16 h and f32 gamma/beta (the residual site). A lane's
// vectors follow x's width, E = Vec16<TX>::n elements (16 bytes of x); h
// and gamma/beta are read at the same element offsets in the widths that
// gives them (load_vec), so the lane-to-column map and the Philox
// counters are those of x's all-same-type layout.

constexpr int kLnBwdWarps = 8;  // backward warps per block, at most
constexpr int kLnMaxCols = 4096;

// How a row's normalised input s is formed from x and h; the backward
// writes dh accordingly
enum LnMode : int {
  kLnX = 0,           // s = x (LayerNorm)
  kLnXPlusH = 1,      // s = x + h, dh = ds (residual, no dropout)
  kLnXPlusDropH = 2,  // s = x + keep * h * scale, dh = keep * ds * scale
};

// s for the E elements at flat offset `off` (a multiple of E, so the
// dropout words start at a multiple of 4). In kLnXPlusDropH mode bit e of
// `keep` says whether element e of h is kept: drawn from Philox when
// kDraw, else given by the caller (the same bits drawn before)
template <typename TX, typename TH, int kMode, bool kDraw = true>
__device__ __forceinline__ void ln_load_s(const TX* __restrict__ x,
                                          const TH* __restrict__ h,
                                          long long off, const DropoutKey& key,
                                          float* s, unsigned& keep) {
  constexpr int E = Vec16<TX>::n;
  load_vec<E>(x + off, s);
  if constexpr (kMode == kLnXPlusH || kMode == kLnXPlusDropH) {
    float hv[E];
    load_vec<E>(h + off, hv);
    if constexpr (kMode == kLnXPlusDropH) {
      if constexpr (kDraw) {
        unsigned words[E];
        philox_words<E>(static_cast<unsigned long long>(off), key, words);
        keep = 0u;
#pragma unroll
        for (int e = 0; e < E; ++e)
          keep |= static_cast<unsigned>(words[e] >= key.threshold) << e;
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        hv[e] = (keep >> e) & 1u ? hv[e] * key.scale : 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s[e] += hv[e];
  }
}

// How a RawVec load goes through the caches: plainly, through the
// read-only path (__ldg: data every row shares, gamma and beta), or
// streaming (__ldcs: evict first, data read once)
enum MxCache : int { kCachePlain = 0, kCacheShared = 1, kCacheStream = 2 };

// N elements of T as raw 32-bit words: loaded in 16-byte accesses (8-byte
// ones for four bf16) and widened to f32 only where they are used, so a
// load stays in flight until then.
template <typename T, int N>
struct RawVec {
  static constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes % 8 == 0, "whole 8-byte accesses");
  unsigned w[kBytes / 4];

  template <int kCache>
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4* q = reinterpret_cast<const uint4*>(p) + i;
        uint4 v;
        if constexpr (kCache == kCacheShared) v = __ldg(q);
        else if constexpr (kCache == kCacheStream) v = __ldcs(q);
        else v = *q;
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 8; ++i) {
        const uint2* q = reinterpret_cast<const uint2*>(p) + i;
        uint2 v;
        if constexpr (kCache == kCacheShared) v = __ldg(q);
        else if constexpr (kCache == kCacheStream) v = __ldcs(q);
        else v = *q;
        w[2 * i] = v.x;
        w[2 * i + 1] = v.y;
      }
    }
  }

  // exact: a bf16 is the high half of the f32 with the same value
  __device__ __forceinline__ void widen(float* out) const {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

// Forward: y = (s - mean) * rstd * gamma + beta with mean first, then the
// centred variance, rstd = rsqrt(var + eps), all f32; y in TX, the f32 row
// statistics saved for the backward.
//
// Bound by bytes at every row count the port gives it, and at a few rows
// (decode: 1 to 8) by latency: the launch and one round trip to device
// memory. So (1) a row's loads are issued before its first reduction:
// x and h (in kLnXPlusDropH mode the row's Philox words are drawn while
// they are in flight) and, in kLnX mode, gamma and beta (K3 reads them
// per row after its reductions, from the L1 cache: held, they spill K3's
// registers); (2) a warp walks rows
// (row = block * warps + warp, then strided by the grid) and, while a lane
// holds at most kLnFwdHoldElems elements of a row (C <= 768, as raw
// words), issues the next row's loads before it reduces the current one,
// and in kLnX mode keeps gamma and beta in registers across its rows,
// loaded once; wider rows are loaded and widened in place, one at a time,
// as registers allow; (3) NV is the row's exact vector count up to 8;
// (4) x and h, read once, are streamed (evict first) in K4, whose
// few-row calls with cold gamma and beta time faster so, and in K3 with
// bf16 x; K3 with f32 x loads them plainly, which times faster there.
// Held, a C = 768 row takes 111-125 registers at two blocks an SM (a
// wider one spills). The caller picks the number of kLnFwdWarps-warp
// blocks (`row_blocks` in ops/layer_norm.py, the backward's grid): one row
// a warp while rows are few, at most kLnFwdBlocksPerSm blocks an SM past
// that. Any grid gives the same result: one warp computes a row, with the
// same lane-to-column map and the same sums, whatever the grid and the
// call's row count.
constexpr int kLnFwdWarps = 8;        // warps of a block
constexpr int kLnFwdBlocksPerSm = 2;  // resident blocks an SM
constexpr int kLnFwdHoldElems = 24;   // a lane holds the next row up to this

// the keep bits of row `row` in kLnXPlusDropH mode: bit e of keep[j] says
// whether element e of the lane's vector j of h is kept, from the Philox
// words at the elements' flat offsets
template <typename TX, int NV>
__device__ __forceinline__ void ln_fwd_keep(long long row, int cols,
                                            int lane, const DropoutKey& key,
                                            unsigned (&keep)[NV]) {
  constexpr int E = Vec16<TX>::n;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    keep[j] = 0u;
    if (c < cols) {
      unsigned words[E];
      philox_words<E>(static_cast<unsigned long long>(row * cols + c), key,
                      words);
#pragma unroll
      for (int e = 0; e < E; ++e)
        keep[j] |= static_cast<unsigned>(words[e] >= key.threshold) << e;
    }
  }
}

// issue the raw loads of row `row` (x, and h when the mode has it) and, in
// kLnXPlusDropH mode, draw its keep bits while they are in flight
template <typename TX, typename TH, int NV, int NH, int kMode>
__device__ __forceinline__ void ln_fwd_issue(
    const TX* __restrict__ x, const TH* __restrict__ h, long long row,
    int cols, int lane, const DropoutKey& key,
    RawVec<TX, Vec16<TX>::n> (&xr)[NV], RawVec<TH, Vec16<TX>::n> (&hr)[NH],
    unsigned (&keep)[NV]) {
  constexpr int E = Vec16<TX>::n;
  constexpr int kCache =
      kMode == kLnX || sizeof(TX) == 2 ? kCacheStream : kCachePlain;
  const long long base = row * cols;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    if (c < cols) {
      xr[j].template load<kCache>(x + base + c);
      if constexpr (kMode != kLnX) hr[j].template load<kCache>(h + base + c);
    }
  }
  if constexpr (kMode == kLnXPlusDropH)
    ln_fwd_keep<TX, NV>(row, cols, lane, key, keep);
}

template <typename TX, typename TH, typename TP, int NV, int kMode>
__global__ void __launch_bounds__(kLnFwdWarps * 32,
                                  NV * Vec16<TX>::n <= kLnFwdHoldElems
                                      ? kLnFwdBlocksPerSm
                                      : 1)
    ln_fwd_kernel(const TX* __restrict__ x, const TH* __restrict__ h,
                  const TP* __restrict__ gamma, const TP* __restrict__ beta,
                  TX* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int rows, int cols, float eps,
                  DropoutKey key) {
  constexpr int E = Vec16<TX>::n;
  // the row held as raw words, the next row's loads in flight
  constexpr bool kHold = NV * E <= kLnFwdHoldElems;
  constexpr bool kParams = kHold && kMode == kLnX;  // gamma/beta held
  constexpr int NR = kHold ? NV : 1;  // raw vectors held (kHold)
  constexpr int NH = kMode == kLnX ? 1 : NR;
  constexpr int NP = kParams ? NV : 1;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  long long row =
      static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  if constexpr (kMode == kLnXPlusDropH) key = load_key(key);

  RawVec<TX, E> xr[NR];
  RawVec<TH, E> hr[NH];
  RawVec<TP, E> gr[NP], br[NP];
  unsigned keep[NV];
  if constexpr (kHold)
    ln_fwd_issue<TX, TH, NV, NH, kMode>(x, h, row, cols, lane, key, xr, hr,
                                        keep);
  if constexpr (kParams) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * E;
      if (c < cols) {
        gr[j].template load<kCacheShared>(gamma + c);
        br[j].template load<kCacheShared>(beta + c);
      }
    }
  }
  while (true) {
    const long long base = row * cols;
    float v[NV][E];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * E;
      if (c < cols) {
        if constexpr (kHold) {
          xr[j % NR].widen(v[j]);
          if constexpr (kMode != kLnX) {
            float hv[E];
            hr[j % NH].widen(hv);
            if constexpr (kMode == kLnXPlusDropH) {
#pragma unroll
              for (int e = 0; e < E; ++e)
                hv[e] = (keep[j] >> e) & 1u ? hv[e] * key.scale : 0.f;
            }
#pragma unroll
            for (int e = 0; e < E; ++e) v[j][e] += hv[e];
          }
        } else {  // wide rows: load and widen in place, as registers allow
          unsigned bits = 0u;
          ln_load_s<TX, TH, kMode>(x, h, base + c, key, v[j], bits);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) sum += v[j][e];
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[j][e] = 0.f;
      }
    }
    const long long next = row + stride;
    if constexpr (kHold) {
      if (next < rows)
        ln_fwd_issue<TX, TH, NV, NH, kMode>(x, h, next, cols, lane, key, xr,
                                            hr, keep);
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
        if constexpr (kParams) {
          gr[j % NP].widen(g);
          br[j % NP].widen(b);
        } else {
          RawVec<TP, E> gq, bq;
          gq.template load<kCacheShared>(gamma + c);
          bq.template load<kCacheShared>(beta + c);
          gq.widen(g);
          bq.widen(b);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) out[e] = v[j][e] * rstd * g[e] + b[e];
        store_vec<E>(y + base + c, out);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
    row = next;
    if (row >= rows) break;
  }
}

template <typename TX, typename TH, typename TP, int NV, int kMode>
cudaError_t ln_fwd_launch(const void* x, const void* h, const void* g,
                          const void* b, void* y, void* mean, void* rstd,
                          int rows, int cols, float eps, int blocks,
                          DropoutKey key, cudaStream_t stream) {
  ln_fwd_kernel<TX, TH, TP, NV, kMode>
      <<<blocks, kLnFwdWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TH*>(h),
      static_cast<const TP*>(g), static_cast<const TP*>(b),
      static_cast<TX*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), rows, cols, eps, key);
  return cudaGetLastError();
}

// y, mean, rstd on a grid of `blocks` blocks of kLnFwdWarps warps (any
// grid covers every row). NV, the vectors a lane takes of a row: exactly
// the row's count up to 8, then 12, 16, 24 or 32
template <typename TX, typename TH, typename TP, int kMode>
cudaError_t ln_fwd_dispatch(const void* x, const void* h, const void* g,
                            const void* b, void* y, void* mean, void* rstd,
                            int rows, int cols, float eps, int blocks,
                            DropoutKey key, cudaStream_t s) {
  constexpr int E = Vec16<TX>::n;
  if (rows <= 0 || cols <= 0 || cols > kLnMaxCols || cols % E || blocks < 1)
    return cudaErrorInvalidValue;
  const int nv = (cols + 32 * E - 1) / (32 * E);
#define MX_LN_FWD(NV)                                                    \
  return ln_fwd_launch<TX, TH, TP, NV, kMode>(x, h, g, b, y, mean, rstd, \
                                              rows, cols, eps, blocks,   \
                                              key, s)
  switch (nv) {
    case 1: MX_LN_FWD(1);
    case 2: MX_LN_FWD(2);
    case 3: MX_LN_FWD(3);
    case 4: MX_LN_FWD(4);
    case 5: MX_LN_FWD(5);
    case 6: MX_LN_FWD(6);
    case 7: MX_LN_FWD(7);
    case 8: MX_LN_FWD(8);
    default: break;
  }
  if (nv <= 12) MX_LN_FWD(12);
  if (nv <= 16) MX_LN_FWD(16);
  if constexpr (E == 4) {
    if (nv <= 24) MX_LN_FWD(24);
    if (nv <= 32) MX_LN_FWD(32);
  }
#undef MX_LN_FWD
  return cudaErrorInvalidValue;
}

// Backward, the formula of the reference's `_bwd_kernel`:
//   xhat = (s - mean) * rstd, wdy = dy * gamma,
//   c1 = sum(wdy) / C, c2 = sum(wdy * xhat) / C,
//   ds = (wdy - c1 - xhat * c2) * rstd,
// dx = ds, dh per the mode, and dgamma = sum_rows(dy * xhat),
// dbeta = sum_rows(dy).
//
// Bound by bytes on the H100, so the design keeps a call's fixed costs
// (partials, shared-memory traffic, a second pass over the grid) small:
// the wrapper launches at most kLnBwdBlocksPerSm blocks of kLnBwdWarps
// warps an SM (`row_blocks` in ops/layer_norm.py), all resident at once,
// and each warp walks its rows (row = block * warps + warp, then strided
// by the grid) in two passes unrolled over the NV vectors of its lane
// (NV exactly the row's vector count up to 8). The first pass sums c1
// and c2, the second writes dx and dh. Up to kLnHoldElems elements a
// lane (C <= 1024 in f32 and bf16) the lane holds its s and dy between
// the passes, so each input crosses device memory once; in kLnX mode
// (K4b) it also sums its columns' dgamma/dbeta across all its rows in
// registers. K3, whose h and Philox words need the registers, and wider
// rows sum into the warp's own slot of shared memory, 16 bytes a lane;
// wider rows are read again (from L1/L2). In kLnXPlusDropH mode the
// Philox words of a vector are drawn once a row; the keep bits stay in a
// register. At the end each warp's sums go to its slot, and the block
// adds its slots in warp order into partials[block] (2 x C f32);
// ln_partials_reduce_kernel adds those in block order and writes dgamma
// and dbeta in TP. The sums' order depends on (rows, C, grid) only: the
// same dgamma/dbeta in every run and in every layout, with no float
// atomics.
constexpr int kLnBwdBlocksPerSm = 2;
constexpr int kLnHoldElems = 32;    // a lane holds its row up to this
constexpr int kLnRegAccElems = 32;  // and, in kLnX mode, its sums
constexpr int kLnBoundElems = 24;   // and fits kLnBwdBlocksPerSm an SM

// kLnBwdBlocksPerSm resident blocks an SM leave 65536 / (256 x blocks)
// registers a thread: enough while a lane holds at most kLnBoundElems
// elements (C = 768 in f32 and bf16)
template <typename TX, typename TH, typename TP, int NV, int kMode>
__global__ void __launch_bounds__(kLnBwdWarps * 32,
                                  (NV * Vec16<TX>::n <= kLnBoundElems
                                       ? kLnBwdBlocksPerSm
                                       : 1))
    ln_bwd_kernel(const TX* __restrict__ x, const TH* __restrict__ h,
                  const TX* __restrict__ dy, const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const TP* __restrict__ gamma, TX* __restrict__ dx,
                  TH* __restrict__ dh, float* __restrict__ partials, int rows,
                  int cols, DropoutKey key) {
  constexpr int E = Vec16<TX>::n;
  constexpr bool kHold = NV * E <= kLnHoldElems;
  // dgamma/dbeta in registers where that leaves no spill at two blocks
  // an SM: K4b; K3 (h, Philox) sums into shared memory
  constexpr bool kRegAcc = kMode == kLnX && NV * E <= kLnRegAccElems;
  constexpr int NH = kHold ? NV : 1;
  constexpr int NA = kRegAcc ? NV : 1;
  constexpr int NK = (NV * E + 31) / 32;  // words of keep bits a lane
  extern __shared__ __align__(16) float acc[];  // [warps][2][cols]
  if constexpr (kMode == kLnXPlusDropH) key = load_key(key);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  float* dg_acc = acc + warp * 2 * cols;
  float* db_acc = dg_acc + cols;

  float ag[NA][E], ab[NA][E];  // the lane's dgamma/dbeta sums (kRegAcc)
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (kRegAcc) {
        ag[j % NA][e] = 0.f;
        ab[j % NA][e] = 0.f;
      } else if (c < cols && e % 4 == 0) {
        *reinterpret_cast<float4*>(dg_acc + c + e) = make_float4(0, 0, 0, 0);
        *reinterpret_cast<float4*>(db_acc + c + e) = make_float4(0, 0, 0, 0);
      }
    }
  }

  float hs[NH][E], hd[NH][E];  // the row's s and dy (kHold)
  for (int row = blockIdx.x * warps + warp; row < rows;
       row += gridDim.x * warps) {
    const long long base = static_cast<long long>(row) * cols;
    const float mu = mean[row], rs = rstd[row];
    unsigned keep[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) keep[k] = 0u;
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * E;
      if (c < cols) {
        float s[E], d[E], g[E];
        unsigned bits = 0u;
        ln_load_s<TX, TH, kMode>(x, h, base + c, key, s, bits);
        keep[j * E / 32] |= bits << (j * E % 32);
        load_vec<E>(dy + base + c, d);
        load_vec<E>(gamma + c, g);
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
        const unsigned bits = keep[j * E / 32] >> (j * E % 32);
        float s[E], d[E], g[E], ds[E];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            s[e] = hs[j % NH][e];
            d[e] = hd[j % NH][e];
          }
        } else {
          unsigned given = bits;
          ln_load_s<TX, TH, kMode, false>(x, h, base + c, key, s, given);
          load_vec<E>(dy + base + c, d);
        }
        load_vec<E>(gamma + c, g);
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          float4 sg, sb;  // the warp's slot, 16 bytes a lane (!kRegAcc)
          if constexpr (!kRegAcc) {
            sg = *reinterpret_cast<float4*>(dg_acc + c + e);
            sb = *reinterpret_cast<float4*>(db_acc + c + e);
          }
          float* pg = reinterpret_cast<float*>(&sg);
          float* pb = reinterpret_cast<float*>(&sb);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float xh = (s[e + k] - mu) * rs;
            ds[e + k] = (d[e + k] * g[e + k] - c1 - xh * c2) * rs;
            if constexpr (kRegAcc) {
              ag[j % NA][e + k] += d[e + k] * xh;
              ab[j % NA][e + k] += d[e + k];
            } else {
              pg[k] += d[e + k] * xh;
              pb[k] += d[e + k];
            }
          }
          if constexpr (!kRegAcc) {
            *reinterpret_cast<float4*>(dg_acc + c + e) = sg;
            *reinterpret_cast<float4*>(db_acc + c + e) = sb;
          }
        }
        store_vec<E>(dx + base + c, ds);
        if constexpr (kMode == kLnXPlusDropH) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            ds[e] = (bits >> e) & 1u ? ds[e] * key.scale : 0.f;
        }
        if constexpr (kMode != kLnX) store_vec<E>(dh + base + c, ds);
      }
    }
  }
  if constexpr (kRegAcc) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * 32 + lane) * E;
      if (c < cols) {
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          *reinterpret_cast<float4*>(dg_acc + c + e) = make_float4(
              ag[j][e], ag[j][e + 1], ag[j][e + 2], ag[j][e + 3]);
          *reinterpret_cast<float4*>(db_acc + c + e) = make_float4(
              ab[j][e], ab[j][e + 1], ab[j][e + 2], ab[j][e + 3]);
        }
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
// entries (dgamma, then dbeta), written in TP, in a fixed order: each
// block takes 32 columns, its kLnReduceWarps warps sum every
// kLnReduceWarps-th partial row (a few loads each, all in flight at
// once), then warp 0 adds the warp sums in order.
constexpr int kLnReduceWarps = 32;

template <typename TP>
__global__ void __launch_bounds__(kLnReduceWarps * 32)
    ln_partials_reduce_kernel(const float* __restrict__ partials,
                              TP* __restrict__ out, int nblocks, int width) {
  __shared__ float red[kLnReduceWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int b = w; b < nblocks; b += kLnReduceWarps)
      a += partials[static_cast<long long>(b) * width + col];
  }
  red[w][lane] = a;
  __syncthreads();
  if (w == 0 && col < width) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kLnReduceWarps; ++i) sum += red[i][lane];
    out[col] = from_float<TP>(sum);
  }
}

// warps of a backward block: kLnBwdWarps, or as many (2, cols) f32 slots
// as fit in a block's 227 KB of shared memory
inline int ln_bwd_warps(int cols) {
  const int fit = (227 * 1024) / (2 * cols * static_cast<int>(sizeof(float)));
  return fit < kLnBwdWarps ? fit : kLnBwdWarps;
}

// dx (and dh), and dgamma/dbeta as TP (2, cols) in `dgb`; `partials` is
// the caller's (nblocks, 2, cols) f32 scratch
template <typename TX, typename TH, typename TP, int NV, int kMode>
cudaError_t ln_bwd_launch(const void* x, const void* h, const void* dy,
                          const void* mean, const void* rstd,
                          const void* gamma, void* dx, void* dh,
                          void* partials, void* dgb, int rows, int cols,
                          int nblocks, DropoutKey key, cudaStream_t stream) {
  const int warps = ln_bwd_warps(cols);
  const int smem = warps * 2 * cols * static_cast<int>(sizeof(float));
  auto kernel = ln_bwd_kernel<TX, TH, TP, NV, kMode>;
  static std::atomic<int> opted[kMaxDevices], carved[kMaxDevices];
  cudaError_t err = opt_in_smem(kernel, smem, opted);
  if (err == cudaSuccess) err = prefer_shared(kernel, carved);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, warps * 32, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TH*>(h),
      static_cast<const TX*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const TP*>(gamma),
      static_cast<TX*>(dx), static_cast<TH*>(dh),
      static_cast<float*>(partials), rows, cols, key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_partials_reduce_kernel<TP>
      <<<(2 * cols + 31) / 32, kLnReduceWarps * 32, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<TP*>(dgb), nblocks,
      2 * cols);
  return cudaGetLastError();
}

// NV, the vectors a lane takes of a row: exactly the row's count up to
// 8, then 12, 16, 24 or 32
template <typename TX, typename TH, typename TP, int kMode>
cudaError_t ln_bwd_dispatch(const void* x, const void* h, const void* dy,
                            const void* mean, const void* rstd,
                            const void* g, void* dx, void* dh,
                            void* partials, void* dgb, int rows, int cols,
                            int nblocks, DropoutKey key, cudaStream_t s) {
  constexpr int E = Vec16<TX>::n;
  if (rows <= 0 || cols <= 0 || cols > kLnMaxCols || cols % E || nblocks <= 0)
    return cudaErrorInvalidValue;
  const int nv = (cols + 32 * E - 1) / (32 * E);
#define MX_LN_BWD(NV)                                                  \
  return ln_bwd_launch<TX, TH, TP, NV, kMode>(x, h, dy, mean, rstd, g, \
                                              dx, dh, partials, dgb,   \
                                              rows, cols, nblocks, key, s)
  switch (nv) {
    case 1: MX_LN_BWD(1);
    case 2: MX_LN_BWD(2);
    case 3: MX_LN_BWD(3);
    case 4: MX_LN_BWD(4);
    case 5: MX_LN_BWD(5);
    case 6: MX_LN_BWD(6);
    case 7: MX_LN_BWD(7);
    case 8: MX_LN_BWD(8);
    default: break;
  }
  if (nv <= 12) MX_LN_BWD(12);
  if (nv <= 16) MX_LN_BWD(16);
  if constexpr (E == 4) {
    if (nv <= 24) MX_LN_BWD(24);
    if (nv <= 32) MX_LN_BWD(32);
  }
#undef MX_LN_BWD
  return cudaErrorInvalidValue;
}

}  // namespace mx
