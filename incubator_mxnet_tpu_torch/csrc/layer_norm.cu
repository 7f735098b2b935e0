// LayerNorm forward over the last axis of a (rows, C) tensor, f32 maths.
//
// Replaces the TPU kernel `incubator_mxnet_tpu/ops/layer_norm.py`
// `_fwd_kernel` (:49, called through `_fwd` :63): mean first, then the
// centred variance (not E[x^2] - E[x]^2), rstd = rsqrt(var + eps),
// y = (x - mean) * rstd * gamma + beta written in the input dtype, and the
// f32 row statistics (mean, rstd) saved for the backward.
//
// Bound on the H100: bytes. Each row is read once and written once
// (2 * rows * C * itemsize, plus 8 bytes of statistics a row) and the
// arithmetic is a few operations per byte. Design: one warp per row, four
// rows per 128-thread block. The warp reads its row once with 16-byte
// loads into registers (NV vectors per lane), reduces the sum and the
// centred sum of squares with shuffles, and writes y from the registers,
// so x crosses device memory exactly once. C is at most 4096 (32 float4
// or 16 eight-wide bf16 vectors per lane) and a multiple of the vector
// width; the Python wrapper checks both and the 16-byte alignment.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

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

template <typename T, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                          const T* __restrict__ beta, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int rows, int cols,
                          float eps) {
  using V = Vec16<T>;
  constexpr int E = V::n;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * cols;

  float v[NV][E];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    if (c < cols) {
      V::load(xr + c, v[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[j][e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[j][e] = 0.f;
    }
  }
  const float mean = mx::group_sum<32>(sum) / cols;

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
  const float rstd = rsqrtf(mx::group_sum<32>(sq) / cols + eps);

  T* yr = y + row * cols;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * E;
    if (c < cols) {
      float g[E], b[E], out[E];
      V::load(gamma + c, g);
      V::load(beta + c, b);
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = v[j][e] * rstd * g[e] + b[e];
      V::store(yr + c, out);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int NV>
cudaError_t launch(const void* x, const void* g, const void* b, void* y,
                   void* mean, void* rstd, int rows, int cols, float eps,
                   cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layer_norm_fwd_kernel<T, NV><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), rows, cols, eps);
  return cudaGetLastError();
}

// smallest power-of-two vector count per lane that covers `cols`
template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* b, void* y,
                     void* mean, void* rstd, int rows, int cols, float eps,
                     cudaStream_t s) {
  constexpr int E = Vec16<T>::n;
  const int nv = (cols + 32 * E - 1) / (32 * E);
  if (nv <= 1) return launch<T, 1>(x, g, b, y, mean, rstd, rows, cols, eps, s);
  if (nv <= 2) return launch<T, 2>(x, g, b, y, mean, rstd, rows, cols, eps, s);
  if (nv <= 4) return launch<T, 4>(x, g, b, y, mean, rstd, rows, cols, eps, s);
  if (nv <= 8) return launch<T, 8>(x, g, b, y, mean, rstd, rows, cols, eps, s);
  if (nv <= 16) return launch<T, 16>(x, g, b, y, mean, rstd, rows, cols, eps, s);
  if constexpr (E == 4) {
    if (nv <= 32) return launch<T, 32>(x, g, b, y, mean, rstd, rows, cols, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// y, mean, rstd = LayerNorm(x) over rows of `cols` elements, on the
// caller's current device. Returns the cudaError_t of the launch.
MX_EXPORT int mx_layer_norm_fwd(int dtype, const void* x,
                                const void* gamma, const void* beta, void* y,
                                void* mean, void* rstd, int rows, int cols,
                                float eps, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > 4096) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(x, gamma, beta, y, mean, rstd, rows, cols, eps, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, rows, cols,
                                     eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
