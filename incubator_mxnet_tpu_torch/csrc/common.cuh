// Shared by the port's CUDA sources. Each source is compiled on its own
// into one shared library with a plain C interface, loaded from Python
// with ctypes (see ops/_build.py), so this header is included once per
// library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MX_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes passed by the Python wrappers
enum MxDtype : int { kFloat32 = 0, kBFloat16 = 1 };

MX_EXPORT const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace mx {

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

}  // namespace mx
