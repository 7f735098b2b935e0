// Max pooling of integer codes over 1-, 2- and 3-d windows (Q2).
//
// Replaces no Pallas kernel. The reference pools the int8 codes of a
// requantize chain with XLA's reduce_window, the padding being the type's
// minimum (`incubator_mxnet_tpu/numpy_extension/__init__.py:492-498`): max
// commutes with the monotone per-tensor quantization, so the stem's
// convolution emits int8 straight through ResNet's max pool. PyTorch's CUDA
// max pooling takes floating types only.
//
// NC... layout, flattened to (N*C, D, H, W) with unit leading spatial axes
// for 1- and 2-d windows; "valid" and "full" differ only in the output size
// and the high padding, which the wrapper gives. One thread an output
// element walks its window; a position in the padding is the identity (the
// type's minimum), so a window wholly in the padding gives the minimum, as
// reduce_window's does. Bound on the H100: bytes (the input read once, the
// output written once).
#include <cstdint>
#include <limits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct PoolShape {
  long long nc;
  int in[3], out[3], k[3], st[3], pad[3];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_max_pool_kernel(const T* __restrict__ x, T* __restrict__ y,
                         PoolShape s, long long total, T ident) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  long long r = idx;
  const int o2 = static_cast<int>(r % s.out[2]);
  r /= s.out[2];
  const int o1 = static_cast<int>(r % s.out[1]);
  r /= s.out[1];
  const int o0 = static_cast<int>(r % s.out[0]);
  const long long plane = r / s.out[0];
  const T* base = x + plane * s.in[0] * s.in[1] * s.in[2];
  T v = ident;
  for (int a = 0; a < s.k[0]; ++a) {
    const int i0 = o0 * s.st[0] - s.pad[0] + a;
    if (static_cast<unsigned>(i0) >= static_cast<unsigned>(s.in[0])) continue;
    for (int b = 0; b < s.k[1]; ++b) {
      const int i1 = o1 * s.st[1] - s.pad[1] + b;
      if (static_cast<unsigned>(i1) >= static_cast<unsigned>(s.in[1]))
        continue;
      const T* row = base + (static_cast<long long>(i0) * s.in[1] + i1) *
                                s.in[2];
      for (int c = 0; c < s.k[2]; ++c) {
        const int i2 = o2 * s.st[2] - s.pad[2] + c;
        if (static_cast<unsigned>(i2) >= static_cast<unsigned>(s.in[2]))
          continue;
        const T u = row[i2];
        v = u > v ? u : v;
      }
    }
  }
  y[idx] = v;
}

template <typename T>
cudaError_t launch(const void* x, void* y, const PoolShape& s,
                   cudaStream_t stream) {
  const long long total =
      s.nc * s.out[0] * static_cast<long long>(s.out[1]) * s.out[2];
  if (total <= 0) return cudaErrorInvalidValue;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int8_max_pool_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(static_cast<const T*>(x),
                                      static_cast<T*>(y), s, total,
                                      std::numeric_limits<T>::lowest());
  return cudaGetLastError();
}

}  // namespace

// y (nc, out...) = the max over each window of x (nc, in...), integer type
// `dtype` (0 int8, 1 uint8, 2 int16, 3 int32, 4 int64), the three spatial
// axes given in order (1 for the axes a 1- or 2-d window lacks), `pad` the
// low padding of each axis (the high side is implied by `out`). Contiguous
// tensors on the current device; runs on `stream`; returns the
// cudaError_t of the launch.
MX_EXPORT int mx_int8_max_pool(int dtype, const void* x, void* y,
                               long long nc, const int* in, const int* out,
                               const int* k, const int* st, const int* pad,
                               void* stream) {
  PoolShape s;
  s.nc = nc;
  for (int i = 0; i < 3; ++i) {
    if (in[i] <= 0 || out[i] <= 0 || k[i] <= 0 || st[i] <= 0 || pad[i] < 0)
      return cudaErrorInvalidValue;
    s.in[i] = in[i];
    s.out[i] = out[i];
    s.k[i] = k[i];
    s.st[i] = st[i];
    s.pad[i] = pad[i];
  }
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<int8_t>(x, y, s, strm);
    case 1:
      return launch<uint8_t>(x, y, s, strm);
    case 2:
      return launch<int16_t>(x, y, s, strm);
    case 3:
      return launch<int32_t>(x, y, s, strm);
    case 4:
      return launch<long long>(x, y, s, strm);
    default:
      return cudaErrorInvalidValue;
  }
}
