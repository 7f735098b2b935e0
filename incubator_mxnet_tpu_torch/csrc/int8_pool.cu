// Max pooling of integer codes over 1-, 2- and 3-d windows (Q2).
//
// Replaces no Pallas kernel. The reference pools the int8 codes of a
// requantize chain with XLA's reduce_window, the padding being the type's
// minimum (`incubator_mxnet_tpu/numpy_extension/__init__.py:492-498`): max
// commutes with the monotone per-tensor quantization, so the stem's
// convolution emits int8 straight through ResNet's max pool. PyTorch's CUDA
// max pooling takes floating types only.
//
// Two kernels, chosen by shape; "valid" and "full" differ only in the
// output size and the high padding, which the wrapper gives, and a
// position in the padding is the identity (the type's minimum), so a
// window wholly in the padding gives the minimum, as reduce_window's does.
// Bound on the H100: bytes (the input read once, the output written once).
//
// - int8_max_pool_nhwc_kernel: 2-d windows over int8 or uint8 codes in
//   the int8 chain's channels-last layout (NHWC in memory, as Q1 writes
//   them). Where C % 16 == 0 (ResNet's stem pool: C = 64) one thread takes
//   16 channels of one output position: each tap in the input one 16-byte
//   load, the window's maximum byte-wise in four __vmaxs4/__vmaxu4, one
//   16-byte store; neighbouring threads hold neighbouring channels, so a
//   warp reads whole 128-byte lines. Other C: one thread an output byte.
// - int8_max_pool_kernel: every other layout and integer type npx.pooling
//   sends (1- and 3-d windows, int16/int32/int64), NC... contiguous,
//   flattened to (N*C, D, H, W) with unit leading spatial axes for 1- and
//   2-d windows; one thread an output element walks its window.
#include <cstdint>
#include <limits>
#include <type_traits>

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

struct NhwcShape {
  int N, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw;
};

template <typename T>
__device__ __forceinline__ unsigned vmax4(unsigned a, unsigned b) {
  if constexpr (std::is_same<T, int8_t>::value) return __vmaxs4(a, b);
  return __vmaxu4(a, b);
}

// one thread: 16 channels (kVec) or one channel of one output position;
// total = N * Ho * Wo * (C / 16 or C)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_max_pool_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y,
                              NhwcShape s, long long total) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int units = kVec ? s.C / 16 : s.C;
  long long pos = idx / units;
  const int cu = static_cast<int>(idx - pos * units);
  const int ow = static_cast<int>(pos % s.Wo);
  pos /= s.Wo;
  const int oh = static_cast<int>(pos % s.Ho);
  const long long n = pos / s.Ho;
  const T* const img = x + n * s.H * s.W * s.C + (kVec ? 16 * cu : cu);
  const int ih0 = oh * s.sh - s.ph;
  const int iw0 = ow * s.sw - s.pw;
  if constexpr (kVec) {
    // the type's minimum in every byte
    const unsigned lo = std::is_same<T, int8_t>::value ? 0x80808080u : 0u;
    uint4 m = make_uint4(lo, lo, lo, lo);
    for (int r = 0; r < s.kh; ++r) {
      const int ih = ih0 + r;
      if (static_cast<unsigned>(ih) >= static_cast<unsigned>(s.H)) continue;
      for (int q = 0; q < s.kw; ++q) {
        const int iw = iw0 + q;
        if (static_cast<unsigned>(iw) >= static_cast<unsigned>(s.W))
          continue;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            img + (static_cast<long long>(ih) * s.W + iw) * s.C));
        m.x = vmax4<T>(m.x, v.x);
        m.y = vmax4<T>(m.y, v.y);
        m.z = vmax4<T>(m.z, v.z);
        m.w = vmax4<T>(m.w, v.w);
      }
    }
    reinterpret_cast<uint4*>(y)[idx] = m;
  } else {
    T m = std::is_same<T, int8_t>::value ? T(-128) : T(0);
    for (int r = 0; r < s.kh; ++r) {
      const int ih = ih0 + r;
      if (static_cast<unsigned>(ih) >= static_cast<unsigned>(s.H)) continue;
      for (int q = 0; q < s.kw; ++q) {
        const int iw = iw0 + q;
        if (static_cast<unsigned>(iw) >= static_cast<unsigned>(s.W))
          continue;
        const T u = img[(static_cast<long long>(ih) * s.W + iw) * s.C];
        m = u > m ? u : m;
      }
    }
    y[idx] = m;
  }
}

template <typename T>
cudaError_t launch_nhwc(const void* x, void* y, const NhwcShape& s,
                        cudaStream_t stream) {
  const bool vec = s.C % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const long long total = static_cast<long long>(s.N) * s.Ho * s.Wo *
                          (vec ? s.C / 16 : s.C);
  if (total <= 0) return cudaErrorInvalidValue;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* xs = static_cast<const T*>(x);
  auto* ys = static_cast<T*>(y);
  if (vec)
    int8_max_pool_nhwc_kernel<T, true>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xs, ys, s,
                                                                 total);
  else
    int8_max_pool_nhwc_kernel<T, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xs, ys, s,
                                                                 total);
  return cudaGetLastError();
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

// y (N, C, Ho, Wo) = the max over each kh x kw window of x (N, C, H, W),
// both channels-last (NHWC in memory), int8 (dtype 0) or uint8 (1), at
// stride (sh, sw) with low padding (ph, pw) (the high side is implied by
// Ho, Wo). On the current device; runs on `stream`; returns the
// cudaError_t of the launch.
MX_EXPORT int mx_int8_max_pool_nhwc(int dtype, const void* x, void* y, int N,
                                    int H, int W, int C, int Ho, int Wo,
                                    int kh, int kw, int sh, int sw, int ph,
                                    int pw, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 ||
      kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0)
    return cudaErrorInvalidValue;
  const NhwcShape s{N, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw};
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_nhwc<int8_t>(x, y, s, strm);
    case 1:
      return launch_nhwc<uint8_t>(x, y, s, strm);
    default:
      return cudaErrorInvalidValue;
  }
}
