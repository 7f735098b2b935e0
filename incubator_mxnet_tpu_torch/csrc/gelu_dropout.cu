// Fused exact-erf GELU + dropout, y = dropout_p(gelu(u)), and its backward
// du = dy * gelu'(u) * mask * scale (K6).
//
// Replaces the TPU kernels `incubator_mxnet_tpu/ops/fused_block.py`
// `_gd_fwd_kernel` (:289) and `_gd_bwd_kernel` (:298), called through
// `_gd_call` (:311). The TPU kernel approximated erf (Abramowitz-Stegun,
// :266-279) because Pallas has no erf lowering there; here Phi(u) is the
// exact 0.5 * (1 + erff(u / sqrt 2)) and phi(u) = expf(-u^2 / 2) /
// sqrt(2 pi), both in f32 (phi underflows to 0 for large |u|, and u * 0 is
// 0, never NaN). The mask is the Philox stream of philox.cuh over the flat
// element index, the stream dropout.cu and fused_block.cu draw, so for one
// key and shape K6 drops exactly the elements K5 drops. As in the
// reference, nothing is saved between the passes: the backward reads u
// and dy and recomputes both the mask and gelu'(u).
//
// Bound on the H100: bytes (forward reads u and writes y, 2 * numel *
// itemsize; backward reads u and dy and writes du, 3 * numel * itemsize).
// The template is dropout.cu: one thread per 16-byte vector (4 f32 or 8
// bf16 elements), a scalar tail when numel is not a multiple of the
// vector width. With kDrop false (p = 0) the kernel draws no Philox words.
// Inputs and outputs are contiguous and 16-byte aligned; the Python
// wrapper sees to both.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// Phi(u), the standard normal CDF
__device__ __forceinline__ float normal_cdf(float u) {
  return 0.5f * (1.f + erff(u * kSqrtHalf));
}

// gelu'(u) = Phi(u) + u * phi(u)
__device__ __forceinline__ float gelu_grad(float u) {
  return normal_cdf(u) + u * (expf(-0.5f * u * u) * kInvSqrt2Pi);
}

// one vector of E elements from flat index i: load the inputs as f32,
// apply `op` to each element with its keep bit, store the result
template <typename T, bool kDrop, typename Op>
__device__ __forceinline__ void elementwise(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            T* __restrict__ out,
                                            long long i, long long n,
                                            const mx::DropoutKey& key,
                                            Op op) {
  using V = mx::Vec16<T>;
  constexpr int E = V::n;
  unsigned words[E];
  if (kDrop) mx::philox_words<E>(static_cast<unsigned long long>(i), key,
                                 words);
  const bool whole = i + E <= n;
  float va[E], vb[E];
  if (whole) {
    V::load(a + i, va);
    if (b != nullptr) V::load(b + i, vb);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      va[e] = i + e < n ? mx::to_float(a[i + e]) : 0.f;
      vb[e] = b != nullptr && i + e < n ? mx::to_float(b[i + e]) : 0.f;
    }
  }
  float r[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float v = op(va[e], vb[e]);
    r[e] = !kDrop ? v : (words[e] >= key.threshold ? v * key.scale : 0.f);
  }
  if (whole) {
    V::store(out + i, r);
  } else {
    for (int e = 0; e < E && i + e < n; ++e)
      out[i + e] = mx::from_float<T>(r[e]);
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    gelu_dropout_fwd_kernel(const T* __restrict__ u, T* __restrict__ y,
                            long long n, mx::DropoutKey key) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) * mx::Vec16<T>::n;
  if (i >= n) return;
  elementwise<T, kDrop>(u, static_cast<const T*>(nullptr), y, i, n, key,
                        [](float v, float) { return v * normal_cdf(v); });
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    gelu_dropout_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dy,
                            T* __restrict__ du, long long n,
                            mx::DropoutKey key) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) * mx::Vec16<T>::n;
  if (i >= n) return;
  elementwise<T, kDrop>(u, dy, du, i, n, key,
                        [](float v, float g) { return g * gelu_grad(v); });
}

unsigned blocks_for(long long n, int e) {
  const long long vecs = (n + e - 1) / e;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks);
}

template <typename T>
cudaError_t launch(const void* u, const void* dy, void* out, long long n,
                   bool drop, mx::DropoutKey key, cudaStream_t s) {
  const unsigned blocks = blocks_for(n, mx::Vec16<T>::n);
  if (blocks == 0) return cudaErrorInvalidValue;
  const T* ut = static_cast<const T*>(u);
  T* ot = static_cast<T*>(out);
  if (dy == nullptr) {
    if (drop)
      gelu_dropout_fwd_kernel<T, true><<<blocks, kThreads, 0, s>>>(ut, ot, n,
                                                                   key);
    else
      gelu_dropout_fwd_kernel<T, false><<<blocks, kThreads, 0, s>>>(ut, ot, n,
                                                                    key);
  } else {
    const T* dt = static_cast<const T*>(dy);
    if (drop)
      gelu_dropout_bwd_kernel<T, true><<<blocks, kThreads, 0, s>>>(ut, dt, ot,
                                                                   n, key);
    else
      gelu_dropout_bwd_kernel<T, false><<<blocks, kThreads, 0, s>>>(ut, dt, ot,
                                                                    n, key);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, const void* u, const void* dy, void* out,
                     long long n, int drop, unsigned k0, unsigned k1,
                     unsigned threshold, float scale, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mx::DropoutKey key{k0, k1, threshold, scale};
  switch (dtype) {
    case kFloat32:
      return launch<float>(u, dy, out, n, drop != 0, key, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(u, dy, out, n, drop != 0, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y = dropout(gelu(u)) over n contiguous elements. With drop = 0 the
// result is gelu(u) and the key is not read; otherwise an element is kept
// where its Philox word under (k0, k1) is >= threshold and then scaled by
// `scale`. Runs on the caller's current device; returns the cudaError_t
// of the launch.
MX_EXPORT int mx_gelu_dropout_fwd(int dtype, const void* u, void* y,
                                  long long n, int drop, unsigned k0,
                                  unsigned k1, unsigned threshold,
                                  float scale, void* stream) {
  return dispatch(dtype, u, nullptr, y, n, drop, k0, k1, threshold, scale,
                  stream);
}

// du = dy * gelu'(u) under the forward's mask and scale (same arguments).
MX_EXPORT int mx_gelu_dropout_bwd(int dtype, const void* u, const void* dy,
                                  void* du, long long n, int drop,
                                  unsigned k0, unsigned k1,
                                  unsigned threshold, float scale,
                                  void* stream) {
  if (dy == nullptr) return cudaErrorInvalidValue;
  return dispatch(dtype, u, dy, du, n, drop, k0, k1, threshold, scale,
                  stream);
}
