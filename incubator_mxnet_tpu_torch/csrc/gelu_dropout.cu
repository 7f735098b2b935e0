// Fused exact-erf GELU + dropout, y = dropout_p(gelu(u)), and its backward
// du = dy * gelu'(u) * mask * scale (K6).
//
// Replaces the TPU kernels `incubator_mxnet_tpu/ops/fused_block.py`
// `_gd_fwd_kernel` (:289) and `_gd_bwd_kernel` (:298), called through
// `_gd_call` (:311). The TPU kernel approximated erf (Abramowitz-Stegun,
// :266-279) because Pallas has no erf lowering there; here Phi(u) and
// phi(u) come from one f32 rational approximation of the normal tail
// (normal_at below), as accurate as erff's form: gelu(u) = u * Phi(u) and
// gelu'(u) = Phi(u) + u * phi(u) (phi underflows to 0 for large |u|, and
// u * 0 is 0, never NaN). The mask is the Philox stream of philox.cuh over
// the flat element index, the stream dropout.cu and fused_block.cu draw,
// so for one key and shape K6 drops exactly the elements K5 drops. As in
// the reference, nothing is saved between the passes: the backward reads
// u and dy and recomputes both the mask and gelu'(u).
//
// Bound on the H100: bytes (forward reads u and writes y, 2 * numel *
// itemsize; backward reads u and dy and writes du, 3 * numel * itemsize).
// In bf16 with the mask the card has about 40 instruction slots a lane per
// element at that bound; Philox and Phi take most of them (erff's
// two-range form, with its per-range coefficients, took more than all of
// them), and the design spends as few instructions as it can outside
// them: a thread takes kVecs 16-byte vectors (4 f32 or 8 bf16 elements each, a
// block's vectors side by side so a warp's loads are contiguous) and
// issues all its loads before any arithmetic, and only the last block
// checks the end of the tensor, vector by vector, with a scalar tail when
// numel is not a multiple of the vector width. With kDrop false (p = 0)
// the kernel draws no Philox words. The key comes by value or, through
// the `_dk` entries, from device memory (philox.cuh). Inputs and outputs
// are contiguous and 16-byte aligned; the Python wrapper sees to both.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// 16-byte vectors a thread: 2 in bf16 (16 elements), 1 in f32 (4), the
// faster of 1, 2 and 4 on the H100 for each (kernel_ablation.py)
template <typename T>
constexpr int kVecs = sizeof(T) == 2 ? 2 : 1;
constexpr float kNegHalfLog2e = -0.72134752044448170f;  // -log2(e) / 2
constexpr float kInvSqrt2Pi = 0.39894228040143268f;
// Phi(-z) = exp(-z^2 / 2) * (1/2 - z * R(z) / Q(z)) for z >= 0: a rational
// fit of the scaled normal tail Phi(-z) exp(z^2 / 2) on [0, 14] (relative
// error 5.5e-9 in exact arithmetic), written so that near z = 0 the
// correction to 1/2 is small and rounds little. R_k and Q_k are the
// coefficients of z^k.
constexpr float kR0 = 0.3989425003528595f, kR1 = 0.417186975479126f,
                kR2 = 0.19334498047828674f, kR3 = 0.046526357531547546f,
                kR4 = 0.005110615398734808f;
constexpr float kQ1 = 1.6723954677581787f, kQ2 = 1.1993036270141602f,
                kQ3 = 0.4674369692802429f, kQ4 = 0.10120818018913269f,
                kQ5 = 0.010221230797469616f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Phi(u), the standard normal CDF, and phi(u), its density, in f32 on one
// range with no branch and no per-range coefficients: one ex2 (shared by
// Phi and phi), one rcp and 10 multiply-adds. Past |u| = 16 the tail is
// below f32's range and Phi is 0 or 1. Max abs error, against float64,
// of u * Phi(u) and of Phi(u) + u * phi(u) over |u| <= 10 is no larger
// than that of the same formulas through erff (chip_smoke.py measures
// both on the card).
struct Normal {
  float cdf, pdf;
};

__device__ __forceinline__ Normal normal_at(float u) {
  const float z = fminf(fabsf(u), 16.f);
  const float e = ex2_approx(z * z * kNegHalfLog2e);  // exp(-z^2 / 2)
  const float r = fmaf(fmaf(fmaf(fmaf(kR4, z, kR3), z, kR2), z, kR1), z, kR0);
  const float q =
      fmaf(fmaf(fmaf(fmaf(fmaf(kQ5, z, kQ4), z, kQ3), z, kQ2), z, kQ1), z, 1.f);
  const float tail = e * fmaf(-z, r * rcp_approx(q), 0.5f);  // Phi(-z)
  return {u < 0.f ? tail : 1.f - tail, e * kInvSqrt2Pi};
}

// gelu(u) = u * Phi(u)
__device__ __forceinline__ float gelu(float u) { return u * normal_at(u).cdf; }

// gelu'(u) = Phi(u) + u * phi(u)
__device__ __forceinline__ float gelu_grad(float u) {
  const Normal n = normal_at(u);
  return fmaf(u, n.pdf, n.cdf);
}

// The forward (kBwd false: out = dropout(gelu(u))) or the backward (out =
// dy * gelu'(u) under the mask) over the kVecs vectors of one thread.
// kWhole: every vector of the block lies inside n.
template <typename T, bool kDrop, bool kBwd, bool kWhole>
__device__ __forceinline__ void gelu_dropout_vectors(
    const T* __restrict__ u, const T* __restrict__ dy, T* __restrict__ out,
    long long first, long long n, const mx::DropoutKey& key) {
  using V = mx::Vec16<T>;
  constexpr int E = V::n;
  constexpr long long kStride = static_cast<long long>(kThreads) * E;
  float a[kVecs<T>][E], b[kVecs<T>][E];
#pragma unroll
  for (int v = 0; v < kVecs<T>; ++v) {
    const long long i = first + v * kStride;
    if (kWhole || i + E <= n) {
      V::load(u + i, a[v]);
      if (kBwd) V::load(dy + i, b[v]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        a[v][e] = i + e < n ? mx::to_float(u[i + e]) : 0.f;
        b[v][e] = kBwd && i + e < n ? mx::to_float(dy[i + e]) : 0.f;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kVecs<T>; ++v) {
    const long long i = first + v * kStride;
    if (!kWhole && i >= n) break;
    unsigned words[E];
    if (kDrop)
      mx::philox_words<E>(static_cast<unsigned long long>(i), key, words);
    float r[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float x = a[v][e];
      const float g = kBwd ? b[v][e] * gelu_grad(x) : gelu(x);
      r[e] = !kDrop ? g : (words[e] >= key.threshold ? g * key.scale : 0.f);
    }
    if (kWhole || i + E <= n) {
      V::store(out + i, r);
    } else {
      for (int e = 0; e < E && i + e < n; ++e)
        out[i + e] = mx::from_float<T>(r[e]);
    }
  }
}

template <typename T, bool kDrop, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    gelu_dropout_kernel(const T* __restrict__ u, const T* __restrict__ dy,
                        T* __restrict__ out, long long n, mx::DropoutKey key) {
  constexpr int E = mx::Vec16<T>::n;
  if constexpr (kDrop) key = mx::load_key(key);
  constexpr long long kBlockElems =
      static_cast<long long>(kVecs<T>) * kThreads * E;
  const long long block_first =
      static_cast<long long>(blockIdx.x) * kBlockElems;
  const long long first =
      block_first + static_cast<long long>(threadIdx.x) * E;
  if (block_first + kBlockElems <= n)
    gelu_dropout_vectors<T, kDrop, kBwd, true>(u, dy, out, first, n, key);
  else
    gelu_dropout_vectors<T, kDrop, kBwd, false>(u, dy, out, first, n, key);
}

template <typename T>
cudaError_t launch(const void* u, const void* dy, void* out, long long n,
                   bool drop, mx::DropoutKey key, cudaStream_t s) {
  constexpr long long kBlockElems =
      static_cast<long long>(kVecs<T>) * kThreads * mx::Vec16<T>::n;
  const long long blocks = (n + kBlockElems - 1) / kBlockElems;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  const T* ut = static_cast<const T*>(u);
  const T* dt = static_cast<const T*>(dy);
  T* ot = static_cast<T*>(out);
  if (dy == nullptr) {
    if (drop)
      gelu_dropout_kernel<T, true, false><<<nb, kThreads, 0, s>>>(ut, dt, ot,
                                                                  n, key);
    else
      gelu_dropout_kernel<T, false, false><<<nb, kThreads, 0, s>>>(ut, dt, ot,
                                                                   n, key);
  } else {
    if (drop)
      gelu_dropout_kernel<T, true, true><<<nb, kThreads, 0, s>>>(ut, dt, ot,
                                                                 n, key);
    else
      gelu_dropout_kernel<T, false, true><<<nb, kThreads, 0, s>>>(ut, dt, ot,
                                                                  n, key);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, const void* u, const void* dy, void* out,
                     long long n, int drop, mx::DropoutKey key,
                     void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  return dispatch(dtype, u, nullptr, y, n, drop,
                  mx::DropoutKey{k0, k1, threshold, scale}, stream);
}

// mx_gelu_dropout_fwd with the mask, its key's two words read from
// device memory at `key_words` when the kernel runs.
MX_EXPORT int mx_gelu_dropout_fwd_dk(int dtype, const void* u, void* y,
                                     long long n, const void* key_words,
                                     unsigned threshold, float scale,
                                     void* stream) {
  if (key_words == nullptr) return cudaErrorInvalidValue;
  return dispatch(dtype, u, nullptr, y, n, 1,
                  mx::DropoutKey{0u, 0u, threshold, scale,
                                 static_cast<const uint2*>(key_words)},
                  stream);
}

// du = dy * gelu'(u) under the forward's mask and scale (same arguments).
MX_EXPORT int mx_gelu_dropout_bwd(int dtype, const void* u, const void* dy,
                                  void* du, long long n, int drop,
                                  unsigned k0, unsigned k1,
                                  unsigned threshold, float scale,
                                  void* stream) {
  if (dy == nullptr) return cudaErrorInvalidValue;
  return dispatch(dtype, u, dy, du, n, drop,
                  mx::DropoutKey{k0, k1, threshold, scale}, stream);
}

// mx_gelu_dropout_bwd with the mask, its key's two words read from
// device memory at `key_words` when the kernel runs.
MX_EXPORT int mx_gelu_dropout_bwd_dk(int dtype, const void* u,
                                     const void* dy, void* du, long long n,
                                     const void* key_words,
                                     unsigned threshold, float scale,
                                     void* stream) {
  if (dy == nullptr || key_words == nullptr) return cudaErrorInvalidValue;
  return dispatch(dtype, u, dy, du, n, 1,
                  mx::DropoutKey{0u, 0u, threshold, scale,
                                 static_cast<const uint2*>(key_words)},
                  stream);
}
