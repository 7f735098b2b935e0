// Dropout, y = x * scale where the element's random word >= threshold,
// else 0 (K5).
//
// Replaces the TPU kernel `incubator_mxnet_tpu/ops/dropout.py`
// `_mask_kernel_body` (:35, called through `_run_kernel` :61), which drew
// its bits from the TPU's hardware generator seeded per grid block. Here
// the bits are Philox4x32-10 over the elements' flat indices under the
// framework key (philox.cuh), the same stream fused_block.cu draws, so the
// two kernels give the same mask for the same key and shape. As in the
// reference, the backward is this kernel run on dy with the same key: no
// mask is saved.
//
// Bound on the H100: bytes (read x, write y: 2 * numel * itemsize). One
// thread per 16-byte vector (4 f32 or 8 bf16 or f16 elements: one or two Philox
// blocks of four words), with a scalar tail when numel is not a multiple
// of the vector width. Inputs and outputs are contiguous and 16-byte
// aligned; the Python wrapper sees to both.
//
// The key comes by value (mx_dropout) or from device memory
// (mx_dropout_dk: a site of a step replayed as a CUDA graph), where the
// fold kernel below writes a step's site keys (philox.cuh fold_key).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   mx::DropoutKey key) {
  using V = mx::Vec16<T>;
  constexpr int E = V::n;
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * E;
  if (i >= n) return;
  key = mx::load_key(key);
  unsigned words[E];
  mx::philox_words<E>(static_cast<unsigned long long>(i), key, words);
  if (i + E <= n) {
    float v[E];
    V::load(x + i, v);
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = words[e] >= key.threshold ? v[e] * key.scale : 0.f;
    V::store(y + i, v);
  } else {
    for (int e = 0; e < E && i + e < n; ++e) {
      const float v = mx::to_float(x[i + e]);
      y[i + e] = mx::from_float<T>(words[e] >= key.threshold ? v * key.scale
                                                             : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, mx::DropoutKey key,
                   cudaStream_t s) {
  constexpr int E = mx::Vec16<T>::n;
  const long long vecs = (n + E - 1) / E;
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dropout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, key);
  return cudaGetLastError();
}

int dispatch(int dtype, const void* x, void* y, long long n,
             mx::DropoutKey key, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, y, n, key, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, y, n, key, s);
    case kFloat16:
      return launch<__half>(x, y, n, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// site j of the table: fold_key(fold_key(base, t), first + j)
__global__ void fold_keys_kernel(const long long* __restrict__ base,
                                 const long long* __restrict__ t,
                                 uint2* __restrict__ table, long long first,
                                 int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint2 step = mx::fold_key(static_cast<unsigned>(base[0]),
                                  static_cast<unsigned>(base[1]),
                                  static_cast<unsigned long long>(*t));
  table[j] = mx::fold_key(step.x, step.y,
                          static_cast<unsigned long long>(first + j));
}

}  // namespace

// y = dropout(x) over n contiguous elements under the key (k0, k1): kept
// where the element's word >= threshold, then scaled by `scale`. Runs on
// the caller's current device; returns the cudaError_t of the launch.
MX_EXPORT int mx_dropout(int dtype, const void* x, void* y, long long n,
                         unsigned k0, unsigned k1, unsigned threshold,
                         float scale, void* stream) {
  return dispatch(dtype, x, y, n, mx::DropoutKey{k0, k1, threshold, scale},
                  stream);
}

// mx_dropout with the key's two words read from device memory at
// `key_words` when the kernel runs.
MX_EXPORT int mx_dropout_dk(int dtype, const void* x, void* y, long long n,
                            const void* key_words, unsigned threshold,
                            float scale, void* stream) {
  if (key_words == nullptr) return cudaErrorInvalidValue;
  return dispatch(dtype, x, y, n,
                  mx::DropoutKey{0u, 0u, threshold, scale,
                                 static_cast<const uint2*>(key_words)},
                  stream);
}

// The site keys first .. first + n - 1 of a step: table[j] (two uint32
// words) = fold_key(fold_key(base, t), first + j), with the base key's
// two words (each < 2^32) and the step counter t read as int64 from
// device memory when the kernel runs. One thread a site.
MX_EXPORT int mx_fold_keys(const void* base, const void* t, void* table,
                           long long first, int n, void* stream) {
  if (n <= 0 || first < 0) return cudaErrorInvalidValue;
  constexpr int kFoldThreads = 64;
  fold_keys_kernel<<<(n + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(base), static_cast<const long long*>(t),
      static_cast<uint2*>(table), first, n);
  return cudaGetLastError();
}
