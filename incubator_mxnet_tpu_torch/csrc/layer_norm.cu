// LayerNorm over the last axis of a (rows, C) tensor, f32 maths: forward
// (K4) and backward (K4b).
//
// Replaces the TPU kernels `incubator_mxnet_tpu/ops/layer_norm.py`
// `_fwd_kernel` (:49, called through `_fwd` :63) and `_bwd_kernel` (:93,
// called through `_bwd` :122).
//
// Forward: mean first, then the centred variance (not E[x^2] - E[x]^2),
// rstd = rsqrt(var + eps), y = (x - mean) * rstd * gamma + beta written in
// the input dtype, and the f32 row statistics (mean, rstd) saved for the
// backward. Backward: dx by the reference's formula (layer_norm.py
// :106-110) from x, dy and the saved statistics, and dgamma/dbeta.
//
// Bound on the H100: bytes. The forward reads each row once and writes it
// once (2 * rows * C * itemsize, plus 8 bytes of statistics a row); the
// backward reads x and dy and writes dx (3 * rows * C * itemsize plus the
// statistics); both do a few operations per byte. Design (the row code is
// in common.cuh, shared with fused_block.cu): one warp per row, 16-byte
// loads, the loops over a row unrolled for its width. The forward (four
// rows per 128-thread block) holds its row in registers, so x crosses
// device memory once. The backward (eight warps per block) reads its row
// twice, the second time from L1/L2, and keeps dgamma/dbeta partials in
// shared memory, one slot per warp; the TPU kernel accumulated them
// across its sequential grid in VMEM, but Hopper's blocks run in
// parallel, so each block writes its (2, C) f32 partial and a second
// kernel sums the partials in a fixed order (deterministic, no float
// atomics). C is at most 4096 and a multiple of the vector width; the
// Python wrapper checks both and the 16-byte alignment.
#include "common.cuh"

namespace {

template <typename T>
cudaError_t bwd(const void* x, const void* dy, const void* mean,
                const void* rstd, const void* gamma, void* dx, void* partials,
                void* dgb, int rows, int cols, int nblocks, cudaStream_t s) {
  return mx::ln_bwd_dispatch<T, mx::kLnX>(x, nullptr, dy, mean, rstd, gamma, dx,
                                        nullptr, partials, dgb, rows, cols,
                                        nblocks, mx::DropoutKey{}, s);
}

}  // namespace

// y, mean, rstd = LayerNorm(x) over rows of `cols` elements, on the
// caller's current device. Returns the cudaError_t of the launch.
MX_EXPORT int mx_layer_norm_fwd(int dtype, const void* x,
                                const void* gamma, const void* beta, void* y,
                                void* mean, void* rstd, int rows, int cols,
                                float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return mx::ln_fwd_dispatch<float, mx::kLnX>(
          x, nullptr, gamma, beta, y, mean, rstd, rows, cols, eps,
          mx::DropoutKey{}, s);
    case kBFloat16:
      return mx::ln_fwd_dispatch<__nv_bfloat16, mx::kLnX>(
          x, nullptr, gamma, beta, y, mean, rstd, rows, cols, eps,
          mx::DropoutKey{}, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dx (rows, cols) in the input dtype, and dgamma/dbeta as f32 (2, cols) in
// `dgb`, from x, dy, the forward's f32 mean/rstd and gamma. `partials` is
// f32 scratch of (nblocks, 2, cols); nblocks picks the grid (and with it
// the summation order, so a fixed nblocks gives the same dgamma/dbeta in
// every run). Runs on the caller's current device; returns the
// cudaError_t of the launches.
MX_EXPORT int mx_layer_norm_bwd(int dtype, const void* x, const void* dy,
                                const void* mean, const void* rstd,
                                const void* gamma, void* dx, void* partials,
                                void* dgb, int rows, int cols, int nblocks,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return bwd<float>(x, dy, mean, rstd, gamma, dx, partials, dgb, rows,
                        cols, nblocks, s);
    case kBFloat16:
      return bwd<__nv_bfloat16>(x, dy, mean, rstd, gamma, dx, partials, dgb,
                                rows, cols, nblocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}
