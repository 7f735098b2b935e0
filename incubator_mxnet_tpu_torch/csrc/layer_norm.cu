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
// statistics); both do a few operations per byte. At the decode's few
// rows (1 to 8) the forward is bound by latency instead: its launch and
// one round trip to device memory. Design (the row code is in
// common.cuh, shared with fused_block.cu): one warp per row, 16-byte
// loads, the loops over a row unrolled for its exact vector count. The
// forward holds its row in registers, so x crosses device memory once
// (streamed: read once, evict first), and issues x, gamma and beta
// together before its first reduction. Both run on the caller's grid
// (`row_blocks` in ops/layer_norm.py): 8-warp blocks, one row a warp while
// rows are few, at most two blocks an SM, all resident, past that, whose
// warps walk the rows. A forward warp keeps its next row's loads in
// flight and gamma/beta in registers, read once a warp. Up to
// C = 1024 a lane holds its row and, up to C = 768, its columns'
// dgamma/dbeta sums in registers. The TPU kernel accumulated dgamma/dbeta across its
// sequential grid in VMEM, but Hopper's blocks run in parallel, so each
// block writes its (2, C) f32 partial and a second kernel sums the
// partials in a fixed order (deterministic, no float atomics) and writes
// them in gamma's dtype. C is at most 4096 and a multiple of the vector
// width; the Python wrapper checks both and the 16-byte alignment.
//
// Layouts (x and y, gamma/beta): both float32, both bfloat16, both
// float16, and bfloat16 or float16 x with float32 gamma/beta, which AMP
// feeds the MLM head's LayerNorm (`models/bert.py` mlm_ln): the row is
// read and written in the 2-byte type, gamma/beta and dgamma/dbeta are
// f32.
#include "common.cuh"

namespace {

template <typename TX, typename TP>
cudaError_t fwd(const void* x, const void* gamma, const void* beta, void* y,
                void* mean, void* rstd, int rows, int cols, float eps,
                int blocks, cudaStream_t s) {
  return mx::ln_fwd_dispatch<TX, TX, TP, mx::kLnX>(
      x, nullptr, gamma, beta, y, mean, rstd, rows, cols, eps, blocks,
      mx::DropoutKey{}, s);
}

template <typename TX, typename TP>
cudaError_t bwd(const void* x, const void* dy, const void* mean,
                const void* rstd, const void* gamma, void* dx, void* partials,
                void* dgb, int rows, int cols, int nblocks, cudaStream_t s) {
  return mx::ln_bwd_dispatch<TX, TX, TP, mx::kLnX>(
      x, nullptr, dy, mean, rstd, gamma, dx, nullptr, partials, dgb, rows,
      cols, nblocks, mx::DropoutKey{}, s);
}

}  // namespace

// y, mean, rstd = LayerNorm(x) over rows of `cols` elements, x and y in
// `dtype`, gamma/beta in `param_dtype` (a layout above), on a grid of
// `blocks` 8-warp blocks (the result does not depend on it), on the
// caller's current device. Returns the cudaError_t of the launch.
MX_EXPORT int mx_layer_norm_fwd(int dtype, int param_dtype, const void* x,
                                const void* gamma, const void* beta, void* y,
                                void* mean, void* rstd, int rows, int cols,
                                float eps, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && param_dtype == kFloat32)
    return fwd<float, float>(x, gamma, beta, y, mean, rstd, rows, cols, eps,
                             blocks, s);
  if (dtype == kBFloat16 && param_dtype == kBFloat16)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd,
                                             rows, cols, eps, blocks, s);
  if (dtype == kBFloat16 && param_dtype == kFloat32)
    return fwd<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, rows,
                                     cols, eps, blocks, s);
  if (dtype == kFloat16 && param_dtype == kFloat16)
    return fwd<__half, __half>(x, gamma, beta, y, mean, rstd, rows, cols, eps,
                               blocks, s);
  if (dtype == kFloat16 && param_dtype == kFloat32)
    return fwd<__half, float>(x, gamma, beta, y, mean, rstd, rows, cols, eps,
                              blocks, s);
  return cudaErrorInvalidValue;
}

// dx (rows, cols) in `dtype` (x's and dy's) and dgamma/dbeta (2, cols) in
// `dgb`, in `param_dtype` (gamma's), from x, dy, the forward's f32
// mean/rstd and gamma. `partials` is f32 scratch of (nblocks, 2, cols);
// nblocks picks the grid (and with it the summation order, so a fixed
// nblocks gives the same dgamma/dbeta in every run). Runs on the caller's
// current device; returns the cudaError_t of the launches.
MX_EXPORT int mx_layer_norm_bwd(int dtype, int param_dtype, const void* x,
                                const void* dy, const void* mean,
                                const void* rstd, const void* gamma, void* dx,
                                void* partials, void* dgb, int rows, int cols,
                                int nblocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && param_dtype == kFloat32)
    return bwd<float, float>(x, dy, mean, rstd, gamma, dx, partials, dgb,
                             rows, cols, nblocks, s);
  if (dtype == kBFloat16 && param_dtype == kBFloat16)
    return bwd<__nv_bfloat16, __nv_bfloat16>(x, dy, mean, rstd, gamma, dx,
                                             partials, dgb, rows, cols,
                                             nblocks, s);
  if (dtype == kBFloat16 && param_dtype == kFloat32)
    return bwd<__nv_bfloat16, float>(x, dy, mean, rstd, gamma, dx, partials,
                                     dgb, rows, cols, nblocks, s);
  if (dtype == kFloat16 && param_dtype == kFloat16)
    return bwd<__half, __half>(x, dy, mean, rstd, gamma, dx, partials, dgb,
                               rows, cols, nblocks, s);
  if (dtype == kFloat16 && param_dtype == kFloat32)
    return bwd<__half, float>(x, dy, mean, rstd, gamma, dx, partials, dgb,
                              rows, cols, nblocks, s);
  return cudaErrorInvalidValue;
}
