// Fused residual + dropout + LayerNorm, y = LN(x + dropout_p(h)) over the
// last axis of (rows, C) tensors: forward and backward (K3).
//
// Replaces the TPU kernels `incubator_mxnet_tpu/ops/fused_block.py`
// `_fwd_kernel` (:62, called through `_fwd` :133) and `_bwd_kernel` (:83,
// called through `_bwd` :169): the post-LN transformer's residual site
// (24 per BERT-base step). The forward reads x and h once, draws the
// dropout mask in registers, and writes y plus the f32 row statistics;
// the backward regenerates the mask from the same key instead of reading
// a saved one, and writes dx, dh and dgamma/dbeta.
//
// The mask is Philox4x32-10 over the elements' flat indices (philox.cuh),
// so it does not depend on block sizes: the TPU kernel seeded its stream
// per (seed, grid step) and had to give forward and backward the same
// block rows (`_block_rows` :123); here any launch shape draws the same
// mask, and `ops/dropout.py` draws the same mask for the same key and
// shape. Modes (common.cuh LnMode): p = 0 adds h without the generator,
// as the TPU kernel's `use_rng=False`, so eval passes go through this
// kernel too; 0 < p < 1 drops. At p = 1 nothing of h is left, and the
// Python wrapper runs the LayerNorm kernels (layer_norm.cu) on x instead.
//
// Bound on the H100: bytes. Forward reads x and h and writes y
// (3 * rows * C * itemsize); backward reads x, h and dy and writes dx and
// dh (5 * rows * C * itemsize), plus the f32 statistics. Design: the
// LayerNorm row code of common.cuh (one warp per row, 16-byte loads, the
// forward's row held in registers, x, h and the Philox words of a row in
// flight together and, on the caller's grid, the next row's loads issued
// before the current row's reductions; the backward on a grid of resident
// blocks whose warps walk many rows, its Philox words drawn once a row,
// dgamma/dbeta summed per warp in shared memory and then in a fixed
// order across the per-block partials). C is at most 4096 and a multiple of the vector
// width; the Python wrapper checks both and the 16-byte alignment.
//
// Layouts (x, y, dx and dy; h and dh; gamma/beta and dgamma/dbeta): all
// float32, all bfloat16, and float32 x with bfloat16 h and float32
// gamma/beta, which AMP feeds both residual sites of a BERT cell (the
// residual stream stays f32, the attention and FFN outputs are bf16
// products): 10 bytes an element forward, 16 backward. A lane's vectors
// follow x's width, so h is read 8 bytes at a time at x's offsets, and
// the mask is the one the f32 layout and K5 draw for the same key.
//
// The key comes by value or, through the `_dk` entries, from device
// memory (a site of a step replayed as a CUDA graph; philox.cuh).
#include "common.cuh"

namespace {

template <typename TX, typename TH, typename TP>
cudaError_t fwd(int mode, const void* x, const void* h, const void* g,
                const void* b, void* y, void* mean, void* rstd, int rows,
                int cols, float eps, int blocks, mx::DropoutKey key,
                cudaStream_t s) {
  switch (mode) {
    case mx::kLnXPlusH:
      return mx::ln_fwd_dispatch<TX, TH, TP, mx::kLnXPlusH>(
          x, h, g, b, y, mean, rstd, rows, cols, eps, blocks, key, s);
    case mx::kLnXPlusDropH:
      return mx::ln_fwd_dispatch<TX, TH, TP, mx::kLnXPlusDropH>(
          x, h, g, b, y, mean, rstd, rows, cols, eps, blocks, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TH, typename TP>
cudaError_t bwd(int mode, const void* x, const void* h, const void* dy,
                const void* mean, const void* rstd, const void* g, void* dx,
                void* dh, void* partials, void* dgb, int rows, int cols,
                int nblocks, mx::DropoutKey key, cudaStream_t s) {
  switch (mode) {
    case mx::kLnXPlusH:
      return mx::ln_bwd_dispatch<TX, TH, TP, mx::kLnXPlusH>(
          x, h, dy, mean, rstd, g, dx, dh, partials, dgb, rows, cols,
          nblocks, key, s);
    case mx::kLnXPlusDropH:
      return mx::ln_bwd_dispatch<TX, TH, TP, mx::kLnXPlusDropH>(
          x, h, dy, mean, rstd, g, dx, dh, partials, dgb, rows, cols,
          nblocks, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the layout of (dtype, h_dtype, param_dtype): 0 all f32, 1 all bf16,
// 2 f32 x with bf16 h and f32 gamma/beta, -1 one not instantiated
int layout(int dtype, int h_dtype, int param_dtype) {
  if (dtype == kFloat32 && h_dtype == kFloat32 && param_dtype == kFloat32)
    return 0;
  if (dtype == kBFloat16 && h_dtype == kBFloat16 &&
      param_dtype == kBFloat16)
    return 1;
  if (dtype == kFloat32 && h_dtype == kBFloat16 && param_dtype == kFloat32)
    return 2;
  return -1;
}

int fwd_entry(int dtype, int h_dtype, int param_dtype, int mode,
              const void* x, const void* h, const void* gamma,
              const void* beta, void* y, void* mean, void* rstd, int rows,
              int cols, float eps, int blocks, mx::DropoutKey key,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout(dtype, h_dtype, param_dtype)) {
    case 0:
      return fwd<float, float, float>(mode, x, h, gamma, beta, y, mean, rstd,
                                      rows, cols, eps, blocks, key, s);
    case 1:
      return fwd<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
          mode, x, h, gamma, beta, y, mean, rstd, rows, cols, eps, blocks,
          key, s);
    case 2:
      return fwd<float, __nv_bfloat16, float>(mode, x, h, gamma, beta, y,
                                              mean, rstd, rows, cols, eps,
                                              blocks, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int bwd_entry(int dtype, int h_dtype, int param_dtype, int mode,
              const void* x, const void* h, const void* dy, const void* mean,
              const void* rstd, const void* gamma, void* dx, void* dh,
              void* partials, void* dgb, int rows, int cols, int nblocks,
              mx::DropoutKey key, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout(dtype, h_dtype, param_dtype)) {
    case 0:
      return bwd<float, float, float>(mode, x, h, dy, mean, rstd, gamma, dx,
                                      dh, partials, dgb, rows, cols, nblocks,
                                      key, s);
    case 1:
      return bwd<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
          mode, x, h, dy, mean, rstd, gamma, dx, dh, partials, dgb, rows,
          cols, nblocks, key, s);
    case 2:
      return bwd<float, __nv_bfloat16, float>(mode, x, h, dy, mean, rstd,
                                              gamma, dx, dh, partials, dgb,
                                              rows, cols, nblocks, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y, mean, rstd = LN(x + dropout(h)) over rows of `cols` elements; x and y
// in `dtype`, h in `h_dtype`, gamma/beta in `param_dtype` (a layout
// above). `mode` is kLnXPlusH or kLnXPlusDropH; (k0, k1) the key,
// `threshold` and `scale` the keep rule (used in kLnXPlusDropH only); the
// grid `blocks` 8-warp blocks (the result does not depend on it). Runs
// on the caller's current device; returns the cudaError_t of the launch.
MX_EXPORT int mx_residual_dropout_ln_fwd(
    int dtype, int h_dtype, int param_dtype, int mode, const void* x,
    const void* h, const void* gamma, const void* beta, void* y, void* mean,
    void* rstd, int rows, int cols, float eps, unsigned k0, unsigned k1,
    unsigned threshold, float scale, int blocks, void* stream) {
  return fwd_entry(dtype, h_dtype, param_dtype, mode, x, h, gamma, beta, y,
                   mean, rstd, rows, cols, eps, blocks,
                   mx::DropoutKey{k0, k1, threshold, scale}, stream);
}

// mx_residual_dropout_ln_fwd in kLnXPlusDropH mode with the key's two
// words read from device memory at `key_words` when the kernel runs.
MX_EXPORT int mx_residual_dropout_ln_fwd_dk(
    int dtype, int h_dtype, int param_dtype, const void* x, const void* h,
    const void* gamma, const void* beta, void* y, void* mean, void* rstd,
    int rows, int cols, float eps, const void* key_words, unsigned threshold,
    float scale, int blocks, void* stream) {
  if (key_words == nullptr) return cudaErrorInvalidValue;
  return fwd_entry(dtype, h_dtype, param_dtype, mx::kLnXPlusDropH, x, h,
                   gamma, beta, y, mean, rstd, rows, cols, eps, blocks,
                   mx::DropoutKey{0u, 0u, threshold, scale,
                                  static_cast<const uint2*>(key_words)},
                   stream);
}

// dx (rows, cols) in `dtype`, dh in `h_dtype` and dgamma/dbeta (2, cols)
// in `dgb`, in `param_dtype`, regenerating the forward's mask from the
// same key; dy is in `dtype`. `partials` is f32 scratch of (nblocks, 2,
// cols); a fixed nblocks gives the same dgamma/dbeta in every run. Runs on
// the caller's current device; returns the cudaError_t of the launches.
MX_EXPORT int mx_residual_dropout_ln_bwd(
    int dtype, int h_dtype, int param_dtype, int mode, const void* x,
    const void* h, const void* dy, const void* mean, const void* rstd,
    const void* gamma, void* dx, void* dh, void* partials, void* dgb,
    int rows, int cols, int nblocks, unsigned k0, unsigned k1,
    unsigned threshold, float scale, void* stream) {
  return bwd_entry(dtype, h_dtype, param_dtype, mode, x, h, dy, mean, rstd,
                   gamma, dx, dh, partials, dgb, rows, cols, nblocks,
                   mx::DropoutKey{k0, k1, threshold, scale}, stream);
}

// mx_residual_dropout_ln_bwd in kLnXPlusDropH mode with the key's two
// words read from device memory at `key_words` when the kernel runs.
MX_EXPORT int mx_residual_dropout_ln_bwd_dk(
    int dtype, int h_dtype, int param_dtype, const void* x, const void* h,
    const void* dy, const void* mean, const void* rstd, const void* gamma,
    void* dx, void* dh, void* partials, void* dgb, int rows, int cols,
    int nblocks, const void* key_words, unsigned threshold, float scale,
    void* stream) {
  if (key_words == nullptr) return cudaErrorInvalidValue;
  return bwd_entry(dtype, h_dtype, param_dtype, mx::kLnXPlusDropH, x, h, dy,
                   mean, rstd, gamma, dx, dh, partials, dgb, rows, cols,
                   nblocks,
                   mx::DropoutKey{0u, 0u, threshold, scale,
                                  static_cast<const uint2*>(key_words)},
                   stream);
}
