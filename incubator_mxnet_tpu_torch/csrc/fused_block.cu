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
// forward's row held in registers, the backward's two passes with per-warp
// dgamma/dbeta slots in shared memory and a fixed-order reduction of the
// per-block partials). C is at most 4096 and a multiple of the vector
// width; the Python wrapper checks both and the 16-byte alignment.
#include "common.cuh"

namespace {

template <typename T>
cudaError_t fwd(int mode, const void* x, const void* h, const void* g,
                const void* b, void* y, void* mean, void* rstd, int rows,
                int cols, float eps, mx::DropoutKey key, cudaStream_t s) {
  switch (mode) {
    case mx::kLnXPlusH:
      return mx::ln_fwd_dispatch<T, mx::kLnXPlusH>(x, h, g, b, y, mean, rstd,
                                                   rows, cols, eps, key, s);
    case mx::kLnXPlusDropH:
      return mx::ln_fwd_dispatch<T, mx::kLnXPlusDropH>(
          x, h, g, b, y, mean, rstd, rows, cols, eps, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd(int mode, const void* x, const void* h, const void* dy,
                const void* mean, const void* rstd, const void* g, void* dx,
                void* dh, void* partials, void* dgb, int rows, int cols,
                int nblocks, mx::DropoutKey key, cudaStream_t s) {
  switch (mode) {
    case mx::kLnXPlusH:
      return mx::ln_bwd_dispatch<T, mx::kLnXPlusH>(x, h, dy, mean, rstd, g, dx,
                                                 dh, partials, dgb, rows, cols,
                                                 nblocks, key, s);
    case mx::kLnXPlusDropH:
      return mx::ln_bwd_dispatch<T, mx::kLnXPlusDropH>(
          x, h, dy, mean, rstd, g, dx, dh, partials, dgb, rows, cols, nblocks,
          key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y, mean, rstd = LN(x + dropout(h)) over rows of `cols` elements. `mode`
// is kLnXPlusH or kLnXPlusDropH; (k0, k1) the key, `threshold` and `scale`
// the keep rule (used in kLnXPlusDropH only). Runs on the caller's current
// device; returns the cudaError_t of the launch.
MX_EXPORT int mx_residual_dropout_ln_fwd(int dtype, int mode, const void* x,
                                         const void* h, const void* gamma,
                                         const void* beta, void* y,
                                         void* mean, void* rstd, int rows,
                                         int cols, float eps, unsigned k0,
                                         unsigned k1, unsigned threshold,
                                         float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mx::DropoutKey key{k0, k1, threshold, scale};
  switch (dtype) {
    case kFloat32:
      return fwd<float>(mode, x, h, gamma, beta, y, mean, rstd, rows, cols,
                        eps, key, s);
    case kBFloat16:
      return fwd<__nv_bfloat16>(mode, x, h, gamma, beta, y, mean, rstd, rows,
                                cols, eps, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dx, dh (rows, cols) in the input dtype and dgamma/dbeta as f32
// (2, cols) in `dgb`, regenerating the forward's mask from the same key.
// `partials` is f32 scratch of (nblocks, 2, cols); a fixed nblocks gives
// the same dgamma/dbeta in every run. Runs on the caller's current
// device; returns the cudaError_t of the launches.
MX_EXPORT int mx_residual_dropout_ln_bwd(
    int dtype, int mode, const void* x, const void* h, const void* dy,
    const void* mean, const void* rstd, const void* gamma, void* dx, void* dh,
    void* partials, void* dgb, int rows, int cols, int nblocks, unsigned k0,
    unsigned k1, unsigned threshold, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mx::DropoutKey key{k0, k1, threshold, scale};
  switch (dtype) {
    case kFloat32:
      return bwd<float>(mode, x, h, dy, mean, rstd, gamma, dx, dh, partials,
                        dgb, rows, cols, nblocks, key, s);
    case kBFloat16:
      return bwd<__nv_bfloat16>(mode, x, h, dy, mean, rstd, gamma, dx, dh,
                                partials, dgb, rows, cols, nblocks, key, s);
    default:
      return cudaErrorInvalidValue;
  }
}
