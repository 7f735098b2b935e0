// Flash-attention forward: blockwise online-softmax attention, O and the
// per-row logsumexp.
//
// Replaces the TPU kernel `incubator_mxnet_tpu/ops/flash_attention.py`
// `_fwd_kernel` (:57, called through `_fwd` :122) with its masks and
// outputs (:84-119): keys at or past the sequence length are masked,
// causal mode masks cols > rows and skips whole key tiles above the
// diagonal, rows at or past the length (when lengths are given) are
// zeroed and get lse = +inf, empty rows get lse = +inf, otherwise
// lse = m + log(l). O is written in the input dtype, lse in f32.
//
// What bounds it on the H100: operations. Attention over T keys does
// 4*T*d flops for each query row (2*T*d for causal) against 4*d*itemsize
// bytes, far above the card's ~20 flop/byte (f32) balance point. This
// first kernel uses the CUDA cores, not the tensor cores (no wgmma/TMA
// yet), so its ceiling is the 67 TFLOP/s f32 rate. Design: one block of
// 256 threads per (batch*head, 64-row query tile); the sequential kv grid
// axis of the TPU kernel becomes a loop inside the block over 64-key
// tiles staged in shared memory as f32 (K and Q transposed, so a thread
// reads four rows or four columns with one 16-byte load). Each thread
// owns a 4x4 tile of the scores and a 4 x d/16 tile of the output, so
// every shared-memory load feeds four fused multiply-adds. The running
// max, sum and output stay in registers; the row statistics are reduced
// across the 16 threads that share a row with shuffles. Query tiles are
// issued last-first so the longest causal rows start first. The kernel
// reads q, k, v and writes o through (batch, head, time) strides, so the
// (B, T, H, d) layout of a fused QKV projection needs no copy, and it
// masks the ragged edges itself: nothing is padded to the tile size.
#include <math.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4x4 score tile each
constexpr int kLS = kBQ + 4;    // row stride of the transposed tiles
constexpr float kNegInf = -1.0e30f;  // finite, as the TPU kernel's NEG_INF
constexpr int kMaxDevices = 64;

constexpr int smem_floats(int dp) { return 2 * dp * kLS + kBK * dp + kBK * kLS; }

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ lengths,
                     long long sqb, long long sqh, long long sqt,
                     long long skb, long long skh, long long skt,
                     long long svb, long long svh, long long svt,
                     long long sob, long long soh, long long sot, int H,
                     int Tq, int Tk, int d, float sm_scale, int causal) {
  constexpr int DC = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [DP][kLS]  q tile, transposed
  float* kT = qT + DP * kLS;    // [DP][kLS]  k tile, transposed
  float* vs = kT + DP * kLS;    // [kBK][DP]  v tile
  float* pT = vs + kBK * DP;    // [kBK][kLS] probabilities, transposed

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows 4ty.., cols 4tx..
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int len_b = lengths ? max(lengths[b], 0) : Tk;
  const int kv_end = min(len_b, Tk);
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int row = q0 + r;
    qT[c * kLS + r] =
        (row < Tq && c < d) ? mx::to_float(qb[row * sqt + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: the tile's last row is q0 + kBQ - 1, so keys >= q0 + kBQ are
  // masked for every row; keys past the length are masked for all rows
  const int kv_stop = causal ? min(kv_end, q0 + kBQ) : kv_end;
  const int n_tiles = kv_stop > 0 ? (kv_stop + kBK - 1) / kBK : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's vs / pT are consumed
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const int key = k0 + r;
      const bool in = key < Tk && c < d;
      kT[c * kLS + r] = in ? mx::to_float(kb[key * skt + c]) : 0.f;
      vs[r * DP + c] = in ? mx::to_float(vb[key * svt + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[c * kLS + 4 * ty]);
      const float4 bk = *reinterpret_cast<const float4*>(&kT[c * kLS + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool ok[4];
      float mx_row = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        ok[j] = col < kv_end && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * sm_scale : kNegInf;
        mx_row = fmaxf(mx_row, s[i][j]);
      }
      const float m_new = fmaxf(m[i], mx::group_max<16>(mx_row));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + mx::group_sum<16>(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pT[(4 * tx + j) * kLS + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&pT[j * kLS + 4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int hh = 0; hh < DP / 64; ++hh) {
        const float4 bv4 =
            *reinterpret_cast<const float4*>(&vs[j * DP + 64 * hh + 4 * tx]);
        const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][hh * 4 + e] = fmaf(av[i], bv[e], acc[i][hh * 4 + e]);
      }
    }
  }

  T* ob = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Tq) continue;
    const bool valid = lengths == nullptr || row < len_b;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int hh = 0; hh < DP / 64; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * hh + 4 * tx + e;
        if (col < d)
          ob[row * sot + col] =
              mx::from_float<T>(valid ? acc[i][hh * 4 + e] / l_safe : 0.f);
      }
    if (tx == 0)
      lse[static_cast<long long>(bh) * Tq + row] =
          (valid && l[i] > 0.f) ? m[i] + logf(l_safe) : INFINITY;
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* lengths, const long long* st, int B,
                   int H, int Tq, int Tk, int d, float sm_scale, int causal,
                   cudaStream_t stream) {
  const int smem = smem_floats(DP) * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, DP>;
  // above 48 KB of shared memory a kernel must opt in, once per device;
  // two threads that race here both make the same idempotent call
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(lengths), st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], H, Tq, Tk, d,
      sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, const void* lengths, const long long* st,
                     int B, int H, int Tq, int Tk, int d, float sm_scale,
                     int causal, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, lengths, st, B, H, Tq, Tk, d,
                         sm_scale, causal, s);
  return launch<T, 128>(q, k, v, o, lse, lengths, st, B, H, Tq, Tk, d,
                        sm_scale, causal, s);
}

}  // namespace

// o (B, H, Tq, d) and lse (B*H, Tq) from q (B, H, Tq, d), k and v
// (B, H, Tk, d). Each of q, k, v, o is addressed through its (batch,
// head, time) element strides with the last axis contiguous. `lengths` is
// an int32 (B,) vector or null. Runs on the caller's current device.
// Returns the cudaError_t of the launch.
MX_EXPORT int mx_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o,
    void* lse, const void* lengths, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sob, long long soh, long long sot,
    int B, int H, int Tq, int Tk, int d, float sm_scale, int causal,
    void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || d <= 0 || d > 128)
    return cudaErrorInvalidValue;
  const long long st[12] = {sqb, sqh, sqt, skb, skh, skt,
                            svb, svh, svt, sob, soh, sot};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(q, k, v, o, lse, lengths, st, B, H, Tq, Tk, d,
                             sm_scale, causal, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(q, k, v, o, lse, lengths, st, B, H, Tq,
                                     Tk, d, sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
