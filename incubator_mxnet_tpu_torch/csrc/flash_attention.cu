// Flash attention: the forward (K1), blockwise online-softmax attention,
// O and the per-row logsumexp; and the backward (K2), dq, dk and dv.
//
// Forward.
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
//
// Backward. Replaces the TPU kernels `_dq_kernel` (:166) and `_dkv_kernel`
// (:204), called through `_bwd` (:245), with the same split: a pre-pass
// kernel writes delta = rowsum(dO * O) (f32, :250); the dq kernel takes
// one block per (batch*head, 64-row query tile) and loops over 64-key
// tiles; the dk/dv kernel takes one block per (batch*head, 64-key tile)
// and loops over 64-row query tiles. Both recompute P = exp(s - lse) from
// the forward's lse instead of reading a saved P, and
// dS = P * (dO V^T - delta) * scale; dq = dS K, dk = dS^T Q, dv = P^T dO.
// Masks as in the forward: keys at or past the length, causal cols > rows
// (whole tiles skipped: the dq kernel stops at the diagonal, the dk/dv
// kernel starts there), ragged edges. A row with lse = +inf (past the
// length, or with no key) is dead: its P is set to 0 without forming
// exp(s - inf), so it adds exactly zero and never NaN. What bounds it:
// operations, as the forward. The TPU kernels' sequential grid axes and
// VMEM accumulators become loops inside the block with the dq or dk/dv
// accumulators in registers (a 4 x d/16 tile per thread, as the forward's
// output); tiles are staged in shared memory as f32, both transposed
// ([d][64], so a thread reads four rows or keys with one 16-byte load for
// S and dP) and row-major where a product runs over the tile's other axis.
// The dk/dv block keeps K and V transposed for the whole loop and streams
// Q and dO in both layouts; P and then dS share one buffer. That is 117 KB
// of shared memory at d <= 64 and 217 KB at d <= 128 (the dq block: 101
// and 185 KB), opted in above 48 KB. Splitting the work into two kernels
// computes S and dP twice: 7 products of 2 * T^2 * d per (batch, head)
// where 5 are needed, so the operation bound can be reached at 5/7 at
// best.
#include <math.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4x4 score tile each
constexpr int kLS = kBQ + 4;    // row stride of the transposed tiles
constexpr float kNegInf = -1.0e30f;  // finite, as the TPU kernel's NEG_INF

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
  static std::atomic<int> opted[mx::kMaxDevices];
  const cudaError_t err = mx::opt_in_smem(kernel, smem, opted);
  if (err != cudaSuccess) return err;
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

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

// element strides of one tensor's (batch, head, time) axes
struct Bht {
  long long b, h, t;
};

struct BwdStrides {
  Bht q, k, v, o, dO, dq, dk, dv;
};

constexpr int dq_smem_floats(int dp) {
  return 4 * dp * kLS + kBK * dp + kBK * kLS;
}
constexpr int dkv_smem_floats(int dp) {
  return 4 * dp * kLS + 2 * kBQ * dp + kBQ * kLS;
}

// delta[bh * Tq + t] = sum_c dO[b, h, t, c] * O[b, h, t, c], one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                           float* __restrict__ delta, Bht so, Bht sdo, int H,
                           int Tq, int d, long long rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int t = static_cast<int>(r % Tq);
  const long long bh = r / Tq;
  const long long b = bh / H, h = bh % H;
  const T* orow = o + b * so.b + h * so.h + t * so.t;
  const T* drow = dO + b * sdo.b + h * sdo.h + t * sdo.t;
  float a = 0.f;
  for (int c = lane; c < d; c += 32)
    a += mx::to_float(orow[c]) * mx::to_float(drow[c]);
  a = mx::group_sum<32>(a);
  if (lane == 0) delta[r] = a;
}

// stage rows [r0, r0 + 64) of one (batch, head) slice as f32: transposed
// into dstT[c * kLS + r] and, when dst is given, row-major into
// dst[r * DP + c]; rows at or past `n_rows` and columns past d are 0
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           long long st, int r0, int n_rows,
                                           int d, float* dstT, float* dst) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int row = r0 + r;
    const float val =
        (row < n_rows && c < d) ? mx::to_float(src[row * st + c]) : 0.f;
    dstT[c * kLS + r] = val;
    if (dst != nullptr) dst[r * DP + c] = val;
  }
}

// s[i][j] = sum_c aT[c][4ty + i] * bT[c][4tx + j] and likewise
// dp = doT x vT, both over the DP staged columns
template <int DP>
__device__ __forceinline__ void tile_products(const float* aT, const float* bT,
                                              const float* gT, const float* vT,
                                              int ty, int tx, float (&s)[4][4],
                                              float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&aT[c * kLS + 4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&bT[c * kLS + 4 * tx]);
    const float4 g = *reinterpret_cast<const float4*>(&gT[c * kLS + 4 * ty]);
    const float4 w = *reinterpret_cast<const float4*>(&vT[c * kLS + 4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
    const float gv[4] = {g.x, g.y, g.z, g.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], wv[j], dp[i][j]);
      }
  }
}

// acc[i][hh * 4 + e] += sum_r lhsT[r * kLS + 4 * ty + i] * rhs[r * DP + 64 *
// hh + 4 * tx + e] over the 64 rows r of the tile
template <int DP>
__device__ __forceinline__ void acc_product(const float* lhsT, const float* rhs,
                                            int ty, int tx,
                                            float (&acc)[4][DP / 16]) {
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(&lhsT[r * kLS + 4 * ty]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int hh = 0; hh < DP / 64; ++hh) {
      const float4 b =
          *reinterpret_cast<const float4*>(&rhs[r * DP + 64 * hh + 4 * tx]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][hh * 4 + e] = fmaf(av[i], bv[e], acc[i][hh * 4 + e]);
    }
  }
}

// write rows 4 * ty + i of a 64-row tile from acc (columns 64 * hh + 4 * tx
// + e); rows at or past n_rows are not written
template <typename T, int DP>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, long long st,
                                          int r0, int n_rows, int d, int ty,
                                          int tx,
                                          const float (&acc)[4][DP / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int hh = 0; hh < DP / 64; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * hh + 4 * tx + e;
        if (col < d) dst[row * st + col] = mx::from_float<T>(acc[i][hh * 4 + e]);
      }
  }
}

// the f32 lse and delta of rows q0 + 4 * ty + i; a row past Tq gets
// lse = +inf, which marks it dead
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               long long bh, int Tq, int q0,
                                               int ty, float (&l)[4],
                                               float (&dl)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    l[i] = row < Tq ? lse[bh * Tq + row] : INFINITY;
    dl[i] = row < Tq ? delta[bh * Tq + row] : 0.f;
  }
}

// p = exp(s * scale - lse) where the (row, col) pair is live, else 0; then
// s <- dS = p * (dp - delta) * scale. Returns p in `p`.
__device__ __forceinline__ void probs_and_ds(float (&s)[4][4],
                                             const float (&dp)[4][4],
                                             float (&p)[4][4],
                                             const float (&l)[4],
                                             const float (&dl)[4], int q0,
                                             int k0, int ty, int tx,
                                             int kv_end, int causal,
                                             float sm_scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const bool live = l[i] < INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + 4 * tx + j;
      const bool ok = live && col < kv_end && (!causal || col <= row);
      p[i][j] = ok ? expf(s[i][j] * sm_scale - l[i]) : 0.f;
      s[i][j] = p[i][j] * (dp[i][j] - dl[i]) * sm_scale;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        const int* __restrict__ lengths, BwdStrides st, int H,
                        int Tq, int Tk, int d, float sm_scale, int causal) {
  constexpr int DC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;              // [DP][kLS]  q tile, transposed
  float* doT = qT + DP * kLS;    // [DP][kLS]  dO tile, transposed
  float* kT = doT + DP * kLS;    // [DP][kLS]  k tile, transposed
  float* vT = kT + DP * kLS;     // [DP][kLS]  v tile, transposed
  float* ks = vT + DP * kLS;     // [kBK][DP]  k tile
  float* dsT = ks + kBK * DP;    // [kBK][kLS] dS, transposed

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int len_b = lengths ? max(lengths[b], 0) : Tk;
  const int kv_end = min(len_b, Tk);

  stage_tile<T, DP>(q + b * st.q.b + h * st.q.h, st.q.t, q0, Tq, d, qT,
                    nullptr);
  stage_tile<T, DP>(dO + b * st.dO.b + h * st.dO.h, st.dO.t, q0, Tq, d, doT,
                    nullptr);
  float l[4], dl[4];
  load_row_stats(lse, delta, bh, Tq, q0, ty, l, dl);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int kv_stop = causal ? min(kv_end, q0 + kBQ) : kv_end;
  const int n_tiles = kv_stop > 0 ? (kv_stop + kBK - 1) / kBK : 0;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's kT / vT / ks / dsT are consumed
    stage_tile<T, DP>(kb, st.k.t, k0, Tk, d, kT, ks);
    stage_tile<T, DP>(vb, st.v.t, k0, Tk, d, vT, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4];
    tile_products<DP>(qT, kT, doT, vT, ty, tx, s, dp);
    probs_and_ds(s, dp, p, l, dl, q0, k0, ty, tx, kv_end, causal, sm_scale);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dsT[(4 * tx + j) * kLS + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    acc_product<DP>(dsT, ks, ty, tx, acc);
  }
  store_acc<T, DP>(dq + b * st.dq.b + h * st.dq.h, st.dq.t, q0, Tq, d, ty, tx,
                   acc);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, const int* __restrict__ lengths,
                         BwdStrides st, int H, int Tq, int Tk, int d,
                         float sm_scale, int causal) {
  constexpr int DC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;              // [DP][kLS]  k tile, transposed
  float* vT = kT + DP * kLS;     // [DP][kLS]  v tile, transposed
  float* qT = vT + DP * kLS;     // [DP][kLS]  q tile, transposed
  float* doT = qT + DP * kLS;    // [DP][kLS]  dO tile, transposed
  float* qs = doT + DP * kLS;    // [kBQ][DP]  q tile
  float* dos = qs + kBQ * DP;    // [kBQ][DP]  dO tile
  float* pb = dos + kBQ * DP;    // [kBQ][kLS] P, then dS (row-major)

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBK;
  const int len_b = lengths ? max(lengths[b], 0) : Tk;
  const int kv_end = min(len_b, Tk);

  stage_tile<T, DP>(k + b * st.k.b + h * st.k.h, st.k.t, k0, Tk, d, kT,
                    nullptr);
  stage_tile<T, DP>(v + b * st.v.b + h * st.v.h, st.v.t, k0, Tk, d, vT,
                    nullptr);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // rows before the tile's first key see none of it (causal); rows at or
  // past the length are dead; a tile of dead keys gets zeros
  const int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  const int q_end = k0 >= kv_end ? q_begin : (lengths ? min(len_b, Tq) : Tq);
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* dob = dO + b * st.dO.b + h * st.dO.h;
  for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
    __syncthreads();  // the previous tile's buffers are consumed
    stage_tile<T, DP>(qb, st.q.t, q0, Tq, d, qT, qs);
    stage_tile<T, DP>(dob, st.dO.t, q0, Tq, d, doT, dos);
    float l[4], dl[4];
    load_row_stats(lse, delta, bh, Tq, q0, ty, l, dl);
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4];
    tile_products<DP>(qT, kT, doT, vT, ty, tx, s, dp);
    probs_and_ds(s, dp, p, l, dl, q0, k0, ty, tx, kv_end, causal, sm_scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&pb[(4 * ty + i) * kLS + 4 * tx]) =
          make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
    __syncthreads();
    acc_product<DP>(pb, dos, ty, tx, acc_v);  // dv += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&pb[(4 * ty + i) * kLS + 4 * tx]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();
    acc_product<DP>(pb, qs, ty, tx, acc_k);   // dk += dS^T Q
  }
  store_acc<T, DP>(dk + b * st.dk.b + h * st.dk.h, st.dk.t, k0, Tk, d, ty, tx,
                   acc_k);
  store_acc<T, DP>(dv + b * st.dv.b + h * st.dv.h, st.dv.t, k0, Tk, d, ty, tx,
                   acc_v);
}

template <typename T, int DP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dO, const void* lse,
                       void* delta, void* dq, void* dk, void* dv,
                       const void* lengths, const BwdStrides& st, int B, int H,
                       int Tq, int Tk, int d, float sm_scale, int causal,
                       cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(lengths);

  const long long rows = static_cast<long long>(B) * H * Tq;
  flash_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
         kThreads, 0, stream>>>(static_cast<const T*>(o), tdo, fdelta, st.o,
                                st.dO, H, Tq, d, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int dq_smem = dq_smem_floats(DP) * static_cast<int>(sizeof(float));
  auto dq_kernel = flash_bwd_dq_kernel<T, DP>;
  static std::atomic<int> dq_opted[mx::kMaxDevices];
  err = mx::opt_in_smem(dq_kernel, dq_smem, dq_opted);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(B * H, (Tq + kBQ - 1) / kBQ), kThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), lens, st, H, Tq, Tk,
      d, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Tk == 0) return cudaSuccess;

  const int dkv_smem = dkv_smem_floats(DP) * static_cast<int>(sizeof(float));
  auto dkv_kernel = flash_bwd_dkv_kernel<T, DP>;
  static std::atomic<int> dkv_opted[mx::kMaxDevices];
  err = mx::opt_in_smem(dkv_kernel, dkv_smem, dkv_opted);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(B * H, (Tk + kBK - 1) / kBK), kThreads, dkv_smem,
               stream>>>(tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dk),
                         static_cast<T*>(dv), lens, st, H, Tq, Tk, d, sm_scale,
                         causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dO, const void* lse,
                         void* delta, void* dq, void* dk, void* dv,
                         const void* lengths, const BwdStrides& st, int B,
                         int H, int Tq, int Tk, int d, float sm_scale,
                         int causal, cudaStream_t s) {
  if (d <= 64)
    return launch_bwd<T, 64>(q, k, v, o, dO, lse, delta, dq, dk, dv, lengths,
                             st, B, H, Tq, Tk, d, sm_scale, causal, s);
  return launch_bwd<T, 128>(q, k, v, o, dO, lse, delta, dq, dk, dv, lengths,
                            st, B, H, Tq, Tk, d, sm_scale, causal, s);
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

// dq (B, H, Tq, d), dk and dv (B, H, Tk, d) from q, k, v, the forward's o
// and f32 lse (B*H, Tq), and dO. `strides` holds the (batch, head, time)
// element strides of q, k, v, o, dO, dq, dk, dv in that order (24
// values), each with the last axis contiguous; `delta` is f32 scratch of
// (B*H, Tq); `lengths` an int32 (B,) vector or null. Runs on the caller's
// current device. Returns the cudaError_t of the launches.
MX_EXPORT int mx_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* lengths, const long long* strides, int B, int H,
    int Tq, int Tk, int d, float sm_scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || d <= 0 || d > 128)
    return cudaErrorInvalidValue;
  BwdStrides st;
  Bht* dst[8] = {&st.q, &st.k, &st.v, &st.o, &st.dO, &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 8; ++i)
    *dst[i] = Bht{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_bwd<float>(q, k, v, o, dO, lse, delta, dq, dk, dv,
                                 lengths, st, B, H, Tq, Tk, d, sm_scale,
                                 causal, s);
    case kBFloat16:
      return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dO, lse, delta, dq, dk,
                                         dv, lengths, st, B, H, Tq, Tk, d,
                                         sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
