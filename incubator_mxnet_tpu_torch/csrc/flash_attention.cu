// Flash attention on Hopper's tensor cores: the forward (K1), blockwise
// online-softmax attention, O and the per-row logsumexp; and the backward
// (K2), dq, dk and dv.
//
// Forward. Replaces the TPU kernel `incubator_mxnet_tpu/ops/
// flash_attention.py` `_fwd_kernel` (:57, called through `_fwd` :122)
// with its masks and outputs (:84-119): keys at or past the sequence
// length are masked, causal mode masks cols > rows and skips whole key
// tiles above the diagonal, rows at or past the length (when lengths are
// given) are zeroed and get lse = +inf, empty rows get lse = +inf,
// otherwise lse = m + log(l). O is written in the input dtype, lse in f32.
//
// Backward. Replaces `_dq_kernel` (:166) and `_dkv_kernel` (:204), called
// through `_bwd` (:245), with the same split: a pre-pass writes
// delta = rowsum(dO * O) (f32, :250); the dq kernel takes one block per
// (batch*head, 64-row query tile) and loops over key tiles; the dk/dv
// kernel takes one block per (batch*head, 64-key tile) and loops over
// query tiles. Both recompute P = exp(s - lse) from the forward's lse;
// dS = P * (dO V^T - delta) * scale, dq = dS K, dk = dS^T Q, dv = P^T dO.
// A row with lse = +inf (past the length, or with no key) is dead: its P
// is set to 0 without forming exp(s - inf), so it adds exactly zero. No
// float atomics: each output element is written by one block, so the
// gradients are the same from run to run.
//
// What bounds them on the H100: operations. Attention over T keys does
// 4*T*d flops a query row (2*T*d causal) against 4*d*itemsize bytes. The
// products run on the tensor cores through `wgmma` (sm_90a, see
// sm90.cuh): one warpgroup of 128 threads owns 64 rows (queries in the
// forward and the dq kernel, keys in the dk/dv kernel), and every product
// of a tile is one chain of m64nNk16 (bf16, f16) or m64nNk8 (TF32) steps:
//
//   forward   S = Q K^T (A, B from shared memory), then O += P V with P
//             from registers: the S accumulator is the A fragment of the
//             next product, so P never touches shared memory;
//   dq        S = Q K^T and dP = dO V^T, then dq += dS K, dS from registers;
//   dk/dv     S^T = K Q^T and dP^T = V dO^T (the tile computes the
//             transposed scores directly), then dv += P^T dO and
//             dk += dS^T Q, P^T and dS^T from registers.
//
// The online softmax runs on the accumulator fragments; a row's max and
// sum reduce over the 4 lanes that share it. Following the reference
// (:97, :196, :234, :236), bf16 and f16 inputs round P and dS to their own
// type before the second product of each pair; f32 inputs keep them f32.
// Scores, the softmax statistics and every accumulator are f32 in all
// three, and masked scores take the finite -1e30 in f32, so a float16 run
// overflows only where a rounded P or dS (or an output) passes 65504.
//
// The two 2-byte types share every tile, layout and staging path; only
// the wgmma instruction (.bf16 or .f16) and the rounding differ, so "bf16"
// below stands for both. bf16: Q, K, V, dO are copied into 128-byte-swizzled tiles with 16-byte
// `cp.async` (zero-filled past d and past the last row; a chunk whose
// source is not 16-byte aligned, e.g. odd d, is copied by scalar loads)
// in a ring of two stages, so the next tile's copy overlaps the current
// tile's products. A B operand that the product reads along its rows (V
// in P V, K in dS K, dO and Q in the dk/dv products) is the same tile
// described MN-major: no transposed copy.
//
// f32 runs the same products as 3xTF32, f32-accurate (PyTorch's
// memory-efficient attention does the same on sm80+): staging splits each
// value x into hi = tf32(x) and lo = tf32(x - hi) and stores both; each
// product is lo*hi + hi*lo + hi*hi, in that order, into one f32
// accumulator, and P and dS are split likewise in registers. TF32 wgmma
// reads shared memory only K-major, so the staging pass also writes the
// transposed tiles the second products need (V^T, K^T, Q^T, dO^T), with
// the depth permuted inside each group of 8 to match the accumulator-fed
// A fragment (sm90.cuh). The split needs the values in registers, so f32
// tiles are loaded by plain 16-byte loads into registers, as 4 x 4
// blocks that feed both the K-major and the transposed store (F32Tile).
// The forward and the dq kernel load the next K, V tile during this
// tile's products at d <= 64; at d > 64 the registers are short and a
// tile is loaded when it is stored. The dk/dv kernel loads Q, dO for
// S^T and dP^T, then writes Q^T, dO^T over them for the second products:
// at 96 KB (d <= 64) two blocks share an SM and overlap each other's
// loads, which measured faster than 128 KB with Q^T, dO^T apart and the
// loads one tile ahead.
//
// Tiles: d is padded with zeros to DP = 64 or 128. The loop tile is 64
// rows for bf16 at d <= 64 and 32 rows otherwise (f32, d > 64), which
// keeps every block within the 227 KB of shared memory. Shared memory
// per block (d <= 64 / d <= 128): bf16 forward 40 / 48 KB, dq 48 / 64 KB,
// dk/dv 48 / 64 KB; f32 forward 64 / 128 KB, dq 112 / 224 KB, dk/dv
// 96 / 192 KB. Query
// tiles are issued last-first so the longest causal rows start first.
// The kernels read q, k, v, o, dO and write o, dq, dk, dv through
// (batch, head, time) strides, so the (B, T, H, d) views of one fused QKV
// projection need no copy; they mask the ragged edges themselves.
//
// Not yet: TMA copies, warp specialisation (a producer warp and two
// consumer warpgroups), intra-warpgroup overlap of softmax and products,
// and a one-kernel backward with atomic dq (5 products instead of 7).
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace mx::sm90;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows a warpgroup owns (wgmma's M)
constexpr int kDeltaThreads = 256;
constexpr int kDeltaLanes = 8;  // lanes of the delta pre-pass a row
constexpr float kNegInf = -1.0e30f;  // finite, as the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Op {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBytes = kF32 ? 4 : 2;  // operand element in smem
  static constexpr int kStep = 32 / kBytes;    // depth of one wgmma step
};

// rows of the loop tile: keys (forward, dq) or queries (dk/dv)
template <typename T, int DP>
constexpr int tile_len() {
  return (Op<T>::kF32 || DP == 128) ? 32 : 64;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- staging ----------------------------------------------------------------

// rows [r0, r0 + R) of a bf16 or f16 matrix (row stride st, d columns) into a
// swizzled tile of depth DP with 16-byte cp.async. A tile whose rows are
// all in range, with d = DP and 16-byte aligned rows, takes the plain
// loop; otherwise each chunk is zero-filled past d, a chunk whose source
// is not 16-byte aligned is copied by scalar loads, and rows at or past
// n_rows are zeros. The caller commits and waits.
template <int R, int DP>
__device__ __forceinline__ void load_h16(uint8_t* tile, const void* src_any,
                                         long long st, int r0, int n_rows,
                                         int d) {
  constexpr int CH = DP / 8;
  const uint16_t* src = static_cast<const uint16_t*>(src_any);
  const uint16_t* base = src + static_cast<long long>(r0) * st;
  const bool full =
      r0 + R <= n_rows && d == DP &&
      ((reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(2 * st)) &
       15) == 0;
  if (full) {
#pragma unroll
    for (int i = 0; i < R * CH / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / CH, c = idx % CH;
      cp_async16(smem_u32(tile + swz(R, r, 16 * c)), base + r * st + 8 * c,
                 16);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < R * CH; idx += kThreads) {
    const int r = idx / CH, c = idx % CH;
    const int n = r0 + r < n_rows ? min(max(d - 8 * c, 0), 8) : 0;
    uint8_t* dst = tile + swz(R, r, 16 * c);
    const uint16_t* p = base + r * st + 8 * c;
    if (n > 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      cp_async16(smem_u32(dst), p, 2 * n);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = 2 * e < n ? p[2 * e] : 0u;
        const uint32_t hi = 2 * e + 1 < n ? p[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// `n` (0..4) floats at p, zeros after; one 16-byte load where it can
__device__ __forceinline__ float4 load4(const float* p, int n) {
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? p[e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float lane_of(const float4& f, int u) {
  return u == 0 ? f.x : u == 1 ? f.y : u == 2 ? f.z : f.w;
}

__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, int off,
                                            float a, float b, float c,
                                            float d) {
  uint32_t h[4], l[4];
  split_tf32(a, h[0], l[0]);
  split_tf32(b, h[1], l[1]);
  split_tf32(c, h[2], l[2]);
  split_tf32(d, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Rows [r0, r0 + R) of an f32 matrix (row stride st, d columns; zeros past
// d and past n_rows) stored as TF32 hi and lo tiles, through registers in
// 4 x 4 blocks: the thread's block i covers rows 8 (g / 2) + g % 2 + 2 e
// (e < 4) and columns 4 c .. 4 c + 3 (blk = threadIdx.x + i * kThreads,
// c = blk % (DP / 4), g = blk / (DP / 4)), so one set of 16-byte loads
// feeds both stores: K-major (a row's 4 columns) and transposed (a
// column's 4 rows, which are the depth slots 4 (g % 2) .. + 3 of group
// g / 2 in the TF32 order of sm90.cuh). A tile held in an F32Tile can be
// loaded one iteration ahead, so the loads overlap the products; copy_k
// and copy_t move one block at a time where registers are short.
template <int R, int DP>
struct F32Tile {
  static constexpr int kPer = R * DP / 16 / kThreads;
  float4 v[kPer][4];

  static __device__ __forceinline__ void load_block(int i, float4 (&b)[4],
                                                    const float* src,
                                                    long long st, int r0,
                                                    int n_rows, int d) {
    const int blk = threadIdx.x + i * kThreads;
    const int c = blk % (DP / 4), g = blk / (DP / 4);
    const int n = min(max(d - 4 * c, 0), 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (g >> 1) + (g & 1) + 2 * e;
      b[e] = (row < n_rows && n > 0)
                 ? load4(src + static_cast<long long>(row) * st + 4 * c, n)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // K-major: R rows, depth DP
  static __device__ __forceinline__ void store_k_block(int i,
                                                       const float4 (&b)[4],
                                                       uint8_t* hi,
                                                       uint8_t* lo) {
    const int blk = threadIdx.x + i * kThreads;
    const int c = blk % (DP / 4), g = blk / (DP / 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_split(hi, lo, swz(R, 8 * (g >> 1) + (g & 1) + 2 * e, 16 * c),
                  b[e].x, b[e].y, b[e].z, b[e].w);
  }

  // transposed: DP rows (the columns), depth R (the rows, permuted)
  static __device__ __forceinline__ void store_t_block(int i,
                                                       const float4 (&b)[4],
                                                       uint8_t* hi,
                                                       uint8_t* lo) {
    const int blk = threadIdx.x + i * kThreads;
    const int c = blk % (DP / 4), g = blk / (DP / 4);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      store_split(hi, lo, swz(DP, 4 * c + u, 16 * g), lane_of(b[0], u),
                  lane_of(b[1], u), lane_of(b[2], u), lane_of(b[3], u));
  }

  __device__ __forceinline__ void load(const float* src, long long st,
                                       int r0, int n_rows, int d) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) load_block(i, v[i], src, st, r0, n_rows, d);
  }
  __device__ __forceinline__ void store_k(uint8_t* hi, uint8_t* lo) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) store_k_block(i, v[i], hi, lo);
  }
  __device__ __forceinline__ void store_t(uint8_t* hi, uint8_t* lo) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) store_t_block(i, v[i], hi, lo);
  }

  template <bool kTransposed>
  static __device__ __forceinline__ void copy(const float* src, long long st,
                                              int r0, int n_rows, int d,
                                              uint8_t* hi, uint8_t* lo) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float4 b[4];
      load_block(i, b, src, st, r0, n_rows, d);
      if constexpr (kTransposed)
        store_t_block(i, b, hi, lo);
      else
        store_k_block(i, b, hi, lo);
    }
  }
};

// ---- products of one tile ---------------------------------------------------

// acc (64 x N) += A B^T over depth DP, A and B K-major tiles (f32: hi at
// a / b, lo one tile further at a + a_lo / b + b_lo)
template <typename T, int DP, int N>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], uint32_t a,
                                           int a_rows, int a_lo, uint32_t b,
                                           int b_lo) {
  constexpr int KS = DP / Op<T>::kStep;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (Op<T>::kF32) {
      mma_ss<float, N>(acc, desc_k(a + a_lo, a_rows, ks), desc_k(b, N, ks));
      mma_ss<float, N>(acc, desc_k(a, a_rows, ks), desc_k(b + b_lo, N, ks));
      mma_ss<float, N>(acc, desc_k(a, a_rows, ks), desc_k(b, N, ks));
    } else {
      mma_ss<T, N>(acc, desc_k(a, a_rows, ks), desc_k(b, N, ks));
    }
  }
}

// acc (64 x DP) += X B, X (64 x BT) the accumulator of an earlier product
// (f32, rounded or split here) and B the BT x DP operand: bf16, a tile of
// BT rows read MN-major; f32, the transposed tile (DP rows, depth BT) with
// its lo one tile further (b_lo). Registers handed to wgmma are held until
// the caller's wait.
template <typename T, int DP, int BT>
struct RegProduct {
  static constexpr int kRegs = Op<T>::kF32 ? BT / 2 : BT / 4;
  uint32_t hi[kRegs];
  uint32_t lo[Op<T>::kF32 ? BT / 2 : 1];

  __device__ __forceinline__ void load(const float (&x)[BT / 2]) {
    if constexpr (Op<T>::kF32) {
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        split_tf32(x[4 * j], hi[4 * j], lo[4 * j]);
        split_tf32(x[4 * j + 2], hi[4 * j + 1], lo[4 * j + 1]);
        split_tf32(x[4 * j + 1], hi[4 * j + 2], lo[4 * j + 2]);
        split_tf32(x[4 * j + 3], hi[4 * j + 3], lo[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BT / 4; ++i)
        hi[i] = pack2<T>(x[2 * i], x[2 * i + 1]);
    }
  }

  __device__ __forceinline__ void issue(float (&acc)[DP / 2], uint32_t b,
                                        int b_lo) {
    if constexpr (Op<T>::kF32) {
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const uint32_t* h = hi + 4 * j;
        const uint32_t* l = lo + 4 * j;
        mma_rs<float, DP>(acc, l[0], l[1], l[2], l[3], desc_k(b, DP, j));
        mma_rs<float, DP>(acc, h[0], h[1], h[2], h[3], desc_k(b + b_lo, DP, j));
        mma_rs<float, DP>(acc, h[0], h[1], h[2], h[3], desc_k(b, DP, j));
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        const uint32_t* h = hi + 4 * kk;
        mma_rs<T, DP>(acc, h[0], h[1], h[2], h[3], desc_mn(b, BT, kk));
      }
    }
  }

  __device__ __forceinline__ void hold_regs() {
    hold(hi);
    hold(lo);
  }
};

template <int n>
__device__ __forceinline__ void zero(float (&a)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) a[i] = 0.f;
}

// write rows r0 + row_a (+ 8) of a 64 x DP accumulator: rows at or past
// n_rows and columns at or past d are not written; values times `mul`
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long st,
                                           int r0, int n_rows, int d,
                                           const float (&acc)[DP / 2],
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x & 31;
  const int row_a = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col_t = 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + row_a + 8 * hh;
    if (row >= n_rows) continue;
    T* out = dst + static_cast<long long>(row) * st;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col_t;
      const float x0 = acc[4 * j + 2 * hh] * mul[hh];
      const float x1 = acc[4 * j + 2 * hh + 1] * mul[hh];
      T* at = out + col;
      if (col + 1 < d &&
          (reinterpret_cast<uintptr_t>(at) & (2 * sizeof(T) - 1)) == 0) {
        if constexpr (Op<T>::kF32)
          *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
        else
          *reinterpret_cast<typename mx::Half2<T>::pair*>(at) =
              mx::Half2<T>::narrow(x0, x1);
      } else {
        if (col < d) at[0] = mx::from_float<T>(x0);
        if (col + 1 < d) at[1] = mx::from_float<T>(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------

template <typename T, int DP>
struct FwdSmem {
  static constexpr int BT = tile_len<T, DP>();
  static constexpr int QT = kRows * DP * Op<T>::kBytes;  // the query tile
  static constexpr int KT = BT * DP * Op<T>::kBytes;     // a key/value tile
  // f32: Q hi, lo | K hi, lo | V^T hi, lo.  bf16: Q | K, V | K, V (ring)
  static constexpr int bytes = (Op<T>::kF32 ? 2 : 1) * QT + 4 * KT + 1024;
};

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
  using L = FwdSmem<T, DP>;
  constexpr bool F32 = Op<T>::kF32;
  constexpr int BT = L::BT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const kv = qs + (F32 ? 2 : 1) * L::QT;

  const int lane = threadIdx.x & 31;
  const int row_a = 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row_a + 8
  const int col_t = 2 * (lane & 3);  // columns 8 j + col_t and the next
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int len_b = lengths ? max(lengths[b], 0) : Tk;
  const int kv_end = min(len_b, Tk);
  // causal: keys past the tile's last row q0 + 63 are masked for every row
  const int kv_stop = causal ? min(kv_end, q0 + kRows) : kv_end;
  const int n_tiles = kv_stop > 0 ? (kv_stop + BT - 1) / BT : 0;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  // f32: K and V tiles in registers; at d <= 64 the next tile's, loaded
  // during this tile's products (at d > 64 the registers are short)
  constexpr bool kAhead = DP == 64;
  F32Tile<BT, DP> kr, vr;
  if constexpr (F32) {
    F32Tile<kRows, DP>::template copy<false>(qb, sqt, q0, Tq, d, qs,
                                             qs + L::QT);
    if (kAhead && n_tiles > 0) {
      kr.load(kb, skt, 0, Tk, d);
      vr.load(vb, svt, 0, Tk, d);
    }
  } else {
    load_h16<kRows, DP>(qs, qb, sqt, q0, Tq, d);
    if (n_tiles > 0) {
      load_h16<BT, DP>(kv, kb, skt, 0, Tk, d);
      load_h16<BT, DP>(kv + L::KT, vb, svt, 0, Tk, d);
    }
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 2];
  zero(acc);
  const float scale2 = sm_scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    uint8_t* kt;  // K (f32: hi, then lo)
    uint8_t* vt;  // bf16: V; f32: V^T hi, then lo
    if constexpr (F32) {
      __syncthreads();  // every warp's products of the previous tile are done
      kt = kv;
      vt = kv + 2 * L::KT;
      if (kAhead) {
        kr.store_k(kt, kt + L::KT);
        vr.store_t(vt, vt + L::KT);
      } else {
        F32Tile<BT, DP>::template copy<false>(kb, skt, k0, Tk, d, kt,
                                              kt + L::KT);
        F32Tile<BT, DP>::template copy<true>(vb, svt, k0, Tk, d, vt,
                                             vt + L::KT);
      }
    } else {
      cp_async_wait_all();
      kt = kv + (t & 1) * 2 * L::KT;
      vt = kt + L::KT;
    }
    fence_async_smem();
    __syncthreads();
    // the next tile's loads overlap this tile's products
    if (t + 1 < n_tiles) {
      if constexpr (F32) {
        if (kAhead) {
          kr.load(kb, skt, k0 + BT, Tk, d);
          vr.load(vb, svt, k0 + BT, Tk, d);
        }
      } else {
        uint8_t* nk = kv + ((t + 1) & 1) * 2 * L::KT;
        load_h16<BT, DP>(nk, kb, skt, k0 + BT, Tk, d);
        load_h16<BT, DP>(nk + L::KT, vb, svt, k0 + BT, Tk, d);
      }
    }
    if constexpr (!F32) cp_async_commit();

    float s[BT / 2];
    zero(s);
    hold(s);
    wg_fence();
    product_ss<T, DP, BT>(s, smem_u32(qs), kRows, L::QT, smem_u32(kt), L::KT);
    wg_commit();
    wg_wait_all();
    hold(s);

    // online softmax in the log2 domain
    const bool edge = k0 + BT > kv_end || (causal && k0 + BT - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int hh = (i >> 1) & 1;
      float x = s[i] * scale2;
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + col_t + (i & 1);
        const int row = q0 + row_a + 8 * hh;
        if (col >= kv_end || (causal && col > row)) x = kNegInf;
      }
      s[i] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int hh = (i >> 1) & 1;
      const float p =
          edge && s[i] == kNegInf ? 0.f : exp2f(s[i] - m[hh]);
      s[i] = p;
      rs[hh] += p;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + quad_sum(rs[hh]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V, P from registers (bf16: rounded, as the reference at :97)
    RegProduct<T, DP, BT> pv;
    pv.load(s);
    pv.hold_regs();
    hold(acc);
    wg_fence();
    pv.issue(acc, smem_u32(vt), L::KT);
    wg_commit();
    wg_wait_all();
    hold(acc);
    pv.hold_regs();
  }
  if constexpr (!F32) cp_async_wait_all();

  float inv[2];
  const int lrow = q0 + row_a;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = lrow + 8 * hh;
    const bool valid = lengths == nullptr || row < len_b;
    inv[hh] = (valid && l[hh] > 0.f) ? 1.f / l[hh] : 0.f;
    if ((lane & 3) == 0 && row < Tq)
      lse[static_cast<long long>(bh) * Tq + row] =
          (valid && l[hh] > 0.f) ? (m[hh] + log2f(l[hh])) * kLn2 : INFINITY;
  }
  store_rows<T, DP>(o + b * sob + h * soh, sot, q0, Tq, d, acc, inv);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const void* lengths, const long long* st, int B,
                   int H, int Tq, int Tk, int d, float sm_scale, int causal,
                   cudaStream_t stream) {
  const int smem = FwdSmem<T, DP>::bytes;
  auto kernel = flash_fwd_kernel<T, DP>;
  static std::atomic<int> opted[mx::kMaxDevices];
  const cudaError_t err = mx::opt_in_smem(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
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

// delta[bh * Tq + t] = sum_c dO[b, h, t, c] * O[b, h, t, c]: kDeltaLanes
// lanes a row, 16-byte loads where both rows are 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                           float* __restrict__ delta, Bht so, Bht sdo, int H,
                           int Tq, int d, long long rows) {
  constexpr int V = mx::Vec16<T>::n;
  const long long r =
      static_cast<long long>(blockIdx.x) * (kDeltaThreads / kDeltaLanes) +
      threadIdx.x / kDeltaLanes;
  const int sub = threadIdx.x % kDeltaLanes;
  float a = 0.f;
  if (r < rows) {
    const int t = static_cast<int>(r % Tq);
    const long long bh = r / Tq;
    const long long b = bh / H, h = bh % H;
    const T* orow = o + b * so.b + h * so.h + t * so.t;
    const T* drow = dO + b * sdo.b + h * sdo.h + t * sdo.t;
    const bool vec = ((reinterpret_cast<uintptr_t>(orow) |
                       reinterpret_cast<uintptr_t>(drow)) & 15) == 0;
    for (int c = sub * V; c < d; c += kDeltaLanes * V) {
      if (vec && c + V <= d) {
        float x[V], y[V];
        mx::Vec16<T>::load(orow + c, x);
        mx::Vec16<T>::load(drow + c, y);
#pragma unroll
        for (int e = 0; e < V; ++e) a += x[e] * y[e];
      } else {
        for (int e = 0; e < V && c + e < d; ++e)
          a += mx::to_float(orow[c + e]) * mx::to_float(drow[c + e]);
      }
    }
  }
  a = mx::group_sum<kDeltaLanes>(a);
  if (r < rows && sub == 0) delta[r] = a;
}

template <typename T, int DP>
struct DqSmem {
  static constexpr int BT = tile_len<T, DP>();
  static constexpr int QT = kRows * DP * Op<T>::kBytes;
  static constexpr int KT = BT * DP * Op<T>::kBytes;
  // f32: Q hi, lo | dO hi, lo | K hi, lo | V hi, lo | K^T hi, lo
  // bf16: Q | dO | K, V | K, V (ring)
  static constexpr int bytes =
      (Op<T>::kF32 ? 4 * QT + 6 * KT : 2 * QT + 4 * KT) + 1024;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        const int* __restrict__ lengths, BwdStrides st, int H,
                        int Tq, int Tk, int d, float sm_scale, int causal) {
  using L = DqSmem<T, DP>;
  constexpr bool F32 = Op<T>::kF32;
  constexpr int BT = L::BT;
  constexpr int QN = F32 ? 2 : 1;  // tiles a staged matrix takes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const qs = align1024(smem_raw);
  uint8_t* const dos = qs + QN * L::QT;
  uint8_t* const kv = dos + QN * L::QT;

  const int lane = threadIdx.x & 31;
  const int row_a = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int len_b = lengths ? max(lengths[b], 0) : Tk;
  const int kv_end = min(len_b, Tk);
  const int kv_stop = causal ? min(kv_end, q0 + kRows) : kv_end;
  const int n_tiles = kv_stop > 0 ? (kv_stop + BT - 1) / BT : 0;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* dob = dO + b * st.dO.b + h * st.dO.h;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;

  // f32: K and V tiles in registers, one ahead at d <= 64 (as the forward)
  constexpr bool kAhead = DP == 64;
  F32Tile<BT, DP> kr, vr;
  if constexpr (F32) {
    F32Tile<kRows, DP>::template copy<false>(qb, st.q.t, q0, Tq, d, qs,
                                             qs + L::QT);
    F32Tile<kRows, DP>::template copy<false>(dob, st.dO.t, q0, Tq, d, dos,
                                             dos + L::QT);
    if (kAhead && n_tiles > 0) {
      kr.load(kb, st.k.t, 0, Tk, d);
      vr.load(vb, st.v.t, 0, Tk, d);
    }
  } else {
    load_h16<kRows, DP>(qs, qb, st.q.t, q0, Tq, d);
    load_h16<kRows, DP>(dos, dob, st.dO.t, q0, Tq, d);
    if (n_tiles > 0) {
      load_h16<BT, DP>(kv, kb, st.k.t, 0, Tk, d);
      load_h16<BT, DP>(kv + L::KT, vb, st.v.t, 0, Tk, d);
    }
    cp_async_commit();
  }

  // this thread's rows: lse in the log2 domain (+inf: dead) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + row_a + 8 * hh;
    const long long at = static_cast<long long>(bh) * Tq + row;
    lse2[hh] = row < Tq ? lse[at] * kLog2e : INFINITY;
    dl[hh] = row < Tq ? delta[at] : 0.f;
  }

  float acc[DP / 2];
  zero(acc);
  const float scale2 = sm_scale * kLog2e;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BT;
    uint8_t* kt;   // K (f32: hi, lo)
    uint8_t* vt;   // V (f32: hi, lo)
    uint8_t* ktt;  // B of dS K: bf16 K read MN-major; f32 K^T hi, lo
    if constexpr (F32) {
      __syncthreads();
      kt = kv;
      vt = kv + 2 * L::KT;
      ktt = kv + 4 * L::KT;
      if (!kAhead) kr.load(kb, st.k.t, k0, Tk, d);
      kr.store_k(kt, kt + L::KT);
      kr.store_t(ktt, ktt + L::KT);
      if (kAhead)
        vr.store_k(vt, vt + L::KT);
      else
        F32Tile<BT, DP>::template copy<false>(vb, st.v.t, k0, Tk, d, vt,
                                              vt + L::KT);
    } else {
      cp_async_wait_all();
      kt = ktt = kv + (t & 1) * 2 * L::KT;
      vt = kt + L::KT;
    }
    fence_async_smem();
    __syncthreads();
    if (t + 1 < n_tiles) {
      if constexpr (F32) {
        if (kAhead) {
          kr.load(kb, st.k.t, k0 + BT, Tk, d);
          vr.load(vb, st.v.t, k0 + BT, Tk, d);
        }
      } else {
        uint8_t* nk = kv + ((t + 1) & 1) * 2 * L::KT;
        load_h16<BT, DP>(nk, kb, st.k.t, k0 + BT, Tk, d);
        load_h16<BT, DP>(nk + L::KT, vb, st.v.t, k0 + BT, Tk, d);
      }
    }
    if constexpr (!F32) cp_async_commit();

    float s[BT / 2], dp[BT / 2];
    zero(s);
    zero(dp);
    hold(s);
    hold(dp);
    wg_fence();
    product_ss<T, DP, BT>(s, smem_u32(qs), kRows, L::QT, smem_u32(kt), L::KT);
    product_ss<T, DP, BT>(dp, smem_u32(dos), kRows, L::QT, smem_u32(vt),
                          L::KT);
    wg_commit();
    wg_wait_all();
    hold(s);
    hold(dp);

    const bool edge = k0 + BT > kv_end || (causal && k0 + BT - 1 > q0);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int hh = (i >> 1) & 1;
      bool live = lse2[hh] < INFINITY;
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + col_t + (i & 1);
        const int row = q0 + row_a + 8 * hh;
        live = live && col < kv_end && (!causal || col <= row);
      }
      const float p = live ? exp2f(s[i] * scale2 - lse2[hh]) : 0.f;
      s[i] = p * (dp[i] - dl[hh]) * sm_scale;  // dS
    }

    // dq += dS K (bf16: dS rounded, as the reference at :196)
    RegProduct<T, DP, BT> dsk;
    dsk.load(s);
    dsk.hold_regs();
    hold(acc);
    wg_fence();
    dsk.issue(acc, smem_u32(ktt), L::KT);
    wg_commit();
    wg_wait_all();
    hold(acc);
    dsk.hold_regs();
  }
  if constexpr (!F32) cp_async_wait_all();
  const float one[2] = {1.f, 1.f};
  store_rows<T, DP>(dq + b * st.dq.b + h * st.dq.h, st.dq.t, q0, Tq, d, acc,
                    one);
}

template <typename T, int DP>
struct DkvSmem {
  static constexpr int BT = tile_len<T, DP>();
  static constexpr int KT = kRows * DP * Op<T>::kBytes;  // the key tile
  static constexpr int QT = BT * DP * Op<T>::kBytes;     // a query tile
  // f32: K hi, lo | V hi, lo | Q hi, lo, dO hi, lo (then Q^T hi, lo,
  //      dO^T hi, lo in the same bytes) | lse, delta
  // bf16: K | V | Q, dO | Q, dO (ring) | lse, delta | lse, delta
  static constexpr int tiles = Op<T>::kF32 ? 4 * KT + 4 * QT : 2 * KT + 4 * QT;
  static constexpr int stats = (Op<T>::kF32 ? 1 : 2) * 2 * BT * 4;
  static constexpr int bytes = tiles + stats + 1024;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, const int* __restrict__ lengths,
                         BwdStrides st, int H, int Tq, int Tk, int d,
                         float sm_scale, int causal) {
  using L = DkvSmem<T, DP>;
  constexpr bool F32 = Op<T>::kF32;
  constexpr int BT = L::BT;
  constexpr int KN = F32 ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ks = align1024(smem_raw);
  uint8_t* const vs = ks + KN * L::KT;
  uint8_t* const qd = vs + KN * L::KT;  // the query-side tiles
  float* const stats = reinterpret_cast<float*>(ks + L::tiles);

  const int lane = threadIdx.x & 31;
  const int row_a = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col_t = 2 * (lane & 3);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kRows;
  const int len_b = lengths ? max(lengths[b], 0) : Tk;
  const int kv_end = min(len_b, Tk);
  // rows before the tile's first key see none of it (causal); rows at or
  // past the length are dead; a tile of dead keys gets zeros
  const int q_begin = causal ? (k0 / BT) * BT : 0;
  const int q_end = k0 >= kv_end ? q_begin : (lengths ? min(len_b, Tq) : Tq);
  const int n_q = q_end > q_begin ? (q_end - q_begin + BT - 1) / BT : 0;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* dob = dO + b * st.dO.b + h * st.dO.h;
  const long long stat0 = static_cast<long long>(bh) * Tq;

  // copy one query tile (bf16) into ring slot `slot`
  auto load_q_tile = [&](int q0, int slot) {
    uint8_t* qt = qd + slot * 2 * L::QT;
    load_h16<BT, DP>(qt, (qb),
                      st.q.t, q0, Tq, d);
    load_h16<BT, DP>(qt + L::QT, (dob),
                      st.dO.t, q0, Tq, d);
    float* sl = stats + slot * 2 * BT;
    for (int i = threadIdx.x; i < BT; i += kThreads) {
      const int row = q0 + i;
      if (row < Tq) {
        cp_async4(smem_u32(sl + i), lse + stat0 + row);
        cp_async4(smem_u32(sl + BT + i), delta + stat0 + row);
      } else {
        sl[i] = INFINITY;
        sl[BT + i] = 0.f;
      }
    }
  };

  const float* qf = reinterpret_cast<const float*>(qb);
  const float* dof = reinterpret_cast<const float*>(dob);

  if constexpr (F32) {
    using KTile = F32Tile<kRows, DP>;
    KTile::template copy<false>(k + b * st.k.b + h * st.k.h, st.k.t, k0, Tk,
                                d, ks, ks + L::KT);
    KTile::template copy<false>(v + b * st.v.b + h * st.v.h, st.v.t, k0, Tk,
                                d, vs, vs + L::KT);
  } else {
    load_h16<kRows, DP>(ks,
                         (
                             k + b * st.k.b + h * st.k.h),
                         st.k.t, k0, Tk, d);
    load_h16<kRows, DP>(vs,
                         (
                             v + b * st.v.b + h * st.v.h),
                         st.v.t, k0, Tk, d);
    if (n_q > 0) load_q_tile(q_begin, 0);
    cp_async_commit();
  }

  // f32 at d > 64: two passes over the query tiles, dv then dk, so that
  // one m64n128 accumulator is live and not two (the registers are short);
  // the second pass recomputes S^T and dP^T
  constexpr int kPasses = (F32 && DP == 128) ? 2 : 1;
  float acc_k[DP / 2], acc_v[DP / 2];
  float(&dk_acc)[DP / 2] = kPasses == 1 ? acc_k : acc_v;
  T* const dkb = dk + b * st.dk.b + h * st.dk.h;
  T* const dvb = dv + b * st.dv.b + h * st.dv.h;
  const float one[2] = {1.f, 1.f};
  const float scale2 = sm_scale * kLog2e;
  for (int pass = 0; pass < kPasses; ++pass) {
    zero(acc_k);
    zero(acc_v);
    const bool want_v = pass == 0, want_k = pass == kPasses - 1;
    for (int it = 0; it < n_q; ++it) {
      const int q0 = q_begin + it * BT;
      uint8_t* qt;   // Q (f32: hi, lo)
      uint8_t* dot;  // dO (f32: hi, lo)
      float* sl;     // lse, delta of the tile's rows
      if constexpr (F32) {
        __syncthreads();
        qt = qd;
        dot = qd + 2 * L::QT;
        sl = stats;
        F32Tile<BT, DP>::template copy<false>(qf, st.q.t, q0, Tq, d, qt,
                                              qt + L::QT);
        F32Tile<BT, DP>::template copy<false>(dof, st.dO.t, q0, Tq, d, dot,
                                              dot + L::QT);
        for (int i = threadIdx.x; i < BT; i += kThreads) {
          const int row = q0 + i;
          sl[i] = row < Tq ? lse[stat0 + row] : INFINITY;
          sl[BT + i] = row < Tq ? delta[stat0 + row] : 0.f;
        }
      } else {
        cp_async_wait_all();
        qt = qd + (it & 1) * 2 * L::QT;
        dot = qt + L::QT;
        sl = stats + (it & 1) * 2 * BT;
      }
      fence_async_smem();
      __syncthreads();
      if constexpr (!F32) {  // the next tile's copy overlaps this tile
        if (it + 1 < n_q) load_q_tile(q0 + BT, (it + 1) & 1);
        cp_async_commit();
      }

      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float s[BT / 2], dp[BT / 2];
      zero(s);
      zero(dp);
      hold(s);
      hold(dp);
      wg_fence();
      product_ss<T, DP, BT>(s, smem_u32(ks), kRows, L::KT, smem_u32(qt), L::QT);
      product_ss<T, DP, BT>(dp, smem_u32(vs), kRows, L::KT, smem_u32(dot),
                            L::QT);
      wg_commit();
      wg_wait_all();
      hold(s);
      hold(dp);

      const bool edge = k0 + kRows > kv_end || (causal && q0 < k0 + kRows - 1);
  #pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int hh = (i >> 1) & 1;
        const int qi = 8 * (i >> 2) + col_t + (i & 1);
        const float l2 = sl[qi] * kLog2e;
        bool live = sl[qi] < INFINITY;
        if (edge) {
          const int key = k0 + row_a + 8 * hh;
          live = live && key < kv_end && (!causal || key <= q0 + qi);
        }
        const float p = live ? exp2f(s[i] * scale2 - l2) : 0.f;
        dp[i] = p * (dp[i] - sl[BT + qi]) * sm_scale;  // dS^T
        s[i] = p;                                      // P^T
      }

      if constexpr (F32) {
        // Q^T and dO^T (depth = the tile's queries) replace Q and dO
        __syncthreads();
        F32Tile<BT, DP>::template copy<true>(qf, st.q.t, q0, Tq, d, qt,
                                             qt + L::QT);
        F32Tile<BT, DP>::template copy<true>(dof, st.dO.t, q0, Tq, d, dot,
                                             dot + L::QT);
        fence_async_smem();
        __syncthreads();
        RegProduct<T, DP, BT> x;
        if (want_v) {  // dv += P^T dO
          x.load(s);
          x.hold_regs();
          hold(acc_v);
          wg_fence();
          x.issue(acc_v, smem_u32(dot), L::QT);
          wg_commit();
          wg_wait_all();
          hold(acc_v);
          x.hold_regs();
        }
        if (want_k) {  // dk += dS^T Q
          x.load(dp);
          x.hold_regs();
          hold(dk_acc);
          wg_fence();
          x.issue(dk_acc, smem_u32(qt), L::QT);
          wg_commit();
          wg_wait_all();
          hold(dk_acc);
          x.hold_regs();
        }
      } else {
        // bf16: P^T and dS^T rounded, as the reference at :234 and :236
        RegProduct<T, DP, BT> pt, dst;
        pt.load(s);
        dst.load(dp);
        pt.hold_regs();
        dst.hold_regs();
        hold(acc_v);
        hold(acc_k);
        wg_fence();
        pt.issue(acc_v, smem_u32(dot), 0);
        dst.issue(acc_k, smem_u32(qt), 0);
        wg_commit();
        wg_wait_all();
        hold(acc_v);
        hold(acc_k);
        pt.hold_regs();
        dst.hold_regs();
      }
    }
    if (kPasses == 2 && pass == 0)
      store_rows<T, DP>(dvb, st.dv.t, k0, Tk, d, acc_v, one);
  }
  if constexpr (!F32) cp_async_wait_all();
  store_rows<T, DP>(dkb, st.dk.t, k0, Tk, d, dk_acc, one);
  if (kPasses == 1) store_rows<T, DP>(dvb, st.dv.t, k0, Tk, d, acc_v, one);
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
  constexpr int per_block = kDeltaThreads / kDeltaLanes;
  flash_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + per_block - 1) / per_block),
         kDeltaThreads, 0,
         stream>>>(static_cast<const T*>(o), tdo, fdelta, st.o, st.dO, H, Tq,
                   d, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int dq_smem = DqSmem<T, DP>::bytes;
  auto dq_kernel = flash_bwd_dq_kernel<T, DP>;
  static std::atomic<int> dq_opted[mx::kMaxDevices];
  err = mx::opt_in_smem(dq_kernel, dq_smem, dq_opted);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(B * H, (Tq + kRows - 1) / kRows), kThreads, dq_smem,
              stream>>>(tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq),
                        lens, st, H, Tq, Tk, d, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Tk == 0) return cudaSuccess;

  const int dkv_smem = DkvSmem<T, DP>::bytes;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, DP>;
  static std::atomic<int> dkv_opted[mx::kMaxDevices];
  err = mx::opt_in_smem(dkv_kernel, dkv_smem, dkv_opted);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(B * H, (Tk + kRows - 1) / kRows), kThreads, dkv_smem,
               stream>>>(tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dk),
                         static_cast<T*>(dv), lens, st, H, Tq, Tk, d,
                         sm_scale, causal);
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

template <typename T>
int smem_bytes(int kernel, int dp) {
  if (kernel == 0)
    return dp == 64 ? FwdSmem<T, 64>::bytes : FwdSmem<T, 128>::bytes;
  if (kernel == 1)
    return dp == 64 ? DqSmem<T, 64>::bytes : DqSmem<T, 128>::bytes;
  return dp == 64 ? DkvSmem<T, 64>::bytes : DkvSmem<T, 128>::bytes;
}

}  // namespace

// dynamic shared memory of one block (bytes, alignment slack included):
// kernel 0 forward, 1 dq, 2 dk/dv; dtype as below; dp = 64 or 128
MX_EXPORT int mx_flash_attention_smem(int kernel, int dtype, int dp) {
  return dtype == kFloat32 ? smem_bytes<float>(kernel, dp)
                           : smem_bytes<__nv_bfloat16>(kernel, dp);
}

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
    case kFloat16:
      return dispatch<__half>(q, k, v, o, lse, lengths, st, B, H, Tq, Tk, d,
                              sm_scale, causal, s);
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
    case kFloat16:
      return dispatch_bwd<__half>(q, k, v, o, dO, lse, delta, dq, dk, dv,
                                  lengths, st, B, H, Tq, Tk, d, sm_scale,
                                  causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
