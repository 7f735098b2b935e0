// int8 x int8 -> int32 convolution as an implicit GEMM on Hopper's
// warpgroup tensor cores, with the quantized layers' epilogue fused, the
// residual block's add among it (Q1).
//
// Replaces no Pallas kernel. The reference contracts int8 codes with XLA ops
// at preferred_element_type=int32 (`incubator_mxnet_tpu/contrib/
// quantization.py:334-336`, the Dense; `:405-410`, the Conv2D). PyTorch has
// no int8 convolution with int32 sums on CUDA, so this kernel is what the
// card needs to run the reference's int8 path at all.
//
// Layout. The codes are channels-last (NHWC in memory) and the weight is
// (O, kh, kw, C/g) in memory, so both operands of the product are K-major
// with k running (r, s, c), c fastest: one tap of one output position is
// C/g contiguous bytes. The output is written NHWC.
//
// The product: M = N*Ho*Wo output positions, N = O/g output channels of a
// group, K = kh*kw*(C/g). A block of 256 threads (two warpgroups) computes
// a 128 x BN tile of (M, N) for one group: BN = 64 where O/g <= 64 (the
// stem, stage 1's 64-channel layers) or where 128-wide tiles would leave
// most SMs idle (the Dense), else 128. Depth comes in stages of 128 bytes,
// one 128-byte-swizzled column block (`sm90.cuh`) each for A (128 rows)
// and B (BN rows), in a ring of 3 stages: 96 KB of dynamic shared memory
// and at most 128 registers a thread at BN 128, two blocks an SM; 72 KB
// and at most 85 registers at BN 64, three blocks an SM (the launch asks
// for the largest shared-memory carveout).
// Every thread stages both operands with 16-byte `cp.async`, src_bytes 0
// zero-filling the padding, rows past M or N and K's ragged end; a
// thread's tap (r, s, c) advances a stage at a time without dividing. The
// loads of stage t + stages - 1 are in flight while the warpgroups run
// stage t's products: `wgmma.mma_async.m64nBNk32.s32.s8.s8`, each
// warpgroup 64 rows, the sums in int32 registers, as many k32 steps as the
// stage holds of K. Each A tile is loaded once a block; the blocks of one
// row of tiles follow each other on the grid, so A's taps are read from
// L2 after the first. Where C/g is not a multiple of 16 a tap is not a
// 16-byte chunk, and two branches of the kernel, chosen by shape, stage A
// and B with plain shared stores into the same swizzled layout instead:
// - rows (the stem: C = 3, 7 x 7, K = 147; groups 1, unit column
//   dilation, kw*C <= 128): the kw taps of one kernel row r are kw*C
//   contiguous bytes of the NHWC input (21 for the stem). Depth is laid
//   out a segment a kernel row, each padded to a multiple of 4 bytes (24),
//   as many whole segments a stage as fit its 128 bytes (5): the stem's
//   depth is 2 stages of 5 and 2 segments. A thread moves a segment with
//   aligned 4-byte loads and funnel shifts, zeroing the taps in the
//   padding and the segment's pad, and the weight's rows are laid out the
//   same way: every product is the same int8 x int8, summed in another
//   order of the same integers.
// - bytes (grouped or column-dilated narrow shapes): byte by byte, k in
//   the (r, s, c) order.
//
// Split-K. Where the tiles would fill under a quarter of the SMs (the
// Dense: M = 64, 16 tiles 64 wide) the depth is cut across blocks (grid
// z), each at least 2 stages deep, as many blocks as SMs at most. Each
// adds its int32 sums into a zeroed int32 workspace with atomics (exact:
// their order changes no bit); the last block to arrive at a tile (a
// counter a tile, after the workspace) reads the whole sums and runs the
// epilogue. The wrapper allocates and zeroes the workspace on the stream,
// so a captured graph zeroes it at every replay.
//
// Bound on the H100: bytes (the int8 input, weight and output once, the
// residual once) at 3.35 TB/s against 2*M*N*K operations at 1979 TOP/s:
// ResNet-50's 1x1 layers and the stem by bytes, the Dense and the deep
// 3x3 layers by operations. What the design leaves (`kernel_ablation.py
// --only q1`): the epilogue's arithmetic a code, some 20 instructions, is
// what the layers with a residual wait on; a block's fixed latency (its
// first loads, its epilogue) is what the short-K 1x1 layers wait on. A
// persistent grid whose epilogue runs straight from the accumulators
// measured slower on every row (at 128 registers it spilled, and its
// 2-byte stores cost more than the staging). TMA (an im2col tensor map,
// made by cuTensorMapEncodeIm2col, which the runtime this library links
// does not export) with warp-specialised producers and a persistent grid
// is later work.
//
// The epilogue in the reference's order (`quantization.py:338-349`,
// `:412-421`): s_x = thresh / 127; y = float(acc) * (s_x * w_scale[o]);
// + bias[o]; then int8 at the consumer's threshold, clip(rint(y * (127 /
// out_t)), -127, 127), or the net's float type, or the raw int32 sums.
// With a residual (the block's other branch, int8 codes of the output's
// shape), the code a just made at out_t = t_add goes on as the reference's
// QuantizedResidualBlock (`quantization.py:618-647`): the same-scale case
// y = float(a + r) * (t_add / 127), the identity case y = a * (t_add /
// 127) + r * (t_in / 127); relu; then clip(rint(y * (127 / block_out_t)),
// -127, 127) or the net's float type. Every step is an explicitly rounded
// intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn): nvcc would contract a*b + c
// into an FMA, which rounds once where the plain version's separate torch
// ops round twice, and a code that flips at a tie would run down the
// chain. Rounding is half to even (__float2int_rn), as torch.round's. The
// thresholds and scales are read from device memory when the kernel runs,
// never passed by value: the chain shares the consumer's threshold
// Parameter, which load_parameters updates in place, and a replayed CUDA
// graph would keep a value baked into its launch. relu on the int8 codes
// (a residual body's relu glue after a code, max(code, 0)) is the last
// step where asked. The sums are staged through shared memory (their
// 16-byte units in a swizzled order, staged_col, so the 16-byte reads do
// not conflict), so each thread runs the epilogue on 16 adjacent channels
// of one output position: 16-byte residual loads and output stores,
// neighbouring lanes on neighbouring channels; the epilogue is compiled
// once for each residual case and output kind.
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace mx::sm90;

constexpr int kBM = 128;       // rows a block: two warpgroups of 64
constexpr int kBK = 128;       // bytes of depth a stage
constexpr int kThreads = 256;

// what the epilogue writes
enum OutKind : int { kOutF32 = 0, kOutBF16 = 1, kOutF16 = 2, kOutInt8 = 3,
                     kOutInt32 = 4 };
// the residual's case (QuantizedResidualBlock)
enum ResMode : int { kResNone = 0, kResSameScale = 1, kResIdentity = 2 };
// how a stage of A and B is staged (the branches above)
enum LoadKind : int { kLoad16 = 0, kLoadRows = 1, kLoadBytes = 2 };

struct ConvShape {
  int N, C, H, W;         // the input, NHWC in memory
  int O, kh, kw;          // the weight, (O, kh, kw, C/g) in memory
  int sh, sw, ph, pw, dh, dw;
  int groups, Ho, Wo;
  int Cg, Og, K, M;       // C/g, O/g, kh*kw*(C/g), N*Ho*Wo
  int MT, NT, KT;         // tiles along M and N, stages of K
  int splits, kt_per;     // split-K: blocks along K, stages each
  int seg, seg_pad, segs; // rows: bytes a kernel row, padded, a stage
};

struct Epilogue {
  const float* thresh;    // the layer's input threshold
  const float* wscale;    // (O,)
  const void* bias;       // (O,) of bias_kind, or null (bias_kind -1)
  int bias_kind;
  const float* out_t;     // the int8 code's threshold (with a residual: t_add)
  void* y;
  int out_kind;
  const int8_t* res;      // the residual, the output's shape, or null
  int res_mode;
  const float* res_t;     // the identity's threshold (t_in)
  const float* res_out_t; // the block's output threshold (int8 output)
  int relu;               // relu on the int8 output codes (no residual)
  int vec;                // 16-byte output and residual chunks
};

template <int BN>
struct Cfg {
  static constexpr int kStages = 3;
  // blocks an SM: three at BN 64 (72 KB a ring, under 85 registers)
  static constexpr int kBlocks = BN == 64 ? 3 : 2;
  static constexpr int kATile = kBM * kBK;
  static constexpr int kStage = kATile + BN * kBK;
  static constexpr int kCRow = BN + 8;  // staged sums: words a row
  static constexpr int kPipe = kStages * kStage;
  static constexpr int kStaging = kBM * kCRow * 4;
  static constexpr int kSmem =
      (kPipe > kStaging ? kPipe : kStaging) + 1024;  // + alignment slack
};

__device__ __forceinline__ float load_bias(const void* bias, int kind,
                                           int o) {
  switch (kind) {
    case kFloat32:
      return static_cast<const float*>(bias)[o];
    case kBFloat16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[o]);
    default:
      return __half2float(static_cast<const __half*>(bias)[o]);
  }
}

__device__ __forceinline__ int clip127(int q) {
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

// The staged sums' layout: a row's 16-word chunk c (16 channels) holds
// its four 4-word units in the order q ^ unit_swizzle(c). A thread reads
// its chunk's unit q, and the 8 threads of a 16-byte shared load (one or
// two rows, consecutive chunks) then fall in distinct banks, where the
// plain order put 4 chunks on the same 4 banks.
__device__ __forceinline__ int unit_swizzle(int chunk) {
  return (chunk >> 1) & 3;
}

// where the staged sums keep logical column col of a row
__device__ __forceinline__ int staged_col(int col) {
  return (col & ~15) | ((((col >> 2) & 3) ^ unit_swizzle(col >> 4)) << 2) |
         (col & 3);
}

// byte offset of 16-byte chunk j of row r in a swizzled 128-byte-wide tile
__device__ __forceinline__ int chunk_at(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// An output position's input origin: the offset of its image and group in
// x, and the window's top-left corner; off < 0 past M.
struct Origin {
  int off, ih, iw;
};

__device__ __forceinline__ Origin origin_of(const ConvShape& s, int g,
                                            int m) {
  Origin o{-1, 0, 0};
  if (m < s.M) {
    const int hw = s.Ho * s.Wo;
    const int n = m / hw;
    const int rem = m - n * hw;
    const int oh = rem / s.Wo;
    o.off = n * s.H * s.W * s.C + g * s.Cg;
    o.ih = oh * s.sh - s.ph;
    o.iw = (rem - oh * s.Wo) * s.sw - s.pw;
  }
  return o;
}

// The depth k = (r*kw + q)*Cg + c of a thread's A chunk, walked a stage
// (128 bytes) at a time: no division after the first stage.
struct Tap {
  int k, c, q, r;
};

__device__ __forceinline__ Tap tap_at(const ConvShape& s, int k) {
  const int tap = k / s.Cg;
  const int r = tap / s.kw;
  return Tap{k, k - tap * s.Cg, tap - r * s.kw, r};
}

__device__ __forceinline__ void next_stage(const ConvShape& s, Tap& t) {
  t.k += kBK;
  t.c += kBK;
  while (t.c >= s.Cg) {
    t.c -= s.Cg;
    if (++t.q == s.kw) {
      t.q = 0;
      ++t.r;
    }
  }
}

// A's 128 x 128 stage: thread t stages chunk t % 8 of rows t / 8 + 32 i,
// at depth tp.k (its chunk's)
__device__ __forceinline__ void load_a16(uint32_t sa, const int8_t* x,
                                         const ConvShape& s,
                                         const Origin (&org)[4],
                                         const Tap& tp) {
  const int j = threadIdx.x & 7;
  const bool kin = tp.k < s.K;
  const int c = tp.c;
  const int dy = tp.r * s.dh;
  const int dx = tp.q * s.dw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (threadIdx.x >> 3) + 32 * i;
    const int ih = org[i].ih + dy;
    const int iw = org[i].iw + dx;
    const bool ok = kin && org[i].off >= 0 &&
                    static_cast<unsigned>(ih) < static_cast<unsigned>(s.H) &&
                    static_cast<unsigned>(iw) < static_cast<unsigned>(s.W);
    const int8_t* src = ok ? x + org[i].off + (ih * s.W + iw) * s.C + c : x;
    cp_async16(sa + chunk_at(row, j), src, ok ? 16 : 0);
  }
}

// B's BN x 128 stage from the weight rows n0 .. n0 + BN - 1 of group g
template <int BN>
__device__ __forceinline__ void load_b16(uint32_t sb, const int8_t* w,
                                         const ConvShape& s, int g, int n0,
                                         int k0) {
  const int j = threadIdx.x & 7;
  const int k = k0 + 16 * j;
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int row = (threadIdx.x >> 3) + 32 * i;
    const bool ok = k < s.K && n0 + row < s.Og;
    const int8_t* src =
        ok ? w + static_cast<long long>(g * s.Og + n0 + row) * s.K + k : w;
    cp_async16(sb + chunk_at(row, j), src, ok ? 16 : 0);
  }
}

// the narrow branch's A stage: thread t gathers bytes 64 (t % 2) .. + 63 of
// row t / 2, walking (r, s, c) from its first k
__device__ __forceinline__ void load_a1(uint8_t* sa, const int8_t* x,
                                        const ConvShape& s, const Origin& org,
                                        int k0) {
  const int row = threadIdx.x >> 1;
  const int part = threadIdx.x & 1;
  int k = k0 + 64 * part;
  int c = 0, r = 0, q = 0;
  if (k < s.K) {
    const int tap = k / s.Cg;
    r = tap / s.kw;
    q = tap - r * s.kw;
    c = k - tap * s.Cg;
  }
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (k < s.K && org.off >= 0) {
        const int ih = org.ih + r * s.dh;
        const int iw = org.iw + q * s.dw;
        if (static_cast<unsigned>(ih) < static_cast<unsigned>(s.H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(s.W))
          wd[b >> 2] |= (static_cast<unsigned>(
                             x[org.off + (ih * s.W + iw) * s.C + c]) &
                         0xffu)
                        << (8 * (b & 3));
      }
      ++k;
      if (++c == s.Cg) {
        c = 0;
        if (++q == s.kw) {
          q = 0;
          ++r;
        }
      }
    }
    *reinterpret_cast<uint4*>(sa + chunk_at(row, part * 4 + cc)) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// the narrow branch's B stage: 256 / BN threads a weight row
template <int BN>
__device__ __forceinline__ void load_b1(uint8_t* sb, const int8_t* w,
                                        const ConvShape& s, int g, int n0,
                                        int k0) {
  constexpr int kTpr = kThreads / BN;
  constexpr int kChunks = 8 / kTpr;
  const int row = threadIdx.x / kTpr;
  const int part = threadIdx.x % kTpr;
  const bool ok = n0 + row < s.Og;
  const int8_t* wrow = w + static_cast<long long>(g * s.Og + n0 + row) * s.K;
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    const int kc = k0 + (part * kChunks + cc) * 16;
    unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (ok && kc + b < s.K)
        wd[b >> 2] |= (static_cast<unsigned>(wrow[kc + b]) & 0xffu)
                      << (8 * (b & 3));
    *reinterpret_cast<uint4*>(sb + chunk_at(row, part * kChunks + cc)) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// the bytes [from, to) of a 4-byte word, as a mask
__device__ __forceinline__ unsigned keep_bytes(int from, int to) {
  from = max(from, 0);
  to = min(to, 4);
  if (from >= to) return 0u;
  const unsigned below_to = to == 4 ? 0xffffffffu : (1u << (8 * to)) - 1u;
  return below_to & ~((1u << (8 * from)) - 1u);
}

// One segment of the rows branch: the `words` 4-byte words of the bytes
// at src, bytes outside [lo, hi) zero, into row `row` of a swizzled tile
// at byte `off` of the stage. Only the aligned words that hold a byte of
// [lo, hi) are read. src null: zeros.
__device__ __forceinline__ void load_seg(uint8_t* tile, int row, int off,
                                         const int8_t* src, int lo, int hi,
                                         int words) {
  if (src == nullptr) lo = hi = 0;
  const int d = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
  const unsigned* base = reinterpret_cast<const unsigned*>(src - d);
  // aligned word j holds the segment's bytes [4 j - d, 4 j - d + 4)
  auto word = [&](int j) {
    const int b = 4 * j - d;
    return b < hi && b + 4 > lo ? __ldg(base + j) : 0u;
  };
  unsigned prev = word(0);
  for (int i = 0; i < words; ++i) {
    const unsigned next = word(i + 1);
    const unsigned v = __funnelshift_r(prev, next, 8 * d) &
                       keep_bytes(lo - 4 * i, hi - 4 * i);
    const int k = off + 4 * i;
    *reinterpret_cast<unsigned*>(tile + chunk_at(row, k >> 4) + (k & 15)) =
        v;
    prev = next;
  }
}

// the segments (kernel rows) stage kt of the rows branch holds
__device__ __forceinline__ int rows_in_stage(const ConvShape& s, int kt) {
  return min(s.segs, s.kh - kt * s.segs);
}

// A's and B's stage kt of the rows branch: thread t moves segments
// t / 128, t / 128 + 2, ... of A row t % 128 and weight row segments
// t % BN, then zeroes its row's bytes past the stage's segments up to its
// last k32 step (threads 0-127 A's rows, 128 on B's)
template <int BN>
__device__ __forceinline__ void load_rows(uint8_t* sa, uint8_t* sb,
                                          const int8_t* x, const int8_t* w,
                                          const ConvShape& s,
                                          const Origin& org, int n0, int kt) {
  const int segs = rows_in_stage(s, kt);
  const int words = s.seg_pad >> 2;
  const int row = threadIdx.x & (kBM - 1);
  // the taps of a kernel row inside the image: bytes [lo, hi) of it
  const int lo = max(0, -org.iw) * s.C;
  const int hi = min(s.kw, s.W - org.iw) * s.C;
  for (int j = threadIdx.x / kBM; j < segs; j += kThreads / kBM) {
    const int ih = org.ih + (kt * s.segs + j) * s.dh;
    const bool ok = org.off >= 0 &&
                    static_cast<unsigned>(ih) < static_cast<unsigned>(s.H);
    load_seg(sa, row, j * s.seg_pad,
             ok ? x + org.off + (ih * s.W + org.iw) * s.C : nullptr, lo, hi,
             words);
  }
  for (int t = threadIdx.x; t < BN * segs; t += kThreads) {
    const int brow = t % BN;
    const int j = t / BN;
    const bool ok = n0 + brow < s.Og;
    load_seg(sb, brow, j * s.seg_pad,
             ok ? w + static_cast<long long>(n0 + brow) * s.K +
                      (kt * s.segs + j) * s.seg
                : nullptr,
             0, s.seg, words);
  }
  const int used = segs * s.seg_pad;
  const int end = (used + 31) & ~31;
  uint8_t* const zt = threadIdx.x < kBM ? sa : sb;
  if (threadIdx.x < kBM || row < BN)
    for (int k = used; k < end; k += 4)
      *reinterpret_cast<unsigned*>(zt + chunk_at(row, k >> 4) + (k & 15)) =
          0u;
}

// 16 outputs of a 2-byte float type, each rounded on its own: two 16-byte
// stores where the chunk is whole (y 16-byte aligned, 16 | O), else one
// element a store.
template <typename T>
__device__ __forceinline__ void store_halves(T* out, const float* yv,
                                             int cnt, bool full) {
  alignas(16) T h[16];
#pragma unroll
  for (int u = 0; u < 16; ++u)
    if constexpr (std::is_same<T, __half>::value)
      h[u] = __float2half_rn(yv[u]);
    else
      h[u] = __float2bfloat16_rn(yv[u]);
  if (full) {
    reinterpret_cast<uint4*>(out)[0] = reinterpret_cast<const uint4*>(h)[0];
    reinterpret_cast<uint4*>(out)[1] = reinterpret_cast<const uint4*>(h)[1];
  } else {
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (u < cnt) out[u] = h[u];
  }
}

// One tile's epilogue from its staged sums: 16 adjacent channels of one
// output position a step, compiled for one residual case and output kind.
template <int BN, int kMode, int kKind>
__device__ __forceinline__ void epilogue(const int* cs, const float* sc,
                                         const float* bi, const Epilogue& e,
                                         const ConvShape& s, int g, int m0,
                                         int n0) {
  using L = Cfg<BN>;
  constexpr int kCpr = BN / 16;  // chunks a row
  constexpr int kIters = kBM * kCpr / kThreads;
  constexpr bool kRes = kMode != kResNone;
  const int tid = threadIdx.x;
  const bool has_bias = e.bias_kind >= 0;
  const float q_mul =
      (kKind == kOutInt8 || kRes) ? __fdiv_rn(127.f, e.out_t[0]) : 0.f;
  const float s_add = kRes ? __fdiv_rn(e.out_t[0], 127.f) : 0.f;
  const float s_in =
      kMode == kResIdentity ? __fdiv_rn(e.res_t[0], 127.f) : 0.f;
  const float q_out = (kRes && kKind == kOutInt8)
                          ? __fdiv_rn(127.f, e.res_out_t[0])
                          : 0.f;
  // relu on the codes: max(code, 0), as torch.relu of int8 codes
  const int lo_code = e.relu ? 0 : -127;
  // the residual's 16 codes of each of this thread's chunks, four to a
  // word: every load in flight before the first chunk's arithmetic
  unsigned rw[kIters][4];
  if constexpr (kRes) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      const int row = i / kCpr;
      const int ol0 = n0 + (i - row * kCpr) * 16;
      const int m = m0 + row;
      rw[it][0] = rw[it][1] = rw[it][2] = rw[it][3] = 0u;
      if (m >= s.M || ol0 >= s.Og) continue;
      const int cnt = min(16, s.Og - ol0);
      const long long base =
          static_cast<long long>(m) * s.O + g * s.Og + ol0;
      if (e.vec && cnt == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(e.res + base));
        rw[it][0] = v.x;
        rw[it][1] = v.y;
        rw[it][2] = v.z;
        rw[it][3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (u < cnt)
            rw[it][u >> 2] |=
                (static_cast<unsigned>(e.res[base + u]) & 0xffu)
                << (8 * (u & 3));
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * kThreads;
    const int row = i / kCpr;
    const int chunk = i - row * kCpr;
    const int col0 = chunk * 16;
    const int swz = unit_swizzle(chunk);
    const int m = m0 + row;
    const int ol0 = n0 + col0;
    if (m >= s.M || ol0 >= s.Og) continue;
    const int cnt = min(16, s.Og - ol0);
    const bool full = e.vec && cnt == 16;
    const long long base =
        static_cast<long long>(m) * s.O + g * s.Og + ol0;
    int a[16];
    float scv[16], biv[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v =
          *reinterpret_cast<const int4*>(cs + row * L::kCRow + col0 +
                                         4 * (q ^ swz));
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
      const float4 c =
          *reinterpret_cast<const float4*>(sc + col0 + 4 * (q ^ swz));
      scv[4 * q] = c.x;
      scv[4 * q + 1] = c.y;
      scv[4 * q + 2] = c.z;
      scv[4 * q + 3] = c.w;
      const float4 b =
          *reinterpret_cast<const float4*>(bi + col0 + 4 * (q ^ swz));
      biv[4 * q] = b.x;
      biv[4 * q + 1] = b.y;
      biv[4 * q + 2] = b.z;
      biv[4 * q + 3] = b.w;
    }
    if constexpr (kKind == kOutInt32) {
      int* const out = static_cast<int*>(e.y) + base;
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (u < cnt) out[u] = a[u];
      continue;
    }
    float yv[16];
    int code[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      float v = __fmul_rn(__int2float_rn(a[u]), scv[u]);
      if (has_bias) v = __fadd_rn(v, biv[u]);
      if constexpr (kRes) {
        const int c = clip127(__float2int_rn(__fmul_rn(v, q_mul)));
        const int r = static_cast<int8_t>(rw[it][u >> 2] >> (8 * (u & 3)));
        v = kMode == kResSameScale
                ? __fmul_rn(__int2float_rn(c + r), s_add)
                : __fadd_rn(__fmul_rn(__int2float_rn(c), s_add),
                            __fmul_rn(__int2float_rn(r), s_in));
        v = v < 0.f ? 0.f : v;
        if constexpr (kKind == kOutInt8)
          code[u] = clip127(__float2int_rn(__fmul_rn(v, q_out)));
      } else if constexpr (kKind == kOutInt8) {
        code[u] = max(clip127(__float2int_rn(__fmul_rn(v, q_mul))), lo_code);
      }
      yv[u] = v;
    }
    if constexpr (kKind == kOutInt8) {
      // four codes to a word: bytes 0 of c0, c1, then of c2, c3
      unsigned qw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        qw[q] = __byte_perm(
            __byte_perm(code[4 * q], code[4 * q + 1], 0x0040),
            __byte_perm(code[4 * q + 2], code[4 * q + 3], 0x0040), 0x5410);
      int8_t* const out = static_cast<int8_t*>(e.y) + base;
      if (full) {
        *reinterpret_cast<uint4*>(out) =
            make_uint4(qw[0], qw[1], qw[2], qw[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (u < cnt)
            out[u] = static_cast<int8_t>(qw[u >> 2] >> (8 * (u & 3)));
      }
    } else if constexpr (kKind == kOutF32) {
      float* const out = static_cast<float*>(e.y) + base;
      if (full) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reinterpret_cast<float4*>(out)[q] =
              make_float4(yv[4 * q], yv[4 * q + 1], yv[4 * q + 2],
                          yv[4 * q + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (u < cnt) out[u] = yv[u];
      }
    } else if constexpr (kKind == kOutBF16) {
      store_halves(static_cast<__nv_bfloat16*>(e.y) + base, yv, cnt, full);
    } else {
      store_halves(static_cast<__half*>(e.y) + base, yv, cnt, full);
    }
  }
}

template <int BN, int kMode>
__device__ __forceinline__ void epilogue_of(const int* cs, const float* sc,
                                            const float* bi,
                                            const Epilogue& e,
                                            const ConvShape& s, int g, int m0,
                                            int n0) {
  switch (e.out_kind) {
    case kOutInt8:
      epilogue<BN, kMode, kOutInt8>(cs, sc, bi, e, s, g, m0, n0);
      break;
    case kOutF32:
      epilogue<BN, kMode, kOutF32>(cs, sc, bi, e, s, g, m0, n0);
      break;
    case kOutBF16:
      epilogue<BN, kMode, kOutBF16>(cs, sc, bi, e, s, g, m0, n0);
      break;
    case kOutF16:
      epilogue<BN, kMode, kOutF16>(cs, sc, bi, e, s, g, m0, n0);
      break;
    default:
      if constexpr (kMode == kResNone)
        epilogue<BN, kMode, kOutInt32>(cs, sc, bi, e, s, g, m0, n0);
  }
}

template <int BN, int kLoad>
__global__ void __launch_bounds__(kThreads, Cfg<BN>::kBlocks)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, ConvShape s, Epilogue e,
                     int* __restrict__ ws) {
  using L = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // s_x * w_scale[o] and bias[o] of the tile's channels
  __shared__ __align__(16) float sc[BN];
  __shared__ __align__(16) float bi[BN];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int nt = blockIdx.x % s.NT;
  const int mt = blockIdx.x / s.NT;
  const int g = blockIdx.z / s.splits;
  const int split = blockIdx.z - g * s.splits;
  const int m0 = mt * kBM;
  const int n0 = nt * BN;
  const int kt0 = split * s.kt_per;
  const int nk = min(s.KT, kt0 + s.kt_per) - kt0;

  if (tid < BN) {
    const int ol = n0 + tid;
    float v = 0.f, b = 0.f;
    if (ol < s.Og) {
      const int o = g * s.Og + ol;
      v = __fmul_rn(__fdiv_rn(e.thresh[0], 127.f), e.wscale[o]);
      if (e.bias_kind >= 0) b = load_bias(e.bias, e.bias_kind, o);
    }
    sc[staged_col(tid)] = v;
    bi[staged_col(tid)] = b;
  }

  Origin org[kLoad == kLoad16 ? 4 : 1];
  if constexpr (kLoad == kLoadRows) {
    org[0] = origin_of(s, g, m0 + (tid & (kBM - 1)));
  } else if constexpr (kLoad == kLoadBytes) {
    org[0] = origin_of(s, g, m0 + (tid >> 1));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      org[i] = origin_of(s, g, m0 + (tid >> 3) + 32 * i);
  }

  // the depth of this thread's A chunk in the next stage it loads (the
  // stages load in order)
  Tap tap = tap_at(s, kt0 * kBK + 16 * (tid & 7));
  auto load = [&](int slot, int kt) {
    uint8_t* const sa = smem + slot * L::kStage;
    uint8_t* const sb = sa + L::kATile;
    const int k0 = kt * kBK;
    if constexpr (kLoad == kLoadRows) {
      load_rows<BN>(sa, sb, x, w, s, org[0], n0, kt);
    } else if constexpr (kLoad == kLoadBytes) {
      load_a1(sa, x, s, org[0], k0);
      load_b1<BN>(sb, w, s, g, n0, k0);
    } else {
      load_a16(smem_u32(sa), x, s, org, tap);
      next_stage(s, tap);
      load_b16<BN>(smem_u32(sb), w, s, g, n0, k0);
    }
  };

  const int wg = tid >> 7;
  const bool wg_on = m0 + 64 * wg < s.M;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int st = 0; st < L::kStages - 1; ++st) {
    if (st < nk) load(st, kt0 + st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<L::kStages - 2>();
    fence_async_smem();
    // stage it has landed; every warpgroup is done with stage it - 1
    __syncthreads();
    const int nxt = it + L::kStages - 1;
    if (nxt < nk) load(nxt % L::kStages, kt0 + nxt);
    cp_async_commit();
    if (wg_on) {
      const uint8_t* const sa = smem + (it % L::kStages) * L::kStage;
      const uint32_t a_t = smem_u32(sa) + wg * 64 * 128;
      const uint32_t b_t = smem_u32(sa + L::kATile);
      // k32 steps this stage holds of K
      const int kt = kt0 + it;
      const int steps =
          kLoad == kLoadRows
              ? (rows_in_stage(s, kt) * s.seg_pad + 31) / 32
              : min(4, (s.K - kt * kBK + 31) / 32);
      hold(acc);
      wg_fence();
#pragma unroll
      for (int st = 0; st < 4; ++st)
        if (st < steps)
          mma_ss_s8<BN>(acc, desc_k(a_t, 64, st), desc_k(b_t, BN, st));
      wg_commit();
      wg_wait_all();
      hold(acc);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the sums of the tile, staged as int32 rows of kCRow words
  int* const cs = reinterpret_cast<int*>(smem);
  const int lane = tid & 31;
  const int r0 = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  if (s.splits == 1) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(cs + (r0 + 8 * h) * L::kCRow +
                                 staged_col(8 * j + c0)) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  } else {
    if (wg_on) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r0 + 8 * h;
          if (m >= s.M) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ol = n0 + 8 * j + c0 + u;
            if (ol < s.Og)
              atomicAdd(ws + static_cast<long long>(m) * s.O + g * s.Og + ol,
                        acc[4 * j + 2 * h + u]);
          }
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* const count = ws + static_cast<long long>(s.M) * s.O +
                         (g * s.MT + mt) * s.NT + nt;
      last = atomicAdd(count, 1) == s.splits - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int i = tid; i < kBM * BN; i += kThreads) {
      const int row = i / BN;
      const int col = i - row * BN;
      const int m = m0 + row;
      cs[row * L::kCRow + staged_col(col)] =
          m < s.M && n0 + col < s.Og
              ? __ldcg(ws + static_cast<long long>(m) * s.O + g * s.Og + n0 +
                       col)
              : 0;
    }
  }
  __syncthreads();

  // the epilogue, compiled for the call's residual case and output kind
  switch (e.res_mode) {
    case kResNone:
      epilogue_of<BN, kResNone>(cs, sc, bi, e, s, g, m0, n0);
      break;
    case kResSameScale:
      epilogue_of<BN, kResSameScale>(cs, sc, bi, e, s, g, m0, n0);
      break;
    default:
      epilogue_of<BN, kResIdentity>(cs, sc, bi, e, s, g, m0, n0);
  }
}

// the SMs of the current device, read once a device
int sm_count() {
  static std::atomic<int> cache[mx::kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= mx::kMaxDevices) return 0;
  int n = cache[dev].load(std::memory_order_acquire);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cache[dev].store(n, std::memory_order_release);
  }
  return n;
}

// how the shape's stages are staged (the branches above)
int load_kind(const ConvShape& s) {
  if (s.Cg % 16 == 0) return kLoad16;
  if (s.groups == 1 && s.dw == 1 && s.segs > 0) return kLoadRows;
  return kLoadBytes;
}

// the shape and its plan: tile width, stages, split-K; false if refused
bool plan(ConvShape& s, int N, int C, int H, int W, int O, int kh, int kw,
          int sh, int sw, int ph, int pw, int dh, int dw, int groups, int Ho,
          int Wo) {
  if (groups <= 0 || C % groups || O % groups || N <= 0 || Ho <= 0 ||
      Wo <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || dh <= 0 ||
      dw <= 0)
    return false;
  s.N = N; s.C = C; s.H = H; s.W = W; s.O = O; s.kh = kh; s.kw = kw;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw; s.dh = dh; s.dw = dw;
  s.groups = groups; s.Ho = Ho; s.Wo = Wo;
  s.Cg = C / groups;
  s.Og = O / groups;
  const long long K = static_cast<long long>(s.Cg) * kh * kw;
  const long long M = static_cast<long long>(N) * Ho * Wo;
  if (K <= 0 || K > 0x7fffffffLL || M > 0x7fffffffLL ||
      static_cast<long long>(N) * H * W * C > 0x7fffffffLL ||
      static_cast<long long>(O) * K > 0x7fffffffLL)
    return false;
  s.K = static_cast<int>(K);
  s.M = static_cast<int>(M);
  s.MT = (s.M + kBM - 1) / kBM;
  const int sms = sm_count();
  // 64-wide tiles where O/g is 64 or where 128-wide ones would leave
  // most SMs without a tile (the Dense's one row of tiles)
  const bool narrow_n =
      s.Og <= 64 ||
      static_cast<long long>(s.MT) * ((s.Og + 127) / 128) * groups * 2 < sms;
  const int bn = narrow_n ? 64 : 128;
  s.NT = (s.Og + bn - 1) / bn;
  s.seg = kw * C;
  s.seg_pad = (s.seg + 3) & ~3;
  s.segs = s.seg_pad <= kBK ? kBK / s.seg_pad : 0;
  s.KT = load_kind(s) == kLoadRows ? (kh + s.segs - 1) / s.segs
                                   : (s.K + kBK - 1) / kBK;
  const long long tiles = static_cast<long long>(s.MT) * s.NT * groups;
  if (static_cast<long long>(s.MT) * s.NT > 0x7fffffffLL) return false;
  // split-K where the tiles would fill under a quarter of the SMs: each
  // block at least 2 stages of depth (its ring overlaps them), as many
  // blocks as SMs at most
  s.splits = 1;
  if (sms > 0 && tiles * 4 <= sms && s.KT >= 4)
    s.splits = min(s.KT / 2, static_cast<int>(sms / tiles));
  s.kt_per = (s.KT + s.splits - 1) / s.splits;
  s.splits = (s.KT + s.kt_per - 1) / s.kt_per;
  return static_cast<long long>(groups) * s.splits <= 65535;
}

long long workspace_words(const ConvShape& s) {
  return s.splits > 1 ? static_cast<long long>(s.M) * s.O +
                            static_cast<long long>(s.MT) * s.NT * s.groups
                      : 0;
}

template <int BN, int kLoad>
cudaError_t launch(const int8_t* x, const int8_t* w, const ConvShape& s,
                   const Epilogue& e, int* ws, cudaStream_t stream) {
  static std::atomic<int> opted[mx::kMaxDevices];
  static std::atomic<int> carved[mx::kMaxDevices];
  auto kernel = int8_conv_kernel<BN, kLoad>;
  cudaError_t err = mx::opt_in_smem(kernel, Cfg<BN>::kSmem, opted);
  // two blocks an SM need the largest shared-memory carveout
  if (err == cudaSuccess) err = mx::prefer_shared(kernel, carved);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.MT * s.NT, 1, s.groups * s.splits);
  kernel<<<grid, kThreads, Cfg<BN>::kSmem, stream>>>(x, w, s, e, ws);
  return cudaGetLastError();
}

}  // namespace

// The int32 words of the split-K workspace the call with these arguments
// needs (zeroed by the caller on the launch's stream), 0 for none, -1 for
// a shape the kernel refuses. The SM count is the current device's.
MX_EXPORT long long mx_int8_conv_workspace(int N, int C, int H, int W, int O,
                                           int kh, int kw, int sh, int sw,
                                           int ph, int pw, int dh, int dw,
                                           int groups, int Ho, int Wo) {
  ConvShape s;
  if (!plan(s, N, C, H, W, O, kh, kw, sh, sw, ph, pw, dh, dw, groups, Ho,
            Wo))
    return -1;
  return workspace_words(s);
}

// y = the quantized convolution of the int8 codes x (N, C, H, W; NHWC in
// memory) with the int8 weight w (O, C/groups, kh, kw; (O, kh, kw, C/g) in
// memory): int32 sums, then the epilogue above into y (N, O, Ho, Wo; NHWC
// in memory) of out_kind (0 f32, 1 bf16, 2 f16, 3 int8, 4 the raw int32
// sums). thresh: the layer's input threshold (one f32); wscale: (O,) f32;
// bias: (O,) of bias_kind (0 f32, 1 bf16, 2 f16) or null with bias_kind -1;
// out_t: the int8 code's threshold. res: null (res_mode 0), or int8 codes
// of y's shape, NHWC, added as the same-scale (1) or identity (2) case of
// the residual block, res_t the identity's threshold, res_out_t the
// block's output threshold for an int8 y. relu: max(code, 0) on an int8
// y without a residual (the chain's relu glue after the code). ws: the
// zeroed workspace of mx_int8_conv_workspace's size, or null where that is
// 0. All pointers on the current device; y and res 16-byte aligned, x and
// w 16-byte aligned (4-byte in the rows branch). Runs on `stream`;
// returns the cudaError_t of the launch.
MX_EXPORT int mx_int8_conv(const void* x, const void* w, int N, int C, int H,
                           int W, int O, int kh, int kw, int sh, int sw,
                           int ph, int pw, int dh, int dw, int groups, int Ho,
                           int Wo, const void* thresh, const void* wscale,
                           const void* bias, int bias_kind, const void* out_t,
                           const void* res, int res_mode, const void* res_t,
                           const void* res_out_t, int relu, void* y,
                           int out_kind, void* ws, void* stream) {
  ConvShape s;
  if (!plan(s, N, C, H, W, O, kh, kw, sh, sw, ph, pw, dh, dw, groups, Ho,
            Wo))
    return cudaErrorInvalidValue;
  if (out_kind < kOutF32 || out_kind > kOutInt32 || bias_kind > kFloat16 ||
      (bias_kind >= 0 && bias == nullptr) ||
      res_mode < kResNone || res_mode > kResIdentity ||
      ((out_kind == kOutInt8 || res_mode != kResNone) && out_t == nullptr) ||
      (res_mode != kResNone &&
       (res == nullptr || out_kind == kOutInt32 ||
        (res_mode == kResIdentity && res_t == nullptr) ||
        (out_kind == kOutInt8 && res_out_t == nullptr))) ||
      (workspace_words(s) > 0 && ws == nullptr))
    return cudaErrorInvalidValue;
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  const int kind = load_kind(s);
  const auto word_misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 3) != 0;
  };
  if (misaligned(y) || (res != nullptr && misaligned(res)) ||
      (kind == kLoad16 && (misaligned(x) || misaligned(w))) ||
      (kind == kLoadRows && (word_misaligned(x) || word_misaligned(w))))
    return cudaErrorMisalignedAddress;
  if (relu && (out_kind != kOutInt8 || res_mode != kResNone))
    return cudaErrorInvalidValue;
  Epilogue e;
  e.thresh = static_cast<const float*>(thresh);
  e.wscale = static_cast<const float*>(wscale);
  e.bias = bias;
  e.bias_kind = bias_kind;
  e.out_t = static_cast<const float*>(out_t);
  e.y = y;
  e.out_kind = out_kind;
  e.res = static_cast<const int8_t*>(res);
  e.res_mode = res_mode;
  e.res_t = static_cast<const float*>(res_t);
  e.res_out_t = static_cast<const float*>(res_out_t);
  e.relu = relu;
  e.vec = O % 16 == 0 && s.Og % 16 == 0;
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* wt = static_cast<const int8_t*>(w);
  int* const wsp = static_cast<int*>(ws);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const bool bn64 = (s.Og + 63) / 64 == s.NT;
  switch (kind) {
    case kLoad16:
      return bn64 ? launch<64, kLoad16>(xs, wt, s, e, wsp, strm)
                  : launch<128, kLoad16>(xs, wt, s, e, wsp, strm);
    case kLoadRows:
      return bn64 ? launch<64, kLoadRows>(xs, wt, s, e, wsp, strm)
                  : launch<128, kLoadRows>(xs, wt, s, e, wsp, strm);
    default:
      return bn64 ? launch<64, kLoadBytes>(xs, wt, s, e, wsp, strm)
                  : launch<128, kLoadBytes>(xs, wt, s, e, wsp, strm);
  }
}
