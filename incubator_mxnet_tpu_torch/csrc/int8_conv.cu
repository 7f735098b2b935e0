// int8 x int8 -> int32 convolution as an implicit GEMM on the tensor cores,
// with the quantized layers' epilogue fused (Q1).
//
// Replaces no Pallas kernel. The reference contracts int8 codes with XLA ops
// at preferred_element_type=int32 (`incubator_mxnet_tpu/contrib/
// quantization.py:334-336`, the Dense; `:405-410`, the Conv2D). PyTorch has
// no int8 convolution with int32 sums on CUDA, so this kernel is what the
// card needs to run the reference's int8 path at all.
//
// The product: M = N*Ho*Wo output positions, N = O/g output channels of a
// group, K = (C/g)*kh*kw. A block computes a 128 x 64 tile of (M, N) for one
// group (grid z). It stages an A tile of 128 rows x 32 k by gathering int8
// codes from the NCHW input into shared memory (zeros for padding and for
// K's ragged end: the stem has K = 147) and a B tile of 64 x 32 from the
// (O, C/g, kh, kw) weight, which is already the k-contiguous column layout
// `mma.sync ... .row.col` wants. Four warps each run 4 x 4
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` a k-step on a 64 x 32
// warp tile, summing in int32. Shared rows are 48 bytes apart, so the
// fragments' 4-byte reads hit 32 distinct banks. The Dense is the same
// kernel at H = W = kh = kw = 1.
//
// Bound on the H100: at ResNet-50's shapes, bytes (each layer's int8 input
// and output once and its weight) against 2*M*N*K operations at 1979 TOP/s.
// This first design re-gathers A once a 64-channel tile of N, byte by byte,
// so it is bound by its loads, not by either: `PERF.md` holds its times.
// wgmma with s8, TMA and a channels-last int8 layout are later work.
//
// The epilogue in the reference's order (`quantization.py:338-349`,
// `:412-421`): s_x = thresh / 127; y = float(acc) * (s_x * w_scale[o]);
// + bias[o]; then int8 at the consumer's threshold, clip(rint(y * (127 /
// out_t)), -127, 127), or the net's float type, or the raw int32 sums.
// Every step is an explicitly rounded intrinsic (__fdiv_rn, __fmul_rn,
// __fadd_rn): nvcc would contract a*b + c into an FMA, which rounds once
// where the plain version's separate torch ops round twice, and a code that
// flips at a tie would run down the chain. Rounding is half to even
// (__float2int_rn), as torch.round's. The thresholds and scales are read from
// device memory when the kernel runs, never passed by value: the chain
// shares the consumer's threshold Parameter, which load_parameters updates
// in place, and a replayed CUDA graph would keep a value baked into its
// launch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kRow = kBK + 16;  // shared row stride in bytes

// what the epilogue writes
enum OutKind : int { kOutF32 = 0, kOutBF16 = 1, kOutF16 = 2, kOutInt8 = 3,
                     kOutInt32 = 4 };

struct ConvShape {
  int N, C, H, W;         // the input, NCHW
  int O, kh, kw;          // the weight, (O, C/g, kh, kw)
  int sh, sw, ph, pw, dh, dw;
  int groups, Ho, Wo;
  int Cg, Og, K, M;       // C/g, O/g, (C/g)*kh*kw, N*Ho*Wo
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld_smem_u32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

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

__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, ConvShape s,
                     const float* __restrict__ thresh,
                     const float* __restrict__ wscale,
                     const void* __restrict__ bias, int bias_kind,
                     const float* __restrict__ out_t, void* __restrict__ y,
                     int out_kind) {
  __shared__ __align__(16) int8_t As[kBM * kRow];
  __shared__ __align__(16) int8_t Bs[kBN * kRow];
  // the k-step's 32 taps: the input offset of (c, r, s) from the row's
  // origin, r*dh and s*dw for the bounds test; -1 past K
  __shared__ int k_off[kBK];
  __shared__ int k_r[kBK];
  __shared__ int k_s[kBK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int hw = s.Ho * s.Wo;
  const int khw = s.kh * s.kw;

  // the A row this thread gathers: output position m0 + tid
  const int am = m0 + tid;
  const bool a_row = am < s.M;
  long long a_base = 0;
  int a_ih0 = 0, a_iw0 = 0;
  if (a_row) {
    const int n = am / hw;
    const int rem = am - n * hw;
    const int oh = rem / s.Wo;
    const int ow = rem - oh * s.Wo;
    a_ih0 = oh * s.sh - s.ph;
    a_iw0 = ow * s.sw - s.pw;
    a_base = (static_cast<long long>(n) * s.C +
              static_cast<long long>(g) * s.Cg) * s.H * s.W +
             static_cast<long long>(a_ih0) * s.W + a_iw0;
  }
  // the B row this thread loads: 16 bytes of weight row n0 + tid / 2
  const int bn = tid >> 1;
  const int bk = (tid & 1) * 16;
  const bool b_row = n0 + bn < s.Og;
  const int8_t* wrow =
      w + (static_cast<long long>(g) * s.Og + n0 + bn) * s.K;
  const bool w_vec = (s.K & 15) == 0;

  const int wm = (warp & 1) * 64;
  const int wn = (warp >> 1) * 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < s.K; k0 += kBK) {
    if (tid < kBK) {
      const int k = k0 + tid;
      if (k < s.K) {
        const int c = k / khw;
        const int rs = k - c * khw;
        const int r = rs / s.kw;
        const int q = rs - r * s.kw;
        k_r[tid] = r * s.dh;
        k_s[tid] = q * s.dw;
        k_off[tid] = c * s.H * s.W + r * s.dh * s.W + q * s.dw;
      } else {
        k_off[tid] = -1;
      }
    }
    __syncthreads();
    // A: 32 codes of row tid, four to a word
    unsigned* arow = reinterpret_cast<unsigned*>(As + tid * kRow);
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = j * 4 + e;
        const int off = k_off[kk];
        int v = 0;
        if (a_row && off >= 0) {
          const int ih = a_ih0 + k_r[kk];
          const int iw = a_iw0 + k_s[kk];
          if (static_cast<unsigned>(ih) < static_cast<unsigned>(s.H) &&
              static_cast<unsigned>(iw) < static_cast<unsigned>(s.W))
            v = x[a_base + off];
        }
        word |= (static_cast<unsigned>(v) & 0xffu) << (8 * e);
      }
      arow[j] = word;
    }
    // B: 16 codes of weight row bn
    unsigned* brow = reinterpret_cast<unsigned*>(Bs + bn * kRow + bk);
    if (b_row && w_vec && k0 + bk + 16 <= s.K) {
      const uint4 v = *reinterpret_cast<const uint4*>(wrow + k0 + bk);
      brow[0] = v.x;
      brow[1] = v.y;
      brow[2] = v.z;
      brow[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + bk + j * 4 + e;
          const int v = (b_row && k < s.K) ? wrow[k] : 0;
          word |= (static_cast<unsigned>(v) & 0xffu) << (8 * e);
        }
        brow[j] = word;
      }
    }
    __syncthreads();
    unsigned af[4][4];
    unsigned bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* r0 = As + (wm + i * 16 + gid) * kRow + tig * 4;
      const int8_t* r1 = r0 + 8 * kRow;
      af[i][0] = ld_smem_u32(r0);
      af[i][1] = ld_smem_u32(r1);
      af[i][2] = ld_smem_u32(r0 + 16);
      af[i][3] = ld_smem_u32(r1 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* c0 = Bs + (wn + j * 8 + gid) * kRow + tig * 4;
      bf[j][0] = ld_smem_u32(c0);
      bf[j][1] = ld_smem_u32(c0 + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  // the epilogue: each element's (m, o) from the mma's C fragment
  const float s_x = __fdiv_rn(thresh[0], 127.f);
  const float q_mul =
      out_kind == kOutInt8 ? __fdiv_rn(127.f, out_t[0]) : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ol = n0 + wn + j * 8 + tig * 2 + c;
      if (ol >= s.Og) continue;
      const int o = g * s.Og + ol;
      const float scale = __fmul_rn(s_x, wscale[o]);
      const float b = bias_kind >= 0 ? load_bias(bias, bias_kind, o) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + i * 16 + gid + h * 8;
          if (m >= s.M) continue;
          const int a = acc[i][j][h * 2 + c];
          const int n = m / hw;
          const long long idx =
              (static_cast<long long>(n) * s.O + o) * hw + (m - n * hw);
          if (out_kind == kOutInt32) {
            static_cast<int*>(y)[idx] = a;
            continue;
          }
          float v = __fmul_rn(__int2float_rn(a), scale);
          if (bias_kind >= 0) v = __fadd_rn(v, b);
          switch (out_kind) {
            case kOutF32:
              static_cast<float*>(y)[idx] = v;
              break;
            case kOutBF16:
              static_cast<__nv_bfloat16*>(y)[idx] = __float2bfloat16_rn(v);
              break;
            case kOutF16:
              static_cast<__half*>(y)[idx] = __float2half_rn(v);
              break;
            default: {
              int q = __float2int_rn(__fmul_rn(v, q_mul));
              q = q < -127 ? -127 : (q > 127 ? 127 : q);
              static_cast<int8_t*>(y)[idx] = static_cast<int8_t>(q);
            }
          }
        }
      }
    }
  }
}

}  // namespace

// y = the quantized convolution of the int8 codes x (N, C, H, W) with the
// int8 weight w (O, C/groups, kh, kw): int32 sums, then the epilogue above
// into y (N, O, Ho, Wo) of out_kind (0 f32, 1 bf16, 2 f16, 3 int8 at the
// threshold *out_t, 4 the raw int32 sums). thresh: the layer's input
// threshold (one f32); wscale: (O,) f32; bias: (O,) of bias_kind (0 f32,
// 1 bf16, 2 f16) or null with bias_kind -1. All pointers on the current
// device, x and w contiguous, w 16-byte aligned. Runs on `stream`; returns
// the cudaError_t of the launch.
MX_EXPORT int mx_int8_conv(const void* x, const void* w, int N, int C, int H,
                           int W, int O, int kh, int kw, int sh, int sw,
                           int ph, int pw, int dh, int dw, int groups, int Ho,
                           int Wo, const void* thresh, const void* wscale,
                           const void* bias, int bias_kind, const void* out_t,
                           void* y, int out_kind, void* stream) {
  if (groups <= 0 || C % groups || O % groups || N <= 0 || Ho <= 0 ||
      Wo <= 0 || out_kind < kOutF32 || out_kind > kOutInt32 ||
      (out_kind == kOutInt8 && out_t == nullptr) ||
      bias_kind > kFloat16 || (bias_kind >= 0 && bias == nullptr))
    return cudaErrorInvalidValue;
  ConvShape s;
  s.N = N; s.C = C; s.H = H; s.W = W; s.O = O; s.kh = kh; s.kw = kw;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw; s.dh = dh; s.dw = dw;
  s.groups = groups; s.Ho = Ho; s.Wo = Wo;
  s.Cg = C / groups;
  s.Og = O / groups;
  const long long K = static_cast<long long>(s.Cg) * kh * kw;
  const long long M = static_cast<long long>(N) * Ho * Wo;
  if (K <= 0 || K > 0x7fffffffLL || M > 0x7fffffffLL ||
      static_cast<long long>(C) * H * W > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  s.K = static_cast<int>(K);
  s.M = static_cast<int>(M);
  const dim3 grid((s.M + kBM - 1) / kBM, (s.Og + kBN - 1) / kBN, groups);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  int8_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), s,
      static_cast<const float*>(thresh), static_cast<const float*>(wscale),
      bias, bias_kind, static_cast<const float*>(out_t), y, out_kind);
  return cudaGetLastError();
}
