// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011), the counter-based generator behind the port's dropout
// masks (dropout.cu, fused_block.cu).
//
// One stream per framework key: the key is the key's two 32-bit words,
// the counter is the element's flat index, and element i takes word
// i mod 4 of the block drawn at counter floor(i / 4). A mask therefore
// depends on the key and the element's index only, never on block or
// tile sizes, so a forward and its backward regenerate the same mask
// with any launch shape, and the plain PyTorch version
// (ops/_philox.py) draws the same bits. An element is kept when its
// word is >= threshold = min(int(p * 2^32), 2^32 - 1) and is then
// scaled by 1 / (1 - p); dropped elements are 0.
#pragma once

#include <cuda_runtime.h>

namespace mx {

struct DropoutKey {
  unsigned k0, k1;     // the framework key's two words
  unsigned threshold;  // keep where bits >= threshold
  float scale;         // 1 / (1 - p)
};

// the 128 random bits of `counter` (a 64-bit block index; the high two
// counter words are 0) under the key (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(unsigned long long counter,
                                               unsigned k0, unsigned k1) {
  unsigned c0 = static_cast<unsigned>(counter);
  unsigned c1 = static_cast<unsigned>(counter >> 32);
  unsigned c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// the words of the E elements (E a multiple of 4) from flat index i on,
// i a multiple of 4
template <int E>
__device__ __forceinline__ void philox_words(unsigned long long i,
                                             const DropoutKey& key,
                                             unsigned* out) {
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const uint4 r = philox4x32_10(i / 4 + q, key.k0, key.k1);
    out[4 * q] = r.x;
    out[4 * q + 1] = r.y;
    out[4 * q + 2] = r.z;
    out[4 * q + 3] = r.w;
  }
}

}  // namespace mx
