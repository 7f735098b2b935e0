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
//
// A key is given either by value (k0, k1: the eager path) or in device
// memory (`words`, two words a kernel reads at its start: a dropout site
// of a step replayed as a CUDA graph, whose keys change from replay to
// replay while the launch's arguments cannot). Both give the same mask
// for the same words. Device keys are folded on the card (fold_key,
// dropout.cu's fold kernel) from the step's base key and counter t and
// the site's index, as ops/_philox.py `fold` does on any device.
#pragma once

#include <cuda_runtime.h>

namespace mx {

struct DropoutKey {
  unsigned k0, k1;     // the framework key's two words
  unsigned threshold;  // keep where bits >= threshold
  float scale;         // 1 / (1 - p)
  // when set, the key's two words in device memory, read in place of
  // (k0, k1) by load_key
  const uint2* words = nullptr;
};

// `key` with (k0, k1) read from its device words, if it has them; a
// kernel that draws a mask calls this once, at its start
__device__ __forceinline__ DropoutKey load_key(DropoutKey key) {
  if (key.words != nullptr) {
    const uint2 w = __ldg(key.words);
    key.k0 = w.x;
    key.k1 = w.y;
  }
  return key;
}

// the 128 random bits of the counter (c0, c1, c2, c3) under (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(unsigned c0, unsigned c1,
                                               unsigned c2, unsigned c3,
                                               unsigned k0, unsigned k1) {
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

// the 128 random bits of `counter` (a 64-bit block index; the high two
// counter words are 0) under the key (k0, k1): a mask's stream
__device__ __forceinline__ uint4 philox4x32_10(unsigned long long counter,
                                               unsigned k0, unsigned k1) {
  return philox4x32_10(static_cast<unsigned>(counter),
                       static_cast<unsigned>(counter >> 32), 0u, 0u, k0, k1);
}

// The key (k0, k1) folded with the 64-bit number n: the first two words
// of the block at counter (n mod 2^32, n >> 32, 0, 1). Word 3 is 1 where
// every block of a mask's stream has word 3 = 0, so a fold never draws a
// block of a mask under the same key. A step's key is fold_key(base, t),
// a site's key fold_key(step key, site).
__device__ __forceinline__ uint2 fold_key(unsigned k0, unsigned k1,
                                          unsigned long long n) {
  const uint4 r = philox4x32_10(static_cast<unsigned>(n),
                                static_cast<unsigned>(n >> 32), 0u, 1u, k0,
                                k1);
  return make_uint2(r.x, r.y);
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
