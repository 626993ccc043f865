// Philox4x32-10 uniforms shared by the port's CUDA kernels
// (fused_cggibbs.cu, freerun_automaton.cu); ops/philox.py computes the same
// function in PyTorch.
#pragma once

#include <stdint.h>

namespace mcmcglm {

// Philox4x32-10 of the counter (c0, c1, c2, c3) under (k0, k1): the first
// output word, mapped to (0, 1) as the TPU kernel's _uniform maps its bits
__device__ __forceinline__ float philox_uniform(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  const float u = __fmul_rn(__uint2float_rn(c0 >> 9), 1.f / 8388608.f);
  return fmaxf(u, 1e-12f);
}

}  // namespace mcmcglm
