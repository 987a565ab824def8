// Philox4x32-10 (Salmon et al., SC 2011): the dropout bits of the port's
// CUDA kernels. The same generator, with the same counter layouts, is
// written in plain PyTorch in miner_tpu_torch/ops/philox.py (and in Triton
// in ops/add_ln.py), so a kernel and its plain version draw the same mask
// from the same 64-bit seed. See ops/philox.py for the layouts.
#pragma once

#include <stdint.h>

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 unsigned long long seed) {
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  Philox4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}
