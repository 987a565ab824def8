// Philox4x32-10 (Salmon et al., SC 2011): the dropout bits of the port's
// CUDA kernels. The same generator, with the same counter layouts, is
// written in plain PyTorch in miner_tpu_torch/ops/philox.py (and in Triton
// in ops/add_ln.py), so a kernel and its plain version draw the same mask
// from the same 64-bit seed. See ops/philox.py for the layouts. The add_ln
// forward is a Triton kernel that writes the rounds out again (ops/add_ln.py)
// with the counter layout of add_ln_bits below.
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
    // one 32 x 32 -> 64-bit multiply gives both halves
    const unsigned long long p0 = static_cast<unsigned long long>(0xD2511F53u) * c0;
    const unsigned long long p1 = static_cast<unsigned long long>(0xCD9E8D57u) * c2;
    c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0;
    c1 = static_cast<uint32_t>(p1);
    c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1;
    c3 = static_cast<uint32_t>(p0);
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

// The mha layout: element (query i, key j) of head h of sequence n is word
// 2 * bit3(i) + bit3(j) of philox(counter = (j', i', h, n)), with h and n the
// head's and the sequence's places in the whole batch (a launch over some of
// them passes its local index plus its offset), where x' is x
// with bit 3 taken out (x' = (x >> 4) * 8 + x % 8). One call covers
// {i, i+8} x {j, j+8}: the four values one lane holds of a 16 x 16 block in
// the mma C layout, whether queries or keys are the rows.
//
// The call for queries 16 qb + qr + {0, 8} and keys 16 kb + kr + {0, 8}
// (qr, kr < 8): word w[2 a + b] is the bits of (query + 8 a, key + 8 b).
__device__ __forceinline__ Philox4 mha_block_bits(int qb, int qr, int kb, int kr, int h,
                                                  int n, unsigned long long seed) {
  return philox4x32_10(static_cast<uint32_t>(kb * 8 + kr), static_cast<uint32_t>(qb * 8 + qr),
                       static_cast<uint32_t>(h), static_cast<uint32_t>(n), seed);
}

// The add_ln layout: element (row r, column c) is word c % 4 of
// philox(counter = (c / 4, r, 0, 0)), r the row's place in the whole batch. The call for columns 4 q .. 4 q + 3 of
// row r: word w[i] is the bits of column 4 q + i.
__device__ __forceinline__ Philox4 add_ln_bits(int q, int r, unsigned long long seed) {
  return philox4x32_10(static_cast<uint32_t>(q), static_cast<uint32_t>(r), 0u, 0u, seed);
}
