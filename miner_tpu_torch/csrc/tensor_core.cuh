// Hopper building blocks for the attention kernels: async copies into
// shared memory, ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 tile
// product with fp32 accumulators, and the split-TF32 m16n8k8 product that
// the fp32 kernels take (below).
//
// Fragment layout of m16n8k16 (lane = 4 * g + t, g in 0..7, t in 0..3):
//   A (16 x 16, row-major) a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   B (16 x 8, k x n)      b0: (k 2t..2t+1, n g)  b1: (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32)       c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1)
// so the C tiles of two neighbouring n8 column blocks, rounded to bf16 and
// packed in pairs, are the A fragment of the next product over those 16
// columns, with no trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes is 16 or 0 (0: the 16 bytes are zeroed)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, for an fp32 tensor off a 16-byte boundary;
// src_bytes is 4 or 0 (0: zeroed)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed on the way into registers
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b on the tensor cores: a 16x16 bf16, b 16x8 bf16, c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// sum over 8 of a[k] * b[k], bf16 pairs in two 16-byte vectors, in fp32
__device__ __forceinline__ float dot8_bf16(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 u = __bfloat1622float2(x[k]), v = __bfloat1622float2(y[k]);
    acc += u.x * v.x + u.y * v.y;
  }
  return acc;
}

// ------------------------------------------------------------ split TF32
// The tensor cores take fp32 operands only as TF32 (10-bit mantissa), which
// alone misses an fp32 tolerance of 1e-4 by ~3x at attention's shapes. Split
// TF32 keeps about fp32's accuracy at three TF32 passes: x = hi + lo with hi
// = x rounded to TF32 and lo = x - hi (exact in fp32), and a b ~ a_lo b_hi +
// a_hi b_lo + a_hi b_hi (the dropped a_lo b_lo is ~2^-22 of a b), the small
// terms first. It is the scheme of PyTorch's memory-efficient attention in
// fp32 (and CUTLASS's 3xTF32). hi is rounded to nearest with ties away, as
// cvt.rna.tf32.f32 rounds, but by two integer operations (add half a TF32
// ulp to the bits, clear the 13 low ones); lo goes to the mma as its fp32
// bits, whose 13 low bits the tensor cores ignore: lo loses at most 2^-10 of
// itself, 2^-21 of x. On the card, cvt.rna for hi and lo made the fp32
// attention kernels 1.2x slower. tests/test_torch_tf32.py emulates this
// bit for bit on the CPU.
//
// Fragment layout of m16n8k8 tf32 (lane = 4 * g + t):
//   A (16 x 8, row-major) a0: (g, t)  a1: (g+8, t)  a2: (g, t+4)  a3: (g+8, t+4)
//   B (8 x 8, k x n)      b0: (k t, n g)  b1: (k t+4, n g)
//   C (16 x 8, fp32)      as m16n8k16: c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1)
// A C tile does not have the A layout, but the order of k within a product
// is free: read A's column t as column 2t and column t + 4 as 2t + 1 (and B's
// rows likewise), and the C tile {c0, c2, c1, c3} is an A fragment over its 8
// columns, with no shuffle. B then reads rows 2t and 2t + 1; with rows
// padded by 4 floats those reads, like the unpermuted (row g, column t) ones,
// fall on 32 distinct banks.

struct Tf32 {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32 split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// an A fragment {a0, a1, a2, a3} split into its hi and lo parts
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32 x = split_tf32(a[i]);
    f.hi[i] = x.hi;
    f.lo[i] = x.lo;
  }
  return f;
}

// the A fragment of a C tile's 16 x 8 values, columns permuted as above
__device__ __forceinline__ FragA split_c_as_a(const float c[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// c += a b on the tensor cores: a 16x8 tf32, b 8x8 tf32, c 16x8 fp32
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32, b given as its two fp32 values (b0, b1)
__device__ __forceinline__ void mma_3xtf32(float c[4], const FragA& a, float b0, float b1) {
  const Tf32 x = split_tf32(b0), y = split_tf32(b1);
  mma_tf32(c, a.lo, x.hi, y.hi);
  mma_tf32(c, a.hi, x.lo, y.lo);
  mma_tf32(c, a.hi, x.hi, y.hi);
}
