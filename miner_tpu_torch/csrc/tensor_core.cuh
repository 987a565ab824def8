// Hopper building blocks for the bf16 attention kernels: 16-byte async
// copies into shared memory, ldmatrix fragment loads and the bf16
// mma.sync.m16n8k16 tile product with fp32 accumulators.
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
