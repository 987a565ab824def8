// Fused cache lookup + candidate scoring, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/lookup_score.py:_lookup_kernel
// (pallas_call at lookup_score.py:134, reached through lookup_score_fused).
// With a (N, D) news-embedding cache, (B, C) candidate rows and (B, K, D)
// interests:
//   out[b, c, k] = cache[cand_idx[b, c]] . interests[b, k]
// without ever building the (B, C, D) gather in device memory.
//
// What bounds it: each candidate row is D values read once and scored
// against K interests, 2*K flops per value: 32 flop/byte for a bf16 cache
// at K = 32, far under the ridge, so the bound is the bytes of the rows
// gathered. A corpus top-k reads every cache row once per batch row; the
// rows of a cache of a few thousand news stay in the 50 MB L2.
//
// Design: one block per (batch row, tile of 64 candidates). The block loads
// its row indices, gathers the rows into shared memory in the cache's own
// type (bf16 or fp32; no fp32 copy of the cache exists), holds the batch
// row's interests in shared memory as fp32 (rows padded against bank
// conflicts), and writes the (tile, K) scores in the interests' type with
// fp32 accumulation. K is not padded to 128: that was TPU lane layout. An
// index outside the cache gives NaN scores for that candidate, as a
// gather out of range does in JAX, instead of reading out of bounds.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TC = 64;  // candidates per block

template <typename TCache, typename TI>
__global__ void __launch_bounds__(THREADS)
lookup_score_fwd_kernel(const TCache* __restrict__ cache,
                        const int* __restrict__ cand_idx,
                        const TI* __restrict__ interests, TI* __restrict__ out,
                        int N, int C, int K, int D) {
  extern __shared__ float smem[];
  float* sI = smem;  // (K, D + 1)
  TCache* sR = reinterpret_cast<TCache*>(sI + K * (D + 1));  // (TC, D)
  __shared__ int sIdx[TC];
  const int b = blockIdx.y, c0 = blockIdx.x * TC, tid = threadIdx.x;
  const int nc = min(TC, C - c0);

  const TI* it = interests + (long)b * K * D;
  for (int idx = tid; idx < K * D; idx += THREADS)
    sI[(idx / D) * (D + 1) + idx % D] = to_float(it[idx]);
  for (int r = tid; r < nc; r += THREADS) sIdx[r] = cand_idx[(long)b * C + c0 + r];
  __syncthreads();

  for (int idx = tid; idx < nc * D; idx += THREADS) {
    const int row = sIdx[idx / D];
    if (row >= 0 && row < N) sR[idx] = cache[(long)row * D + idx % D];
  }
  __syncthreads();

  TI* o = out + ((long)b * C + c0) * K;
  for (int idx = tid; idx < nc * K; idx += THREADS) {
    const int r = idx / K, k = idx % K;
    const int row = sIdx[r];
    float acc;
    if (row >= 0 && row < N) {
      const TCache* rr = sR + r * D;
      const float* ir = sI + k * (D + 1);
      acc = 0.f;
      for (int d = 0; d < D; ++d) acc += to_float(rr[d]) * ir[d];
    } else {
      acc = __int_as_float(0x7fc00000);  // NaN
    }
    o[idx] = from_float<TI>(acc);
  }
}

template <typename TCache, typename TI>
cudaError_t launch_lookup(const void* cache, const void* cand_idx,
                          const void* interests, void* out, int N, int B, int C,
                          int K, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)K * (D + 1) + sizeof(TCache) * (size_t)TC * D;
  cudaError_t err = cudaFuncSetAttribute(
      lookup_score_fwd_kernel<TCache, TI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + TC - 1) / TC, B);
  lookup_score_fwd_kernel<TCache, TI><<<grid, THREADS, smem, stream>>>(
      static_cast<const TCache*>(cache), static_cast<const int*>(cand_idx),
      static_cast<const TI*>(interests), static_cast<TI*>(out), N, C, K, D);
  return cudaGetLastError();
}

template <typename TCache>
cudaError_t dispatch_interests(const void* cache, const void* cand_idx,
                               const void* interests, void* out, int N, int B,
                               int C, int K, int D, int interests_dtype,
                               cudaStream_t stream) {
  switch (interests_dtype) {
    case DTYPE_F32:
      return launch_lookup<TCache, float>(cache, cand_idx, interests, out, N, B,
                                          C, K, D, stream);
    case DTYPE_BF16:
      return launch_lookup<TCache, __nv_bfloat16>(cache, cand_idx, interests,
                                                  out, N, B, C, K, D, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// cache (N, D) in cache_dtype; cand_idx (B, C) int32; interests (B, K, D) and
// out (B, C, K) in interests_dtype; all contiguous.
extern "C" int lookup_score_fwd(const void* cache, const void* cand_idx,
                                const void* interests, void* out, int N, int B,
                                int C, int K, int D, int cache_dtype,
                                int interests_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || B <= 0 || B > 65535 || C <= 0 || K <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case DTYPE_F32:
      return dispatch_interests<float>(cache, cand_idx, interests, out, N, B, C,
                                       K, D, interests_dtype, s);
    case DTYPE_BF16:
      return dispatch_interests<__nv_bfloat16>(cache, cand_idx, interests, out,
                                               N, B, C, K, D, interests_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}
