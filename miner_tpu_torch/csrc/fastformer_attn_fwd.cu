// Fastformer additive attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/fastformer_attn.py:_ff_kernel
// (pallas_call at fastformer_attn.py:114, reached through _ff_pallas and
// fastformer_attention_fused). Per batch row b, with q, k (L, D), h heads of
// hd = D / h channels, scale 1/sqrt(hd) and a mask bias of 0 or -10000:
//   alpha[l,j]  = softmax_l((q[l] . wqa[:,j] + bqa[j]) * scale + bias[l])
//   pooled_q[d] = sum_l alpha[l, d/hd] q[l,d]
//   u[l,d]      = k[l,d] pooled_q[d]
//   beta[l,j]   = softmax_l((u[l] . wka[:,j] + bka[j]) * scale + bias[l])
//   pooled_k[d] = sum_l beta[l, d/hd] u[l,d]
//   out[l,d]    = pooled_k[d] q[l,d]
// Each head's score is a dot over the whole D. Intermediates are rounded to
// the input type where the JAX reference rounds them (scores before and
// after the bias, softmax weights, pooled vectors, u); fp32 accumulation.
//
// What bounds it: at the training path's shape (B=16, L=50, D=256, h=16,
// fp32) a call reads and writes ~0.53 MB and does ~14 MFLOP: 0.16 us of
// bytes and 0.2 us of fp32 operations on an H100. Its time is set by the
// launch and by the latency of a few dependent passes over a row, not by
// bytes or operations; B rows fill at most B of the 132 SMs.
//
// Design: one block per batch row. Both weights (transposed, so a warp's
// lanes read consecutive channels), their biases, the (h, L) scores and
// both pooled vectors live in shared memory (~50 KB at L=256, D=256,
// h=16). q and k stay in device memory and are read in four coalesced
// passes (they are L2-resident: 51 KB a row in fp32); u is recomputed from
// k and pooled_q where it is needed instead of being stored. A score row is
// one warp: lanes split D and 16 heads accumulate in registers per pass.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HC = 16;  // heads accumulated in registers per pass over D
constexpr float FF_MASK_FILL = -10000.f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x[l, d] = a[l, d], or round(a[l, d] * mod[d]) when mod is given (u)
template <typename T>
__device__ __forceinline__ float input(const T* a, const float* mod, int D,
                                       int l, int d) {
  const float x = to_float(a[(long)l * D + d]);
  return mod == nullptr ? x : round_to<T>(x * mod[d]);
}

// sS[j, l] = round(round(x[l] . w[:, j]) + b[j]) * scale + bias[l]
template <typename T>
__device__ void scores(const T* a, const float* mod, const float* sWt,
                       const float* sB, const int* mask, float* sS, int L,
                       int D, int h, float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int l = warp; l < L; l += WARPS) {
    const float bias = mask[l] != 0 ? 0.f : FF_MASK_FILL;
    for (int j0 = 0; j0 < h; j0 += HC) {
      float acc[HC];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) acc[jj] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float x = input(a, mod, D, l, d);
#pragma unroll
        for (int jj = 0; jj < HC; ++jj)
          if (j0 + jj < h) acc[jj] += x * sWt[(j0 + jj) * D + d];
      }
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const float s = warp_sum(acc[jj]);
        if (lane == 0 && j0 + jj < h)
          sS[(j0 + jj) * L + l] =
              round_to<T>(round_to<T>(s) + sB[j0 + jj]) * scale + bias;
      }
    }
  }
}

// softmax over l of each head's row of sS, rounded to T; one warp a head
template <typename T>
__device__ void softmax_rows(float* sS, int L, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < h; j += WARPS) {
    float* row = sS + j * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, row[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(row[l] - m);
      row[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) row[l] = round_to<T>(row[l] / sum);
  }
}

// pooled[d] = round(sum_l weights[head(d), l] x[l, d]); one thread a channel
template <typename T>
__device__ void pool(const T* a, const float* mod, const float* sS,
                     float* pooled, int L, int D, int hd) {
  for (int d = threadIdx.x; d < D; d += THREADS) {
    const float* w = sS + (d / hd) * L;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc += w[l] * input(a, mod, D, l, d);
    pooled[d] = round_to<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fastformer_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ wqa, const T* __restrict__ bqa,
                           const T* __restrict__ wka, const T* __restrict__ bka,
                           const int* __restrict__ mask, T* __restrict__ out,
                           int L, int D, int h) {
  extern __shared__ float smem[];
  float* sWq = smem;         // (h, D): wqa transposed
  float* sWk = sWq + h * D;  // (h, D): wka transposed
  float* sBq = sWk + h * D;  // (h,)
  float* sBk = sBq + h;      // (h,)
  float* sS = sBk + h;       // (h, L): scores, then softmax weights
  float* sPq = sS + h * L;   // (D,) pooled_q
  float* sPk = sPq + D;      // (D,) pooled_k
  const int tid = threadIdx.x, hd = D / h;
  const long row = (long)blockIdx.x * L * D;
  const T* qb = q + row;
  const T* kb = k + row;
  const int* mb = mask + (long)blockIdx.x * L;
  const float scale = 1.f / sqrtf((float)hd);

  for (int idx = tid; idx < D * h; idx += THREADS) {
    const int d = idx / h, j = idx % h;
    sWq[j * D + d] = to_float(wqa[idx]);
    sWk[j * D + d] = to_float(wka[idx]);
  }
  for (int j = tid; j < h; j += THREADS) {
    sBq[j] = to_float(bqa[j]);
    sBk[j] = to_float(bka[j]);
  }
  __syncthreads();

  scores<T>(qb, nullptr, sWq, sBq, mb, sS, L, D, h, scale);
  __syncthreads();
  softmax_rows<T>(sS, L, h);
  __syncthreads();
  pool<T>(qb, nullptr, sS, sPq, L, D, hd);
  __syncthreads();
  scores<T>(kb, sPq, sWk, sBk, mb, sS, L, D, h, scale);
  __syncthreads();
  softmax_rows<T>(sS, L, h);
  __syncthreads();
  pool<T>(kb, sPq, sS, sPk, L, D, hd);
  __syncthreads();

  T* ob = out + row;
  for (int idx = tid; idx < L * D; idx += THREADS)
    ob[idx] = from_float<T>(sPk[idx % D] * to_float(qb[idx]));
}

template <typename T>
cudaError_t launch_ff(const void* q, const void* k, const void* wqa,
                      const void* bqa, const void* wka, const void* bka,
                      const void* mask, void* out, int B, int L, int D, int h,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)h * D + 2 * (size_t)h +
                                       (size_t)L * h + 2 * (size_t)D);
  cudaError_t err = cudaFuncSetAttribute(
      fastformer_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fastformer_attn_fwd_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(wqa), static_cast<const T*>(bqa),
      static_cast<const T*>(wka), static_cast<const T*>(bka),
      static_cast<const int*>(mask), static_cast<T*>(out), L, D, h);
  return cudaGetLastError();
}

}  // namespace

// q, k and out (B, L, D), wqa and wka (D, h), bqa and bka (h,), all of one
// dtype; mask (B, L) int32; all contiguous.
extern "C" int fastformer_attn_fwd(const void* q, const void* k, const void* wqa,
                                   const void* bqa, const void* wka,
                                   const void* bka, const void* mask, void* out,
                                   int B, int L, int D, int h, int dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || L <= 0 || D <= 0 || h <= 0 || D % h != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch_ff<float>(q, k, wqa, bqa, wka, bka, mask, out, B, L, D, h, s);
    case DTYPE_BF16:
      return launch_ff<__nv_bfloat16>(q, k, wqa, bqa, wka, bka, mask, out, B, L,
                                       D, h, s);
    default:
      return cudaErrorInvalidValue;
  }
}
