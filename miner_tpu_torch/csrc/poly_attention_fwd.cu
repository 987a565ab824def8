// Fused poly-attention (interest extraction), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/poly_attention.py:_poly_kernel
// (pallas_call at poly_attention.py:91, reached through
// poly_attention_fused). Per batch row b, with emb (H, D), W (D, P) and
// codes (K, P):
//   proj    = tanh(emb @ W), rounded to emb's type      (H, P)
//   logits  = proj @ codes^T + bias[b]; masked -> -1e9   (H, K)
//   weights = softmax over H (fp32), rounded to emb's type
//   out     = weights^T @ emb                           (K, D)
//
// What bounds it: at the main path's shapes (H=50, D=256, P=200, K=32) a
// row reads 25.6 KB of bf16 emb and does ~6.1 MFLOP, ~240 flop/byte; W and
// codes (~115 KB) are shared by every row and stay in L2. Near the ridge,
// and with B <= 32 rows per request batch the card is mostly idle: the
// real cost is the launch, which the fusion keeps at one.
//
// Design: one block per batch row, everything in shared memory (emb, proj,
// codes, logits: ~123 KB at the main path's shapes, dynamic shared memory),
// so no intermediate touches device memory. W streams from L2, read once
// per chunk of 16 history rows. fp32 accumulation throughout.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HC = 16;  // history rows per pass over W

template <typename T>
__global__ void __launch_bounds__(THREADS)
poly_attention_fwd_kernel(const T* __restrict__ emb, const T* __restrict__ w,
                          const T* __restrict__ codes,
                          const int* __restrict__ mask,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int H, int D, int P, int K) {
  extern __shared__ float smem[];
  float* sE = smem;                  // (H, D)
  float* sProj = sE + H * D;         // (H, P)
  float* sC = sProj + H * P;         // (K, P + 1), padded against bank conflicts
  float* sW = sC + K * (P + 1);      // (H, K): logits, then weights
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* e = emb + (long)b * H * D;

  for (int idx = tid; idx < H * D; idx += THREADS) sE[idx] = to_float(e[idx]);
  for (int idx = tid; idx < K * P; idx += THREADS)
    sC[(idx / P) * (P + 1) + idx % P] = to_float(codes[idx]);
  __syncthreads();

  // proj: one thread per column p; W's row d is read coalesced across p
  for (int p = tid; p < P; p += THREADS) {
    for (int h0 = 0; h0 < H; h0 += HC) {
      float acc[HC];
#pragma unroll
      for (int hh = 0; hh < HC; ++hh) acc[hh] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float wv = to_float(w[(long)d * P + p]);
#pragma unroll
        for (int hh = 0; hh < HC; ++hh)
          acc[hh] += sE[min(h0 + hh, H - 1) * D + d] * wv;
      }
#pragma unroll
      for (int hh = 0; hh < HC; ++hh)
        if (h0 + hh < H) sProj[(h0 + hh) * P + p] = round_to<T>(tanhf(acc[hh]));
    }
  }
  __syncthreads();

  for (int idx = tid; idx < H * K; idx += THREADS) {
    const int h = idx / K, k = idx % K;
    const float* pr = sProj + h * P;
    const float* cr = sC + k * (P + 1);
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += pr[p] * cr[p];
    acc += bias[(long)b * H + h];
    sW[idx] = mask[(long)b * H + h] != 0 ? acc : MASK_FILL;
  }
  __syncthreads();

  // softmax over the history axis, one thread per code
  for (int k = tid; k < K; k += THREADS) {
    float mx = -INFINITY;
    for (int h = 0; h < H; ++h) mx = fmaxf(mx, sW[h * K + k]);
    float sum = 0.f;
    for (int h = 0; h < H; ++h) {
      const float ex = expf(sW[h * K + k] - mx);
      sW[h * K + k] = ex;
      sum += ex;
    }
    for (int h = 0; h < H; ++h) sW[h * K + k] = round_to<T>(sW[h * K + k] / sum);
  }
  __syncthreads();

  T* o = out + (long)b * K * D;
  for (int idx = tid; idx < K * D; idx += THREADS) {
    const int k = idx / D, d = idx % D;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += sW[h * K + k] * sE[h * D + d];
    o[idx] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch_poly(const void* emb, const void* w, const void* codes,
                        const void* mask, const void* bias, void* out, int B,
                        int H, int D, int P, int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)H * D + (size_t)H * P +
                                       (size_t)K * (P + 1) + (size_t)H * K);
  cudaError_t err = cudaFuncSetAttribute(
      poly_attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  poly_attention_fwd_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(emb), static_cast<const T*>(w),
      static_cast<const T*>(codes), static_cast<const int*>(mask),
      static_cast<const float*>(bias), static_cast<T*>(out), H, D, P, K);
  return cudaGetLastError();
}

}  // namespace

// emb (B, H, D), w (D, P), codes (K, P) and out (B, K, D) of one dtype;
// mask (B, H) int32; bias (B, H) float32; all contiguous.
extern "C" int poly_attention_fwd(const void* emb, const void* w,
                                  const void* codes, const void* mask,
                                  const void* bias, void* out, int B, int H,
                                  int D, int P, int K, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || H <= 0 || D <= 0 || P <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch_poly<float>(emb, w, codes, mask, bias, out, B, H, D, P, K, s);
    case DTYPE_BF16:
      return launch_poly<__nv_bfloat16>(emb, w, codes, mask, bias, out, B, H, D,
                                        P, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}
