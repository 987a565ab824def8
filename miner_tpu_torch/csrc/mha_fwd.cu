// Fused multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/mha.py:_fwd_kernel (pallas_call at
// mha.py:208, reached through fused_mha). Per (sequence n, head h):
//   P = softmax_j(q_i . k_j / sqrt(Dh), masked keys -> -1e9)
//   out[n, i, h] = sum_j dropout(P)_ij v_j
// read straight from the fused (N, L, 3D) QKV projection by stride, with an
// optional block-diagonal band (seqs > 1: query i and key j attend only when
// i / (L/seqs) == j / (L/seqs)). Dropout on P keeps element (n, h, i, j) iff
// its Philox4x32-10 bits (csrc/philox.cuh, counter (j/4, i, h, n), word j%4)
// are >= thresh, and scales it by 1/(1-rate): the TPU kernel's rule with a
// counter-based generator instead of the TPU's, so the backward kernel and
// the plain version (ops/mha.py) regenerate the same mask.
//
// When a backward follows, the kernel also writes each row's softmax
// statistics (running max m and 1/l, as float2 into an (N, H, L) buffer,
// 10.8 MB at the sapo shape) so the backward rebuilds P without a second
// pass over the keys. The TPU kernel stores nothing and recomputes. Two
// values, not one log-sum-exp: with the finite -1e9 fill, a fully masked
// row has m = -1e9 and in fp32 m + log(l) rounds back to -1e9.
//
// What bounds it: at L = 128 and Dh = 64 a (sequence, head) pair reads
// 3 * L * Dh values and does 4 * L * L * Dh flops, 64 flops per bf16 byte:
// under the card's ~295 flop/byte ridge, so the bound is memory. This first
// kernel does its arithmetic in fp32 on the CUDA cores (no wgmma yet), so in
// practice it is bound by fp32 FMA issue and shared-memory reads.
//
// Design: one block per (sequence, head, tile of up to 64 query rows), one
// thread per query row holding its q and its output accumulator in
// registers. Keys and values stream through shared memory in tiles of 32
// with an online softmax, so shared memory stays at ~33 KB for any L. Q is
// staged through shared memory for coalesced loads and the output through
// the same buffer for coalesced stores. Logits and accumulation are fp32.
// Masked keys get the finite fill -1e9 (as mha.py:36,102 does): the running
// max starts at -inf but every tile holds at least one existing key, so the
// first rescale is exp(-inf) = 0 and never inf - inf; a row whose keys are
// all masked comes out as the mean of V, not NaN. The normaliser l sums the
// undropped probabilities; dropout applies to what enters the PV sum.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int MAX_BQ = 64;  // query rows (threads) per block
constexpr int BK = 32;      // keys per shared-memory tile

struct Dropout {
  unsigned long long seed;
  unsigned int thresh;
  float inv_keep;
  int on;
};

template <typename T, int DH>
__global__ void __launch_bounds__(MAX_BQ)
mha_fwd_kernel(const T* __restrict__ qkv, const int* __restrict__ mask,
               T* __restrict__ out, float2* __restrict__ stats, int L, int H,
               int seqs, Dropout drop) {
  const int n = blockIdx.x, h = blockIdx.y;
  const int bq = blockDim.x;
  const int q0 = blockIdx.z * bq;
  const int tid = threadIdx.x;
  const int D = H * DH;
  const long row_stride = 3L * D;
  const T* base = qkv + (long)n * L * row_stride + h * DH;
  const int* row_mask = mask + (long)n * L;
  const int sub = L / seqs;

  __shared__ __align__(16) float sK[BK][DH];
  __shared__ __align__(16) float sV[BK][DH];
  __shared__ float sQO[MAX_BQ][DH + 1];  // padded: each thread reads its own row

  for (int idx = tid; idx < bq * DH; idx += bq) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    sQO[r][d] = i < L ? to_float(base[(long)i * row_stride + d]) : 0.f;
  }
  __syncthreads();

  const int i = q0 + tid;
  const int my_seg = i / sub;
  const float scale = 1.0f / sqrtf((float)DH);
  float q[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = sQO[tid][d];
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * DH; idx += bq) {
      const int r = idx / DH, d = idx % DH, j = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < L) {
        const T* row = base + (long)j * row_stride + d;
        kv = to_float(row[D]);
        vv = to_float(row[2 * D]);
      }
      sK[r][d] = kv;
      sV[r][d] = vv;
    }
    __syncthreads();
    const int nk = min(BK, L - k0);

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      float acc = 0.f;
      if (r < nk) {
        const float4* kr = reinterpret_cast<const float4*>(&sK[r][0]);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kk = kr[d4];
          acc += q[4 * d4] * kk.x + q[4 * d4 + 1] * kk.y +
                 q[4 * d4 + 2] * kk.z + q[4 * d4 + 3] * kk.w;
        }
        acc *= scale;
        const int j = k0 + r;
        const bool valid = row_mask[j] != 0 && (seqs == 1 || j / sub == my_seg);
        acc = valid ? acc : MASK_FILL;
        tile_max = fmaxf(tile_max, acc);
      }
      s[r] = acc;
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // first tile: exp(-inf) = 0
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] *= alpha;
    Philox4 bits;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      if (drop.on && (r & 3) == 0)
        bits = philox4x32_10((unsigned)(k0 + r) >> 2, (unsigned)i, (unsigned)h,
                             (unsigned)n, drop.seed);
      if (r < nk) {
        const float p = expf(s[r] - m_new);
        l += p;
        float pv = p;
        if (drop.on) pv = bits.w[r & 3] >= drop.thresh ? p * drop.inv_keep : 0.f;
        const float4* vr = reinterpret_cast<const float4*>(&sV[r][0]);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 vv = vr[d4];
          o[4 * d4] += pv * vv.x;
          o[4 * d4 + 1] += pv * vv.y;
          o[4 * d4 + 2] += pv * vv.z;
          o[4 * d4 + 3] += pv * vv.w;
        }
      }
    }
    m = m_new;
  }

  __syncthreads();  // everyone is done reading sQO as Q
  const float inv = 1.f / l;  // l >= 1: the row's max contributes exp(0)
  if (stats != nullptr && i < L) stats[((long)n * H + h) * L + i] = make_float2(m, inv);
#pragma unroll
  for (int d = 0; d < DH; ++d) sQO[tid][d] = o[d] * inv;
  __syncthreads();
  T* obase = out + (long)n * L * D + h * DH;
  for (int idx = tid; idx < bq * DH; idx += bq) {
    const int r = idx / DH, d = idx % DH, ii = q0 + r;
    if (ii < L) obase[(long)ii * D + d] = from_float<T>(sQO[r][d]);
  }
}

template <typename T, int DH>
cudaError_t launch_mha(const void* qkv, const void* mask, void* out,
                       void* stats, int N, int L, int H, int seqs,
                       Dropout drop, cudaStream_t stream) {
  const int bq = L <= 32 ? 32 : MAX_BQ;
  const dim3 grid(N, H, (L + bq - 1) / bq);
  mha_fwd_kernel<T, DH><<<grid, bq, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int*>(mask),
      static_cast<T*>(out), static_cast<float2*>(stats), L, H, seqs, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* qkv, const void* mask, void* out,
                              void* stats, int N, int L, int H, int Dh,
                              int seqs, Dropout drop, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_mha<T, 16>(qkv, mask, out, stats, N, L, H, seqs, drop, stream);
    case 32: return launch_mha<T, 32>(qkv, mask, out, stats, N, L, H, seqs, drop, stream);
    case 64: return launch_mha<T, 64>(qkv, mask, out, stats, N, L, H, seqs, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (N, L, 3*H*Dh) and out (N, L, H*Dh) of one dtype, mask (N, L) int32,
// all contiguous; Dh in {16, 32, 64}; L % seqs == 0. stats: (N, H, L) float2
// (row max, 1/row sum) or null. Dropout is on when `dropping` is non-zero:
// keep iff bits >= thresh, kept values scaled by inv_keep.
extern "C" int mha_fwd(const void* qkv, const void* mask, void* out,
                       void* stats, int N, int L, int H, int Dh, int seqs,
                       unsigned long long seed, unsigned int thresh,
                       float inv_keep, int dropping, int dtype, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || L <= 0 || H <= 0 || H > 65535 || seqs <= 0 || L % seqs != 0)
    return cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, inv_keep, dropping != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_head_dim<float>(qkv, mask, out, stats, N, L, H, Dh, seqs, drop, s);
    case DTYPE_BF16:
      return dispatch_head_dim<__nv_bfloat16>(qkv, mask, out, stats, N, L, H, Dh,
                                              seqs, drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}
