// Fused multi-head self-attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/mha.py:_bwd_kernel (pallas_call at
// mha.py:232, the custom_vjp backward of fused_mha). Per (sequence n,
// head h), with P the forward's softmax, keep its dropout mask and
// Pd = keep * P / (1 - rate):
//   dV = Pd^T dO,  dP = keep * (dO V^T) / (1 - rate),
//   dS = P * (dP - rowsum(dP * P)) / sqrt(Dh),  dQ = dS K,  dK = dS^T Q,
// written by stride into one (N, L, 3D) gradient in the q|k|v layout of the
// fused projection, so the qkv Linear takes it with no split or concat.
// rowsum(dP * P) equals rowsum(dO * O) (O the forward's output), which is
// what the kernel computes: one Dh-long dot per query row instead of a
// second pass over the keys. P is rebuilt from the forward's softmax
// statistics (row max and 1/row sum, see mha_fwd.cu) and the dropout mask
// is regenerated from the same Philox counters (csrc/philox.cuh), so nothing
// random and no (L, L) tensor is stored.
//
// What bounds it: 5 products of 2 * L * L * Dh flops per (sequence, head)
// (QK^T, dO V^T, dV, dQ, dK) against reading qkv, out, dout and writing
// dqkv: ~110 flops per bf16 byte at L = 128, under the ridge, so memory in
// principle; this first kernel does its arithmetic in fp32 on the CUDA
// cores, so in practice fp32 FMA issue and shared-memory reads bound it.
//
// Design: one block per (sequence, head, tile of up to 64 query rows), one
// thread per query row holding q, dO and its dQ accumulator in registers.
// K and V stream through shared memory in tiles of 32 keys. For each key
// tile a thread computes its row of dS and Pd into shared memory; then the
// block reduces over its query rows to the tile's dK and dV (thread per
// (key, column)). Blocks of one (n, h) run in no order on Hopper, so dK and
// dV cannot be summed across query tiles in place: with one query tile
// (L <= 64) the block writes them straight into dqkv; otherwise each tile
// writes fp32 partials to a scratch buffer the wrapper allocates, and a
// second kernel sums them in a fixed order and casts them into dqkv
// (deterministic: no atomics). A fully masked row (all keys at -1e9) has a
// uniform P over all L keys, and its gradient reaches V of the masked keys,
// as in the TPU kernel.
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

template <int DH>
constexpr int smem_floats() {
  return 2 * BK * DH + 2 * MAX_BQ * (DH + 1) + 2 * MAX_BQ * (BK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(MAX_BQ)
mha_bwd_kernel(const T* __restrict__ qkv, const int* __restrict__ mask,
               const T* __restrict__ out, const T* __restrict__ dout,
               const float2* __restrict__ stats, T* __restrict__ dqkv,
               float* __restrict__ partial, int N, int L, int H, int seqs,
               Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                     // (BK, DH)
  float* sV = sK + BK * DH;             // (BK, DH)
  float* sQ = sV + BK * DH;             // (BQ, DH + 1)
  float* sdO = sQ + MAX_BQ * (DH + 1);  // (BQ, DH + 1)
  float* sDS = sdO + MAX_BQ * (DH + 1); // (BQ, BK + 1)
  float* sPD = sDS + MAX_BQ * (BK + 1); // (BQ, BK + 1)

  const int n = blockIdx.x, h = blockIdx.y;
  const int bq = blockDim.x;
  const int q0 = blockIdx.z * bq;
  const int tid = threadIdx.x;
  const int D = H * DH;
  const long row_stride = 3L * D;
  const T* base = qkv + (long)n * L * row_stride + h * DH;
  const T* dobase = dout + (long)n * L * D + h * DH;
  const int* row_mask = mask + (long)n * L;
  const int sub = L / seqs;

  for (int idx = tid; idx < bq * DH; idx += bq) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    sQ[r * (DH + 1) + d] = i < L ? to_float(base[(long)i * row_stride + d]) : 0.f;
    sdO[r * (DH + 1) + d] = i < L ? to_float(dobase[(long)i * D + d]) : 0.f;
  }
  __syncthreads();

  const int i = q0 + tid;
  const bool row_ok = i < L;
  const int my_seg = i / sub;
  const float scale = 1.0f / sqrtf((float)DH);
  float q[DH], dO[DH], dq[DH];
  float Di = 0.f;
  const T* obase = out + (long)n * L * D + h * DH + (long)i * D;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = sQ[tid * (DH + 1) + d];
    dO[d] = sdO[tid * (DH + 1) + d];
    dq[d] = 0.f;
    if (row_ok) Di += dO[d] * to_float(obase[d]);
  }
  float2 st = make_float2(0.f, 0.f);
  if (row_ok) st = stats[((long)n * H + h) * L + i];

  const bool direct = gridDim.z == 1;
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV/sDS/sPD are consumed
    for (int idx = tid; idx < BK * DH; idx += bq) {
      const int r = idx / DH, d = idx % DH, j = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < L) {
        const T* row = base + (long)j * row_stride + d;
        kv = to_float(row[D]);
        vv = to_float(row[2 * D]);
      }
      sK[r * DH + d] = kv;
      sV[r * DH + d] = vv;
    }
    __syncthreads();
    const int nk = min(BK, L - k0);

    Philox4 bits;
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      if (drop.on && (r & 3) == 0)
        bits = philox4x32_10((unsigned)(k0 + r) >> 2, (unsigned)i, (unsigned)h,
                             (unsigned)n, drop.seed);
      float ds = 0.f, pd = 0.f;
      if (r < nk && row_ok) {
        const float4* kr = reinterpret_cast<const float4*>(sK + r * DH);
        const float4* vr = reinterpret_cast<const float4*>(sV + r * DH);
        float s = 0.f, dpd = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kk = kr[d4], vv = vr[d4];
          s += q[4 * d4] * kk.x + q[4 * d4 + 1] * kk.y +
               q[4 * d4 + 2] * kk.z + q[4 * d4 + 3] * kk.w;
          dpd += dO[4 * d4] * vv.x + dO[4 * d4 + 1] * vv.y +
                 dO[4 * d4 + 2] * vv.z + dO[4 * d4 + 3] * vv.w;
        }
        s *= scale;
        const int j = k0 + r;
        const bool valid = row_mask[j] != 0 && (seqs == 1 || j / sub == my_seg);
        s = valid ? s : MASK_FILL;
        const float p = expf(s - st.x) * st.y;
        float dp = dpd;
        pd = p;
        if (drop.on) {
          const bool keep = bits.w[r & 3] >= drop.thresh;
          pd = keep ? p * drop.inv_keep : 0.f;
          dp = keep ? dpd * drop.inv_keep : 0.f;
        }
        ds = p * (dp - Di) * scale;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kk = kr[d4];
          dq[4 * d4] += ds * kk.x;
          dq[4 * d4 + 1] += ds * kk.y;
          dq[4 * d4 + 2] += ds * kk.z;
          dq[4 * d4 + 3] += ds * kk.w;
        }
      }
      sDS[tid * (BK + 1) + r] = ds;
      sPD[tid * (BK + 1) + r] = pd;
    }
    __syncthreads();

    // dK, dV of this key tile, summed over the block's query rows
    for (int idx = tid; idx < nk * DH; idx += bq) {
      const int r = idx / DH, d = idx % DH, j = k0 + r;
      float dk = 0.f, dv = 0.f;
      for (int t = 0; t < bq; ++t) {
        dk += sDS[t * (BK + 1) + r] * sQ[t * (DH + 1) + d];
        dv += sPD[t * (BK + 1) + r] * sdO[t * (DH + 1) + d];
      }
      if (direct) {
        T* drow = dqkv + ((long)n * L + j) * row_stride + h * DH + d;
        drow[D] = from_float<T>(dk);
        drow[2 * D] = from_float<T>(dv);
      } else {
        float* prow = partial + (((long)blockIdx.z * N + n) * L + j) * (2L * D) + h * DH + d;
        prow[0] = dk;
        prow[D] = dv;
      }
    }
  }

  __syncthreads();  // everyone is done reading sQ
#pragma unroll
  for (int d = 0; d < DH; ++d) sQ[tid * (DH + 1) + d] = dq[d];
  __syncthreads();
  for (int idx = tid; idx < bq * DH; idx += bq) {
    const int r = idx / DH, d = idx % DH, ii = q0 + r;
    if (ii < L)
      dqkv[((long)n * L + ii) * row_stride + h * DH + d] =
          from_float<T>(sQ[r * (DH + 1) + d]);
  }
}

// dqkv[n, j, D + c] = sum over query tiles z of partial[z, n, j, c], c < 2D
template <typename T>
__global__ void mha_bwd_reduce_kernel(const float* __restrict__ partial,
                                      T* __restrict__ dqkv, long rows, int D,
                                      int tiles) {
  const long total = rows * 2L * D;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < tiles; ++z) acc += partial[z * total + e];
    const long row = e / (2L * D);
    const int c = (int)(e % (2L * D));
    dqkv[row * 3L * D + D + c] = from_float<T>(acc);
  }
}

template <typename T, int DH>
cudaError_t launch_bwd(const void* qkv, const void* mask, const void* out,
                       const void* dout, const void* stats, void* dqkv,
                       void* partial, int N, int L, int H, int seqs,
                       Dropout drop, cudaStream_t stream) {
  const int bq = L <= 32 ? 32 : MAX_BQ;
  const int tiles = (L + bq - 1) / bq;
  if (tiles > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N, H, tiles);
  mha_bwd_kernel<T, DH><<<grid, bq, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int*>(mask),
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float2*>(stats), static_cast<T*>(dqkv),
      static_cast<float*>(partial), N, L, H, seqs, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  mha_bwd_reduce_kernel<T><<<132 * 8, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(dqkv), (long)N * L,
      H * DH, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* qkv, const void* mask, const void* out,
                              const void* dout, const void* stats, void* dqkv,
                              void* partial, int N, int L, int H, int Dh,
                              int seqs, Dropout drop, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_bwd<T, 16>(qkv, mask, out, dout, stats, dqkv, partial, N, L, H, seqs, drop, stream);
    case 32: return launch_bwd<T, 32>(qkv, mask, out, dout, stats, dqkv, partial, N, L, H, seqs, drop, stream);
    case 64: return launch_bwd<T, 64>(qkv, mask, out, dout, stats, dqkv, partial, N, L, H, seqs, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of query tiles the kernel splits L into: the wrapper allocates
// partial = (tiles, N, L, 2*H*Dh) fp32 when it is above 1.
extern "C" int mha_bwd_query_tiles(int L) {
  const int bq = L <= 32 ? 32 : MAX_BQ;
  return (L + bq - 1) / bq;
}

// qkv, dqkv (N, L, 3*H*Dh), out, dout (N, L, H*Dh) of one dtype, mask (N, L)
// int32, stats (N, H, L) float2 from mha_fwd, all contiguous. The dropout
// arguments must be those of the forward call.
extern "C" int mha_bwd(const void* qkv, const void* mask, const void* out,
                       const void* dout, const void* stats, void* dqkv,
                       void* partial, int N, int L, int H, int Dh, int seqs,
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
      return dispatch_head_dim<float>(qkv, mask, out, dout, stats, dqkv, partial,
                                      N, L, H, Dh, seqs, drop, s);
    case DTYPE_BF16:
      return dispatch_head_dim<__nv_bfloat16>(qkv, mask, out, dout, stats, dqkv,
                                              partial, N, L, H, Dh, seqs, drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}
