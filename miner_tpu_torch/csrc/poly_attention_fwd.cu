// Fused poly-attention (interest extraction), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/poly_attention.py:_poly_kernel
// (pallas_call at poly_attention.py:91, reached through
// poly_attention_fused). Per batch row b, with emb (H, D), W (D, P) and
// codes (K, P):
//   proj    = tanh(emb @ W), rounded to emb's type      (H, P)
//   logits  = proj @ codes^T + bias[b]; masked -> fill   (H, K)
//   weights = softmax over H (fp32), rounded to emb's type
//   out     = weights^T @ emb                           (K, D)
//
// What bounds it: at the main path's shapes (H = 50, D = 256, P = 200,
// K = 32) a row reads 25.6 KB of bf16 emb and does ~6.1 MFLOP; W and codes
// (~115 KB) are shared by every row and stay in L2. The least time for a
// request batch (B = 32) is well under a microsecond; what a launch really
// costs is its latency: how long the chain load -> three dependent
// products -> softmax -> store takes for one row, and how few SMs share
// the rows.
//
// bf16 design, on the tensor cores, one cluster of NC = 4 CTAs per batch
// row (B = 32: 128 CTAs, where one block a row filled 32 of 132 SMs).
// Each CTA loads the row's emb whole and a quarter of W's columns (and the
// same columns of the codes) into shared memory by 16-byte cp.async:
//   1. proj = tanh(emb @ W[:, slice]): mma.sync m16n8k16 bf16 -> fp32 over
//      H padded to 64 rows and its slice of P padded to 16-column chunks,
//      rounded to bf16 (as the TPU kernel rounds it) into shared memory;
//   2. its partial logits proj @ codes[:, slice]^T (fp32, on the mma);
//   3. cluster barrier; each CTA sums the four partials in rank order over
//      distributed shared memory (every CTA gets the same sums), adds the
//      bias, masks, and takes the softmax over H in fp32, rounded to bf16;
//   4. out[:, its quarter of D] = weights^T @ emb on the mma.
// The fill of a masked slot is the launch's mask_fill: -1e9 (masking), or
// the reference's legacy 1e-30 (--legacy_poly_mask: a masked slot's logit
// is ~0, so pads keep a weight), in place of logits + bias.
// Padding: history rows past H are zero in emb and are left out of the
// softmax (weight exactly 0, -inf whatever the fill), so a user with no
// clicks, whose H real rows all hold the finite fill, gets the mean of the
// H real rows (pads included), as the plain version does; P columns past P are zero in both W and the codes (tanh(0)
// = 0 against a zero code); codes past K are zero and their rows of out
// are not written. Nothing but out touches device memory.
//
// fp32 stays on the CUDA cores (the design of the first port: one block
// per row, everything in shared memory, W streamed from L2 in chunks of 16
// history rows): on the tensor cores fp32 operands would run as TF32,
// whose 10-bit mantissa fails the 1e-4 fp32 tolerance and the card-vs-CPU
// parity phases.
#include <cooperative_groups.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------- float32
constexpr int THREADS = 256;
constexpr int HC = 16;  // history rows per pass over W

size_t fp32_smem_bytes(int H, int D, int P, int K) {
  return sizeof(float) * ((size_t)H * D + (size_t)H * P + (size_t)K * (P + 1) + (size_t)H * K);
}

__global__ void __launch_bounds__(THREADS)
poly_attention_fp32(const float* __restrict__ emb, const float* __restrict__ w,
                    const float* __restrict__ codes, const int* __restrict__ mask,
                    const float* __restrict__ bias, float* __restrict__ out, int H, int D,
                    int P, int K, float mask_fill) {
  extern __shared__ float smem[];
  float* sE = smem;                  // (H, D)
  float* sProj = sE + H * D;         // (H, P)
  float* sC = sProj + H * P;         // (K, P + 1), padded against bank conflicts
  float* sW = sC + K * (P + 1);      // (H, K): logits, then weights
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* e = emb + (long)b * H * D;

  for (int idx = tid; idx < H * D; idx += THREADS) sE[idx] = e[idx];
  for (int idx = tid; idx < K * P; idx += THREADS)
    sC[(idx / P) * (P + 1) + idx % P] = codes[idx];
  __syncthreads();

  // proj: one thread per column p; W's row d is read coalesced across p
  for (int p = tid; p < P; p += THREADS) {
    for (int h0 = 0; h0 < H; h0 += HC) {
      float acc[HC];
#pragma unroll
      for (int hh = 0; hh < HC; ++hh) acc[hh] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float wv = w[(long)d * P + p];
#pragma unroll
        for (int hh = 0; hh < HC; ++hh)
          acc[hh] += sE[min(h0 + hh, H - 1) * D + d] * wv;
      }
#pragma unroll
      for (int hh = 0; hh < HC; ++hh)
        if (h0 + hh < H) sProj[(h0 + hh) * P + p] = tanhf(acc[hh]);
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
    sW[idx] = mask[(long)b * H + h] != 0 ? acc : mask_fill;
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
    for (int h = 0; h < H; ++h) sW[h * K + k] /= sum;
  }
  __syncthreads();

  float* o = out + (long)b * K * D;
  for (int idx = tid; idx < K * D; idx += THREADS) {
    const int k = idx / D, d = idx % D;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += sW[h * K + k] * sE[h * D + d];
    o[idx] = acc;
  }
}

// --------------------------------------------------------------- bfloat16
namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int NC = 4;        // CTAs a batch row: one cluster
constexpr int TC_WARPS = 8;

// Shared memory of one CTA; every CTA of a launch has the same layout, sized
// for the widest P slice. Rows of bf16 are padded by 8 values so ldmatrix
// reads them without bank conflicts.
struct Layout {
  int Hp, Kp, pchunks, ps;  // H and K padded to 16; P in 16-column chunks; slice width
  int lde, ldw, ldt, ldl;   // row strides: emb, W / codes / proj slices, weights^T, logits
  size_t part, logit, e, w, c, proj, wt, bytes;  // byte offsets
  __host__ __device__ Layout(int H, int D, int P, int K) {
    Hp = (H + 15) / 16 * 16;
    Kp = (K + 15) / 16 * 16;
    pchunks = (P + 15) / 16;
    ps = 16 * ((pchunks + NC - 1) / NC);
    lde = D + 8;
    ldw = ps + 8;
    ldt = Hp + 8;
    ldl = Kp + 1;
    part = 0;                                       // (Hp, Kp) fp32: this CTA's partial logits
    logit = part + sizeof(float) * Hp * Kp;         // (Hp, Kp + 1) fp32: the summed logits
    e = logit + sizeof(float) * Hp * ldl;           // (Hp, D + 8) emb
    e = (e + 15) / 16 * 16;
    w = e + sizeof(bf16) * Hp * lde;                // (D, ps + 8) W's slice
    c = w + sizeof(bf16) * (size_t)D * ldw;         // (Kp, ps + 8) the codes' slice
    proj = c + sizeof(bf16) * Kp * ldw;             // (Hp, ps + 8) proj's slice
    wt = proj + sizeof(bf16) * Hp * ldw;            // (Kp, Hp + 8) weights^T
    bytes = wt + sizeof(bf16) * Kp * ldt;
  }
};

// grid B * NC, cluster (NC, 1, 1); D a multiple of 16, P of 8, the rows of
// emb, W and the codes 16-byte aligned
__global__ void __cluster_dims__(NC, 1, 1) __launch_bounds__(32 * TC_WARPS)
poly_attention_bf16(const bf16* __restrict__ emb, const bf16* __restrict__ w,
                    const bf16* __restrict__ codes, const int* __restrict__ mask,
                    const float* __restrict__ bias, bf16* __restrict__ out, int H, int D,
                    int P, int K, float mask_fill) {
  extern __shared__ __align__(16) unsigned char smem_tc[];  // fp32's smem is a float[]
  const Layout lay(H, D, P, K);
  float* sPart = reinterpret_cast<float*>(smem_tc + lay.part);
  float* sLog = reinterpret_cast<float*>(smem_tc + lay.logit);
  bf16* sE = reinterpret_cast<bf16*>(smem_tc + lay.e);
  bf16* sW = reinterpret_cast<bf16*>(smem_tc + lay.w);
  bf16* sC = reinterpret_cast<bf16*>(smem_tc + lay.c);
  bf16* sProj = reinterpret_cast<bf16*>(smem_tc + lay.proj);
  bf16* sWt = reinterpret_cast<bf16*>(smem_tc + lay.wt);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / NC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Hp = lay.Hp, Kp = lay.Kp;
  // this CTA's 16-column chunks of P
  const int c0 = rank * lay.pchunks / NC, nchunk = (rank + 1) * lay.pchunks / NC - c0;
  const int p0 = 16 * c0, np8 = 2 * nchunk;  // first column, 8-column pieces

  const bf16* e = emb + (long)b * H * D;
  const int d8 = D / 8;
  for (int i = tid; i < Hp * d8; i += blockDim.x) {
    const int r = i / d8, ch = i % d8;
    const bool ok = r < H;
    cp_async16(sE + r * lay.lde + ch * 8, ok ? e + (long)r * D + ch * 8 : e, ok ? 16 : 0);
  }
  for (int i = tid; i < D * np8; i += blockDim.x) {
    const int d = i / np8, p = p0 + 8 * (i % np8);
    const bool ok = p < P;
    cp_async16(sW + d * lay.ldw + (p - p0), ok ? w + (long)d * P + p : w, ok ? 16 : 0);
  }
  for (int i = tid; i < Kp * np8; i += blockDim.x) {
    const int k = i / np8, p = p0 + 8 * (i % np8);
    const bool ok = k < K && p < P;
    cp_async16(sC + k * lay.ldw + (p - p0), ok ? codes + (long)k * P + p : codes,
               ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. proj slice = tanh(emb @ W slice), a (16 rows, 16 columns) unit a warp
  for (int u = warp; u < (Hp / 16) * nchunk; u += TC_WARPS) {
    const int mt = u / nchunk, pc = u % nchunk;
    float acc[2][4] = {};
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4], bw[4];
      ldsm_x4(a, sE + (mt * 16 + (lane & 15)) * lay.lde + kc * 16 + (lane >> 4) * 8);
      ldsm_x4_t(bw, sW + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lay.ldw + pc * 16 +
                        (lane >> 4) * 8);
      mma_bf16(acc[0], a, bw[0], bw[1]);
      mma_bf16(acc[1], a, bw[2], bw[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(sProj + (mt * 16 + g + 8 * r) * lay.ldw + pc * 16 +
                                     nt * 8 + 2 * t) =
            pack_bf16(tanhf(acc[nt][2 * r]), tanhf(acc[nt][2 * r + 1]));
  }
  __syncthreads();

  // 2. partial logits = proj slice @ codes slice^T, (16 rows, 16 codes) a unit
  for (int u = warp; u < (Hp / 16) * (Kp / 16); u += TC_WARPS) {
    const int mt = u / (Kp / 16), kt = u % (Kp / 16);
    float acc[2][4] = {};
    for (int pc = 0; pc < nchunk; ++pc) {
      uint32_t a[4], bc[4];
      ldsm_x4(a, sProj + (mt * 16 + (lane & 15)) * lay.ldw + pc * 16 + (lane >> 4) * 8);
      ldsm_x4(bc, sC + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * lay.ldw + pc * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[0], a, bc[0], bc[1]);
      mma_bf16(acc[1], a, bc[2], bc[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(sPart + (mt * 16 + g + 8 * r) * Kp + kt * 16 + nt * 8 +
                                   2 * t) = make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
  cluster.sync();  // every CTA's partial logits are written

  // 3. the cluster's sum of the partials, in rank order, with bias and mask
  // (masked slots: mask_fill); history rows past H get -inf: no weight at all
  const float* parts[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r) parts[r] = cluster.map_shared_rank(sPart, r);
  const int* mrow = mask + (long)b * H;
  const float* brow = bias + (long)b * H;
  for (int i = tid; i < Hp * Kp; i += blockDim.x) {
    const int h = i / Kp, k = i % Kp;
    float v = -INFINITY;
    if (h < H) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < NC; ++r) acc += parts[r][i];
      v = mrow[h] != 0 ? acc + brow[h] : mask_fill;
    }
    sLog[h * lay.ldl + k] = v;
  }
  cluster.sync();  // no CTA reads another's partials past here (nor leaves early)

  // softmax over the history axis, a warp per code; weights^T rounded to bf16
  for (int k = warp; k < Kp; k += TC_WARPS) {
    float mx = -INFINITY;
    for (int h = lane; h < Hp; h += 32) mx = fmaxf(mx, sLog[h * lay.ldl + k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int h = lane; h < Hp; h += 32) {
      const float ex = expf(sLog[h * lay.ldl + k] - mx);  // -inf: 0
      sLog[h * lay.ldl + k] = ex;
      sum += ex;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int h = lane; h < Hp; h += 32)
      sWt[k * lay.ldt + h] = __float2bfloat16_rn(sLog[h * lay.ldl + k] / sum);
  }
  __syncthreads();

  // 4. out[:, this CTA's columns] = weights^T @ emb, (16 codes, 16 columns) a unit
  const int dchunks = D / 16;
  const int dc0 = rank * dchunks / NC, ndc = (rank + 1) * dchunks / NC - dc0;
  bf16* o = out + (long)b * K * D;
  for (int u = warp; u < (Kp / 16) * ndc; u += TC_WARPS) {
    const int mt = u / ndc, dc = dc0 + u % ndc;
    float acc[2][4] = {};
    for (int kc = 0; kc < Hp / 16; ++kc) {
      uint32_t a[4], be[4];
      ldsm_x4(a, sWt + (mt * 16 + (lane & 15)) * lay.ldt + kc * 16 + (lane >> 4) * 8);
      ldsm_x4_t(be, sE + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lay.lde + dc * 16 +
                        (lane >> 4) * 8);
      mma_bf16(acc[0], a, be[0], be[1]);
      mma_bf16(acc[1], a, be[2], be[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = mt * 16 + g + 8 * r;
      if (k < K) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<uint32_t*>(o + (long)k * D + dc * 16 + nt * 8 + 2 * t) =
              pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
    }
  }
}

cudaError_t launch_bf16(const void* emb, const void* w, const void* codes, const void* mask,
                        const void* bias, void* out, int B, int H, int D, int P, int K,
                        float mask_fill, cudaStream_t stream) {
  if (D % 16 != 0 || P % 8 != 0) return cudaErrorInvalidValue;
  const size_t smem = Layout(H, D, P, K).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      poly_attention_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  poly_attention_bf16<<<B * NC, 32 * TC_WARPS, smem, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const bf16*>(w),
      static_cast<const bf16*>(codes), static_cast<const int*>(mask),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, D, P, K, mask_fill);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const void* emb, const void* w, const void* codes,
                        const void* mask, const void* bias, void* out, int B,
                        int H, int D, int P, int K, float mask_fill,
                        cudaStream_t stream) {
  const size_t smem = fp32_smem_bytes(H, D, P, K);
  cudaError_t err = cudaFuncSetAttribute(
      poly_attention_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  poly_attention_fp32<<<B, THREADS, smem, stream>>>(
      static_cast<const float*>(emb), static_cast<const float*>(w),
      static_cast<const float*>(codes), static_cast<const int*>(mask),
      static_cast<const float*>(bias), static_cast<float*>(out), H, D, P, K, mask_fill);
  return cudaGetLastError();
}

}  // namespace

// Shared memory a block of the kernel for `dtype` takes at these shapes.
extern "C" long long poly_attention_smem_bytes(int H, int D, int P, int K, int dtype) {
  return (long long)(dtype == DTYPE_BF16 ? Layout(H, D, P, K).bytes
                                         : fp32_smem_bytes(H, D, P, K));
}

// emb (B, H, D), w (D, P), codes (K, P) and out (B, K, D) of one dtype;
// mask (B, H) int32; bias (B, H) float32; all contiguous. bf16: D a
// multiple of 16 and P of 8, emb, w and codes 16-byte aligned. mask_fill:
// the logit of a masked slot.
extern "C" int poly_attention_fwd(const void* emb, const void* w,
                                  const void* codes, const void* mask,
                                  const void* bias, void* out, int B, int H,
                                  int D, int P, int K, int dtype, float mask_fill,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || H <= 0 || D <= 0 || P <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch_fp32(emb, w, codes, mask, bias, out, B, H, D, P, K, mask_fill, s);
    case DTYPE_BF16:
      return launch_bf16(emb, w, codes, mask, bias, out, B, H, D, P, K, mask_fill, s);
    default:
      return cudaErrorInvalidValue;
  }
}
