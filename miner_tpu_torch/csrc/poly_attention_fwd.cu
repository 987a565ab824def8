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
// request batch (B = 32) is well under a microsecond (fp32: 1.3 us, by
// its operations at 165 TFLOP/s, the TF32 rate over three passes); what a
// launch really costs is its latency: how long the chain load -> three
// dependent products -> softmax -> store takes for one row, and how few
// SMs share the rows.
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
// Where emb whole does not fit beside a quarter of W (D = 768, a Miner
// without --apply_reduce_dim: ~245 KB a CTA), D is split across a cluster of
// 8 (the fp32 route's D split): each CTA stages its eighth of emb's
// 16-column chunks and the same rows of W with all of W's columns, computes
// the partial proj over its D in fp32 for all of P, and after a cluster
// barrier sums the eight partials of its slice of P over distributed shared
// memory in rank order before tanh and the rounding to bf16 (~136 KB a CTA
// at H = 50, P = 200, K = 32); steps 2 and 3 follow on its eighth of P, and
// out's columns are the CTA's own emb columns. The plan (bf16_plan: 4 CTAs,
// else 8 with D split) comes from the shapes alone, never the batch, so a
// row's result does not depend on its batch.
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
// fp32 design (one block a row on the CUDA cores, the first port's, read
// W from L2 inside its loop and left 100 of 132 SMs idle at B = 32): the
// same four steps on a cluster of CTAs a row, the products on the tensor
// cores in split TF32 (tensor_core.cuh: mma.sync m16n8k8, three TF32 passes
// a product, ~2^-21 of each product; one TF32 pass alone misses the 1e-4
// fp32 tolerance, tests/test_torch_poly_tf32.py). Each CTA of 16 warps
// stages the row's emb whole, its mask and bias, and its slice of W's and
// the codes' 8-column pieces of P by cp.async (16-byte copies when emb, W
// and the codes are 16-byte aligned and D, P multiples of 4, else 4-byte
// copies, chosen at launch), zero past H, D, P and K; proj stays fp32
// (tanh) in the CTA's shared slice, its even and odd k-steps in two
// accumulators (half the chain of dependent mma); the softmax runs a warp a
// code; the weights^T enter out's product from shared memory. Rows are
// padded so that every fragment read falls on distinct banks: the k order
// of a product is free, and the ones whose operands pair up along k read
// them as (2t, 2t + 1) by float2. The CTAs a row depend on the shapes
// alone (fp32_plan), never on the batch, so a row's result does not depend
// on how many rows share its launch: 3 (~185 KB a CTA at the main shapes,
// one an SM; an H100 holds 39 such clusters at once, so B = 32 is one
// wave), or 8 where a third of W's columns does not fit. Where emb whole
// does not fit either (D = 768, a Miner without --apply_reduce_dim), D is
// split across 8 CTAs: each stages its eighth of emb's columns and of W's
// rows with all of W's columns, computes the partial proj over its D, and
// the cluster sums the partials over distributed shared memory in rank
// order before tanh, for each CTA's slice of P (one cluster barrier more);
// out's columns are then the CTA's own emb columns. A shape that fits none
// of these is refused (the wrapper raises). What sets the time is the
// row's chain of latencies (~22 us a wave), not the work.
#include <cooperative_groups.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

// --------------------------------------------------------------- bfloat16
namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int NC = 4;           // CTAs a batch row, D whole: one cluster
constexpr int MAX_CLUSTER = 8;  // the largest portable cluster
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr int TC_WARPS = 8;

// a row pitch of at least n floats (n a multiple of 8) that is 8 mod 16:
// float2 reads of (row g, columns 2t, 2t + 1) by a half-warp, and scalar
// reads of (rows t, t + 4, column g), fall on distinct banks
__host__ __device__ inline int pitch_8_of_16(int n) { return n % 16 == 8 ? n : n + 8; }

// CTAs a batch row, and D split across them or not
struct Plan {
  int nc;
  bool split;
};

// Shared memory of one bf16 CTA with nc CTAs a row; every CTA of a launch
// has the same layout, sized for the widest slices. Rows of bf16 are padded
// by 8 values (an odd number of 16-byte units) so ldmatrix reads them
// without bank conflicts. D whole: emb whole and the CTA's slice of W's
// columns. D split: the CTA's slice of emb's columns and of W's rows with
// all of W's columns, and the partial proj over its D (fp32), which the
// cluster sums.
struct Layout {
  int Hp, Kp, pchunks, ps, ds;  // H and K padded to 16; P in 16-column chunks; the widest
                                // slices of P and D
  int lde, ldw, ldc, ldt, ldl, ldp;  // row strides: emb, W, codes / proj slices, weights^T,
                                     // logits, partial proj
  size_t part, logit, e, w, c, proj, wt, pp, bytes;  // byte offsets
  __host__ __device__ Layout(int H, int D, int P, int K, int nc, bool split) {
    Hp = (H + 15) / 16 * 16;
    Kp = (K + 15) / 16 * 16;
    pchunks = (P + 15) / 16;
    ps = 16 * ((pchunks + nc - 1) / nc);
    ds = split ? 16 * ((D / 16 + nc - 1) / nc) : D;
    lde = ds + 8;
    ldw = (split ? 16 * pchunks : ps) + 8;
    ldc = ps + 8;
    ldt = Hp + 8;
    ldl = Kp + 1;
    ldp = pitch_8_of_16(16 * pchunks);
    part = 0;                                       // (Hp, Kp) fp32: this CTA's partial logits
    logit = part + sizeof(float) * Hp * Kp;         // (Hp, Kp + 1) fp32: the summed logits
    e = logit + sizeof(float) * Hp * ldl;           // (Hp, ds + 8) emb or its slice
    e = (e + 15) / 16 * 16;
    w = e + sizeof(bf16) * Hp * lde;                // (ds, ldw) W's slice
    c = w + sizeof(bf16) * (size_t)ds * ldw;        // (Kp, ps + 8) the codes' slice
    proj = c + sizeof(bf16) * Kp * ldc;             // (Hp, ps + 8) proj's slice
    wt = proj + sizeof(bf16) * Hp * ldc;            // (Kp, Hp + 8) weights^T
    pp = (wt + sizeof(bf16) * Kp * ldt + 15) / 16 * 16;  // D split: (Hp, ldp) partial proj
    bytes = split ? pp + sizeof(float) * Hp * ldp : wt + sizeof(bf16) * Kp * ldt;
  }
};

// the bf16 kernel's plans, in the order it takes the first whose CTA fits:
// 4 CTAs a row (emb whole), 8 with D split (D = 768).
// ops/poly_attention.py:BF16_PLANS lists the same.
constexpr Plan BF16_PLANS[] = {{NC, false}, {MAX_CLUSTER, true}};

Plan bf16_plan(int H, int D, int P, int K) {
  for (const Plan& p : BF16_PLANS)
    if (Layout(H, D, P, K, p.nc, p.split).bytes <= MAX_SMEM) return p;
  return {0, true};
}

// One CTA of the bf16 kernel; grid B * NCT, cluster (NCT, 1, 1); D a
// multiple of 16, P of 8, the rows of emb, W and the codes 16-byte aligned.
template <bool SPLIT>
__device__ __forceinline__ void poly_bf16_cta(unsigned char* smem, const bf16* __restrict__ emb,
                                              const bf16* __restrict__ w,
                                              const bf16* __restrict__ codes,
                                              const int* __restrict__ mask,
                                              const float* __restrict__ bias,
                                              bf16* __restrict__ out, int H, int D, int P,
                                              int K, float mask_fill) {
  constexpr int NCT = SPLIT ? MAX_CLUSTER : NC;
  const Layout lay(H, D, P, K, NCT, SPLIT);
  float* sPart = reinterpret_cast<float*>(smem + lay.part);
  float* sLog = reinterpret_cast<float*>(smem + lay.logit);
  bf16* sE = reinterpret_cast<bf16*>(smem + lay.e);
  bf16* sW = reinterpret_cast<bf16*>(smem + lay.w);
  bf16* sC = reinterpret_cast<bf16*>(smem + lay.c);
  bf16* sProj = reinterpret_cast<bf16*>(smem + lay.proj);
  bf16* sWt = reinterpret_cast<bf16*>(smem + lay.wt);
  float* sPP = reinterpret_cast<float*>(smem + lay.pp);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / NCT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Hp = lay.Hp, Kp = lay.Kp;
  const int ldc = SPLIT ? lay.ldc : lay.ldw;  // the codes' and proj's pitch (D whole: W's)
  // this CTA's 16-column chunks of P; D split: of D too (its columns of
  // emb and rows of W, and out's columns); D whole: all of D in emb
  const int c0 = rank * lay.pchunks / NCT, nchunk = (rank + 1) * lay.pchunks / NCT - c0;
  const int p0 = 16 * c0, np8 = 2 * nchunk;  // first column, 8-column pieces
  const int ec0 = SPLIT ? rank * (D / 16) / NCT : 0;
  const int nec = SPLIT ? (rank + 1) * (D / 16) / NCT - ec0 : D / 16;

  const bf16* e = emb + (long)b * H * D;
  if (SPLIT) {
    const int e8 = 2 * nec, w8 = 2 * lay.pchunks;
    for (int i = tid; i < Hp * e8; i += blockDim.x) {
      const int r = i / e8, ch = i % e8;
      const bool ok = r < H;
      cp_async16(sE + r * lay.lde + ch * 8, ok ? e + (long)r * D + 16 * ec0 + ch * 8 : e,
                 ok ? 16 : 0);
    }
    for (int i = tid; i < 16 * nec * w8; i += blockDim.x) {
      const int d = i / w8, p = 8 * (i % w8);
      const bool ok = p < P;
      cp_async16(sW + d * lay.ldw + p, ok ? w + (long)(16 * ec0 + d) * P + p : w, ok ? 16 : 0);
    }
  } else {
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
  }
  for (int i = tid; i < Kp * np8; i += blockDim.x) {
    const int k = i / np8, p = p0 + 8 * (i % np8);
    const bool ok = k < K && p < P;
    cp_async16(sC + k * ldc + (p - p0), ok ? codes + (long)k * P + p : codes, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. D whole: proj slice = tanh(emb @ W slice). D split: the partial proj,
  // emb slice @ W slice over this CTA's D, for all of P (fp32). A (16 rows,
  // 16 columns) unit a warp.
  const int nunit = SPLIT ? lay.pchunks : nchunk;
  for (int u = warp; u < (Hp / 16) * nunit; u += TC_WARPS) {
    const int mt = u / nunit, pc = u % nunit;
    float acc[2][4] = {};
    for (int kc = 0; kc < nec; ++kc) {
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
      for (int r = 0; r < 2; ++r) {
        const int row = mt * 16 + g + 8 * r, col = pc * 16 + nt * 8 + 2 * t;
        if (SPLIT)
          *reinterpret_cast<float2*>(sPP + row * lay.ldp + col) =
              make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
        else
          *reinterpret_cast<uint32_t*>(sProj + row * ldc + col) =
              pack_bf16(tanhf(acc[nt][2 * r]), tanhf(acc[nt][2 * r + 1]));
      }
  }
  if (SPLIT) {
    cluster.sync();  // every CTA's partial proj is written
    // proj slice = tanh(the cluster's sum of the partials, in rank order),
    // rounded to bf16; all the loads in flight before the first add
    const float* pparts[NCT];
#pragma unroll
    for (int r = 0; r < NCT; ++r) pparts[r] = cluster.map_shared_rank(sPP, r);
    const int w16 = 16 * nchunk;
    for (int i = tid; i < Hp * w16; i += blockDim.x) {
      const int h = i / w16, p = i % w16, off = h * lay.ldp + p0 + p;
      float part[NCT];
#pragma unroll
      for (int r = 0; r < NCT; ++r) part[r] = pparts[r][off];
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < NCT; ++r) acc += part[r];
      sProj[h * ldc + p] = __float2bfloat16_rn(tanhf(acc));
    }
  }
  __syncthreads();

  // 2. partial logits = proj slice @ codes slice^T, (16 rows, 16 codes) a unit
  for (int u = warp; u < (Hp / 16) * (Kp / 16); u += TC_WARPS) {
    const int mt = u / (Kp / 16), kt = u % (Kp / 16);
    float acc[2][4] = {};
    for (int pc = 0; pc < nchunk; ++pc) {
      uint32_t a[4], bc[4];
      ldsm_x4(a, sProj + (mt * 16 + (lane & 15)) * ldc + pc * 16 + (lane >> 4) * 8);
      ldsm_x4(bc, sC + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldc + pc * 16 +
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
  const float* parts[NCT];
#pragma unroll
  for (int r = 0; r < NCT; ++r) parts[r] = cluster.map_shared_rank(sPart, r);
  const int* mrow = mask + (long)b * H;
  const float* brow = bias + (long)b * H;
  for (int i = tid; i < Hp * Kp; i += blockDim.x) {
    const int h = i / Kp, k = i % Kp;
    float v = -INFINITY;
    if (h < H) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < NCT; ++r) acc += parts[r][i];
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
  const int dc0 = rank * dchunks / NCT, ndc = (rank + 1) * dchunks / NCT - dc0;
  bf16* o = out + (long)b * K * D;
  for (int u = warp; u < (Kp / 16) * ndc; u += TC_WARPS) {
    const int mt = u / ndc, dc = dc0 + u % ndc;
    float acc[2][4] = {};
    for (int kc = 0; kc < Hp / 16; ++kc) {
      uint32_t a[4], be[4];
      ldsm_x4(a, sWt + (mt * 16 + (lane & 15)) * lay.ldt + kc * 16 + (lane >> 4) * 8);
      ldsm_x4_t(be, sE + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lay.lde +
                        (dc - ec0) * 16 + (lane >> 4) * 8);
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

// the two bf16 entries: names of their own in traces and in the ptxas report
__global__ void __cluster_dims__(NC, 1, 1) __launch_bounds__(32 * TC_WARPS)
poly_attention_bf16(const bf16* __restrict__ emb, const bf16* __restrict__ w,
                    const bf16* __restrict__ codes, const int* __restrict__ mask,
                    const float* __restrict__ bias, bf16* __restrict__ out, int H, int D,
                    int P, int K, float mask_fill) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  poly_bf16_cta<false>(smem_tc, emb, w, codes, mask, bias, out, H, D, P, K, mask_fill);
}

__global__ void __cluster_dims__(MAX_CLUSTER, 1, 1) __launch_bounds__(32 * TC_WARPS)
poly_attention_bf16_dsplit(const bf16* __restrict__ emb, const bf16* __restrict__ w,
                           const bf16* __restrict__ codes, const int* __restrict__ mask,
                           const float* __restrict__ bias, bf16* __restrict__ out, int H,
                           int D, int P, int K, float mask_fill) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  poly_bf16_cta<true>(smem_tc, emb, w, codes, mask, bias, out, H, D, P, K, mask_fill);
}

cudaError_t launch_bf16(const void* emb, const void* w, const void* codes, const void* mask,
                        const void* bias, void* out, int B, int H, int D, int P, int K,
                        float mask_fill, cudaStream_t stream) {
  if (D % 16 != 0 || P % 8 != 0) return cudaErrorInvalidValue;
  const Plan plan = bf16_plan(H, D, P, K);
  if (plan.nc == 0) return cudaErrorInvalidValue;
  const auto kernel = plan.split ? poly_attention_bf16_dsplit : poly_attention_bf16;
  const size_t smem = Layout(H, D, P, K, plan.nc, plan.split).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * plan.nc, 32 * TC_WARPS, smem, stream>>>(
      static_cast<const bf16*>(emb), static_cast<const bf16*>(w),
      static_cast<const bf16*>(codes), static_cast<const int*>(mask),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, D, P, K, mask_fill);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32
constexpr int F32_WARPS = 16;

// Shared memory of one fp32 CTA with nc CTAs a batch row; every CTA of a
// launch has the same layout, sized for the widest slices. D whole: a CTA
// holds emb whole and its slice of W's columns. D split: a CTA holds its
// slice of emb's columns and of W's rows, all of W's columns, and the
// partial proj over its slice of D, which the cluster sums.
struct F32Layout {
  int Hp, Kp, Dp, Pp, ps, ds;  // H and K padded to 16, D and P to 8; the widest slices of P, D
  int lde, ldw, ldc, ldq, ldl, ldt, ldp;  // pitches: emb, W, codes and proj slices, partial
                                          // logits, logits, weights^T, partial proj
  size_t part, logit, e, w, c, proj, wt, pp, mb, bytes;  // byte offsets
  __host__ __device__ F32Layout(int H, int D, int P, int K, int nc, bool split) {
    Hp = (H + 15) / 16 * 16;
    Kp = (K + 15) / 16 * 16;
    Dp = (D + 7) / 8 * 8;
    Pp = (P + 7) / 8 * 8;
    ps = 8 * ((Pp / 8 + nc - 1) / nc);
    ds = split ? 8 * ((Dp / 8 + nc - 1) / nc) : Dp;
    lde = pitch_8_of_16(ds);      // A of proj by (g, 2t) pairs; B of out by rows (t, t + 4)
    ldw = (split ? Pp : ps) + 4;  // B of proj by rows (2t, 2t + 1): a pitch 4 mod 8
    ldc = pitch_8_of_16(ps);      // proj and the codes: A and B of the logits by (g, 2t) pairs
    ldq = pitch_8_of_16(Kp);      // C tiles stored by (g, 2t) pairs
    ldl = Kp + 1;                 // read down a column, a lane a history row
    ldt = Hp + 4;                 // A of out by (g, t): a pitch 4 mod 8
    ldp = pitch_8_of_16(Pp);      // C tiles stored by (g, 2t) pairs
    part = 0;                                       // (Hp, Kp) this CTA's partial logits
    logit = part + sizeof(float) * Hp * ldq;        // (Hp, Kp) the summed logits
    e = (logit + sizeof(float) * Hp * ldl + 15) / 16 * 16;  // (Hp, ds) emb or its slice
    w = e + sizeof(float) * Hp * lde;               // (ds, ps) or (ds, Pp): W's slice
    c = w + sizeof(float) * (size_t)ds * ldw;       // (Kp, ps) the codes' slice
    proj = c + sizeof(float) * Kp * ldc;            // (Hp, ps) proj's slice
    wt = proj + sizeof(float) * Hp * ldc;           // (Kp, Hp) weights^T
    pp = wt + sizeof(float) * Kp * ldt;             // D split: (Hp, Pp) the partial proj
    mb = pp + (split ? sizeof(float) * Hp * ldp : 0);  // (Hp,) mask, then (Hp,) bias
    bytes = mb + 2 * sizeof(float) * Hp;
  }
};

// The CTAs a batch row and the layout, from the shapes alone: the first of
// 3 CTAs (emb whole, a third of W's columns each), 8 (an eighth), and 8
// with D split (an eighth of emb's columns and W's rows each: D = 768)
// whose CTA fits; nc = 0 where none does. ops/poly_attention.py:FP32_PLANS
// lists the same.
constexpr Plan FP32_PLANS[] = {{3, false}, {MAX_CLUSTER, false}, {MAX_CLUSTER, true}};

Plan fp32_plan(int H, int D, int P, int K) {
  for (const Plan& p : FP32_PLANS)
    if (F32Layout(H, D, P, K, p.nc, p.split).bytes <= MAX_SMEM) return p;
  return {0, true};
}

// rows x cols floats (cols a multiple of 4) of src (row pitch sld) into dst
// (row pitch dld) by cp.async, zero where row >= rmax or col >= cmax: 16-byte
// copies when vec (src, sld and cmax multiples of 4 floats), else 4-byte
__device__ __forceinline__ void stage(float* dst, int dld, const float* src, long sld,
                                      int rows, int cols, int rmax, int cmax, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const int r = i / c4, col = 4 * (i - r * c4);
      const bool ok = r < rmax && col < cmax;
      cp_async16(dst + r * dld + col, ok ? src + r * sld + col : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, col = i - r * cols;
      const bool ok = r < rmax && col < cmax;
      cp_async4(dst + r * dld + col, ok ? src + r * sld + col : src, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// sum over the cluster's CTAs, in rank order, of the float at `off` in each
// one's copy of `buf` (all the loads in flight before the first add)
__device__ __forceinline__ float cluster_sum(const cg::cluster_group& cluster, float* buf,
                                             int off, int nc) {
  float part[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    part[r] = r < nc ? cluster.map_shared_rank(buf, r)[off] : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) acc += part[r];
  return acc;
}

// grid B * nc, cluster (nc, 1, 1) as fp32_plan gives them; any D, P; vec:
// emb, w and codes 16-byte aligned and D, P multiples of 4
template <bool SPLIT>
__global__ void __launch_bounds__(32 * F32_WARPS, 1)
poly_attention_fp32(const float* __restrict__ emb, const float* __restrict__ w,
                    const float* __restrict__ codes, const int* __restrict__ mask,
                    const float* __restrict__ bias, float* __restrict__ out, int H, int D,
                    int P, int K, float mask_fill, int vec) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const F32Layout lay(H, D, P, K, nc, SPLIT);
  float* sPart = reinterpret_cast<float*>(smem_f32 + lay.part);
  float* sLog = reinterpret_cast<float*>(smem_f32 + lay.logit);
  float* sE = reinterpret_cast<float*>(smem_f32 + lay.e);
  float* sW = reinterpret_cast<float*>(smem_f32 + lay.w);
  float* sC = reinterpret_cast<float*>(smem_f32 + lay.c);
  float* sProj = reinterpret_cast<float*>(smem_f32 + lay.proj);
  float* sWt = reinterpret_cast<float*>(smem_f32 + lay.wt);
  float* sPP = reinterpret_cast<float*>(smem_f32 + lay.pp);
  int* sMask = reinterpret_cast<int*>(smem_f32 + lay.mb);
  float* sBias = reinterpret_cast<float*>(sMask + lay.Hp);
  const int b = blockIdx.x / nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Hp = lay.Hp, Kp = lay.Kp, Dp = lay.Dp;
  const int lde = lay.lde, ldw = lay.ldw, ldc = lay.ldc, ldt = lay.ldt;
  // this CTA's 8-column pieces of P, and of D (out's columns; D split: also
  // its columns of emb and rows of W)
  const int np8 = lay.Pp / 8, nd8 = Dp / 8;
  const int pc0 = rank * np8 / nc, npc = (rank + 1) * np8 / nc - pc0;
  const int dc0 = rank * nd8 / nc, ndc = (rank + 1) * nd8 / nc - dc0;
  const int p0 = 8 * pc0, d0 = SPLIT ? 8 * dc0 : 0;

  // emb (D split: its slice of columns), the slice's W and codes, zero past
  // H, D, P and K, in shared memory before any product
  const float* e = emb + (long)b * H * D;
  if (SPLIT) {
    stage(sE, lde, e + d0, D, Hp, 8 * ndc, H, D - d0, vec);
    stage(sW, ldw, w + (long)d0 * P, P, 8 * ndc, lay.Pp, D - d0, P, vec);
  } else {
    stage(sE, lde, e, D, Hp, Dp, H, D, vec);
    stage(sW, ldw, w + p0, P, Dp, 8 * npc, D, P - p0, vec);
  }
  stage(sC, ldc, codes + p0, P, Kp, 8 * npc, K, P - p0, vec);
  cp_async_commit();
  for (int h = tid; h < H; h += blockDim.x) {
    sMask[h] = mask[(long)b * H + h];
    sBias[h] = bias[(long)b * H + h];
  }
  cp_async_wait<0>();
  __syncthreads();

  // 1. D whole: proj slice = tanh(emb @ W slice). D split: the partial
  // proj, emb slice @ W slice over this CTA's D, for all of P. A (16 rows,
  // two 8-column pieces) unit a warp; k read in the order (2t, 2t + 1):
  // emb's pairs by float2. Even and odd k-steps sum into two accumulators
  // (added at the end), so that the chain of dependent mma is half as long.
  const int npieces = SPLIT ? np8 : npc, nk = SPLIT ? ndc : nd8;
  float* const dst = SPLIT ? sPP : sProj;
  const int ldd = SPLIT ? lay.ldp : ldc;
  const int pg = (npieces + 1) / 2;
  for (int u = warp; u < (Hp / 16) * pg; u += F32_WARPS) {
    const int mt = u / pg, pc = 2 * (u - mt * pg);
    const bool two = pc + 1 < npieces;
    float acc[2][4] = {}, odd[2][4] = {};
    const float* ar = sE + (mt * 16 + g) * lde + 2 * t;
    const float* br = sW + 2 * t * ldw + pc * 8 + g;
    auto step = [&](float (&c)[2][4], int kc) {
      const float2 x = ld2(ar + kc * 8), y = ld2(ar + 8 * lde + kc * 8);
      const FragA a = split_a(x.x, y.x, x.y, y.y);
      const float* bk = br + kc * 8 * ldw;
      mma_3xtf32(c[0], a, bk[0], bk[ldw]);
      if (two) mma_3xtf32(c[1], a, bk[8], bk[ldw + 8]);
    };
#pragma unroll 2
    for (int kc = 0; kc + 1 < nk; kc += 2) {
      step(acc, kc);
      step(odd, kc + 1);
    }
    if (nk & 1) step(acc, nk - 1);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc[nt][x] += odd[nt][x];
        if (!SPLIT) acc[nt][x] = tanhf(acc[nt][x]);
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      if (nt == 0 || two)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(dst + (mt * 16 + g + 8 * r) * ldd + (pc + nt) * 8 +
                                     2 * t) = make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
  if (SPLIT) {
    cluster.sync();  // every CTA's partial proj is written
    // proj slice = tanh(the cluster's sum of the partials, in rank order)
    const int w8 = 8 * npc;
    for (int i = tid; i < Hp * w8; i += blockDim.x) {
      const int h = i / w8, p = i - h * w8;
      sProj[h * ldc + p] = tanhf(cluster_sum(cluster, sPP, h * lay.ldp + p0 + p, nc));
    }
  }
  __syncthreads();

  // 2. partial logits = proj slice @ codes slice^T, (16 rows, 8 codes) a
  // unit; k in the order (2t, 2t + 1) in both operands
  const int kq = Kp / 8;
  for (int u = warp; u < (Hp / 16) * kq; u += F32_WARPS) {
    const int mt = u / kq, nt = u - mt * kq;
    float acc[4] = {};
    const float* ar = sProj + (mt * 16 + g) * ldc + 2 * t;
    const float* br = sC + (nt * 8 + g) * ldc + 2 * t;
    for (int kc = 0; kc < npc; ++kc) {
      const float2 x = ld2(ar + kc * 8), y = ld2(ar + 8 * ldc + kc * 8);
      const float2 bb = ld2(br + kc * 8);
      mma_3xtf32(acc, split_a(x.x, y.x, x.y, y.y), bb.x, bb.y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(sPart + (mt * 16 + g + 8 * r) * lay.ldq + nt * 8 + 2 * t) =
          make_float2(acc[2 * r], acc[2 * r + 1]);
  }
  cluster.sync();  // every CTA's partial logits are written

  // 3. the cluster's sum of the partials, in rank order, with bias and mask
  // (masked slots: mask_fill); history rows past H get -inf: no weight at all
#pragma unroll 2
  for (int i = tid; i < Hp * Kp; i += blockDim.x) {
    const int h = i / Kp, k = i - h * Kp;
    float v = -INFINITY;
    if (h < H) {
      const float acc = cluster_sum(cluster, sPart, h * lay.ldq + k, nc);
      v = sMask[h] != 0 ? acc + sBias[h] : mask_fill;
    }
    sLog[h * lay.ldl + k] = v;
  }
  __syncthreads();
  // this CTA reads no other's shared memory past here; none may leave while
  // another still reads its partials (the wait is at the end)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // 4. softmax over the history axis, a warp a code, into weights^T
  for (int k = warp; k < Kp; k += F32_WARPS) {
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
    for (int h = lane; h < Hp; h += 32) sWt[k * ldt + h] = sLog[h * lay.ldl + k] / sum;
  }
  __syncthreads();

  // 5. out[:, this CTA's 8-column pieces of D] = weights^T @ emb, (16 codes,
  // two pieces) a unit
  const int dg = (ndc + 1) / 2;
  float* o = out + (long)b * K * D;
  for (int u = warp; u < (Kp / 16) * dg; u += F32_WARPS) {
    const int mt = u / dg, dc = dc0 + 2 * (u - mt * dg);
    const bool two = dc + 1 < dc0 + ndc;
    float acc[2][4] = {};
    const float* ar = sWt + (mt * 16 + g) * ldt + t;
    const float* br = sE + t * lde + dc * 8 - d0 + g;
#pragma unroll 4
    for (int kc = 0; kc < Hp / 8; ++kc) {
      const float* ak = ar + kc * 8;
      const FragA a = split_a(ak[0], ak[8 * ldt], ak[4], ak[8 * ldt + 4]);
      const float* bk = br + kc * 8 * lde;
      mma_3xtf32(acc[0], a, bk[0], bk[4 * lde]);
      if (two) mma_3xtf32(acc[1], a, bk[8], bk[4 * lde + 8]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = mt * 16 + g + 8 * r;
      if (k >= K) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        if (nt == 0 || two)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int d = (dc + nt) * 8 + 2 * t + x;
            if (d < D) o[(long)k * D + d] = acc[nt][2 * r + x];
          }
    }
  }
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

cudaError_t launch_fp32(const void* emb, const void* w, const void* codes, const void* mask,
                        const void* bias, void* out, int B, int H, int D, int P, int K,
                        float mask_fill, cudaStream_t stream) {
  const Plan plan = fp32_plan(H, D, P, K);
  if (plan.nc == 0) return cudaErrorInvalidValue;
  const auto kernel = plan.split ? poly_attention_fp32<true> : poly_attention_fp32<false>;
  const size_t smem = F32Layout(H, D, P, K, plan.nc, plan.split).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = ((reinterpret_cast<uintptr_t>(emb) | reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(codes)) % 16 == 0) &&
                  D % 4 == 0 && P % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * plan.nc);
  cfg.blockDim = dim3(32 * F32_WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(emb),
                           static_cast<const float*>(w), static_cast<const float*>(codes),
                           static_cast<const int*>(mask), static_cast<const float*>(bias),
                           static_cast<float*>(out), H, D, P, K, mask_fill, vec);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Shared memory a CTA of the kernel for `dtype` takes at these shapes with
// nc CTAs a row and D split across them or not.
extern "C" long long poly_attention_layout_bytes(int H, int D, int P, int K, int dtype, int nc,
                                                 int split) {
  return (long long)(dtype == DTYPE_BF16 ? Layout(H, D, P, K, nc, split != 0).bytes
                                         : F32Layout(H, D, P, K, nc, split != 0).bytes);
}

// Shared memory a CTA of the kernel for `dtype` takes at these shapes, in
// the layout the launch takes (bf16_plan's or fp32_plan's; where none fits,
// that of its last plan).
extern "C" long long poly_attention_smem_bytes(int H, int D, int P, int K, int dtype) {
  Plan plan = dtype == DTYPE_BF16 ? bf16_plan(H, D, P, K) : fp32_plan(H, D, P, K);
  if (plan.nc == 0) plan = {MAX_CLUSTER, true};
  return poly_attention_layout_bytes(H, D, P, K, dtype, plan.nc, plan.split);
}

// emb (B, H, D), w (D, P), codes (K, P) and out (B, K, D) of one dtype;
// mask (B, H) int32; bias (B, H) float32; all contiguous. bf16: D a
// multiple of 16 and P of 8, emb, w and codes 16-byte aligned; fp32 any
// shape; either type at a shape whose CTA fits in shared memory in one of
// its plans (poly_attention_smem_bytes).
// mask_fill: the logit of a masked slot.
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
