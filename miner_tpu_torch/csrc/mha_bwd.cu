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
// rowsum(dP * P) equals D_i = rowsum(dO * O) (O the forward's output), which
// is what the kernel computes, in fp32: one Dh-long dot per query row
// instead of a second pass over the keys. P is rebuilt from the forward's
// softmax statistics (row max and 1/row sum, see mha_fwd.cu) and the
// dropout mask is regenerated from the same Philox counters
// (csrc/philox.cuh), so nothing random and no (L, L) tensor is stored. A
// fully masked row (all keys at -1e9) has a uniform P over all L keys, and
// its gradient reaches V of the masked keys, as in the TPU kernel.
//
// What bounds it: at the sapo training shape (N = 880, L = 128, 12 heads of
// Dh = 64) five products of 2 N H L^2 Dh flops each (QK^T, dO V^T, dV, dK,
// dQ) = 110.7 GFLOP against ~1.40 GB that must move (qkv, out, dout, stats
// and mask read, dqkv written), ~79 FLOP per byte: under the bf16 ridge of
// ~295, so the bound is the bytes (~0.42 ms at 3.35 TB/s). With dropout,
// Philox's integer work (N H L^2 / 4 calls, as in the forward) comes next.
//
// Design, on the tensor cores, the same for both types, with no cross-block
// sum. One block per (sequence, head) owns that head's whole
// gradient: up to 8 warps, each owning 16 keys, so a key tile is min(L,
// 128) keys (16 * warps); longer sequences loop over key tiles of 128. K
// and V of the tile are copied into shared memory once by 16-byte cp.async;
// queries go through in steps of 32 rows (Q, dO and O, double-buffered,
// rows padded by 16 bytes). Per step every warp computes, for its 16 keys
// and the 32 queries,
//   S^T = K Q^T and dP^T = V dO^T, keys as the rows so that P^T and dS^T
//     come out in the A layout of
//   dV += Pd^T dO and dK += dS^T Q, accumulated in fp32 registers over all
//     query steps and written once;
// P = exp(s - m) / l from the statistics, keep from one Philox call per
// lane and 16 x 16 block (keys g, g+8 x queries 2t+e, 2t+e+8: the same
// counters as the forward's lanes, transposed). dS^T goes to shared memory,
// and after a barrier the warps compute dQ of the step's 32 rows = dS K
// over the tile's keys. With one key tile (L <= 128) that dQ is final and
// is written at once; with more, each dQ element is summed over the key
// tiles by the one lane that owns it. No atomics, no second kernel,
// deterministic.
// bf16: mma.sync m16n8k16 with fragments by ldmatrix (.trans for dS and
// K in dQ); Pd and dS are rounded to bf16 before their products, as the TPU
// kernel rounds them (mha.py:157, 171); the dQ sums over key tiles (L >
// 128) go through a global fp32 scratch row of this (sequence, head) that
// no other block touches. fp32: mma.sync m16n8k8 in split TF32
// (tensor_core.cuh) for all five products, fragments by 32-bit shared loads
// split in registers, Pd^T and dS^T entering dV and dK straight from their
// C registers (their 8 queries read in the order (2t, 2t+1), dO's and Q's
// rows likewise); dQ over key tiles sums in the fp32 output itself. An fp32
// input off a 16-byte boundary is copied by 4-byte cp.async, chosen at
// launch. The fp32 kernel has a body of its own: one template over both
// types changed the bf16 kernel's register allocation and cost it 2-3% on
// the card (L = 32, and L = 128 without dropout).
#include "common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// The Philox counter takes a sequence's and a head's places in the whole
// batch: the launch's index plus seq_offset / head_offset (a rank's part of
// a batch). OFF false, a launch over the whole batch, is built without the
// adds, which cost the bf16 kernels a spill (the wrapper passes zeros then).
template <bool OFF>
struct Dropout {
  unsigned long long seed;
  unsigned int thresh;
  float inv_keep;
  int on;
  int seq_offset, head_offset;
  __device__ __forceinline__ int seq(int n) const { return OFF ? n + seq_offset : n; }
  __device__ __forceinline__ int head(int h) const { return OFF ? h + head_offset : h; }
};

// --------------------------------------------------------------- bfloat16
typedef __nv_bfloat16 bf16;

constexpr int TC_WARPS = 8;
constexpr int TC_KEYS = 16 * TC_WARPS;  // keys per tile at most
constexpr int BQ = 32;                  // query rows per step
constexpr int LDS = BQ + 8;             // dS^T row pitch (bf16)

int tc_warps(int L) { return L >= TC_KEYS ? TC_WARPS : (L + 15) / 16; }

template <int DH>
constexpr int tc_smem_bytes(int keys) {
  // K, V (keys rows); Q, dO, O (2 x BQ rows each); dS^T; m, 1/l, D_i
  return (2 * keys * (DH + 8) + 6 * BQ * (DH + 8) + keys * LDS) * 2 + 3 * BQ * 4;
}

// grid (N, H), blockDim 32 * tc_warps(L). dq_acc: (N, H, L, DH) fp32
// scratch when L > 128, else null.
template <int DH, bool OFF>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
mha_bwd_bf16(const bf16* __restrict__ qkv, const int* __restrict__ mask,
             const bf16* __restrict__ out, const bf16* __restrict__ dout,
             const float2* __restrict__ stats, bf16* __restrict__ dqkv,
             float* __restrict__ dq_acc, int L, int H, int seqs, Dropout<OFF> drop) {
  constexpr int LD = DH + 8, CH = DH / 8;
  const int nw = blockDim.x >> 5, KT = 16 * nw;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + KT * LD;
  bf16* sQ = sV + KT * LD;         // 2 buffers of BQ rows
  bf16* sdO = sQ + 2 * BQ * LD;
  bf16* sO = sdO + 2 * BQ * LD;
  bf16* sdS = sO + 2 * BQ * LD;    // (KT, LDS): dS^T, keys x queries
  float* sM = reinterpret_cast<float*>(sdS + KT * LDS);
  float* sIL = sM + BQ;
  float* sD = sIL + BQ;

  const int n = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = H * DH;
  const long rs = 3L * D;
  const bf16* seq = qkv + (long)n * L * rs;
  bf16* dseq = dqkv + (long)n * L * rs;
  const bf16* oseq = out + (long)n * L * D + h * DH;
  const bf16* doseq = dout + (long)n * L * D + h * DH;
  const int* mrow = mask + (long)n * L;
  const float2* srow = stats + ((long)n * H + h) * L;
  float* dq_row = dq_acc == nullptr ? nullptr : dq_acc + ((long)n * H + h) * L * DH;
  const int sub = L / seqs;
  const float scale = 1.0f / sqrtf((float)DH);
  const float ik = drop.on ? drop.inv_keep : 1.f;

  // rows r0.. of a (row stride `stride`) matrix, rows past L zero-filled
  auto load_rows = [&](bf16* dst, const bf16* src, long stride, int r0, int rows) {
    for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
      const int r = c / CH, ch = c % CH, j = r0 + r;
      cp_async16(dst + r * LD + ch * 8, src + (long)min(j, L - 1) * stride + ch * 8,
                 j < L ? 16 : 0);
    }
  };
  auto load_queries = [&](int buf, int q0) {
    load_rows(sQ + buf * BQ * LD, seq + h * DH, rs, q0, BQ);
    load_rows(sdO + buf * BQ * LD, doseq, D, q0, BQ);
    load_rows(sO + buf * BQ * LD, oseq, D, q0, BQ);
  };

  for (int k0 = 0; k0 < L; k0 += KT) {
    if (k0 > 0) __syncthreads();  // the last tile's dQ products have read sK
    load_rows(sK, seq + D + h * DH, rs, k0, KT);
    load_rows(sV, seq + 2 * D + h * DH, rs, k0, KT);
    load_queries(0, 0);
    cp_async_commit();
    const int kw = k0 + warp * 16;  // this warp's first key
    const bool active = kw < L;     // warp-uniform
    int kok[2];                     // keys g, g + 8: 1 valid, 0 masked, -1 none
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kw + g + 8 * r;
      kok[r] = j < L ? (mrow[j] != 0) : -1;
    }
    const int nkb = (min(KT, L - k0) + 15) / 16;  // 16-key blocks holding keys
    float dv[DH / 8][4], dk[DH / 8][4];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
      for (int x = 0; x < 4; ++x) dv[dt][x] = dk[dt][x] = 0.f;

    int buf = 0;
    for (int q0 = 0; q0 < L; q0 += BQ, buf ^= 1) {
      if (q0 + BQ < L) {
        load_queries(buf ^ 1, q0 + BQ);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // rows past L: 1/l = 0, so their P is 0 and they add nothing
      for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
        const float2 s2 = q0 + r < L ? srow[q0 + r] : make_float2(0.f, 0.f);
        sM[r] = s2.x;
        sIL[r] = s2.y;
      }
      __syncthreads();  // A: the step's rows and statistics have landed
      const bf16* q_s = sQ + buf * BQ * LD;
      const bf16* do_s = sdO + buf * BQ * LD;
      const bf16* o_s = sO + buf * BQ * LD;
      // D_i = rowsum(dO * O) in fp32: CH consecutive lanes per row
      for (int c = threadIdx.x; c < BQ * CH; c += blockDim.x) {
        const int r = c / CH, ch = c % CH;
        float acc = dot8_bf16(*reinterpret_cast<const uint4*>(do_s + r * LD + ch * 8),
                              *reinterpret_cast<const uint4*>(o_s + r * LD + ch * 8));
#pragma unroll
        for (int off = CH / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (ch == 0) sD[r] = acc;
      }
      __syncthreads();  // B: D_i

      if (active) {
        float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[nt][x] = dp[nt][x] = 0.f;
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc) {
          uint32_t ka[4], va[4];  // the warp's 16 keys as A
          ldsm_x4(ka, sK + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
          ldsm_x4(va, sV + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int qb = 0; qb < BQ / 16; ++qb) {
            const int off = (qb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t b[4];  // queries qb*16.. as B = Q^T, dO^T: two n8 tiles
            ldsm_x4(b, q_s + off);
            mma_bf16(s[2 * qb], ka, b[0], b[1]);
            mma_bf16(s[2 * qb + 1], ka, b[2], b[3]);
            ldsm_x4(b, do_s + off);
            mma_bf16(dp[2 * qb], va, b[0], b[1]);
            mma_bf16(dp[2 * qb + 1], va, b[2], b[3]);
          }
        }
        // P from the statistics; s[nt][x] is (key g + 8 (x >> 1), query
        // q0 + nt * 8 + 2t + (x & 1))
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1, ql = nt * 8 + 2 * t + (x & 1);
            const int i = q0 + ql, j = kw + g + 8 * r;
            float v = s[nt][x] * scale;
            if (kok[r] == 0 || (seqs > 1 && j / sub != i / sub)) v = MASK_FILL;
            s[nt][x] = kok[r] < 0 ? 0.f : exp2f((v - sM[ql]) * LOG2E) * sIL[ql];
          }
        }
        // keep multipliers (inv_keep or 0; 1 without dropout) into kp
        float kp[BQ / 8][4];
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) kp[nt][x] = ik;
        if (drop.on) {
#pragma unroll
          for (int qb = 0; qb < BQ / 16; ++qb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // words: (key g, query 2t+e), (g+8, 2t+e), (g, 2t+e+8), (g+8, 2t+e+8)
              const Philox4 bits = mha_block_bits((q0 >> 4) + qb, 2 * t + e, kw >> 4, g,
                                                  drop.head(h), drop.seq(n), drop.seed);
              const unsigned th = drop.thresh;
              if (bits.w[0] < th) kp[2 * qb][e] = 0.f;
              if (bits.w[1] < th) kp[2 * qb][2 + e] = 0.f;
              if (bits.w[2] < th) kp[2 * qb + 1][e] = 0.f;
              if (bits.w[3] < th) kp[2 * qb + 1][2 + e] = 0.f;
            }
          }
        }
        // s <- Pd, dp <- dS = P (keep dP / (1 - rate) - D_i) / sqrt(Dh)
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float p = s[nt][x];
            const float Di = sD[nt * 8 + 2 * t + (x & 1)];
            s[nt][x] = p * kp[nt][x];
            dp[nt][x] = p * (dp[nt][x] * kp[nt][x] - Di) * scale;
          }
        }
#pragma unroll
        for (int qb = 0; qb < BQ / 16; ++qb) {
          const uint32_t pa[4] = {pack_bf16(s[2 * qb][0], s[2 * qb][1]),
                                  pack_bf16(s[2 * qb][2], s[2 * qb][3]),
                                  pack_bf16(s[2 * qb + 1][0], s[2 * qb + 1][1]),
                                  pack_bf16(s[2 * qb + 1][2], s[2 * qb + 1][3])};
          const uint32_t da[4] = {pack_bf16(dp[2 * qb][0], dp[2 * qb][1]),
                                  pack_bf16(dp[2 * qb][2], dp[2 * qb][3]),
                                  pack_bf16(dp[2 * qb + 1][0], dp[2 * qb + 1][1]),
                                  pack_bf16(dp[2 * qb + 1][2], dp[2 * qb + 1][3])};
#pragma unroll
          for (int dpr = 0; dpr < DH / 16; ++dpr) {
            const int off = (qb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dpr * 16 +
                            (lane >> 4) * 8;
            uint32_t b[4];  // dO, Q rows qb*16.., columns dpr*16..: two n8 tiles
            ldsm_x4_t(b, do_s + off);
            mma_bf16(dv[2 * dpr], pa, b[0], b[1]);
            mma_bf16(dv[2 * dpr + 1], pa, b[2], b[3]);
            ldsm_x4_t(b, q_s + off);
            mma_bf16(dk[2 * dpr], da, b[0], b[1]);
            mma_bf16(dk[2 * dpr + 1], da, b[2], b[3]);
          }
          bf16* row = sdS + (warp * 16 + g) * LDS + qb * 16 + 2 * t;
          *reinterpret_cast<uint32_t*>(row) = da[0];
          *reinterpret_cast<uint32_t*>(row + 8 * LDS) = da[1];
          *reinterpret_cast<uint32_t*>(row + 8) = da[2];
          *reinterpret_cast<uint32_t*>(row + 8 * LDS + 8) = da[3];
        }
      }
      __syncthreads();  // C: dS^T of every warp

      // dQ of the step's rows = dS K over the tile's keys, one 16 x 16
      // block per warp at a time
      for (int blk = warp; blk < (BQ / 16) * (DH / 16); blk += nw) {
        const int qb = blk / (DH / 16), dpr = blk % (DH / 16);
        float acc[2][4] = {};
        for (int kc = 0; kc < nkb; ++kc) {
          uint32_t a[4], b[4];
          ldsm_x4_t(a, sdS + (kc * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + qb * 16 +
                           ((lane >> 3) & 1) * 8);
          ldsm_x4_t(b, sK + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dpr * 16 +
                           (lane >> 4) * 8);
          mma_bf16(acc[0], a, b[0], b[1]);
          mma_bf16(acc[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int dt = 0; dt < 2; ++dt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = q0 + qb * 16 + g + 8 * r;
            if (i >= L) continue;
            const int d = dpr * 16 + dt * 8 + 2 * t;
            float v0 = acc[dt][2 * r], v1 = acc[dt][2 * r + 1];
            if (dq_row != nullptr) {  // summed over key tiles by this lane alone
              float2* p = reinterpret_cast<float2*>(dq_row + (long)i * DH + d);
              if (k0 > 0) {
                const float2 o = *p;
                v0 += o.x;
                v1 += o.y;
              }
              if (k0 + KT < L) {
                *p = make_float2(v0, v1);
                continue;
              }
            }
            *reinterpret_cast<uint32_t*>(dseq + (long)i * rs + h * DH + d) =
                pack_bf16(v0, v1);
          }
        }
      }
    }

    if (active) {  // dK, dV of the warp's keys, written once
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = kw + g + 8 * r;
          if (j >= L) continue;
          bf16* row = dseq + (long)j * rs + h * DH + dt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(row + D) = pack_bf16(dk[dt][2 * r], dk[dt][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(row + 2 * D) =
              pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
        }
      }
    }
  }
}

template <int DH, bool OFF>
cudaError_t launch_bf16(const void* qkv, const void* mask, const void* out,
                        const void* dout, const void* stats, void* dqkv,
                        void* scratch, int N, int L, int H, int seqs,
                        Dropout<OFF> drop, cudaStream_t stream) {
  const int nw = tc_warps(L);
  if (L > 16 * nw && scratch == nullptr) return cudaErrorInvalidValue;
  const int smem = tc_smem_bytes<DH>(16 * nw);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_bf16<DH, OFF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N, H);
  mha_bwd_bf16<DH, OFF><<<grid, 32 * nw, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(mask),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float2*>(stats), static_cast<bf16*>(dqkv),
      L > 16 * nw ? static_cast<float*>(scratch) : nullptr, L, H, seqs, drop);
  return cudaGetLastError();
}

// ------------------------------------------------------- float32 (split TF32)
// The bf16 kernel's structure (TC_WARPS, BQ, tc_warps), rows padded by 4
// floats so the fragment reads fall on distinct banks
constexpr int LDS_F32 = BQ + 4;  // dS^T row pitch (fp32)

template <int DH>
constexpr int fp32_smem_bytes(int keys) {
  // K, V (keys rows); Q, dO, O (2 x BQ rows each); dS^T; m, 1/l, D_i
  return (2 * keys * (DH + 4) + 6 * BQ * (DH + 4) + keys * LDS_F32) * 4 + 3 * BQ * 4;
}

// S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys (rows of sKw, sVw)
// and the step's BQ queries: s[nt][x], dp[nt][x] is (key g + 8 (x >> 1),
// query nt * 8 + 2t + (x & 1))
template <int DH>
__device__ __forceinline__ void key_logits_fp32(float (&s)[BQ / 8][4],
                                                float (&dp)[BQ / 8][4], const float* sKw,
                                                const float* sVw, const float* q_s,
                                                const float* do_s, int lane) {
  constexpr int LD = DH + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < DH / 8; ++kc) {
    const float* kr = sKw + g * LD + kc * 8 + t;
    const float* vr = sVw + g * LD + kc * 8 + t;
    const FragA ka = split_a(kr[0], kr[8 * LD], kr[4], kr[8 * LD + 4]);
    const FragA va = split_a(vr[0], vr[8 * LD], vr[4], vr[8 * LD + 4]);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {  // B = Q^T, dO^T: (d t, query g), (d t+4, g)
      const int off = (nt * 8 + g) * LD + kc * 8 + t;
      mma_3xtf32(s[nt], ka, q_s[off], q_s[off + 4]);
      mma_3xtf32(dp[nt], va, do_s[off], do_s[off + 4]);
    }
  }
}

// dV += Pd^T dO and dK += dS^T Q (s holds Pd, dp holds dS, in the C layout
// of key_logits_fp32), and dS^T into the warp's 16 rows of sdSw
template <int DH>
__device__ __forceinline__ void key_grads_fp32(float (&dv)[DH / 8][4],
                                               float (&dk)[DH / 8][4],
                                               const float (&s)[BQ / 8][4],
                                               const float (&dp)[BQ / 8][4], const float* q_s,
                                               const float* do_s, float* sdSw, int lane) {
  constexpr int LD = DH + 4, LDS = LDS_F32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < BQ / 8; ++nt) {
    // the 8 queries of n8 tile nt as the k of dV, dK, read as (2t, 2t+1)
    const FragA pa = split_c_as_a(s[nt]), da = split_c_as_a(dp[nt]);
    const int off = (nt * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      mma_3xtf32(dv[dt], pa, do_s[off + dt * 8], do_s[off + LD + dt * 8]);
      mma_3xtf32(dk[dt], da, q_s[off + dt * 8], q_s[off + LD + dt * 8]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(sdSw + (g + 8 * r) * LDS + nt * 8 + 2 * t) =
          make_float2(dp[nt][2 * r], dp[nt][2 * r + 1]);
  }
}

// one 16 x 16 block of dQ = dS K (queries qb*16.., columns dpr*16..) over
// the tile's nkb 16-key blocks, as two n8 C tiles
template <int DH>
__device__ __forceinline__ void dq_block_fp32(float (&acc)[2][4], const float* sdS,
                                              const float* sK, int qb, int dpr, int nkb,
                                              int lane) {
  constexpr int LD = DH + 4, LDS = LDS_F32;
  const int g = lane >> 2, t = lane & 3;
  for (int kc = 0; kc < 2 * nkb; ++kc) {  // 8 keys a step, read as (2t, 2t+1)
    const float* ar = sdS + (kc * 8 + 2 * t) * LDS + qb * 16 + g;
    const FragA a = split_a(ar[0], ar[8], ar[LDS], ar[LDS + 8]);
    const float* br = sK + (kc * 8 + 2 * t) * LD + dpr * 16 + g;
    mma_3xtf32(acc[0], a, br[0], br[LD]);
    mma_3xtf32(acc[1], a, br[8], br[LD + 8]);
  }
}

// grid (N, H), blockDim 32 * tc_warps(L). vec: qkv, out and dout are
// 16-byte aligned. One block per SM (its K, V, the query buffers and dS^T
// take 137 KB of shared memory at Dh = 64), so the cap is 255 registers and
// the dK, dV accumulators and split fragments stay in registers.
template <int DH, bool OFF>
__global__ void __launch_bounds__(32 * TC_WARPS, 1)
mha_bwd_fp32(const float* __restrict__ qkv, const int* __restrict__ mask,
             const float* __restrict__ out, const float* __restrict__ dout,
             const float2* __restrict__ stats, float* __restrict__ dqkv, int L, int H,
             int seqs, int vec, Dropout<OFF> drop) {
  constexpr int LD = DH + 4, LDS = LDS_F32, CH = DH / 4;
  const int nw = blockDim.x >> 5, KT = 16 * nw;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* sK = reinterpret_cast<float*>(tc_smem);
  float* sV = sK + KT * LD;
  float* sQ = sV + KT * LD;       // 2 buffers of BQ rows
  float* sdO = sQ + 2 * BQ * LD;
  float* sO = sdO + 2 * BQ * LD;
  float* sdS = sO + 2 * BQ * LD;  // (KT, LDS): dS^T, keys x queries
  float* sM = reinterpret_cast<float*>(sdS + KT * LDS);
  float* sIL = sM + BQ;
  float* sD = sIL + BQ;

  const int n = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = H * DH;
  const long rs = 3L * D;
  const float* seq = qkv + (long)n * L * rs;
  float* dseq = dqkv + (long)n * L * rs;
  const float* oseq = out + (long)n * L * D + h * DH;
  const float* doseq = dout + (long)n * L * D + h * DH;
  const int* mrow = mask + (long)n * L;
  const float2* srow = stats + ((long)n * H + h) * L;
  const int sub = L / seqs;
  const float scale = 1.0f / sqrtf((float)DH);
  const float ik = drop.on ? drop.inv_keep : 1.f;

  // rows r0.. of a (row stride `stride`) matrix, rows past L zero-filled
  auto load_rows = [&](float* dst, const float* src, long stride, int r0, int rows) {
    if (!vec) {  // off a 16-byte boundary: 4-byte copies
      for (int c = threadIdx.x; c < rows * DH; c += blockDim.x) {
        const int r = c / DH, d = c % DH, j = r0 + r;
        cp_async4(dst + r * LD + d, src + (long)min(j, L - 1) * stride + d, j < L ? 4 : 0);
      }
      return;
    }
    for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
      const int r = c / CH, ch = c % CH, j = r0 + r;
      cp_async16(dst + r * LD + ch * 4, src + (long)min(j, L - 1) * stride + ch * 4,
                 j < L ? 16 : 0);
    }
  };
  auto load_queries = [&](int buf, int q0) {
    load_rows(sQ + buf * BQ * LD, seq + h * DH, rs, q0, BQ);
    load_rows(sdO + buf * BQ * LD, doseq, D, q0, BQ);
    load_rows(sO + buf * BQ * LD, oseq, D, q0, BQ);
  };

  for (int k0 = 0; k0 < L; k0 += KT) {
    if (k0 > 0) __syncthreads();  // the last tile's dQ products have read sK
    load_rows(sK, seq + D + h * DH, rs, k0, KT);
    load_rows(sV, seq + 2 * D + h * DH, rs, k0, KT);
    load_queries(0, 0);
    cp_async_commit();
    const int kw = k0 + warp * 16;  // this warp's first key
    const bool active = kw < L;     // warp-uniform
    int kok[2];                     // keys g, g + 8: 1 valid, 0 masked, -1 none
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kw + g + 8 * r;
      kok[r] = j < L ? (mrow[j] != 0) : -1;
    }
    const int nkb = (min(KT, L - k0) + 15) / 16;  // 16-key blocks holding keys
    float dv[DH / 8][4], dk[DH / 8][4];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
      for (int x = 0; x < 4; ++x) dv[dt][x] = dk[dt][x] = 0.f;

    int buf = 0;
    for (int q0 = 0; q0 < L; q0 += BQ, buf ^= 1) {
      if (q0 + BQ < L) {
        load_queries(buf ^ 1, q0 + BQ);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // rows past L: 1/l = 0, so their P is 0 and they add nothing
      for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
        const float2 s2 = q0 + r < L ? srow[q0 + r] : make_float2(0.f, 0.f);
        sM[r] = s2.x;
        sIL[r] = s2.y;
      }
      __syncthreads();  // A: the step's rows and statistics have landed
      const float* q_s = sQ + buf * BQ * LD;
      const float* do_s = sdO + buf * BQ * LD;
      const float* o_s = sO + buf * BQ * LD;
      // D_i = rowsum(dO * O) in fp32: CH consecutive lanes per row
      for (int c = threadIdx.x; c < BQ * CH; c += blockDim.x) {
        const int r = c / CH, ch = c % CH;
        const float4 u = *reinterpret_cast<const float4*>(do_s + r * LD + ch * 4);
        const float4 v = *reinterpret_cast<const float4*>(o_s + r * LD + ch * 4);
        float acc = u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
#pragma unroll
        for (int off = CH / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (ch == 0) sD[r] = acc;
      }
      __syncthreads();  // B: D_i

      if (active) {
        float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[nt][x] = dp[nt][x] = 0.f;
        key_logits_fp32<DH>(s, dp, sK + warp * 16 * LD, sV + warp * 16 * LD, q_s, do_s, lane);
        // P from the statistics; s[nt][x] is (key g + 8 (x >> 1), query
        // q0 + nt * 8 + 2t + (x & 1))
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1, ql = nt * 8 + 2 * t + (x & 1);
            const int i = q0 + ql, j = kw + g + 8 * r;
            float v = s[nt][x] * scale;
            if (kok[r] == 0 || (seqs > 1 && j / sub != i / sub)) v = MASK_FILL;
            s[nt][x] = kok[r] < 0 ? 0.f : exp2f((v - sM[ql]) * LOG2E) * sIL[ql];
          }
        }
        // keep multipliers (inv_keep or 0; 1 without dropout) into kp
        float kp[BQ / 8][4];
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) kp[nt][x] = ik;
        if (drop.on) {
#pragma unroll
          for (int qb = 0; qb < BQ / 16; ++qb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // words: (key g, query 2t+e), (g+8, 2t+e), (g, 2t+e+8), (g+8, 2t+e+8)
              const Philox4 bits = mha_block_bits((q0 >> 4) + qb, 2 * t + e, kw >> 4, g,
                                                  drop.head(h), drop.seq(n), drop.seed);
              const unsigned th = drop.thresh;
              if (bits.w[0] < th) kp[2 * qb][e] = 0.f;
              if (bits.w[1] < th) kp[2 * qb][2 + e] = 0.f;
              if (bits.w[2] < th) kp[2 * qb + 1][e] = 0.f;
              if (bits.w[3] < th) kp[2 * qb + 1][2 + e] = 0.f;
            }
          }
        }
        // s <- Pd, dp <- dS = P (keep dP / (1 - rate) - D_i) / sqrt(Dh)
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float p = s[nt][x];
            const float Di = sD[nt * 8 + 2 * t + (x & 1)];
            s[nt][x] = p * kp[nt][x];
            dp[nt][x] = p * (dp[nt][x] * kp[nt][x] - Di) * scale;
          }
        }
        key_grads_fp32<DH>(dv, dk, s, dp, q_s, do_s, sdS + warp * 16 * LDS, lane);
      }
      __syncthreads();  // C: dS^T of every warp

      // dQ of the step's rows = dS K over the tile's keys, one 16 x 16
      // block per warp at a time
      for (int blk = warp; blk < (BQ / 16) * (DH / 16); blk += nw) {
        const int qb = blk / (DH / 16), dpr = blk % (DH / 16);
        float acc[2][4] = {};
        dq_block_fp32<DH>(acc, sdS, sK, qb, dpr, nkb, lane);
#pragma unroll
        for (int dt = 0; dt < 2; ++dt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = q0 + qb * 16 + g + 8 * r;
            if (i >= L) continue;
            const int d = dpr * 16 + dt * 8 + 2 * t;
            float v0 = acc[dt][2 * r], v1 = acc[dt][2 * r + 1];
            float2* dst = reinterpret_cast<float2*>(dseq + (long)i * rs + h * DH + d);
            if (k0 > 0) {  // summed over key tiles in the output, by this lane alone
              const float2 o = *dst;
              v0 += o.x;
              v1 += o.y;
            }
            *dst = make_float2(v0, v1);
          }
        }
      }
    }

    if (active) {  // dK, dV of the warp's keys, written once
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = kw + g + 8 * r;
          if (j >= L) continue;
          float* row = dseq + (long)j * rs + h * DH + dt * 8 + 2 * t;
          *reinterpret_cast<float2*>(row + D) = make_float2(dk[dt][2 * r], dk[dt][2 * r + 1]);
          *reinterpret_cast<float2*>(row + 2 * D) =
              make_float2(dv[dt][2 * r], dv[dt][2 * r + 1]);
        }
      }
    }
  }
}

// scratch: unused (dQ sums in dqkv), taken for launch_bf16's signature
template <int DH, bool OFF>
cudaError_t launch_fp32(const void* qkv, const void* mask, const void* out,
                        const void* dout, const void* stats, void* dqkv,
                        void* scratch, int N, int L, int H, int seqs,
                        Dropout<OFF> drop, cudaStream_t stream) {
  const int nw = tc_warps(L);
  const int smem = fp32_smem_bytes<DH>(16 * nw);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_fp32<DH, OFF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out) |
                    reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  const dim3 grid(N, H);
  mha_bwd_fp32<DH, OFF><<<grid, 32 * nw, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int*>(mask),
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<const float2*>(stats), static_cast<float*>(dqkv), L, H, seqs, vec, drop);
  return cudaGetLastError();
}

template <bool BF16, bool OFF>
cudaError_t dispatch_head_dim(const void* qkv, const void* mask, const void* out,
                              const void* dout, const void* stats, void* dqkv,
                              void* scratch, int N, int L, int H, int Dh,
                              int seqs, Dropout<OFF> drop, cudaStream_t stream) {
  switch (Dh) {
#define MHA_CASE(DH)                                                                  \
  case DH:                                                                            \
    return BF16 ? launch_bf16<DH>(qkv, mask, out, dout, stats, dqkv, scratch, N, L,   \
                                  H, seqs, drop, stream)                              \
                : launch_fp32<DH>(qkv, mask, out, dout, stats, dqkv, scratch, N, L,   \
                                  H, seqs, drop, stream);
    MHA_CASE(16)
    MHA_CASE(32)
    MHA_CASE(64)
#undef MHA_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <bool OFF>
int dispatch_type(const void* qkv, const void* mask, const void* out, const void* dout,
                  const void* stats, void* dqkv, void* scratch, int N, int L, int H, int Dh,
                  int seqs, Dropout<OFF> drop, int dtype, cudaStream_t s) {
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_head_dim<false>(qkv, mask, out, dout, stats, dqkv, scratch, N, L,
                                      H, Dh, seqs, drop, s);
    case DTYPE_BF16:
      return dispatch_head_dim<true>(qkv, mask, out, dout, stats, dqkv, scratch, N, L,
                                     H, Dh, seqs, drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32 scratch the wrapper allocates for mha_bwd, in floats (0: none): in
// bfloat16, the (N, H, L, Dh) dQ sums when L spans more than one key tile
// (L > 128); float32 sums them in its output and takes none.
extern "C" long long mha_bwd_scratch_floats(int N, int L, int H, int Dh, int dtype) {
  if (dtype != DTYPE_BF16 || L <= 16 * tc_warps(L)) return 0;
  return (long long)N * L * H * Dh;
}

// qkv, dqkv (N, L, 3*H*Dh), out, dout (N, L, H*Dh) of one dtype, mask (N, L)
// int32, stats (N, H, L) float2 from mha_fwd, all contiguous, dqkv
// 16-byte aligned (bf16: all of them); scratch as mha_bwd_scratch_floats
// says. The dropout arguments, offsets included, must be those of the
// forward call.
extern "C" int mha_bwd(const void* qkv, const void* mask, const void* out,
                       const void* dout, const void* stats, void* dqkv,
                       void* scratch, int N, int L, int H, int Dh, int seqs,
                       unsigned long long seed, unsigned int thresh,
                       float inv_keep, int dropping, int seq_offset, int head_offset,
                       int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || L <= 0 || H <= 0 || H > 65535 || seqs <= 0 || L % seqs != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dropping && (seq_offset || head_offset))
    return dispatch_type(qkv, mask, out, dout, stats, dqkv, scratch, N, L, H, Dh, seqs,
                         Dropout<true>{seed, thresh, inv_keep, 1, seq_offset, head_offset},
                         dtype, s);
  return dispatch_type(qkv, mask, out, dout, stats, dqkv, scratch, N, L, H, Dh, seqs,
                       Dropout<false>{seed, thresh, inv_keep, dropping != 0, 0, 0}, dtype, s);
}
