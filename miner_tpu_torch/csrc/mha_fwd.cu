// Fused multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/mha.py:_fwd_kernel (pallas_call at
// mha.py:208, reached through fused_mha). Per (sequence n, head h):
//   P = softmax_j(q_i . k_j / sqrt(Dh), masked keys -> -1e9)
//   out[n, i, h] = sum_j dropout(P)_ij v_j
// read straight from the fused (N, L, 3D) QKV projection by stride, with an
// optional block-diagonal band (seqs > 1: query i and key j attend only when
// i / (L/seqs) == j / (L/seqs)). Dropout on P keeps element (n, h, i, j) iff
// its Philox4x32-10 bits (csrc/philox.cuh: counter (j', i', h, n), word
// 2 * bit3(i) + bit3(j)) are >= thresh, and scales it by 1/(1-rate): the TPU
// kernel's rule with a counter-based generator instead of the TPU's, so the
// backward kernel and the plain version (ops/mha.py) regenerate the mask.
// Masked keys get the finite fill -1e9, as the TPU kernel does: a row whose
// keys are all masked comes out as the mean of V, not NaN. The normaliser l
// sums the undropped fp32 probabilities; dropout applies to what enters PV.
//
// When a backward follows, the kernel also writes each row's softmax
// statistics (row max m and 1/l, as float2 into an (N, H, L) buffer) so the
// backward rebuilds P without a second pass over the keys. Two values, not
// one log-sum-exp: with the finite -1e9 fill, a fully masked row has
// m = -1e9 and in fp32 m + log(l) rounds back to -1e9.
//
// What bounds it: at the sapo training shape (N = 880, L = 128, 12 heads of
// Dh = 64) the kernel does 4 N H L^2 Dh = 44.3 GFLOP and must move 692 MB
// (qkv read, out written), 64 FLOP per byte: far under the card's bf16
// ridge of ~295, so the bound is the bytes (0.21 ms at 3.35 TB/s; 0.22 ms
// with the 10.8 MB of statistics). With dropout, Philox's integer work
// (N H L^2 / 4 = 43 M calls of 10 rounds) is the next largest cost.
//
// bf16 design, on the tensor cores. One block per (sequence, head), K and V
// read from device memory once: 8 warps, each owning 16 query rows as one
// mma row tile, so 128 query rows per pass (longer sequences take further
// passes of 128). Keys go through shared memory in tiles of 64, two stages
// deep, by 16-byte cp.async; rows are padded by 8 bf16 so ldmatrix reads
// them without bank conflicts. When L <= 64 a block takes several heads of
// one sequence (L = 32: 4 heads, 2 warps each) with all their keys in one
// tile, so no block is two warps. Per warp and key tile:
//   S = Q K^T: mma.sync m16n8k16 bf16 -> fp32, Q fragments loaded once per
//     pass with ldmatrix and held in registers, K fragments by ldmatrix;
//   masks and the online softmax (running max, rescale) in fp32 registers;
//   dropout: one Philox call per lane gives the lane's four values of a
//     16 x 16 block, (rows g, g+8) x (keys 2t+e, 2t+e+8);
//   O += P V: P rounded to bf16 in registers (as the TPU kernel rounds it,
//     mha.py:110) and reused as the A fragment (C -> A identity), V through
//     ldmatrix.trans. The plain version keeps fp32 P; the bf16 tolerance
//     (2^-6 of the output's scale) covers the rounding.
// The epilogue writes stats and stages out through the warp's own Q rows in
// shared memory for 16-byte coalesced stores.
//
// fp32 stays on the CUDA cores (one thread per query row, the design of the
// first port): on the tensor cores fp32 operands would run as TF32, whose
// 10-bit mantissa fails the 1e-4 fp32 tolerance and the card-vs-CPU parity
// phases. Each type has exactly one kernel. A thread that owns one query
// row uses two of a Philox call's four words (keys j and j + 8), so the
// fp32 kernel makes N H L^2 / 2 calls, twice the bf16 kernel's.
#include "common.cuh"
#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Dropout {
  unsigned long long seed;
  unsigned int thresh;
  float inv_keep;
  int on;
};

// ---------------------------------------------------------------- float32
constexpr int MAX_BQ = 64;  // query rows (threads) per block
constexpr int BK = 32;      // keys per shared-memory tile

template <int DH>
__global__ void __launch_bounds__(MAX_BQ)
mha_fwd_fp32(const float* __restrict__ qkv, const int* __restrict__ mask,
             float* __restrict__ out, float2* __restrict__ stats, int L, int H,
             int seqs, Dropout drop) {
  const int n = blockIdx.x, h = blockIdx.y;
  const int bq = blockDim.x;
  const int q0 = blockIdx.z * bq;
  const int tid = threadIdx.x;
  const int D = H * DH;
  const long row_stride = 3L * D;
  const float* base = qkv + (long)n * L * row_stride + h * DH;
  const int* row_mask = mask + (long)n * L;
  const int sub = L / seqs;

  __shared__ __align__(16) float sK[BK][DH];
  __shared__ __align__(16) float sV[BK][DH];
  __shared__ float sQO[MAX_BQ][DH + 1];  // padded: each thread reads its own row

  for (int idx = tid; idx < bq * DH; idx += bq) {
    const int r = idx / DH, d = idx % DH, i = q0 + r;
    sQO[r][d] = i < L ? base[(long)i * row_stride + d] : 0.f;
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
        const float* row = base + (long)j * row_stride + d;
        kv = row[D];
        vv = row[2 * D];
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
    // Keys in order; key r (bit 3 clear) draws its Philox call and keeps
    // key r + 8's word for later. (Taking keys r and r + 8 together, as the
    // backward does, ran slower here on the card.)
    uint32_t upper[8];
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      if (r < nk) {
        const float p = expf(s[r] - m_new);
        l += p;
        float pv = p;
        if (drop.on) {
          uint32_t word;  // key r's dropout bits
          if ((r & 8) == 0) {
            const uint2 pair = mha_row_pair_bits(i, (k0 + r) >> 4, r & 7, h, n, drop.seed);
            word = pair.x;
            upper[r & 7] = pair.y;
          } else {
            word = upper[r & 7];
          }
          pv = word >= drop.thresh ? p * drop.inv_keep : 0.f;
        }
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
  float* obase = out + (long)n * L * D + h * DH;
  for (int idx = tid; idx < bq * DH; idx += bq) {
    const int r = idx / DH, d = idx % DH, ii = q0 + r;
    if (ii < L) obase[(long)ii * D + d] = sQO[r][d];
  }
}

template <int DH>
cudaError_t launch_fp32(const void* qkv, const void* mask, void* out, void* stats,
                        int N, int L, int H, int seqs, Dropout drop,
                        cudaStream_t stream) {
  const int bq = L <= 32 ? 32 : MAX_BQ;
  const dim3 grid(N, H, (L + bq - 1) / bq);
  mha_fwd_fp32<DH><<<grid, bq, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int*>(mask),
      static_cast<float*>(out), static_cast<float2*>(stats), L, H, seqs, drop);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bfloat16
typedef __nv_bfloat16 bf16;

constexpr int TC_WARPS = 8;
constexpr int TC_ROWS = 16 * TC_WARPS;  // query rows of a pass; key rows staged
constexpr int TC_BK = 64;               // keys per tile

template <int DH>
constexpr int tc_smem_bytes() {
  // Q, K (2 stages), V (2 stages) of TC_ROWS padded rows, key flags
  return 3 * TC_ROWS * (DH + 8) * 2 + TC_ROWS * 4;
}

template <int DH>
struct RowState {
  float o[DH / 8][4];  // C fragments of the warp's 16 x DH output
  float m[2], l[2];    // rows g and g + 8; l is this lane's partial sum
};

// One key tile of (up to) 64 keys for the warp's 16 query rows. key_ok[j]:
// 1 valid, 0 masked (-1e9), -1 past L (no key). k0: the tile's first key;
// nblk: its 16-key blocks that hold keys; qt0: the warp's first query row
// (k0 and qt0 are multiples of 16, which the dropout layout needs).
template <int DH>
__device__ __forceinline__ void attend_tile(RowState<DH>& st,
                                            const uint32_t (&qf)[DH / 16][4],
                                            const bf16* sKt, const bf16* sVt,
                                            const int* key_ok, int k0, int nblk,
                                            int qt0, int sub, int seqs, int h, int n,
                                            float scale, const Dropout& drop, int lane) {
  constexpr int LD = DH + 8;
  const int g = lane >> 2, t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
    for (int x = 0; x < 4; ++x) s[2 * kb][x] = s[2 * kb + 1][x] = 0.f;
    if (kb < nblk) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t b[4];  // keys kb*16.. as B = K^T: two n8 tiles
        ldsm_x4(b, sKt + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * kb], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * kb + 1], qf[kc], b[2], b[3]);
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int jl = nt * 8 + 2 * t + (x & 1);
      const int i = qt0 + g + (x >> 1) * 8;
      const int ok = nt / 2 < nblk ? key_ok[jl] : -1;
      float v = s[nt][x] * scale;
      if (ok == 0 || (seqs > 1 && (k0 + jl) / sub != i / sub)) v = MASK_FILL;
      if (ok < 0) v = -INFINITY;  // no key: weight exactly 0
      s[nt][x] = v;
      mx[x >> 1] = fmaxf(mx[x >> 1], v);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile holds a key, so m_new is finite; first tile: exp2(-inf) = 0
    const float m_new = fmaxf(st.m[r], mx[r]);
    const float alpha = exp2f((st.m[r] - m_new) * LOG2E);
    st.m[r] = m_new;
    st.l[r] *= alpha;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      st.o[dt][2 * r] *= alpha;
      st.o[dt][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p = exp2f((s[nt][x] - st.m[x >> 1]) * LOG2E);
      st.l[x >> 1] += p;
      s[nt][x] = p;
    }
  }
  if (drop.on) {
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      if (kb < nblk) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // words: (g, 2t+e), (g, 2t+e+8), (g+8, 2t+e), (g+8, 2t+e+8)
          const Philox4 bits =
              mha_block_bits(qt0 >> 4, g, (k0 >> 4) + kb, 2 * t + e, h, n, drop.seed);
          const float ik = drop.inv_keep;
          const unsigned th = drop.thresh;
          s[2 * kb][e] = bits.w[0] >= th ? s[2 * kb][e] * ik : 0.f;
          s[2 * kb + 1][e] = bits.w[1] >= th ? s[2 * kb + 1][e] * ik : 0.f;
          s[2 * kb][2 + e] = bits.w[2] >= th ? s[2 * kb][2 + e] * ik : 0.f;
          s[2 * kb + 1][2 + e] = bits.w[3] >= th ? s[2 * kb + 1][2 + e] * ik : 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    if (kb < nblk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                             pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                             pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                             pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t b[4];  // V rows kb*16.., columns dp*16..: two n8 tiles
        ldsm_x4_t(b, sVt + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                         (lane >> 4) * 8);
        mma_bf16(st.o[2 * dp], a, b[0], b[1]);
        mma_bf16(st.o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// Normalise, write stats, and store the warp's 16 rows through its own Q
// rows of shared memory (sQw) with 16-byte stores.
template <int DH>
__device__ __forceinline__ void finish_rows(RowState<DH>& st, bf16* sQw, bf16* out,
                                            float2* stats, int n, int h, int H, int L,
                                            int qt0, int lane) {
  constexpr int LD = DH + 8, CH = DH / 8;
  const int g = lane >> 2, t = lane & 3;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;  // l >= 1: the row's max contributes exp(0)
    const int i = qt0 + g + 8 * r;
    if (stats != nullptr && t == 0 && i < L)
      stats[((long)n * H + h) * L + i] = make_float2(st.m[r], inv[r]);
  }
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(sQw + (g + 8 * r) * LD + dt * 8 + 2 * t) =
          pack_bf16(st.o[dt][2 * r] * inv[r], st.o[dt][2 * r + 1] * inv[r]);
  __syncwarp();
  const long D = (long)H * DH;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, i = qt0 + r;
    if (i < L)
      *reinterpret_cast<uint4*>(out + ((long)n * L + i) * D + h * DH + ch * 8) =
          *reinterpret_cast<const uint4*>(sQw + r * LD + ch * 8);
  }
}

template <int DH>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[DH / 16][4],
                                                 const bf16* sQw, int lane) {
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldsm_x4(qf[kc], sQw + (lane & 15) * (DH + 8) + kc * 16 + (lane >> 4) * 8);
}

template <int DH>
__device__ __forceinline__ void init_rows(RowState<DH>& st) {
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int x = 0; x < 4; ++x) st.o[dt][x] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// grid (N, ceil(H / hpb)); blockDim 32 * warps. L <= 64: hpb heads per
// block, ceil(L/16) warps each, one key tile. L > 64: hpb = 1, 8 warps.
template <int DH>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
mha_fwd_bf16(const bf16* __restrict__ qkv, const int* __restrict__ mask,
             bf16* __restrict__ out, float2* __restrict__ stats, int L, int H,
             int seqs, int hpb, Dropout drop) {
  constexpr int LD = DH + 8, CH = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TC_ROWS * LD;
  bf16* sV = sK + TC_ROWS * LD;
  int* sKey = reinterpret_cast<int*>(sV + TC_ROWS * LD);

  const int n = blockIdx.x, h0 = blockIdx.y * hpb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = H * DH;
  const long rs = 3L * D;
  const bf16* seq = qkv + (long)n * L * rs;
  const int* mrow = mask + (long)n * L;
  const int sub = L / seqs;
  const float scale = 1.0f / sqrtf((float)DH);
  const bool multi = L <= TC_BK;
  const int Lp = (L + 15) & ~15;
  const int tph = multi ? Lp / 16 : TC_WARPS;  // warps per head
  const int h = h0 + warp / tph;
  bf16* sQw = sQ + warp * 16 * LD;

  // rows r0.. of one column block (col: element offset in a qkv row), rows
  // past L zero-filled
  auto load_rows = [&](bf16* dst, int col, int r0, int rows) {
    for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
      const int r = c / CH, ch = c % CH, j = r0 + r;
      cp_async16(dst + r * LD + ch * 8, seq + (long)min(j, L - 1) * rs + col + ch * 8,
                 j < L ? 16 : 0);
    }
  };
  auto load_keys = [&](int* dst, int r0, int rows) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int j = r0 + r;
      dst[r] = j < L ? (mrow[j] != 0) : -1;
    }
  };

  RowState<DH> st;
  uint32_t qf[DH / 16][4];

  if (multi) {
    for (int s = 0; s < hpb; ++s) {
      const int hh = h0 + s;
      if (hh >= H) break;
      load_rows(sQ + s * Lp * LD, hh * DH, 0, Lp);
      load_rows(sK + s * Lp * LD, D + hh * DH, 0, Lp);
      load_rows(sV + s * Lp * LD, 2 * D + hh * DH, 0, Lp);
    }
    cp_async_commit();
    load_keys(sKey, 0, Lp);
    cp_async_wait<0>();
    __syncthreads();
    if (h < H) {  // warp-uniform: the last block may hold fewer heads
      const int slot = warp / tph, qt0 = (warp % tph) * 16;
      init_rows(st);
      load_q_fragments<DH>(qf, sQw, lane);
      attend_tile(st, qf, sK + slot * Lp * LD, sV + slot * Lp * LD, sKey, 0, Lp / 16,
                  qt0, sub, seqs, h, n, scale, drop, lane);
      finish_rows(st, sQw, out, stats, n, h, H, L, qt0, lane);
    }
    return;
  }

  for (int q0 = 0; q0 < L; q0 += TC_ROWS) {
    if (q0 > 0) __syncthreads();  // every warp has stored its rows from sQ
    load_rows(sQ, h * DH, q0, TC_ROWS);
    load_rows(sK, D + h * DH, 0, TC_BK);
    load_rows(sV, 2 * D + h * DH, 0, TC_BK);
    cp_async_commit();
    load_keys(sKey, 0, TC_BK);
    const int qt0 = q0 + warp * 16;
    const bool active = qt0 < L;  // warp-uniform
    init_rows(st);
    int stage = 0;
    for (int k0 = 0; k0 < L; k0 += TC_BK, stage ^= 1) {
      if (k0 + TC_BK < L) {  // prefetch the next tile into the other stage
        const int nxt = (stage ^ 1) * TC_BK;
        load_rows(sK + nxt * LD, D + h * DH, k0 + TC_BK, TC_BK);
        load_rows(sV + nxt * LD, 2 * D + h * DH, k0 + TC_BK, TC_BK);
        cp_async_commit();
        load_keys(sKey + nxt, k0 + TC_BK, TC_BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this tile (and, first, Q) has landed
      if (active) {
        if (k0 == 0) load_q_fragments<DH>(qf, sQw, lane);
        attend_tile(st, qf, sK + stage * TC_BK * LD, sV + stage * TC_BK * LD,
                    sKey + stage * TC_BK, k0, (min(TC_BK, L - k0) + 15) / 16, qt0, sub,
                    seqs, h, n, scale, drop, lane);
      }
      __syncthreads();  // the stage is consumed before it is refilled
    }
    if (active) finish_rows(st, sQw, out, stats, n, h, H, L, qt0, lane);
  }
}

template <int DH>
cudaError_t launch_bf16(const void* qkv, const void* mask, void* out, void* stats,
                        int N, int L, int H, int seqs, Dropout drop,
                        cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int hpb = 1, warps = TC_WARPS;
  if (L <= TC_BK) {
    const int tph = (L + 15) / 16;
    hpb = H < TC_WARPS / tph ? H : TC_WARPS / tph;  // min(H, 8 / tph) >= 1
    warps = hpb * tph;
  }
  const dim3 grid(N, (H + hpb - 1) / hpb);
  mha_fwd_bf16<DH><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(mask),
      static_cast<bf16*>(out), static_cast<float2*>(stats), L, H, seqs, hpb, drop);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_head_dim(const void* qkv, const void* mask, void* out,
                              void* stats, int N, int L, int H, int Dh,
                              int seqs, Dropout drop, cudaStream_t stream) {
  switch (Dh) {
#define MHA_CASE(DH)                                                                   \
  case DH:                                                                             \
    return BF16 ? launch_bf16<DH>(qkv, mask, out, stats, N, L, H, seqs, drop, stream)  \
                : launch_fp32<DH>(qkv, mask, out, stats, N, L, H, seqs, drop, stream);
    MHA_CASE(16)
    MHA_CASE(32)
    MHA_CASE(64)
#undef MHA_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (N, L, 3*H*Dh) and out (N, L, H*Dh) of one dtype, mask (N, L) int32,
// all contiguous (bf16: 16-byte aligned); Dh in {16, 32, 64}; L % seqs == 0.
// stats: (N, H, L) float2 (row max, 1/row sum) or null. Dropout is on when
// `dropping` is non-zero: keep iff bits >= thresh, kept values scaled by
// inv_keep.
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
      return dispatch_head_dim<false>(qkv, mask, out, stats, N, L, H, Dh, seqs, drop, s);
    case DTYPE_BF16:
      return dispatch_head_dim<true>(qkv, mask, out, stats, N, L, H, Dh, seqs, drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}
