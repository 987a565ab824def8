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
// with the 10.8 MB of statistics). In fp32 the bytes double (1.395 GB,
// 0.42 ms) and the products run as three TF32 passes: 44.3 GFLOP at 495 / 3
// = 165 TFLOP/s is 0.27 ms, so the bytes still bound it. With dropout,
// Philox's integer work (N H L^2 / 4 = 43 M calls of 10 rounds) is the next
// largest cost.
//
// Design, on the tensor cores, one kernel for both types. One block per
// (sequence, head), K and V read from device memory once: 8 warps, each
// owning 16 query rows as one mma row tile, so 128 query rows per pass
// (longer sequences take further passes of 128). Keys go through shared
// memory in tiles of 64, two stages deep, by 16-byte cp.async; rows are
// padded by 16 bytes so the fragment reads fall on distinct banks. When
// L <= 64 a block takes several heads of one sequence (L = 32: 4 heads, 2
// warps each) with all their keys in one tile, so no block is two warps.
// Per warp and key tile:
//   S = Q K^T on the tensor cores, fp32 accumulators;
//   masks and the online softmax (running max, rescale) in fp32 registers;
//   dropout: one Philox call per lane gives the lane's four values of a
//     16 x 16 block, (rows g, g+8) x (keys 2t+e, 2t+e+8);
//   O += P V on the tensor cores, P taken from S's registers.
// bf16: mma.sync m16n8k16, Q fragments loaded once per pass with ldmatrix
// and held in registers, K by ldmatrix, V by ldmatrix.trans; P rounded to
// bf16 (as the TPU kernel rounds it, mha.py:110) and reused as the A
// fragment (C -> A identity). The plain version keeps fp32 P; the bf16
// tolerance (2^-6 of the output's scale) covers the rounding.
// fp32: mma.sync m16n8k8 in split TF32 (tensor_core.cuh: three TF32
// passes, ~2^-21 of each product, against TF32's 2^-11 that alone fails the
// 1e-4 fp32 tolerance), fragments read from shared memory by 32-bit loads
// and split in registers, a tile attended 16 keys at a time (S in 24
// registers fewer, so two blocks fit an SM with no spill); P stays fp32
// and enters PV as the A fragment with its 8 keys read in the order (2t,
// 2t+1) (tensor_core.cuh), V's rows likewise. A qkv view off a 16-byte
// boundary (fp32 only; the wrapper refuses it in bf16) is copied by 4-byte
// cp.async, chosen at launch.
// The epilogue writes stats and stages out through the warp's own Q rows
// in shared memory for 16-byte coalesced stores.
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

typedef __nv_bfloat16 bf16;

constexpr int TC_WARPS = 8;
constexpr int TC_ROWS = 16 * TC_WARPS;  // query rows of a pass; key rows staged
constexpr int TC_BK = 64;               // keys per tile

// row pitch in elements: rows padded by 16 bytes (ldmatrix's conflict-free
// pitch in bf16; in fp32 the fragment reads' distinct banks)
template <typename T, int DH>
__host__ __device__ constexpr int row_pitch() {
  return DH + 16 / (int)sizeof(T);
}

// keys a warp attends at a time: a 64-key tile in bf16; in fp32 one 16-key
// block, so that S takes 24 registers fewer and the split-TF32 fragments fit
// 128 registers, two blocks per SM, with no spill (at 32 keys the Dh = 64
// build spilled 20 bytes; 16 cost 1.5% at the sapo shape on the card)
template <typename T>
__host__ __device__ constexpr int attend_keys() {
  return sizeof(T) == 2 ? 64 : 16;
}

template <typename T, int DH>
constexpr int tc_smem_bytes() {
  // Q, K (2 stages), V (2 stages) of TC_ROWS padded rows, key flags
  return 3 * TC_ROWS * row_pitch<T, DH>() * (int)sizeof(T) + TC_ROWS * 4;
}

template <int DH>
struct RowState {
  float o[DH / 8][4];  // C fragments of the warp's 16 x DH output
  float m[2], l[2];    // rows g and g + 8; l is this lane's partial sum
};

// The warp's Q operand over a pass. bf16: fragments loaded once by
// ldmatrix and held in registers; fp32: the warp's 16 rows in shared
// memory, read and split at each tile (holding them split would take 2 DH
// registers).
template <typename T, int DH>
struct QOperand;

template <int DH>
struct QOperand<bf16, DH> {
  uint32_t f[DH / 16][4];
  __device__ __forceinline__ void load(const bf16* sQw, int lane) {
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc)
      ldsm_x4(f[kc], sQw + (lane & 15) * (DH + 8) + kc * 16 + (lane >> 4) * 8);
  }
};

template <int DH>
struct QOperand<float, DH> {
  const float* rows;
  __device__ __forceinline__ void load(const float* sQw, int) { rows = sQw; }
};

// s = Q K^T over the chunk's 16-key blocks kb < nblk (others left 0)
template <int DH, int KB>
__device__ __forceinline__ void tile_logits(float (&s)[KB / 8][4],
                                            const QOperand<bf16, DH>& q, const bf16* sKt,
                                            int nblk, int lane) {
  constexpr int LD = row_pitch<bf16, DH>();
#pragma unroll
  for (int kb = 0; kb < KB / 16; ++kb) {
#pragma unroll
    for (int x = 0; x < 4; ++x) s[2 * kb][x] = s[2 * kb + 1][x] = 0.f;
    if (kb < nblk) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        uint32_t b[4];  // keys kb*16.. as B = K^T: two n8 tiles
        ldsm_x4(b, sKt + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * kb], q.f[kc], b[0], b[1]);
        mma_bf16(s[2 * kb + 1], q.f[kc], b[2], b[3]);
      }
    }
  }
}

template <int DH, int KB>
__device__ __forceinline__ void tile_logits(float (&s)[KB / 8][4],
                                            const QOperand<float, DH>& q, const float* sKt,
                                            int nblk, int lane) {
  constexpr int LD = row_pitch<float, DH>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[nt][x] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DH / 8; ++kc) {
    const float* qr = q.rows + g * LD + kc * 8 + t;
    const FragA a = split_a(qr[0], qr[8 * LD], qr[4], qr[8 * LD + 4]);
#pragma unroll
    for (int nt = 0; nt < KB / 8; ++nt) {
      if (nt / 2 < nblk) {  // B = K^T: b0 (d t, key g), b1 (d t+4, key g)
        const float* kr = sKt + (nt * 8 + g) * LD + kc * 8 + t;
        mma_3xtf32(s[nt], a, kr[0], kr[4]);
      }
    }
  }
}

// o += P V over the chunk's 16-key blocks kb < nblk; s holds P (C layout)
template <int DH, int KB>
__device__ __forceinline__ void tile_values(float (&o)[DH / 8][4], const float (&s)[KB / 8][4],
                                            const bf16* sVt, int nblk, int lane) {
  constexpr int LD = row_pitch<bf16, DH>();
#pragma unroll
  for (int kb = 0; kb < KB / 16; ++kb) {
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
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int DH, int KB>
__device__ __forceinline__ void tile_values(float (&o)[DH / 8][4], const float (&s)[KB / 8][4],
                                            const float* sVt, int nblk, int lane) {
  constexpr int LD = row_pitch<float, DH>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt) {
    if (nt / 2 < nblk) {  // the 8 keys of n8 tile nt, read as (2t, 2t+1)
      const FragA a = split_c_as_a(s[nt]);
      const float* vr = sVt + (nt * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) mma_3xtf32(o[dt], a, vr[dt * 8], vr[LD + dt * 8]);
    }
  }
}

// One chunk of (up to) attend_keys<T>() keys for the warp's 16 query rows,
// holding at least one key. key_ok[j]: 1 valid, 0 masked (-1e9), -1 past L
// (no key). k0: the chunk's first key; nblk: its 16-key blocks that hold
// keys; qt0: the warp's first query row (k0 and qt0 are multiples of 16,
// which the dropout layout needs).
template <typename T, int DH, bool OFF>
__device__ __forceinline__ void attend_tile(RowState<DH>& st, const QOperand<T, DH>& q,
                                            const T* sKt, const T* sVt,
                                            const int* key_ok, int k0, int nblk,
                                            int qt0, int sub, int seqs, int h, int n,
                                            float scale, const Dropout<OFF>& drop, int lane) {
  constexpr int KB = attend_keys<T>();
  const int g = lane >> 2, t = lane & 3;
  float s[KB / 8][4];
  tile_logits<DH, KB>(s, q, sKt, nblk, lane);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < KB / 8; ++nt) {
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
    // every chunk holds a key, so m_new is finite; first: exp2(-inf) = 0
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
  for (int nt = 0; nt < KB / 8; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p = exp2f((s[nt][x] - st.m[x >> 1]) * LOG2E);
      st.l[x >> 1] += p;
      s[nt][x] = p;
    }
  }
  if (drop.on) {
#pragma unroll
    for (int kb = 0; kb < KB / 16; ++kb) {
      if (kb < nblk) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // words: (g, 2t+e), (g, 2t+e+8), (g+8, 2t+e), (g+8, 2t+e+8)
          const Philox4 bits =
              mha_block_bits(qt0 >> 4, g, (k0 >> 4) + kb, 2 * t + e,
                             drop.head(h), drop.seq(n), drop.seed);
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
  tile_values<DH, KB>(st.o, s, sVt, nblk, lane);
}

// The tile's first nkeys keys (k0 the first), in chunks of attend_keys<T>():
// one attend_tile in bf16, whose chunk is the tile; a loop in fp32 (a loop
// in bf16 too cost its L <= 64 path 8% on the card).
template <typename T, int DH, bool OFF>
__device__ __forceinline__ void attend(RowState<DH>& st, const QOperand<T, DH>& q,
                                       const T* sKt, const T* sVt, const int* key_ok, int k0,
                                       int nkeys, int qt0, int sub, int seqs, int h, int n,
                                       float scale, const Dropout<OFF>& drop, int lane) {
  constexpr int KB = attend_keys<T>(), LD = row_pitch<T, DH>();
  if constexpr (KB == TC_BK) {
    attend_tile(st, q, sKt, sVt, key_ok, k0, (nkeys + 15) / 16, qt0, sub, seqs, h, n, scale,
                drop, lane);
  } else {
    for (int c0 = 0; c0 < nkeys; c0 += KB)
      attend_tile(st, q, sKt + c0 * LD, sVt + c0 * LD, key_ok + c0, k0 + c0,
                  (min(KB, nkeys - c0) + 15) / 16, qt0, sub, seqs, h, n, scale, drop, lane);
  }
}

// two output values of a row, adjacent columns, into shared memory as T
__device__ __forceinline__ void put_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void put_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Normalise, write stats, and store the warp's 16 rows through its own Q
// rows of shared memory (sQw) with 16-byte stores.
template <typename T, int DH>
__device__ __forceinline__ void finish_rows(RowState<DH>& st, T* sQw, T* out,
                                            float2* stats, int n, int h, int H, int L,
                                            int qt0, int lane) {
  constexpr int LD = row_pitch<T, DH>(), VEC = 16 / (int)sizeof(T), CH = DH / VEC;
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
      put_pair(sQw + (g + 8 * r) * LD + dt * 8 + 2 * t, st.o[dt][2 * r] * inv[r],
               st.o[dt][2 * r + 1] * inv[r]);
  __syncwarp();
  const long D = (long)H * DH;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH, i = qt0 + r;
    if (i < L)
      *reinterpret_cast<uint4*>(out + ((long)n * L + i) * D + h * DH + ch * VEC) =
          *reinterpret_cast<const uint4*>(sQw + r * LD + ch * VEC);
  }
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

// The kernel body of both types. grid (N, ceil(H / hpb)); blockDim 32 *
// warps. L <= 64: hpb heads per block, ceil(L/16) warps each, one key tile.
// L > 64: hpb = 1, 8 warps. vec: qkv is 16-byte aligned (always, in bf16).
template <typename T, int DH, bool OFF>
__device__ __forceinline__ void mha_fwd_body(const T* __restrict__ qkv,
                                             const int* __restrict__ mask, T* __restrict__ out,
                                             float2* __restrict__ stats, int L, int H,
                                             int seqs, int hpb, int vec, Dropout<OFF> drop) {
  constexpr int LD = row_pitch<T, DH>(), VEC = 16 / (int)sizeof(T), CH = DH / VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + TC_ROWS * LD;
  T* sV = sK + TC_ROWS * LD;
  int* sKey = reinterpret_cast<int*>(sV + TC_ROWS * LD);

  const int n = blockIdx.x, h0 = blockIdx.y * hpb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = H * DH;
  const long rs = 3L * D;
  const T* seq = qkv + (long)n * L * rs;
  const int* mrow = mask + (long)n * L;
  const int sub = L / seqs;
  const float scale = 1.0f / sqrtf((float)DH);
  const bool multi = L <= TC_BK;
  const int Lp = (L + 15) & ~15;
  const int tph = multi ? Lp / 16 : TC_WARPS;  // warps per head
  const int h = h0 + warp / tph;
  T* sQw = sQ + warp * 16 * LD;

  // rows r0.. of one column block (col: element offset in a qkv row), rows
  // past L zero-filled
  auto load_rows = [&](T* dst, int col, int r0, int rows) {
    if (sizeof(T) == 4 && !vec) {  // fp32 off a 16-byte boundary: 4-byte copies
      for (int c = threadIdx.x; c < rows * DH; c += blockDim.x) {
        const int r = c / DH, d = c % DH, j = r0 + r;
        cp_async4(dst + r * LD + d, seq + (long)min(j, L - 1) * rs + col + d, j < L ? 4 : 0);
      }
      return;
    }
    for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
      const int r = c / CH, ch = c % CH, j = r0 + r;
      cp_async16(dst + r * LD + ch * VEC, seq + (long)min(j, L - 1) * rs + col + ch * VEC,
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
  QOperand<T, DH> q;

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
      q.load(sQw, lane);
      attend(st, q, sK + slot * Lp * LD, sV + slot * Lp * LD, sKey, 0, Lp, qt0, sub, seqs,
             h, n, scale, drop, lane);
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
        if (k0 == 0) q.load(sQw, lane);
        attend(st, q, sK + stage * TC_BK * LD, sV + stage * TC_BK * LD,
               sKey + stage * TC_BK, k0, min(TC_BK, L - k0), qt0, sub, seqs, h, n, scale,
               drop, lane);
      }
      __syncthreads();  // the stage is consumed before it is refilled
    }
    if (active) finish_rows(st, sQw, out, stats, n, h, H, L, qt0, lane);
  }
}

// One entry point per type, so that each keeps its name in traces and in
// the ptxas report, and its own register cap: 128 a thread, two blocks of
// 8 warps per SM.
template <int DH, bool OFF>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
mha_fwd_bf16(const bf16* __restrict__ qkv, const int* __restrict__ mask,
             bf16* __restrict__ out, float2* __restrict__ stats, int L, int H, int seqs,
             int hpb, int vec, Dropout<OFF> drop) {
  mha_fwd_body<bf16, DH>(qkv, mask, out, stats, L, H, seqs, hpb, vec, drop);
}

template <int DH, bool OFF>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
mha_fwd_fp32(const float* __restrict__ qkv, const int* __restrict__ mask,
             float* __restrict__ out, float2* __restrict__ stats, int L, int H, int seqs,
             int hpb, int vec, Dropout<OFF> drop) {
  mha_fwd_body<float, DH>(qkv, mask, out, stats, L, H, seqs, hpb, vec, drop);
}

template <typename T, int DH, bool OFF>
cudaError_t launch(const void* qkv, const void* mask, void* out, void* stats, int N,
                   int L, int H, int seqs, Dropout<OFF> drop, cudaStream_t stream) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int smem = tc_smem_bytes<T, DH>();
  const auto kernel = BF16 ? (void*)mha_fwd_bf16<DH, OFF> : (void*)mha_fwd_fp32<DH, OFF>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int hpb = 1, warps = TC_WARPS;
  if (L <= TC_BK) {
    const int tph = (L + 15) / 16;
    hpb = H < TC_WARPS / tph ? H : TC_WARPS / tph;  // min(H, 8 / tph) >= 1
    warps = hpb * tph;
  }
  const int vec = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  const dim3 grid(N, (H + hpb - 1) / hpb);
  if (BF16)
    mha_fwd_bf16<DH, OFF><<<grid, 32 * warps, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const int*>(mask),
        static_cast<bf16*>(out), static_cast<float2*>(stats), L, H, seqs, hpb, vec, drop);
  else
    mha_fwd_fp32<DH, OFF><<<grid, 32 * warps, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<const int*>(mask),
        static_cast<float*>(out), static_cast<float2*>(stats), L, H, seqs, hpb, vec, drop);
  return cudaGetLastError();
}

template <typename T, bool OFF>
cudaError_t dispatch_head_dim(const void* qkv, const void* mask, void* out,
                              void* stats, int N, int L, int H, int Dh,
                              int seqs, Dropout<OFF> drop, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(qkv, mask, out, stats, N, L, H, seqs, drop, stream);
    case 32: return launch<T, 32>(qkv, mask, out, stats, N, L, H, seqs, drop, stream);
    case 64: return launch<T, 64>(qkv, mask, out, stats, N, L, H, seqs, drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool OFF>
int dispatch_type(const void* qkv, const void* mask, void* out, void* stats, int N, int L,
                  int H, int Dh, int seqs, Dropout<OFF> drop, int dtype, cudaStream_t s) {
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_head_dim<float>(qkv, mask, out, stats, N, L, H, Dh, seqs, drop, s);
    case DTYPE_BF16:
      return dispatch_head_dim<bf16>(qkv, mask, out, stats, N, L, H, Dh, seqs, drop, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (N, L, 3*H*Dh) and out (N, L, H*Dh) of one dtype, mask (N, L) int32,
// all contiguous, out 16-byte aligned (qkv too in bf16); Dh in {16, 32,
// 64}; L % seqs == 0.
// stats: (N, H, L) float2 (row max, 1/row sum) or null. Dropout is on when
// `dropping` is non-zero: keep iff bits >= thresh, kept values scaled by
// inv_keep. The mask of sequence n, head h is drawn at (n + seq_offset,
// h + head_offset): a launch over some sequences or heads of a batch draws
// their masks of the whole batch's launch.
extern "C" int mha_fwd(const void* qkv, const void* mask, void* out,
                       void* stats, int N, int L, int H, int Dh, int seqs,
                       unsigned long long seed, unsigned int thresh,
                       float inv_keep, int dropping, int seq_offset, int head_offset,
                       int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || L <= 0 || H <= 0 || H > 65535 || seqs <= 0 || L % seqs != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dropping && (seq_offset || head_offset))
    return dispatch_type(qkv, mask, out, stats, N, L, H, Dh, seqs,
                         Dropout<true>{seed, thresh, inv_keep, 1, seq_offset, head_offset},
                         dtype, s);
  return dispatch_type(qkv, mask, out, stats, N, L, H, Dh, seqs,
                       Dropout<false>{seed, thresh, inv_keep, dropping != 0, 0, 0}, dtype, s);
}
