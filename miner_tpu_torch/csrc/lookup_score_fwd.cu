// Fused cache lookup + candidate scoring, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/lookup_score.py:_lookup_kernel
// (pallas_call at lookup_score.py:134, reached through lookup_score_fused).
// With a (N, D) news-embedding cache, (B, C) candidate rows and (B, K, D)
// interests:
//   out[b, c, k] = cache[cand_idx[b, c]] . interests[b, k]
// without ever building the (B, C, D) gather in device memory. An index in
// [-N, 0) takes row N + index and one outside [-N, N) gives NaN scores for
// that candidate, as a gather does in JAX (jnp.take), instead of reading
// out of bounds. An int8 cache (parallel/news_cache.py:Int8Rows) comes
// with a float32 scale a row: out = (q . interests) * scale, the scale
// applied to the fp32 sum, then rounded once to the interests' type.
//
// What bounds it: each candidate row is D values read once and scored
// against K interests, 2 K flops per value: 32 flop/byte for a bf16 cache
// at K = 32 (64 for int8), far under the ridge, so the least time is the
// bytes of the distinct rows gathered and of the (B, C, K) scores written.
// Every (b, c) row still passes from L2 to an SM once: a corpus top-k at
// B = 32 moves 32 x the cache through L2, which bounds it in practice.
//
// Design: a block takes one batch row and a run of `tiles` tiles of 64
// candidates (the wrapper sizes the run so that the grid is about one wave
// of the card, ops/lookup_score.py:plan). It loads the run's indices once,
// stages the row's interests once, and gathers each tile's rows into
// shared memory by 16-byte cp.async into a double buffer (the next tile
// gathered while one is scored), as the TPU kernel's two DMA groups were.
// Where two buffers do not fit (a bf16 cache at the PLM's D = 768, a Miner
// without --apply_reduce_dim: ~251 KB a block), one takes them: the next
// tile is gathered once every warp has scored the last (~157 KB). On the
// CUDA cores, where a 64-candidate tile does not fit in two buffers (fp32
// rows at D = 768, the lstm combine without --apply_reduce_dim: ~500 KB
// a block; one buffer would still take ~304 KB), a tile is 32 candidates,
// in two buffers where they fit, else in one (fp32 rows at D = 768: ~203
// KB a block). The tile and the buffers are template parameters: the
// wrapper's plan picks the tile (ops/lookup_score.py:plan), the launch
// the buffers (stages_for); a shape that fits in none is refused.
// Scores go through shared memory and leave as 16-byte stores of the
// contiguous (tile, K) block of out. Blocks are numbered batch row
// fastest, so the blocks that gather one candidate tile for every batch
// row run together: a corpus top-k reads each cache tile from device
// memory about once even when the cache outgrows L2.
//
// Two routes, by the types and D:
// - bf16 cache with bf16 interests, D a multiple of 16, or int8 cache with
//   bf16 interests, D a multiple of 32: the tensor cores. mma.sync m16n8k16
//   bf16 -> fp32 (csrc/tensor_core.cuh), a warp a (16 candidates, 16
//   interests) unit; K padded to 16 with zero rows. bf16 x bf16 products
//   are exact in fp32, so the result is the reference's fp32 einsum up to
//   summation order. int8 rows land in the double buffer as int8 (half the
//   bytes of bf16); a warp loads its A fragments of them with one ldmatrix
//   per 32 columns (16-bit lanes holding two int8 each) and widens them to
//   bf16 in registers, exactly, since |q| <= 127 < 2^8. A lane then holds
//   columns 4t..4t+3 of a 16-column chunk where the mma's layout puts
//   2t, 2t + 1, 2t + 8, 2t + 9: the products are summed over the chunk in
//   another order of k, so the lane reads the interests' B fragments at the
//   same four columns (one 8-byte load) and the dot product is unchanged.
//   Widening costs more instructions than the mma, so each element is
//   widened once per 32 interests: two warps take one 16-candidate piece,
//   each half of the 32-column steps and 32 interests at a time, and their
//   partial sums meet in shared memory.
// - every other pair, or D off the 16-column tiles: the CUDA cores (the
//   tensor cores' fp32 is TF32, which fails the fp32 tolerance). The row's
//   interests are staged once a block in their own type, K padded to 32;
//   each thread holds 2 candidates x 4 interests of a tile in registers,
//   fed by 16-byte (fp32) or 8-byte (bf16) loads from shared memory,
//   widened to fp32 as they are read; int8 rows by 4-byte loads.
#include <stdint.h>

#include "common.cuh"
#include "tensor_core.cuh"

template <> __device__ __forceinline__ int8_t from_float<int8_t>(float x) {
  return static_cast<int8_t>(x);
}

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TC = 64;  // candidates a tile (the CUDA cores take 32 where 64 do not fit)
constexpr int TC_SMALL = 32;
// gather buffers: one tile in flight while one is scored (on the tensor
// cores, one buffer where two do not fit: a bf16 cache at D = 768)
constexpr int STAGES = 2;
constexpr size_t MAX_SMEM = 227 * 1024;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared memory of one block, in bytes: the row's interests, the buffers
// of gathered rows, the scores of a tile in the output type, the run's
// indices; tiles of `tc` candidates.
struct Layout {
  int kp, ldi, ldr;  // interest rows (K padded); interest and gathered-row strides, in elements
  size_t in, rows, stage, red, out, idx, bytes;
  __host__ __device__ Layout(int K, int D, bool tensor_core, int cache_elem, int out_elem,
                             int tiles, int stages = STAGES, int tc = TC) {
    if (tensor_core && cache_elem == 1) {
      // int8 rows padded by 16 bytes and bf16 interests by 16 elements: the
      // 8 rows of an ldmatrix and the 16 lanes of an 8-byte load of B each
      // fall on distinct banks (D a multiple of 32)
      kp = round_up(K, 16);
      ldi = D + 16;
      ldr = D + 16;
    } else if (tensor_core) {  // bf16 rows and interests padded by 8 for ldmatrix
      kp = round_up(K, 16);
      ldi = D + 8;
      ldr = D + 8;
    } else {  // a warp's 8 interest rows at 16 bytes apart mod 128: no bank conflicts
      kp = round_up(K, 32);
      ldi = out_elem == 4 ? round_up(D, 32) + 4 : round_up(D, 64) + 8;
      ldr = round_up(D, 8);
    }
    in = 0;
    rows = in + align16((size_t)kp * ldi * out_elem);
    stage = align16((size_t)tc * ldr * cache_elem);
    red = rows + stages * stage;
    // int8 on the tensor cores: one warp's partial sums a 16-candidate
    // piece, 16 floats a lane
    out = red + (tensor_core && cache_elem == 1 ? (size_t)(TC / 16) * 16 * 32 * 4 : 0);
    idx = out + align16((size_t)tc * K * out_elem);
    bytes = idx + align16(sizeof(int) * (size_t)tiles * tc);
  }
};

// n elements of T, shared -> device memory, by 16-byte stores when dst is
// aligned (src always is)
template <typename T>
__device__ __forceinline__ void write_out(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    done = n / V * V;
    for (int c = threadIdx.x; c < n / V; c += THREADS)
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

// nrows rows of D elements into dst (stride ld): row r is src's row idx[r]
// (row r when idx is null) for r < n, and zero past n or where that row
// lies outside [0, N); by 16-byte cp.async when vec, else element by
// element with the columns D..round_up(D, 4) zeroed
template <typename T>
__device__ __forceinline__ void gather(T* dst, int ld, const T* src, const int* idx, int n,
                                       int nrows, int N, int D, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int chunks = D / V;
    for (int i = threadIdx.x; i < nrows * chunks; i += THREADS) {
      const int r = i / chunks, ch = i - r * chunks;
      const int row = r >= n ? -1 : idx ? idx[r] : r;
      const bool ok = row >= 0 && row < N;
      cp_async16(dst + r * ld + ch * V, ok ? src + (long)row * D + ch * V : src, ok ? 16 : 0);
    }
  } else {
    const int D4 = round_up(D, 4);
    for (int i = threadIdx.x; i < nrows * D4; i += THREADS) {
      const int r = i / D4, d = i - r * D4;
      const int row = r >= n ? -1 : idx ? idx[r] : r;
      dst[r * ld + d] = row >= 0 && row < N && d < D ? src[(long)row * D + d]
                                                     : from_float<T>(0.f);
    }
  }
}

__device__ __forceinline__ float nan_unless(bool ok, float v) {
  return ok ? v : __int_as_float(0x7fc00000);
}

// The block's batch row and its run of tiles [t0, t1) of `tc` candidates,
// batch row fastest.
struct Run {
  int b, t0, t1;
  __device__ __forceinline__ Run(int B, int C, int tiles, int tc = TC) {
    b = blockIdx.x % B;
    t0 = blockIdx.x / B * tiles;
    t1 = min(t0 + tiles, (C + tc - 1) / tc);
  }
};

// the gather buffers a launch takes: two where they fit, else one (always
// two for the CUDA cores' 64-candidate tiles, which the plan takes only
// where two fit)
inline int stages_for(int K, int D, bool tensor_core, int cache_elem, int out_elem, int tiles,
                      int tc = TC) {
  if (!tensor_core && tc == TC) return STAGES;
  return Layout(K, D, tensor_core, cache_elem, out_elem, tiles, STAGES, tc).bytes <= MAX_SMEM
             ? STAGES
             : 1;
}

// tile t's rows have landed: the next tile's group, when there is one (two
// buffers), may still be in flight
__device__ __forceinline__ void wait_tile(int t, const Run& run, int stages) {
  if (stages > 1 && t + 1 < run.t1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// the run's rows into sIdx: an index in [-N, 0) wrapped to N + index, -1
// for one outside [-N, N) and past C
__device__ __forceinline__ void load_indices(const Run& run, const int* cand_idx, int* sIdx,
                                             int C, int N, int tc = TC) {
  const int* idx = cand_idx + (long)run.b * C + (long)run.t0 * tc;
  const int n = min((run.t1 - run.t0) * tc, C - run.t0 * tc);
  for (int i = threadIdx.x; i < (run.t1 - run.t0) * tc; i += THREADS) {
    int row = i < n ? idx[i] : -1;
    if (i < n && row < 0) row = row >= -N ? row + N : -1;
    sIdx[i] = row < N ? row : -1;
  }
}

// four int8 (byte 0 the lowest column) -> two bf16 pairs, exactly: each
// byte, offset by 128, becomes the low mantissa bits of 2^23 and the float
// minus 2^23 + 128 is the integer
__device__ __forceinline__ void widen4(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.f;
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// the scale of a candidate's row: its int8 scale, 1 for a float cache
template <typename TCache>
__device__ __forceinline__ float row_scale(const float* scales, int row) {
  if constexpr (sizeof(TCache) == 1) {
    return row >= 0 ? scales[row] : 1.f;
  } else {
    return 1.f;
  }
}

// ------------------------------------------------------- tensor cores
// TCache bf16, or int8_t with scales: its rows widened to bf16 in registers
template <typename TCache, int NSTAGES>
__global__ void __launch_bounds__(THREADS)
lookup_score_tc(const TCache* __restrict__ cache, const float* __restrict__ scales,
                const int* __restrict__ cand_idx, const bf16* __restrict__ interests,
                bf16* __restrict__ out, int N, int B, int C, int K, int D, int tiles) {
  constexpr int stages = NSTAGES;
  constexpr bool kInt8 = sizeof(TCache) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(K, D, true, sizeof(TCache), 2, tiles, stages);
  bf16* sI = reinterpret_cast<bf16*>(smem + lay.in);
  bf16* sOut = reinterpret_cast<bf16*>(smem + lay.out);
  int* sIdx = reinterpret_cast<int*>(smem + lay.idx);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const Run run(B, C, tiles);
  // the interests' copies in flight while the indices load
  gather(sI, lay.ldi, interests + (long)run.b * K * D, nullptr, K, lay.kp, K, D, true);
  load_indices(run, cand_idx, sIdx, C, N);
  __syncthreads();  // sIdx
  auto stage_rows = [&](int t) {
    return reinterpret_cast<TCache*>(smem + lay.rows + (t % stages) * lay.stage);
  };
  auto tile_size = [&](int t) { return min(TC, C - t * TC); };
  auto fetch = [&](int t) {
    const int nc = tile_size(t);
    gather(stage_rows(t), lay.ldr, cache, sIdx + (t - run.t0) * TC, nc,
           min(TC, round_up(nc, 16)), N, D, true);
    cp_async_commit();
  };

  fetch(run.t0);  // in the interests' group
  const int ktiles = lay.kp / 16;
  for (int t = run.t0; t < run.t1; ++t) {
    if (stages > 1 && t + 1 < run.t1) fetch(t + 1);  // into the buffer of t - 1
    wait_tile(t, run, stages);
    __syncthreads();
    const TCache* rows = stage_rows(t);
    const int* tIdx = sIdx + (t - run.t0) * TC;
    const int nc = tile_size(t);
    const int mtiles = (nc + 15) / 16;
    // the scores of 16 candidates (piece mt) x 16 interests (kt) into sOut
    auto store = [&](const float (&acc)[2][4], int mt, int kt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = mt * 16 + g + 8 * r;
        if (c >= nc) continue;
        const bool ok = tIdx[c] >= 0;
        const float scale = row_scale<TCache>(scales, tIdx[c]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = kt * 16 + nt * 8 + 2 * t4 + e;
            if (k < K)
              sOut[c * K + k] = __float2bfloat16_rn(nan_unless(ok, acc[nt][2 * r + e] * scale));
          }
      }
    };
    if constexpr (kInt8) {
      // warps 2 mt and 2 mt + 1 take piece mt, the even and the odd
      // 32-column steps; 32 interests (two units) at a time
      const int mt = warp >> 1, half = warp & 1;
      const bool active = mt < mtiles;
      float* red = reinterpret_cast<float*>(smem + lay.red) + mt * 16 * 32 + lane;
      for (int kt0 = 0; kt0 < ktiles; kt0 += 2) {
        const bool two = kt0 + 1 < ktiles;
        float acc[2][2][4] = {};
        if (active) {
          // the lane's interest rows (n g and g + 8 of each unit), at the
          // four columns 4t..4t+3 of a chunk that its int8 fragments hold
          const bf16* i0 = sI + (kt0 * 16 + g) * lay.ldi + 4 * t4;
          for (int kc = 2 * half; kc < D / 16; kc += 4) {
            uint32_t q[4];  // rows g, g + 8 of chunk kc, then of chunk kc + 1
            ldsm_x4(q, rows + (mt * 16 + (lane & 15)) * lay.ldr + kc * 16 + (lane >> 4) * 16);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t a[4];
              widen4(q[2 * h], a[0], a[2]);
              widen4(q[2 * h + 1], a[1], a[3]);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (j == 1 && !two) break;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                  const uint2 b = *reinterpret_cast<const uint2*>(
                      i0 + (j * 16 + nt * 8) * lay.ldi + (kc + h) * 16);
                  mma_bf16(acc[j][nt], a, b.x, b.y);
                }
              }
            }
          }
          if (half) {  // the odd steps' partial sums, for the even warp
#pragma unroll
            for (int f = 0; f < 16; ++f) red[f * 32] = (&acc[0][0][0])[f];
          }
        }
        __syncthreads();
        if (active && !half) {
#pragma unroll
          for (int f = 0; f < 16; ++f) (&acc[0][0][0])[f] += red[f * 32];
          store(acc[0], mt, kt0);
          if (two) store(acc[1], mt, kt0 + 1);
        }
        if (kt0 + 2 < ktiles) __syncthreads();  // red is taken before the next pair
      }
    } else {
      for (int u = warp; u < mtiles * ktiles; u += WARPS) {
        const int mt = u / ktiles, kt = u - mt * ktiles;
        float acc[2][4] = {};
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t a[4], bi[4];
          ldsm_x4(a, rows + (mt * 16 + (lane & 15)) * lay.ldr + kc * 16 + (lane >> 4) * 8);
          ldsm_x4(bi, sI + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * lay.ldi + kc * 16 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(acc[0], a, bi[0], bi[1]);
          mma_bf16(acc[1], a, bi[2], bi[3]);
        }
        store(acc, mt, kt);
      }
    }
    __syncthreads();
    if (stages == 1 && t + 1 < run.t1) fetch(t + 1);  // every warp is done with the buffer
    write_out(out + ((long)run.b * C + (long)t * TC) * K, sOut, nc * K);
  }
}

// ------------------------------------------------------- CUDA cores
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_float4(v.x, v.y, v.z, v.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// one block an SM at fp32 rows (~170 KB of shared memory): no register
// cap. Tiles of TCC candidates (64 or 32) in NSTAGES buffers; a thread
// scores TCC / 32 candidates x 4 interests at a time
template <typename TCache, typename TI, int TCC, int NSTAGES>
__global__ void __launch_bounds__(THREADS, 1)
lookup_score_cc(const TCache* __restrict__ cache, const float* __restrict__ scales,
                const int* __restrict__ cand_idx, const TI* __restrict__ interests,
                TI* __restrict__ out, int N, int B, int C, int K, int D, int tiles) {
  constexpr int CPT = TCC / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(K, D, false, sizeof(TCache), sizeof(TI), tiles, NSTAGES, TCC);
  TI* sI = reinterpret_cast<TI*>(smem + lay.in);
  TI* sOut = reinterpret_cast<TI*>(smem + lay.out);
  int* sIdx = reinterpret_cast<int*>(smem + lay.idx);
  const int tid = threadIdx.x;
  const int kg = tid & 7, cgp = tid >> 3;  // interests kg + 8 i; candidates cgp + 32 j
  const int D4 = round_up(D, 4);
  const bool vec = reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                   (D * sizeof(TCache)) % 16 == 0;
  const bool vec_i = reinterpret_cast<uintptr_t>(interests) % 16 == 0 &&
                     (D * sizeof(TI)) % 16 == 0;

  const Run run(B, C, tiles, TCC);
  gather(sI, lay.ldi, interests + (long)run.b * K * D, nullptr, K, lay.kp, K, D, vec_i);
  load_indices(run, cand_idx, sIdx, C, N, TCC);
  __syncthreads();  // sIdx
  auto stage_rows = [&](int t) {
    return reinterpret_cast<TCache*>(smem + lay.rows + (t % NSTAGES) * lay.stage);
  };
  auto tile_size = [&](int t) { return min(TCC, C - t * TCC); };
  auto fetch = [&](int t) {
    const int nc = tile_size(t);
    gather(stage_rows(t), lay.ldr, cache, sIdx + (t - run.t0) * TCC, nc,
           min(TCC, round_up(nc, 16)), N, D, vec);
    cp_async_commit();
  };

  fetch(run.t0);  // in the interests' group
  for (int t = run.t0; t < run.t1; ++t) {
    if (NSTAGES > 1 && t + 1 < run.t1) fetch(t + 1);  // into the buffer of t - 1
    wait_tile(t, run, NSTAGES);
    __syncthreads();
    const TCache* rows = stage_rows(t);
    const int* tIdx = sIdx + (t - run.t0) * TCC;
    const int nc = tile_size(t);
    if (cgp < nc) {  // candidate cgp + 32 < nc only if cgp < nc
      // two named rows, not an array of CPT: with an array the 64-candidate
      // tile took 2 registers fewer and ran 1.3% slower (int8 rows, fp32
      // interests, H100)
      const TCache* r0 = rows + cgp * lay.ldr;
      const TCache* r1 = rows + (cgp + 32) * lay.ldr;  // read with 64-candidate tiles
      for (int k0 = 0; k0 < K; k0 += 32) {
        float acc[CPT][4] = {};
        const TI* ib = sI + (k0 + kg) * lay.ldi;
        for (int d = 0; d < D4; d += 4) {
          const float4 x0 = load4(r0 + d), x1 = CPT == 2 ? load4(r1 + d) : x0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = load4(ib + 8 * i * lay.ldi + d);
            acc[0][i] = dot4(x0, w, acc[0][i]);
            if constexpr (CPT == 2) acc[1][i] = dot4(x1, w, acc[1][i]);
          }
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = cgp + 32 * j;
          if (c >= nc) continue;
          const bool ok = tIdx[c] >= 0;
          const float scale = row_scale<TCache>(scales, tIdx[c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + kg + 8 * i;
            if (k < K) sOut[c * K + k] = from_float<TI>(nan_unless(ok, acc[j][i] * scale));
          }
        }
      }
    }
    __syncthreads();
    if (NSTAGES == 1 && t + 1 < run.t1) fetch(t + 1);  // every warp is done with the buffer
    write_out(out + ((long)run.b * C + (long)t * TCC) * K, sOut, nc * K);
  }
}

bool tensor_core_route(int D, int cache_dtype, int interests_dtype) {
  return interests_dtype == DTYPE_BF16 && ((cache_dtype == DTYPE_BF16 && D % 16 == 0) ||
                                           (cache_dtype == DTYPE_I8 && D % 32 == 0));
}

int elem_size(int dtype) { return dtype == DTYPE_I8 ? 1 : dtype == DTYPE_BF16 ? 2 : 4; }

template <typename TCache>
cudaError_t launch_tc(const void* cache, const void* scales, const void* cand_idx,
                      const void* interests, void* out, int N, int B, int C, int K, int D,
                      int tiles, int blocks, cudaStream_t stream) {
  const int stages = stages_for(K, D, true, sizeof(TCache), 2, tiles);
  const auto kernel = stages == STAGES ? lookup_score_tc<TCache, STAGES> : lookup_score_tc<TCache, 1>;
  const size_t smem = Layout(K, D, true, sizeof(TCache), 2, tiles, stages).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const TCache*>(cache), static_cast<const float*>(scales),
      static_cast<const int*>(cand_idx), static_cast<const bf16*>(interests),
      static_cast<bf16*>(out), N, B, C, K, D, tiles);
  return cudaGetLastError();
}

template <typename TCache, typename TI>
cudaError_t launch_cc(const void* cache, const void* scales, const void* cand_idx,
                      const void* interests, void* out, int N, int B, int C, int K, int D,
                      int tc, int tiles, int blocks, cudaStream_t stream) {
  const int stages = stages_for(K, D, false, sizeof(TCache), sizeof(TI), tiles, tc);
  const auto kernel = tc == TC ? lookup_score_cc<TCache, TI, TC, STAGES>
                      : stages == STAGES ? lookup_score_cc<TCache, TI, TC_SMALL, STAGES>
                                         : lookup_score_cc<TCache, TI, TC_SMALL, 1>;
  const size_t smem = Layout(K, D, false, sizeof(TCache), sizeof(TI), tiles, stages, tc).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const TCache*>(cache), static_cast<const float*>(scales),
      static_cast<const int*>(cand_idx), static_cast<const TI*>(interests),
      static_cast<TI*>(out), N, B, C, K, D, tiles);
  return cudaGetLastError();
}

template <typename TCache>
cudaError_t dispatch_cc(const void* cache, const void* scales, const void* cand_idx,
                        const void* interests, void* out, int N, int B, int C, int K, int D,
                        int interests_dtype, int tc, int tiles, int blocks,
                        cudaStream_t stream) {
  switch (interests_dtype) {
    case DTYPE_F32:
      return launch_cc<TCache, float>(cache, scales, cand_idx, interests, out, N, B, C, K, D,
                                      tc, tiles, blocks, stream);
    case DTYPE_BF16:
      return launch_cc<TCache, bf16>(cache, scales, cand_idx, interests, out, N, B, C, K, D,
                                     tc, tiles, blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory a block takes at these shapes, for the route the types and
// D pick, with runs of `tiles` tiles of `tile` candidates (64; 32 on the
// CUDA cores), in the buffers the launch takes.
extern "C" long long lookup_score_smem_bytes(int K, int D, int cache_dtype,
                                            int interests_dtype, int tiles, int tile) {
  const bool tc = tensor_core_route(D, cache_dtype, interests_dtype);
  const int ce = elem_size(cache_dtype), oe = elem_size(interests_dtype);
  return (long long)Layout(K, D, tc, ce, oe, tiles, stages_for(K, D, tc, ce, oe, tiles, tile),
                           tile).bytes;
}

// cache (N, D) in cache_dtype, with scales (N, 1) float32 for an int8 cache
// (null for the others); cand_idx (B, C) int32; interests (B, K, D) and out
// (B, C, K) in interests_dtype; all contiguous; a block scores a run of
// `tiles` tiles of `tile` candidates (64, or 32 on the CUDA-core route).
// The tensor-core route (bf16 interests with a bf16 cache, D a multiple of
// 16, or an int8 one, D a multiple of 32) takes cache and interests
// 16-byte aligned.
extern "C" int lookup_score_fwd(const void* cache, const void* scales, const void* cand_idx,
                                const void* interests, void* out, int N, int B, int C,
                                int K, int D, int cache_dtype, int interests_dtype,
                                int tiles, int tile, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || B <= 0 || C <= 0 || K <= 0 || D <= 0 || tiles <= 0)
    return cudaErrorInvalidValue;
  if ((cache_dtype == DTYPE_I8) != (scales != nullptr)) return cudaErrorInvalidValue;
  const bool tensor_core = tensor_core_route(D, cache_dtype, interests_dtype);
  if (tile != TC && (tensor_core || tile != TC_SMALL)) return cudaErrorInvalidValue;
  const long long blocks = (long long)B * (((C + tile - 1) / tile + tiles - 1) / tiles);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
    if ((reinterpret_cast<uintptr_t>(cache) | reinterpret_cast<uintptr_t>(interests)) % 16)
      return cudaErrorMisalignedAddress;
    if (cache_dtype == DTYPE_I8)
      return launch_tc<int8_t>(cache, scales, cand_idx, interests, out, N, B, C, K, D, tiles,
                               (int)blocks, s);
    return launch_tc<bf16>(cache, scales, cand_idx, interests, out, N, B, C, K, D, tiles,
                           (int)blocks, s);
  }
  switch (cache_dtype) {
    case DTYPE_F32:
      return dispatch_cc<float>(cache, scales, cand_idx, interests, out, N, B, C, K, D,
                                interests_dtype, tile, tiles, (int)blocks, s);
    case DTYPE_BF16:
      return dispatch_cc<bf16>(cache, scales, cand_idx, interests, out, N, B, C, K, D,
                               interests_dtype, tile, tiles, (int)blocks, s);
    case DTYPE_I8:
      return dispatch_cc<int8_t>(cache, scales, cand_idx, interests, out, N, B, C, K, D,
                                 interests_dtype, tile, tiles, (int)blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}
