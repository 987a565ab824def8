// Fused cache lookup + candidate scoring, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/lookup_score.py:_lookup_kernel
// (pallas_call at lookup_score.py:134, reached through lookup_score_fused).
// With a (N, D) news-embedding cache, (B, C) candidate rows and (B, K, D)
// interests:
//   out[b, c, k] = cache[cand_idx[b, c]] . interests[b, k]
// without ever building the (B, C, D) gather in device memory. An index
// outside [0, N) gives NaN scores for that candidate, as a gather out of
// range does in JAX, instead of reading out of bounds.
//
// What bounds it: each candidate row is D values read once and scored
// against K interests, 2 K flops per value: 32 flop/byte for a bf16 cache
// at K = 32, far under the ridge, so the least time is the bytes of the
// distinct rows gathered and of the (B, C, K) scores written. Every (b, c)
// row still passes from L2 to an SM once: a corpus top-k at B = 32 moves
// 32 x the cache through L2, which bounds it in practice.
//
// Design: a block takes one batch row and a run of `tiles` tiles of 64
// candidates (the wrapper sizes the run so that the grid is about one wave
// of the card, ops/lookup_score.py:plan). It loads the run's indices once,
// stages the row's interests once, and gathers each tile's rows into
// shared memory by 16-byte cp.async into a double buffer (the next tile
// gathered while one is scored), as the TPU kernel's two DMA groups were.
// Scores go through shared memory and leave as 16-byte stores of the
// contiguous (tile, K) block of out. Blocks are numbered batch row
// fastest, so the blocks that gather one candidate tile for every batch
// row run together: a corpus top-k reads each cache tile from device
// memory about once even when the cache outgrows L2.
//
// Two routes, by the types and D:
// - bf16 cache and bf16 interests, D a multiple of 16: the tensor cores.
//   mma.sync m16n8k16 bf16 -> fp32 (csrc/tensor_core.cuh), a warp a (16
//   candidates, 16 interests) unit; K padded to 16 with zero rows. bf16 x
//   bf16 products are exact in fp32, so the result is the reference's fp32
//   einsum up to summation order.
// - every other pair, or D off the 16-column tiles: the CUDA cores (the
//   tensor cores' fp32 is TF32, which fails the fp32 tolerance). The row's
//   interests are staged once a block in their own type, K padded to 32;
//   each thread holds 2 candidates x 4 interests of a tile in registers,
//   fed by 16-byte (fp32) or 8-byte (bf16) loads from shared memory,
//   widened to fp32 as they are read.
#include <stdint.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TC = 64;  // candidates a tile
constexpr int STAGES = 2;  // gather buffers: one tile in flight while one is scored

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared memory of one block, in bytes: the row's interests, the two
// buffers of gathered rows, the scores of a tile in the output type, the
// run's indices.
struct Layout {
  int kp, ldi, ldr;  // interest rows (K padded); interest and row strides, in elements
  size_t in, rows, stage, out, idx, bytes;
  __host__ __device__ Layout(int K, int D, bool tensor_core, int cache_elem, int out_elem,
                             int tiles) {
    if (tensor_core) {  // bf16 interests, rows padded by 8 for ldmatrix
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
    stage = align16((size_t)TC * ldr * cache_elem);
    out = rows + STAGES * stage;
    idx = out + align16((size_t)TC * K * out_elem);
    bytes = idx + align16(sizeof(int) * (size_t)tiles * TC);
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

// The block's batch row and its run of tiles [t0, t1), batch row fastest.
struct Run {
  int b, t0, t1;
  __device__ __forceinline__ Run(int B, int C, int tiles) {
    b = blockIdx.x % B;
    t0 = blockIdx.x / B * tiles;
    t1 = min(t0 + tiles, (C + TC - 1) / TC);
  }
};

// tile t's rows have landed: the next tile's group, when there is one, may
// still be in flight
__device__ __forceinline__ void wait_tile(int t, const Run& run) {
  if (t + 1 < run.t1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// the run's indices into sIdx, -1 past C
__device__ __forceinline__ void load_indices(const Run& run, const int* cand_idx, int* sIdx,
                                             int C) {
  const int* idx = cand_idx + (long)run.b * C + (long)run.t0 * TC;
  const int n = min((run.t1 - run.t0) * TC, C - run.t0 * TC);
  for (int i = threadIdx.x; i < (run.t1 - run.t0) * TC; i += THREADS)
    sIdx[i] = i < n ? idx[i] : -1;
}

// ------------------------------------------------------- tensor cores
__global__ void __launch_bounds__(THREADS)
lookup_score_tc(const bf16* __restrict__ cache, const int* __restrict__ cand_idx,
                const bf16* __restrict__ interests, bf16* __restrict__ out, int N, int B,
                int C, int K, int D, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(K, D, true, 2, 2, tiles);
  bf16* sI = reinterpret_cast<bf16*>(smem + lay.in);
  bf16* sOut = reinterpret_cast<bf16*>(smem + lay.out);
  int* sIdx = reinterpret_cast<int*>(smem + lay.idx);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const Run run(B, C, tiles);
  // the interests' copies in flight while the indices load
  gather(sI, lay.ldi, interests + (long)run.b * K * D, nullptr, K, lay.kp, K, D, true);
  load_indices(run, cand_idx, sIdx, C);
  __syncthreads();  // sIdx
  auto stage_rows = [&](int t) {
    return reinterpret_cast<bf16*>(smem + lay.rows + (t % STAGES) * lay.stage);
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
    if (t + 1 < run.t1) fetch(t + 1);  // into the buffer of t - 1
    wait_tile(t, run);
    __syncthreads();
    const bf16* rows = stage_rows(t);
    const int* tIdx = sIdx + (t - run.t0) * TC;
    const int nc = tile_size(t);
    const int mtiles = (nc + 15) / 16;
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
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = mt * 16 + g + 8 * r;
        if (c >= nc) continue;
        const bool ok = tIdx[c] >= 0 && tIdx[c] < N;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = kt * 16 + nt * 8 + 2 * t4 + e;
            if (k < K)
              sOut[c * K + k] = __float2bfloat16_rn(nan_unless(ok, acc[nt][2 * r + e]));
          }
      }
    }
    __syncthreads();
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// one block an SM at fp32 rows (~170 KB of shared memory): no register cap
template <typename TCache, typename TI>
__global__ void __launch_bounds__(THREADS, 1)
lookup_score_cc(const TCache* __restrict__ cache, const int* __restrict__ cand_idx,
                const TI* __restrict__ interests, TI* __restrict__ out, int N, int B, int C,
                int K, int D, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(K, D, false, sizeof(TCache), sizeof(TI), tiles);
  TI* sI = reinterpret_cast<TI*>(smem + lay.in);
  TI* sOut = reinterpret_cast<TI*>(smem + lay.out);
  int* sIdx = reinterpret_cast<int*>(smem + lay.idx);
  const int tid = threadIdx.x;
  const int kg = tid & 7, cgp = tid >> 3;  // interests kg + 8 i; candidates cgp, cgp + 32
  const int D4 = round_up(D, 4);
  const bool vec = reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                   (D * sizeof(TCache)) % 16 == 0;
  const bool vec_i = reinterpret_cast<uintptr_t>(interests) % 16 == 0 &&
                     (D * sizeof(TI)) % 16 == 0;

  const Run run(B, C, tiles);
  gather(sI, lay.ldi, interests + (long)run.b * K * D, nullptr, K, lay.kp, K, D, vec_i);
  load_indices(run, cand_idx, sIdx, C);
  __syncthreads();  // sIdx
  auto stage_rows = [&](int t) {
    return reinterpret_cast<TCache*>(smem + lay.rows + (t % STAGES) * lay.stage);
  };
  auto tile_size = [&](int t) { return min(TC, C - t * TC); };
  auto fetch = [&](int t) {
    const int nc = tile_size(t);
    gather(stage_rows(t), lay.ldr, cache, sIdx + (t - run.t0) * TC, nc,
           min(TC, round_up(nc, 16)), N, D, vec);
    cp_async_commit();
  };

  fetch(run.t0);  // in the interests' group
  for (int t = run.t0; t < run.t1; ++t) {
    if (t + 1 < run.t1) fetch(t + 1);
    wait_tile(t, run);
    __syncthreads();
    const TCache* rows = stage_rows(t);
    const int* tIdx = sIdx + (t - run.t0) * TC;
    const int nc = tile_size(t);
    if (cgp < nc) {  // candidate cgp + 32 < nc only if cgp < nc
      const TCache* r0 = rows + cgp * lay.ldr;
      const TCache* r1 = rows + (cgp + 32) * lay.ldr;
      for (int k0 = 0; k0 < K; k0 += 32) {
        float acc[2][4] = {};
        const TI* ib = sI + (k0 + kg) * lay.ldi;
        for (int d = 0; d < D4; d += 4) {
          const float4 x0 = load4(r0 + d), x1 = load4(r1 + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = load4(ib + 8 * i * lay.ldi + d);
            acc[0][i] = dot4(x0, w, acc[0][i]);
            acc[1][i] = dot4(x1, w, acc[1][i]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = cgp + 32 * j;
          if (c >= nc) continue;
          const bool ok = tIdx[c] >= 0 && tIdx[c] < N;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + kg + 8 * i;
            if (k < K) sOut[c * K + k] = from_float<TI>(nan_unless(ok, acc[j][i]));
          }
        }
      }
    }
    __syncthreads();
    write_out(out + ((long)run.b * C + (long)t * TC) * K, sOut, nc * K);
  }
}

bool tensor_core_route(int D, int cache_dtype, int interests_dtype) {
  return cache_dtype == DTYPE_BF16 && interests_dtype == DTYPE_BF16 && D % 16 == 0;
}

int elem_size(int dtype) { return dtype == DTYPE_BF16 ? 2 : 4; }

cudaError_t launch_tc(const void* cache, const void* cand_idx, const void* interests,
                      void* out, int N, int B, int C, int K, int D, int tiles, int blocks,
                      cudaStream_t stream) {
  const size_t smem = Layout(K, D, true, 2, 2, tiles).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lookup_score_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lookup_score_tc<<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(cache), static_cast<const int*>(cand_idx),
      static_cast<const bf16*>(interests), static_cast<bf16*>(out), N, B, C, K, D, tiles);
  return cudaGetLastError();
}

template <typename TCache, typename TI>
cudaError_t launch_cc(const void* cache, const void* cand_idx, const void* interests,
                      void* out, int N, int B, int C, int K, int D, int tiles, int blocks,
                      cudaStream_t stream) {
  const size_t smem = Layout(K, D, false, sizeof(TCache), sizeof(TI), tiles).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      lookup_score_cc<TCache, TI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lookup_score_cc<TCache, TI><<<blocks, THREADS, smem, stream>>>(
      static_cast<const TCache*>(cache), static_cast<const int*>(cand_idx),
      static_cast<const TI*>(interests), static_cast<TI*>(out), N, B, C, K, D, tiles);
  return cudaGetLastError();
}

template <typename TCache>
cudaError_t dispatch_cc(const void* cache, const void* cand_idx, const void* interests,
                        void* out, int N, int B, int C, int K, int D, int interests_dtype,
                        int tiles, int blocks, cudaStream_t stream) {
  switch (interests_dtype) {
    case DTYPE_F32:
      return launch_cc<TCache, float>(cache, cand_idx, interests, out, N, B, C, K, D, tiles,
                                      blocks, stream);
    case DTYPE_BF16:
      return launch_cc<TCache, bf16>(cache, cand_idx, interests, out, N, B, C, K, D, tiles,
                                     blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory a block takes at these shapes, for the route the types and
// D pick, with runs of `tiles` tiles.
extern "C" long long lookup_score_smem_bytes(int K, int D, int cache_dtype,
                                            int interests_dtype, int tiles) {
  return (long long)Layout(K, D, tensor_core_route(D, cache_dtype, interests_dtype),
                           elem_size(cache_dtype), elem_size(interests_dtype), tiles)
      .bytes;
}

// cache (N, D) in cache_dtype; cand_idx (B, C) int32; interests (B, K, D) and
// out (B, C, K) in interests_dtype; all contiguous; a block scores a run of
// `tiles` tiles of 64 candidates. The tensor-core route (both bf16, D a
// multiple of 16) takes cache and interests 16-byte aligned.
extern "C" int lookup_score_fwd(const void* cache, const void* cand_idx,
                                const void* interests, void* out, int N, int B, int C,
                                int K, int D, int cache_dtype, int interests_dtype,
                                int tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || B <= 0 || C <= 0 || K <= 0 || D <= 0 || tiles <= 0)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)B * (((C + TC - 1) / TC + tiles - 1) / tiles);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core_route(D, cache_dtype, interests_dtype)) {
    if ((reinterpret_cast<uintptr_t>(cache) | reinterpret_cast<uintptr_t>(interests)) % 16)
      return cudaErrorMisalignedAddress;
    return launch_tc(cache, cand_idx, interests, out, N, B, C, K, D, tiles, (int)blocks, s);
  }
  switch (cache_dtype) {
    case DTYPE_F32:
      return dispatch_cc<float>(cache, cand_idx, interests, out, N, B, C, K, D,
                                interests_dtype, tiles, (int)blocks, s);
    case DTYPE_BF16:
      return dispatch_cc<bf16>(cache, cand_idx, interests, out, N, B, C, K, D,
                               interests_dtype, tiles, (int)blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}
