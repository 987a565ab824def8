// Fastformer additive attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/fastformer_attn.py:_ff_kernel
// (pallas_call at fastformer_attn.py:114, reached through _ff_pallas and
// fastformer_attention_fused). Per batch row b, with q, k (L, D), h heads of
// hd = D / h channels, scale 1/sqrt(hd) and a mask bias of 0 or -10000:
//   alpha[l,j]  = softmax_l((q[l] . wqa[:,j] + bqa[j]) * scale + bias[l])
//   pooled_q[d] = sum_l alpha[l, d/hd] q[l,d]
//   u[l,d]      = k[l,d] pooled_q[d]
//   beta[l,j]   = softmax_l((u[l] . wka[:,j] + bka[j]) * scale + bias[l])
//   pooled_k[d] = sum_l beta[l, d/hd] u[l,d]
//   out[l,d]    = pooled_k[d] q[l,d]
// Each head's score is a dot over the whole D. Intermediates are rounded to
// the input type where the JAX reference rounds them (scores before and
// after the bias, softmax weights, pooled vectors, u); fp32 accumulation.
//
// What bounds it: at the training path's shape (B=16, L=50, D=256, h=16,
// fp32) a call reads and writes ~0.53 MB and does ~14 MFLOP: 0.16 us of
// bytes and 0.2 us of fp32 operations on an H100. Its time is set by the
// latency of the dependent steps of a row (two score passes, two softmaxes
// over L, two poolings), and by how many SMs share the rows.
//
// Design: a cluster of NC CTAs per batch row (NC chosen by the wrapper, 1 to
// 8; B = 16 and NC = 4 give 64 CTAs, where one block a row gave 16). CTA r
// owns rows [r L / NC, (r + 1) L / NC) and stages them, q and k, in shared
// memory once (16-byte cp.async), with both weights transposed to (h, D) so
// that a warp's lanes read consecutive channels. Then, twice (q, then u):
//   1. scores of its rows: a warp takes 2 rows x 16 heads, lanes split D,
//      and one reduce-scatter over the warp (31 shuffles) leaves each lane
//      one (row, head) sum;
//   2. its rows' softmax max and sum per head (sum of exp(s - local max));
//   3. cluster barrier; every CTA combines the NC (max, sum) pairs in rank
//      order over distributed shared memory, so each knows the row's max and
//      sum before any weight is normalised and rounded;
//   4. its rows' weights, and its partial pooled D-vector (a short loop over
//      its own rows in shared memory, a thread a channel);
//   5. cluster barrier; every CTA sums the NC partials in rank order (the
//      same sums in every CTA, and from run to run) and rounds the pooled
//      vector.
// Between the two passes u = k * pooled_q replaces k in shared memory. Each
// CTA writes out for its own rows. Nothing but out touches device memory.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HC = 16;  // heads a warp scores at once
constexpr int RW = 2;   // rows a warp scores at once: RW * HC = 32 sums
constexpr int MAX_CLUSTER = 8;
constexpr float FF_MASK_FILL = -10000.f;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of one CTA, in bytes; every CTA of a launch has the same
// layout, sized for the largest row slice.
struct Layout {
  int ls, hp, ldw;  // rows a CTA owns at most, heads padded to HC, weight row stride
  size_t q, k, wq, wk, bq, bk, s, stat, part, pool, glob, bytes;
  __host__ __device__ Layout(int L, int D, int h, int nc, int elem) {
    ls = (L + nc - 1) / nc;
    hp = (h + HC - 1) / HC * HC;
    ldw = D + 1;
    q = 0;                                               // (ls, D) T: q rows
    k = q + align16((size_t)ls * D * elem);              // (ls, D) T: k, then u
    wq = k + align16((size_t)ls * D * elem);             // (hp, D + 1) fp32: wqa^T
    wk = wq + align16(sizeof(float) * hp * ldw);         // (hp, D + 1) fp32: wka^T
    bq = wk + align16(sizeof(float) * hp * ldw);         // (h,) fp32
    bk = bq + align16(sizeof(float) * h);                // (h,) fp32
    s = bk + align16(sizeof(float) * h);                 // (ls, h) fp32: scores, weights
    stat = s + align16(sizeof(float) * ls * h);          // (2 passes, h, 2): local max, sum
    part = stat + align16(sizeof(float) * 4 * h);        // (2 passes, D): partial pools
    pool = part + align16(sizeof(float) * 2 * D);        // (2, D): pooled_q, pooled_k
    glob = pool + align16(sizeof(float) * 2 * D);        // (h, 2): the row's max and sum
    bytes = glob + align16(sizeof(float) * 2 * h);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One step of the reduce-scatter: a lane keeps the half of its first 2 O
// values that its lane bit O picks, plus the partner lane's same half.
template <int O>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The warp's sum of v[lane], for each lane: 32 sums for 31 shuffles (the
// widths are template constants, so v stays in registers).
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// Everything one additive-attention pooling needs of this CTA's shared memory.
struct Pass {
  const float* wt;  // (hp, ldw) transposed weight
  const float* b;   // (h,) bias
  float* stat;      // (h, 2) this CTA's max and sum per head
  float* part;      // (D,) this CTA's partial pool
  float* pooled;    // (D,) the pooled vector, rounded to T
};

// One pooling over the row: the scores of this CTA's rows of x, the softmax
// over all L rows of the cluster's batch row, pooled[d] = round(sum_l
// weight[l, d / hd] x[l, d]) in every CTA of the cluster.
template <typename T>
__device__ void attend(const cg::cluster_group& cluster, const T* sX, const Pass& p,
                       float* sS, float* sGlob, const int* mrow, int ls, int D, int h,
                       int ldw, float scale) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = static_cast<int>(cluster.num_blocks());

  // 1. scores: RW rows x HC heads a warp, lanes over D, one reduce-scatter
  for (int l = warp * RW; l < ls; l += WARPS * RW) {
    const T* xa = sX + l * D;
    const T* xb = sX + min(l + 1, ls - 1) * D;
    for (int j0 = 0; j0 < h; j0 += HC) {
      float v[RW * HC];
#pragma unroll
      for (int i = 0; i < RW * HC; ++i) v[i] = 0.f;
      const float* w = p.wt + j0 * ldw;
      for (int d = lane; d < D; d += 32) {
        const float a = to_float(xa[d]), c = to_float(xb[d]);
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) {
          const float wv = w[jj * ldw + d];  // rows past h are zero
          v[jj] = fmaf(a, wv, v[jj]);
          v[HC + jj] = fmaf(c, wv, v[HC + jj]);
        }
      }
      const float s = reduce_scatter32(v, lane);
      const int r = l + lane / HC, j = j0 + lane % HC;
      if (r < ls && j < h)
        sS[r * h + j] = round_to<T>(round_to<T>(s) + p.b[j]) * scale +
                        (mrow[r] != 0 ? 0.f : FF_MASK_FILL);
    }
  }
  __syncthreads();

  // 2. this CTA's max and sum of exp(s - max) per head (-inf and 0 for no rows)
  for (int j = warp; j < h; j += WARPS) {
    float m = -INFINITY;
    for (int l = lane; l < ls; l += 32) m = fmaxf(m, sS[l * h + j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < ls; l += 32) sum += expf(sS[l * h + j] - m);
    sum = warp_sum(sum);
    if (lane == 0) {
      p.stat[2 * j] = m;
      p.stat[2 * j + 1] = sum;
    }
  }
  cluster.sync();

  // 3. the row's max and sum, combined over the cluster in rank order
  for (int j = tid; j < h; j += THREADS) {
    float m = -INFINITY;
    for (int r = 0; r < nc; ++r) m = fmaxf(m, cluster.map_shared_rank(p.stat, r)[2 * j]);
    float sum = 0.f;
    for (int r = 0; r < nc; ++r) {
      const float* st = cluster.map_shared_rank(p.stat, r);
      sum += st[2 * j + 1] * expf(st[2 * j] - m);  // a rank of no rows adds 0
    }
    sGlob[2 * j] = m;
    sGlob[2 * j + 1] = sum;
  }
  __syncthreads();

  // 4. weights normalised, then rounded; this CTA's partial pool
  for (int i = tid; i < ls * h; i += THREADS) {
    const int j = i % h;
    sS[i] = round_to<T>(expf(sS[i] - sGlob[2 * j]) / sGlob[2 * j + 1]);
  }
  __syncthreads();
  const int hd = D / h;
  for (int d = tid; d < D; d += THREADS) {
    const float* w = sS + d / hd;
    float acc = 0.f;
    for (int l = 0; l < ls; ++l) acc = fmaf(w[l * h], to_float(sX[l * D + d]), acc);
    p.part[d] = acc;
  }
  cluster.sync();

  // 5. the partials summed in rank order, rounded
  for (int d = tid; d < D; d += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < nc; ++r) acc += cluster.map_shared_rank(p.part, r)[d];
    p.pooled[d] = round_to<T>(acc);
  }
  __syncthreads();
}

// n elements of T, global -> shared, by 16-byte cp.async when vec (both
// 16-byte aligned, n * sizeof(T) a multiple of 16), else one at a time
template <typename T>
__device__ void stage(T* dst, const T* src, int n, bool vec) {
  if (vec) {
    const int chunks = n * (int)sizeof(T) / 16;
    for (int c = threadIdx.x; c < chunks; c += THREADS)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * c,
                 reinterpret_cast<const char*>(src) + 16 * c, 16);
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

// w (D, h) -> wt (hp, ldw) fp32, transposed, rows h..hp-1 zero
template <typename T>
__device__ void stage_weight(float* wt, const T* w, int D, int h, int hp, int ldw) {
  for (int e = threadIdx.x; e < D * h; e += THREADS) {
    const int d = e / h;
    wt[(e - d * h) * ldw + d] = to_float(w[e]);
  }
  for (int e = threadIdx.x; e < (hp - h) * ldw; e += THREADS) wt[h * ldw + e] = 0.f;
}

// grid B * nc, cluster (nc, 1, 1), nc = 1..8
template <typename T>
__global__ void __launch_bounds__(THREADS)
fastformer_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ wqa, const T* __restrict__ bqa,
                           const T* __restrict__ wka, const T* __restrict__ bka,
                           const int* __restrict__ mask, T* __restrict__ out, int L,
                           int D, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout lay(L, D, h, nc, sizeof(T));
  T* sQ = reinterpret_cast<T*>(smem + lay.q);
  T* sK = reinterpret_cast<T*>(smem + lay.k);
  float* sWq = reinterpret_cast<float*>(smem + lay.wq);
  float* sWk = reinterpret_cast<float*>(smem + lay.wk);
  float* sBq = reinterpret_cast<float*>(smem + lay.bq);
  float* sBk = reinterpret_cast<float*>(smem + lay.bk);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sStat = reinterpret_cast<float*>(smem + lay.stat);
  float* sPart = reinterpret_cast<float*>(smem + lay.part);
  float* sPool = reinterpret_cast<float*>(smem + lay.pool);
  float* sGlob = reinterpret_cast<float*>(smem + lay.glob);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nc;
  const int l0 = rank * L / nc, ls = (rank + 1) * L / nc - l0;
  const long row = ((long)b * L + l0) * D;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0) &&
                   (D * sizeof(T)) % 16 == 0;

  stage(sQ, q + row, ls * D, vec);
  stage(sK, k + row, ls * D, vec);
  cp_async_commit();
  stage_weight(sWq, wqa, D, h, lay.hp, lay.ldw);
  stage_weight(sWk, wka, D, h, lay.hp, lay.ldw);
  for (int j = tid; j < h; j += THREADS) {
    sBq[j] = to_float(bqa[j]);
    sBk[j] = to_float(bka[j]);
  }
  cp_async_wait<0>();
  __syncthreads();

  const float scale = 1.f / sqrtf((float)(D / h));
  const int* mrow = mask + (long)b * L + l0;
  const Pass pq{sWq, sBq, sStat, sPart, sPool};
  const Pass pk{sWk, sBk, sStat + 2 * h, sPart + D, sPool + D};
  attend<T>(cluster, sQ, pq, sS, sGlob, mrow, ls, D, h, lay.ldw, scale);
  for (int i = tid; i < ls * D; i += THREADS)  // u = k * pooled_q, rounded
    sK[i] = from_float<T>(to_float(sK[i]) * sPool[i % D]);
  __syncthreads();
  attend<T>(cluster, sK, pk, sS, sGlob, mrow, ls, D, h, lay.ldw, scale);
  // this CTA reads no other's shared memory past here; none may leave while
  // another still reads its partials
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  T* ob = out + row;
  const float* pooled_k = sPool + D;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int c = tid; c < ls * D / V; c += THREADS) {
      const int d0 = (c * V) % D;
      alignas(16) T v[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        v[i] = from_float<T>(to_float(sQ[c * V + i]) * pooled_k[d0 + i]);
      *reinterpret_cast<uint4*>(ob + c * V) = *reinterpret_cast<const uint4*>(v);
    }
  } else {
    for (int i = tid; i < ls * D; i += THREADS)
      ob[i] = from_float<T>(to_float(sQ[i]) * pooled_k[i % D]);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
cudaError_t launch_ff(const void* q, const void* k, const void* wqa, const void* bqa,
                      const void* wka, const void* bka, const void* mask, void* out, int B,
                      int L, int D, int h, int nc, cudaStream_t stream) {
  const size_t smem = Layout(L, D, h, nc, sizeof(T)).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fastformer_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * nc);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fastformer_attn_fwd_kernel<T>, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(wqa),
                           static_cast<const T*>(bqa), static_cast<const T*>(wka),
                           static_cast<const T*>(bka), static_cast<const int*>(mask),
                           static_cast<T*>(out), L, D, h);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

int elem_size(int dtype) { return dtype == DTYPE_BF16 ? 2 : 4; }

}  // namespace

// Shared memory a CTA takes at these shapes with nc CTAs a batch row.
extern "C" long long fastformer_attn_smem_bytes(int L, int D, int h, int nc, int dtype) {
  return (long long)Layout(L, D, h, nc, elem_size(dtype)).bytes;
}

// q, k and out (B, L, D), wqa and wka (D, h), bqa and bka (h,), all of one
// dtype; mask (B, L) int32; all contiguous; nc CTAs (one cluster) a batch row.
extern "C" int fastformer_attn_fwd(const void* q, const void* k, const void* wqa,
                                   const void* bqa, const void* wka, const void* bka,
                                   const void* mask, void* out, int B, int L, int D, int h,
                                   int nc, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B <= 0 || L <= 0 || D <= 0 || h <= 0 || D % h != 0 || nc < 1 || nc > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32:
      return launch_ff<float>(q, k, wqa, bqa, wka, bka, mask, out, B, L, D, h, nc, s);
    case DTYPE_BF16:
      return launch_ff<__nv_bfloat16>(q, k, wqa, bqa, wka, bka, mask, out, B, L, D, h, nc,
                                      s);
    default:
      return cudaErrorInvalidValue;
  }
}
