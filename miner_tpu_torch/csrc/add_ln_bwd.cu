// Fused dropout + residual add + LayerNorm, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel miner_tpu/ops/add_ln.py:_bwd_kernel (pallas_call
// at add_ln.py:144). For y = LayerNorm(x + dropout(h)) over rows of D
// features and the gradient dy, with s = x + dropout(h) recomputed in fp32:
//   mu = mean(s), rstd = 1 / sqrt(mean((s - mu)^2) + eps)    (two passes)
//   xhat = (s - mu) rstd,  g = dy gamma
//   ds = rstd (g - mean(g) - xhat mean(g xhat))
//   dx = ds,  dh = keep ? ds / (1 - rate) : 0
//   dgamma = sum over rows of dy xhat,  dbeta = sum over rows of dy
// The keep mask is regenerated from the seed with the add_ln Philox layout
// (philox.cuh: add_ln_bits, mirrored by ops/philox.py:add_ln_bits), the one
// the Triton forward and the plain version (ops/add_ln.py) draw, so nothing
// random is stored.
//
// What bounds it: bytes. At the sapo training shape (T = 112,640 rows of
// D = 768, bf16) it reads x, h and dy and writes dx and dh: 865 MB, 0.258 ms
// at 3.35 TB/s. The arithmetic, ~20 flop and a quarter of a Philox call per
// element, is far under the card's ridge, but only if it overlaps the loads.
//
// Design: a persistent grid of 4-warp blocks, as many as fit on the SMs at
// once; one warp per row at a time, rows strided over all warps. Lane l
// owns the 16-byte vectors l, l + 32, ... of a row (8 bf16 or 4 fp32
// values each), so every load and store is one coalesced 16-byte access,
// no column is padded (D = 768 in bf16: 96 vectors, three a lane), and the
// 8 bf16 columns of a vector take exactly two Philox calls, all four words
// of each used. The four row sums (mean, centred variance, mean(g),
// mean(g xhat)) are warp shuffles. In bf16 at D <= 768 the warp issues the
// next row's loads before this row's arithmetic, so a row is in flight
// while the last one reduces, and dgamma and dbeta stay in the lane's
// registers for its own columns over every row the warp visits. Wider rows
// (fp32 at D = 768: 24 columns a lane) would spill that way: there dy is
// loaded once x and h are spent, and dgamma and dbeta are summed in the
// warp's own slice of shared memory (Plan below). Either way they are
// summed over the block's warps in shared memory and go out as one
// (2, blocks, D) fp32 partial per block, which the wrapper sums: blocks run
// in no order, so no sum is carried across the grid (the TPU kernel's
// partials are summed outside it too, add_ln.py:168).
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;  // an SM's blocks: at most 170 registers a thread
constexpr int MAX_D = 1024;  // 32 columns a lane at most: the keep bits are one word

// The Philox counter takes a row's place in the whole batch: the launch's
// row plus row_offset (a rank's rows of a batch). OFF false, a launch over
// the whole batch, is built without the add.
template <bool OFF>
struct Dropout {
  unsigned long long seed;
  unsigned int thresh;
  float inv_keep;  // 1 when off
  int on;
  int row_offset;
  __device__ __forceinline__ int row(int r) const { return OFF ? r + row_offset : r; }
};

// 16 bytes of T as floats
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // low half: the lower column
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int D) { return sizeof(float) * (size_t)D * (1 + 2 * WARPS); }

// How a kernel of type T and NJ vectors a lane spends its registers (at
// most 170 a thread: three blocks, 12 warps an SM). In bf16 up to D = 768
// (three vectors a lane) a warp holds the next row's x, h and dy in
// registers while it works on this one, and its dgamma and dbeta sums too.
// Wider (fp32 at D = 768: six vectors a lane) that spills: the registers
// go to the row at hand, dy is loaded once x and h are spent, and dgamma
// and dbeta are summed in the warp's own slice of shared memory (each
// lane its own columns, no atomics).
template <typename T, int NJ>
struct Plan {
  static constexpr bool in_regs = sizeof(T) == 2 && NJ <= 3;
};

// NJ: 16-byte vectors a lane owns, ceil(D / (32 * Vec<T>::N)).
template <typename T, int NJ, bool OFF>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
add_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                  const float* __restrict__ gamma, const T* __restrict__ dy,
                  T* __restrict__ dx, T* __restrict__ dh, float* __restrict__ partial,
                  int rows, int D, float eps, Dropout<OFF> drop) {
  constexpr int V = Vec<T>::N;
  constexpr bool IN_REGS = Plan<T, NJ>::in_regs;  // next row and sums in registers
  extern __shared__ float smem[];
  float* sGamma = smem;    // (D)
  float* sSum = smem + D;  // (WARPS, 2, D): each warp's dgamma, dbeta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / V;
  const float inv_d = 1.f / static_cast<float>(D);
  for (int c = threadIdx.x; c < D; c += THREADS) sGamma[c] = gamma[c];
  for (int c = threadIdx.x; c < 2 * WARPS * D; c += THREADS) sSum[c] = 0.f;
  __syncthreads();
  float* sDg = sSum + 2 * warp * D;  // this warp's dgamma, then its dbeta
  float* sDb = sDg + D;

  float dg[IN_REGS ? NJ : 1][V], db[IN_REGS ? NJ : 1][V];
#pragma unroll
  for (int j = 0; j < (IN_REGS ? NJ : 1); ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) dg[j][e] = db[j][e] = 0.f;

  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* h4 = reinterpret_cast<const uint4*>(h);
  const uint4* dy4 = reinterpret_cast<const uint4*>(dy);
  auto load_xh = [&](int r, uint4(&ax)[NJ], uint4(&ah)[NJ]) {
    const long base = (long)r * nvec;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int v = lane + 32 * j;
      if (v < nvec) {
        ax[j] = __ldg(x4 + base + v);
        ah[j] = __ldg(h4 + base + v);
      }
    }
  };
  auto load_dy = [&](int r, uint4(&ad)[NJ]) {
    const long base = (long)r * nvec;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < nvec) ad[j] = __ldg(dy4 + base + lane + 32 * j);
  };

  const int stride = gridDim.x * WARPS;
  int row = blockIdx.x * WARPS + warp;
  uint4 cx[NJ], ch[NJ], cd[NJ];
  if (row < rows) {
    load_xh(row, cx, ch);
    if constexpr (IN_REGS) load_dy(row, cd);
  }
  for (; row < rows; row += stride) {
    const int next = row + stride;
    uint4 nx[NJ], nh[NJ], nd[NJ];
    if constexpr (IN_REGS) {
      if (next < rows) {
        load_xh(next, nx, nh);
        load_dy(next, nd);
      }
    }
    // s = x + dropout(h); bit j V + e of keep: column (lane + 32 j) V + e
    float s[NJ][V];
    uint32_t keep = 0xffffffffu;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int v = lane + 32 * j;
#pragma unroll
      for (int e = 0; e < V; ++e) s[j][e] = 0.f;
      if (v < nvec) {
        float fx[V], fh[V];
        Vec<T>::unpack(cx[j], fx);
        Vec<T>::unpack(ch[j], fh);
        if (drop.on) {
#pragma unroll
          for (int p = 0; p < V / 4; ++p) {
            const Philox4 b = add_ln_bits(v * (V / 4) + p, drop.row(row), drop.seed);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (b.w[i] < drop.thresh) keep &= ~(1u << (j * V + 4 * p + i));
          }
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float hv = (keep >> (j * V + e)) & 1u ? fh[e] * drop.inv_keep : 0.f;
          s[j][e] = fx[e] + hv;
          sum += s[j][e];
        }
      }
    }
    if constexpr (!IN_REGS) load_dy(row, cd);  // into the registers x and h held
    const float mu = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (lane + 32 * j < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[j][e] -= mu;
          sq += s[j][e] * s[j][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    // xhat in s; dgamma, dbeta; the sums of g and g xhat
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int v = lane + 32 * j;
      if (v < nvec) {
        float fd[V];
        Vec<T>::unpack(cd[j], fd);
        const float* gm = sGamma + v * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = s[j][e] * rstd;
          s[j][e] = xh;
          if constexpr (IN_REGS) {
            dg[j][e] += fd[e] * xh;
            db[j][e] += fd[e];
          } else {
            sDg[v * V + e] += fd[e] * xh;
            sDb[v * V + e] += fd[e];
          }
          const float g = fd[e] * gm[e];
          sg += g;
          sgx += g * xh;
        }
      }
    }
    const float mg = warp_sum(sg) * inv_d;
    const float mgx = warp_sum(sgx) * inv_d;
    const long base = (long)row * nvec;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int v = lane + 32 * j;
      if (v < nvec) {
        float fd[V], ox[V], oh[V];
        Vec<T>::unpack(cd[j], fd);
        const float* gm = sGamma + v * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float ds = rstd * (fd[e] * gm[e] - mg - s[j][e] * mgx);
          ox[e] = ds;
          oh[e] = (keep >> (j * V + e)) & 1u ? ds * drop.inv_keep : 0.f;
        }
        reinterpret_cast<uint4*>(dx)[base + v] = Vec<T>::pack(ox);
        reinterpret_cast<uint4*>(dh)[base + v] = Vec<T>::pack(oh);
      }
    }
    if constexpr (IN_REGS) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        cx[j] = nx[j];
        ch[j] = nh[j];
        cd[j] = nd[j];
      }
    } else {
      if (next < rows) load_xh(next, cx, ch);
    }
  }

  // the block's dgamma, dbeta: each warp's columns, summed over warps in order
  if constexpr (IN_REGS) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int v = lane + 32 * j;
      if (v < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sDg[v * V + e] = dg[j][e];
          sDb[v * V + e] = db[j][e];
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += sSum[(2 * w) * D + c];
      b += sSum[(2 * w + 1) * D + c];
    }
    partial[(long)blockIdx.x * D + c] = a;
    partial[((long)gridDim.x + blockIdx.x) * D + c] = b;
  }
}

struct Args {
  const void *x, *h, *gamma, *dy;
  void *dx, *dh, *partial;
  int rows, D, blocks, device;
  float eps;
  Dropout<true> drop;
  cudaStream_t stream;
  int* grid_out;  // non-null: only report the grid size
};

template <typename T, int NJ>
cudaError_t run(const Args& a) {
  if constexpr (NJ * Vec<T>::N > 32) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = smem_bytes(a.D);
    if (a.grid_out != nullptr) {
      int per_sm = 0, sms = 0;
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, add_ln_bwd_kernel<T, NJ, false>, THREADS, smem);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
      if (err != cudaSuccess) return err;
      const int need = (a.rows + WARPS - 1) / WARPS;
      *a.grid_out = need < per_sm * sms ? need : per_sm * sms;
      if (*a.grid_out < 1) *a.grid_out = 1;
      return cudaSuccess;
    }
    const Dropout<true>& d = a.drop;
    if (d.on && d.row_offset)
      add_ln_bwd_kernel<T, NJ, true><<<a.blocks, THREADS, smem, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.h),
          static_cast<const float*>(a.gamma), static_cast<const T*>(a.dy),
          static_cast<T*>(a.dx), static_cast<T*>(a.dh), static_cast<float*>(a.partial),
          a.rows, a.D, a.eps, d);
    else
      add_ln_bwd_kernel<T, NJ, false><<<a.blocks, THREADS, smem, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.h),
          static_cast<const float*>(a.gamma), static_cast<const T*>(a.dy),
          static_cast<T*>(a.dx), static_cast<T*>(a.dh), static_cast<float*>(a.partial),
          a.rows, a.D, a.eps, Dropout<false>{d.seed, d.thresh, d.inv_keep, d.on, 0});
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t by_width(const Args& a) {
  constexpr int V = Vec<T>::N;
  if (a.D <= 0 || a.D % V != 0 || a.D > MAX_D) return cudaErrorInvalidValue;
  switch ((a.D / V + 31) / 32) {
    case 1: return run<T, 1>(a);
    case 2: return run<T, 2>(a);
    case 3: return run<T, 3>(a);
    case 4: return run<T, 4>(a);
    case 5: return run<T, 5>(a);
    case 6: return run<T, 6>(a);
    case 7: return run<T, 7>(a);
    case 8: return run<T, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Args& a, int dtype) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return err;
  if (a.rows <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case DTYPE_F32: return by_width<float>(a);
    case DTYPE_BF16: return by_width<__nv_bfloat16>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of blocks add_ln_bwd launches for `rows` rows of D: the rows
// of the (2, blocks, D) partial buffer the caller allocates.
extern "C" int add_ln_bwd_blocks(int rows, int D, int dtype, int device, int* blocks) {
  Args a{};
  a.rows = rows;
  a.D = D;
  a.device = device;
  a.grid_out = blocks;
  return dispatch(a, dtype);
}

// x, h, dy, dx, dh (rows, D) of one dtype, 16-byte aligned, D a multiple of
// 8 (bf16) or 4 (fp32) up to 1024; gamma (D) fp32; partial (2, blocks, D)
// fp32, blocks from add_ln_bwd_blocks: per block, dgamma then dbeta sums.
// Dropout is on when `dropping` is non-zero: keep iff bits >= thresh, kept
// values scaled by inv_keep; row r's mask is drawn at row r + row_offset (a
// launch over some rows of a batch draws their masks of the whole batch's).
extern "C" int add_ln_bwd(const void* x, const void* h, const void* gamma, const void* dy,
                          void* dx, void* dh, void* partial, int rows, int D, int blocks,
                          float eps, unsigned long long seed, unsigned int thresh,
                          float inv_keep, int dropping, int row_offset, int dtype,
                          int device, void* stream) {
  if (blocks <= 0) return cudaErrorInvalidValue;
  Args a{x, h, gamma, dy, dx, dh, partial, rows, D, blocks, device, eps,
         Dropout<true>{seed, thresh, dropping ? inv_keep : 1.f, dropping != 0, row_offset},
         static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(a, dtype);
}
