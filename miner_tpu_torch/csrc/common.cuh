// Shared helpers for the port's CUDA kernels (plain C interface, no PyTorch
// headers). Included once by each .cu file, each built into its own library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// dtype codes: the same table as miner_tpu_torch/ops/common.py DTYPE_CODES;
// DTYPE_I8 (INT8_CODE there) only for lookup+score's int8 cache rows
enum { DTYPE_F32 = 0, DTYPE_BF16 = 1, DTYPE_I8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision and back, where the reference rounds an
// intermediate to the working type
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// the fill for masked logits: finite, as in the TPU kernels, so a fully
// masked row is a uniform softmax and never 0/0
#define MASK_FILL (-1e9f)

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
