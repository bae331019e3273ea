// Shared helpers of the port's CUDA kernels: dtype codes and conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (repro_torch/kernels/_build.py DTYPE_CODES)
enum ReproDtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The launch returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch (too many threads, too much shared memory, bad grid).
#define REPRO_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
