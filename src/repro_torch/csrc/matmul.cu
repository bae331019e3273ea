// matmul: out (M, N) = x (M, K) @ w (K, N), f32 accumulation, output in the
// input dtype.  Replaces matmul_pallas (src/repro/kernels/ring_matmul/
// kernel.py:39, pallas_call at :54); the tile routine and its design note
// are in matmul.cuh.  One block per output tile: the TPU kernel's
// sequential K grid axis becomes the K loop inside the block.
#include "matmul.cuh"

template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) MmSmem sm;
  mm_tile<T>(x, K, w, N, out, N, M, N, K, blockIdx.y * MM_BM,
             blockIdx.x * MM_BN, sm);
}

template <typename T>
static void launch(const void* x, const void* w, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  matmul_kernel<T><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, N, K);
}

extern "C" int repro_matmul(const void* x, const void* w, void* out, int M,
                            int N, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: launch<float>(x, w, out, M, N, K, s); break;
    case kF16: launch<__half>(x, w, out, M, N, K, s); break;
    case kBF16: launch<__nv_bfloat16>(x, w, out, M, N, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  REPRO_RETURN_LAUNCH_STATUS();
}
