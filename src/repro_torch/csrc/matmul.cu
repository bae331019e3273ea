// matmul: out (M, N) = x (M, K) @ w (K, N), f32 accumulation, output in the
// input dtype.  Replaces matmul_pallas (src/repro/kernels/ring_matmul/
// kernel.py:39, pallas_call at :54); the tile routines, the route rule and
// the design note are in matmul.cuh.  The TPU kernel's sequential K grid
// axis becomes the K loop inside a block.  Tensor-core route: persistent
// 2-CTA clusters, one CTA per SM, walk the output tiles in pairs, both
// operands read through TMA maps built here for each call.  CUDA-core
// route: one block per output tile.
#include "matmul.cuh"

template <typename T>
__global__ void __launch_bounds__(MM_THREADS, 2)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) float mm_smem[];
  mm_tile<T>(x, K, w, N, out, N, M, N, K, blockIdx.y * MM_BM,
             blockIdx.x * MM_BN, mm_smem);
}

template <typename T>
__global__ void __launch_bounds__(TC_THREADS, 1)
matmul_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 T* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem[];
  const TcSmem sm = tc_smem_init(smem);
  const int tiles_m = (M + TC_BM - 1) / TC_BM;
  const int tiles_n = (N + TC_BN - 1) / TC_BN;
  const int nk = (K + TC_BK - 1) / TC_BK;
  const int first = blockIdx.x / TC_CLUSTER, step = gridDim.x / TC_CLUSTER;
  TcPipe pipe;
  int m0, n0;
  if (threadIdx.x == TC_CONSUMERS) {
    for (int t = first; t < tc_pairs(tiles_m, tiles_n); t += step) {
      tc_tile_origin(t, tiles_m, tiles_n, m0, n0);
      tc_load_tile(sm, pipe, &xmap, 0, &wmap, 0, m0, n0, nk);
    }
  } else if (threadIdx.x < TC_CONSUMERS) {
    for (int t = first; t < tc_pairs(tiles_m, tiles_n); t += step) {
      tc_tile_origin(t, tiles_m, tiles_n, m0, n0);
      tc_mma_tile<T>(sm, pipe, nk, out + (long long)m0 * N + n0, N, M - m0,
                     N - n0);
    }
  }
  cluster_sync();  // the peer's last arrivals have landed before either exits
}

template <typename T>
static int launch_simt(const void* x, const void* w, void* out, int M, int N,
                       int K, cudaStream_t stream) {
  const int smem = mm_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  matmul_kernel<T><<<grid, MM_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, N, K);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int launch_tc(const void* x, const void* w, void* out, int M, int N,
                     int K, int dtype, cudaStream_t stream) {
  if (!tc_route_ok(dtype, K, N, {x, w}))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  int err = tc_map(&xmap, x, dtype, 1, M, K, TC_BM);
  if (err == 0) err = tc_map(&wmap, w, dtype, 1, K, N, TC_BK);
  if (err != 0) return err;
  const long long pairs = (long long)((M + TC_BM - 1) / TC_BM + 1)
                          / TC_CLUSTER * ((N + TC_BN - 1) / TC_BN);
  TcLaunch launch(matmul_tc_kernel<T>, stream, false);
  err = launch.size(pairs);
  if (err != 0) return err;
  cudaError_t e = cudaLaunchKernelEx(&launch.cfg, matmul_tc_kernel<T>, xmap,
                                     wmap, static_cast<T*>(out), M, N, K);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_matmul(const void* x, const void* w, void* out, int M,
                            int N, int K, int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) {
    switch (dtype) {
      case kF16: return launch_tc<__half>(x, w, out, M, N, K, dtype, s);
      case kBF16: return launch_tc<__nv_bfloat16>(x, w, out, M, N, K, dtype, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return launch_simt<float>(x, w, out, M, N, K, s);
    case kF16: return launch_simt<__half>(x, w, out, M, N, K, s);
    case kBF16: return launch_simt<__nv_bfloat16>(x, w, out, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
