// The blocked GEMM tile routine shared by matmul.cu and ring_matmul.cu.
//
// Replaces the tile loop of the TPU kernel _mm_kernel
// (src/repro/kernels/ring_matmul/kernel.py:22, launched at :54): one
// (MM_BM x MM_BN) output tile, K walked in MM_BK steps, f32 accumulator in
// registers, output cast to the input dtype, ragged edges masked on load and
// store instead of padded.
//
// Bound on this card: operations.  (M, K) @ (K, N) does 2MNK flops on
// (MK + KN + MN) elements; at the main path's 7560 x 30240 x 7560 bf16 that
// is 3.5 ms at 989 TFLOP/s.  This first version runs on the CUDA cores, not
// the tensor cores (wgmma is later work), so it sits far above that bound:
// each of 256 threads keeps a 4 x 4 accumulator and reads its A and B
// fragments as one float4 each from shared memory per k, so 16 FMAs cost two
// shared loads.  Tiles are staged in f32, 8 KiB per block (MM_TILE in
// repro_torch/kernels/plan.py must match the defines below).
#pragma once

#include "common.cuh"

#define MM_BM 64
#define MM_BK 16
#define MM_BN 64
#define MM_THREADS 256

struct MmSmem {
  float a[MM_BK][MM_BM];  // A tile, transposed: a[k][m]
  float b[MM_BK][MM_BN];
};

// C[m0:m0+BM, n0:n0+BN] = A[m0:, :K] @ B[:K, n0:] for row-major A (lda),
// B (ldb), C (ldc).  Every thread of the block must call it (it syncs).
template <typename T>
__device__ void mm_tile(const T* __restrict__ A, long long lda,
                        const T* __restrict__ B, long long ldb,
                        T* __restrict__ C, long long ldc,
                        int M, int N, int K, int m0, int n0, MmSmem& sm) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // 16 x 16 threads, 4 x 4 outputs each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MM_BK) {
#pragma unroll
    for (int i = 0; i < (MM_BM * MM_BK) / MM_THREADS; ++i) {
      int e = t + i * MM_THREADS;
      int m = e / MM_BK, k = e % MM_BK;  // k fastest: coalesced rows of A
      int gm = m0 + m, gk = k0 + k;
      sm.a[k][m] = (gm < M && gk < K) ? to_f32(A[gm * lda + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (MM_BK * MM_BN) / MM_THREADS; ++i) {
      int e = t + i * MM_THREADS;
      int k = e / MM_BN, n = e % MM_BN;  // n fastest: coalesced rows of B
      int gk = k0 + k, gn = n0 + n;
      sm.b[k][n] = (gk < K && gn < N) ? to_f32(B[gk * ldb + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MM_BK; ++k) {
      float4 a = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
      float4 b = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
      float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < N) C[gm * ldc + gn] = from_f32<T>(acc[i][j]);
    }
  }
}
