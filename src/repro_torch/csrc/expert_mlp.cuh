// The grouped expert-MLP tile routines shared by expert_mlp.cu and
// moe_dispatch.cu.
//
// They replace the body of the TPU kernel _expert_mlp_kernel
// (src/repro/kernels/moe_dispatch/kernel.py:27, launched at :44) and the
// grouped MLP the fused dispatch kernel inlines (_grouped_mlp,
// src/repro/kernels/moe_dispatch/fused.py:186): per expert,
//   g = x @ w_gate, u = x @ w_up      (f32 accumulation)
//   h = silu(g) * u, rounded to x's dtype
//   y = h @ w_down                    (f32 accumulation, cast)
// in two passes: gate_up_tile writes h for one (EX_BM x EX_BN) tile of
// (rows, f) into a scratch buffer in device memory, down_tile reads h back
// for one (EX_BM x EX_BN) tile of (rows, d).  A caller runs every gate/up
// tile, synchronises, then every down tile.
//
// Live rows.  Each problem (one expert's row block) carries a live-row
// count: rows at or past it are zero in the dispatch layouts, so their
// output is exactly zero (silu(0) * 0 @ w_down = 0).  The routines compute
// no product for them: a tile wholly past the count skips its K loop, and
// a thread whose four rows are all past it skips its FMAs; down_tile
// writes those rows as zeros.
//
// Row independence.  Every output element is one thread's sum over K in
// increasing k, with no split of K across threads or blocks, so a row's
// result depends on that row and the weights alone: the fused dispatch
// kernel and this kernel give the same bits for the same row.
//
// Bound on this card: bytes at decode, operations at a prefill chunk.  A
// (token, choice) pair costs 2 * 3 * d * f flops; the weights of every
// expert that receives a row are read once (3 d f elements).  At
// qwen3-moe's d = 4096, f = 1536 a decode step's 32 pairs touch at most 32
// experts (1.2 GB, 0.36 ms at 3.35 TB/s) and a 512-token chunk's 4096
// pairs do 155 GFLOP (0.16 ms at 989 TFLOP/s).  This first version runs on
// the CUDA cores, not the tensor cores (wgmma and TMA are later work): 256
// threads each keep a 4 x 4 accumulator (two of them in the gate/up pass)
// and read their A and B fragments as float4s from f32 tiles in shared
// memory, 24.5 KiB a block.  A K step of 32 keeps 24 loads a thread in
// flight between barriers (the loop waits on its loads, and at decode
// there is little arithmetic to hide them under), and the x tile's rows
// are padded by 4 floats so its transposed stores spread over 8 banks.
#pragma once

#include "common.cuh"

#define EX_BM 64
#define EX_BK 32
#define EX_BN 64
#define EX_PAD 4
#define EX_THREADS 256

struct ExSmem {
  float a[EX_BK][EX_BM + EX_PAD];  // x or h tile, transposed: a[k][m]
  float b[EX_BK][EX_BN];  // w_gate or w_down tile
  float c[EX_BK][EX_BN];  // w_up tile
};

// One problem: one expert's row block and that expert's weights.
template <typename T>
struct ExProblem {
  const T* x;   // (C, d) input rows
  const T* wg;  // (d, f)
  const T* wu;  // (d, f)
  const T* wd;  // (f, d)
  T* h;         // (C, f) scratch
  T* y;         // (C, d) output
  int live;     // rows [0, live) carry tokens
};

__device__ __forceinline__ float ex_silu(float g) { return g / (1.f + expf(-g)); }

// A tile (EX_BM rows x EX_BK of K), transposed into sm.a; rows >= live and
// k >= K read as zero.
template <typename T>
__device__ __forceinline__ void ex_load_a(const T* __restrict__ A, long long lda,
                                          int live, int K, int m0, int k0,
                                          ExSmem& sm) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (EX_BM * EX_BK) / EX_THREADS; ++i) {
    int e = t + i * EX_THREADS;
    int m = e / EX_BK, k = e % EX_BK;
    int gm = m0 + m, gk = k0 + k;
    sm.a[k][m] = (gm < live && gk < K) ? to_f32(A[gm * lda + gk]) : 0.f;
  }
}

// B tile (EX_BK of K x EX_BN columns) of a row-major (K, N) matrix.
template <typename T>
__device__ __forceinline__ void ex_load_b(const T* __restrict__ B, int K, int N,
                                          int k0, int n0, float (*dst)[EX_BN]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (EX_BK * EX_BN) / EX_THREADS; ++i) {
    int e = t + i * EX_THREADS;
    int k = e / EX_BN, n = e % EX_BN;
    int gk = k0 + k, gn = n0 + n;
    dst[k][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * N + gn]) : 0.f;
  }
}

// h[m0:m0+BM, n0:n0+BN] = round(silu(x wg) * (x wu)) for the live rows.
// Every thread of the block must call it (it syncs).
template <typename T>
__device__ void gate_up_tile(const ExProblem<T>& p, int d, int f, int m0,
                             int n0, ExSmem& sm) {
  if (m0 >= p.live) return;  // uniform over the block
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // 16 x 16 threads, 4 x 4 outputs each
  const bool busy = m0 + ty * 4 < p.live;
  float ag[4][4], au[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ag[i][j] = au[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += EX_BK) {
    ex_load_a<T>(p.x, d, p.live, d, m0, k0, sm);
    ex_load_b<T>(p.wg, d, f, k0, n0, sm.b);
    ex_load_b<T>(p.wu, d, f, k0, n0, sm.c);
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int k = 0; k < EX_BK; ++k) {
        float4 a = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
        float4 bg = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
        float4 bu = *reinterpret_cast<const float4*>(&sm.c[k][tx * 4]);
        float av[4] = {a.x, a.y, a.z, a.w};
        float gv[4] = {bg.x, bg.y, bg.z, bg.w};
        float uv[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ag[i][j] += av[i] * gv[j];
            au[i][j] += av[i] * uv[j];
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= p.live) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < f)
        p.h[(long long)gm * f + gn] = from_f32<T>(ex_silu(ag[i][j]) * au[i][j]);
    }
  }
}

// y[m0:m0+BM, n0:n0+BN] = h @ wd for the live rows, zeros for the rows
// [live, C).  Every thread of the block must call it (it syncs).
template <typename T>
__device__ void down_tile(const ExProblem<T>& p, int C, int f, int d, int m0,
                          int n0, ExSmem& sm) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (m0 < p.live) {  // uniform over the block
    const bool busy = m0 + ty * 4 < p.live;
    for (int k0 = 0; k0 < f; k0 += EX_BK) {
      ex_load_a<T>(p.h, f, p.live, f, m0, k0, sm);
      ex_load_b<T>(p.wd, f, d, k0, n0, sm.b);
      __syncthreads();
      if (busy) {
#pragma unroll
        for (int k = 0; k < EX_BK; ++k) {
          float4 a = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
          float4 b = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
          float av[4] = {a.x, a.y, a.z, a.w};
          float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < d)
        p.y[(long long)gm * d + gn] = from_f32<T>(gm < p.live ? acc[i][j] : 0.f);
    }
  }
}

// Work items.  A pass runs NW weight sets (experts) x NS problems sharing
// each set (sources) x row tiles x column tiles; items that share a weight
// column tile are adjacent, so the blocks reading one weight tile from L2
// run together.  get(wp, sp) returns problem sp of weight set wp.
__host__ __device__ __forceinline__ long long ex_gate_up_items(long long NW, int NS,
                                                               int C, int f) {
  return NW * NS * ((C + EX_BM - 1) / EX_BM) * ((f + EX_BN - 1) / EX_BN);
}

__host__ __device__ __forceinline__ long long ex_down_items(long long NW, int NS,
                                                            int C, int d) {
  return NW * NS * ((C + EX_BM - 1) / EX_BM) * ((d + EX_BN - 1) / EX_BN);
}

template <typename T, typename Get>
__device__ void gate_up_item(long long item, int NS, int C, int d, int f,
                             const Get& get, ExSmem& sm) {
  const int mt = (C + EX_BM - 1) / EX_BM, nt = (f + EX_BN - 1) / EX_BN;
  const int mtile = (int)(item % mt);
  item /= mt;
  const int sp = (int)(item % NS);
  item /= NS;
  const int ntile = (int)(item % nt);
  const ExProblem<T> p = get(item / nt, sp);
  gate_up_tile<T>(p, d, f, mtile * EX_BM, ntile * EX_BN, sm);
}

template <typename T, typename Get>
__device__ void down_item(long long item, int NS, int C, int d, int f,
                          const Get& get, ExSmem& sm) {
  const int mt = (C + EX_BM - 1) / EX_BM, nt = (d + EX_BN - 1) / EX_BN;
  const int mtile = (int)(item % mt);
  item /= mt;
  const int sp = (int)(item % NS);
  item /= NS;
  const int ntile = (int)(item % nt);
  const ExProblem<T> p = get(item / nt, sp);
  down_tile<T>(p, C, f, d, mtile * EX_BM, ntile * EX_BN, sm);
}
