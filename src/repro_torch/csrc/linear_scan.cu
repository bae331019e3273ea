// linear_scan: the chunked linear recurrence of RWKV6 time-mix and Mamba2 SSD,
//   S_t = S_{t-1} * diag(a_t) + p_t ⊗ q_t,      y_t = S_{t-1 or t} r_t,
// with p (BH, T, M), q / a / r (BH, T, N), the state S (M, N) in f32 carried
// in from s0 (or zeros) and written out at the end; y_t reads S_{t-1} when
// readout_pre, else S_t.  It computes linear_scan_ref (the sequential scan)
// for any decay in [0, 1].
//
// Replaces linear_scan_pallas (src/repro/kernels/linear_scan/kernel.py:104,
// body _scan_kernel at :38).  The Pallas kernel factors a chunk as
// R' = r·exp(L_prev), Q' = q·exp(-L) so that two MXU products give the
// intra-chunk term, and clamps exp(-L) at e^30.  That clamp is wrong once the
// cumulative log-decay L passes -30 inside a chunk: the pair (t, s = t-1) has
// the true factor exp(L_{t-1} - L_s) = 1, which the clamp turns into
// exp(L_{t-1} + 30).  At the served models' decays (e^-1 a step for RWKV's
// random weights, 0.5 for Mamba2's) its y is off by more than half.  This
// kernel never forms exp(-L): every exponent it takes is a difference
// L_x - L_s with x at or after s, which is <= 0, so nothing overflows and
// nothing is clamped.
//
// Per chunk of c rows (c <= 64; the ragged last chunk is padded with p = q =
// r = 0 and a = 1, which leave S and L unchanged; T = 1 is one chunk of one
// row), with L the inclusive prefix sum of log(max(a, 1e-38)) over the chunk
// and Lr = L_{t-1} (readout_pre, 0 at t = 0) or L_t:
//   A[t, s]  = sum_n r[t,n] q[s,n] exp(Lr[t,n] - L[s,n])   for s < t (pre) or s <= t
//   y[t, m]  = sum_s A[t,s] p[s,m] + sum_n r[t,n] exp(Lr[t,n]) S[m,n]
//   S[m, n] <- S[m,n] exp(L[c-1,n]) + sum_s p[s,m] q[s,n] exp(L[c-1,n] - L[s,n])
//
// Layout: one block per sequence (BH blocks of 256 threads as 16 x 16),
// walking its chunks in order with S in shared memory; that loop takes the
// place of the TPU grid's sequential chunk axis.  Thread (ty, tx) owns the
// 4 x 4 outputs (ty + 16i, tx + 16j) of each product.  Shared memory at
// c = M = N = 64 is 97 KiB (p, q, r, L, A and S, the N-wide rows padded to
// N + 1 so a column walk hits 32 banks), so two blocks fit an SM.  Inputs
// are f32 and contiguous.
//
// Bound on this card: a prefill layer at the served shapes (BH 256, T 2000,
// M = N = 64) reads 0.54 GB and writes 0.13 GB, about 0.2 ms at HBM rate,
// and does about 2 c^2 N + 2 c^2 M + 4 c M N f32 operations a chunk, about
// 0.26 ms at the f32 rate: it is bound by operations.  Besides those, the
// intra-chunk weights take 10/16 of c^2 N exponentials a chunk on the
// special function units (the 4 x 4 thread blocks on and below the
// diagonal; about 1.3e9 a layer), which this first version does not avoid,
// and its products run on the CUDA cores in f32 (no tensor cores).
// A decode step (T = 1) reads and writes its 4 MiB of state: bound by bytes.
#include "common.cuh"

#define CMAX 64
#define DMAX 64
#define NT 256

struct ScanParams {
  const float* p;
  const float* q;
  const float* a;
  const float* r;
  const float* s0;  // (BH, M, N) or null for zeros
  float* y;         // (BH, T, M)
  float* s_fin;     // (BH, M, N)
  int T, M, N, C, pre;
};

__global__ void __launch_bounds__(NT, 2) linear_scan_kernel(ScanParams prm) {
  extern __shared__ float smem[];
  const int M = prm.M, N = prm.N, C = prm.C, T = prm.T;
  const int NP = N + 1, CP = C + 1;
  float* ps = smem;            // [C][M]    p
  float* qs = ps + C * M;      // [C][NP]   q, then q * exp(L[c-1] - L)
  float* rs = qs + C * NP;     // [C][NP]   r, then r * exp(Lr)
  float* Ls = rs + C * NP;     // [C][NP]   a, then L
  float* As = Ls + C * NP;     // [C][CP]   intra-chunk weights
  float* Ss = As + C * CP;     // [M][NP]   the running state

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = blockIdx.x;
  const float* p = prm.p + bh * T * M;
  const float* q = prm.q + bh * T * N;
  const float* a = prm.a + bh * T * N;
  const float* r = prm.r + bh * T * N;
  float* y = prm.y + bh * T * M;

  for (int i = tid; i < M * N; i += NT) {
    const int m = i / N, n = i % N;
    Ss[m * NP + n] = prm.s0 ? prm.s0[bh * M * N + i] : 0.f;
  }

  for (int c0 = 0; c0 < T; c0 += C) {
    const int rows = min(C, T - c0);
    // -- stage the chunk (padded rows leave S and L unchanged) --------------
    for (int i = tid; i < C * M; i += NT) {
      const int t = i / M, m = i % M;
      ps[i] = t < rows ? p[(long long)(c0 + t) * M + m] : 0.f;
    }
    for (int i = tid; i < C * N; i += NT) {
      const int t = i / N, n = i % N;
      const bool live = t < rows;
      const long long g = (long long)(c0 + t) * N + n;
      qs[t * NP + n] = live ? q[g] : 0.f;
      rs[t * NP + n] = live ? r[g] : 0.f;
      Ls[t * NP + n] = live ? a[g] : 1.f;
    }
    __syncthreads();
    // -- L: inclusive prefix sum of log a over the chunk, per channel --------
    if (tid < N) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += logf(fmaxf(Ls[t * NP + tid], 1e-38f));
        Ls[t * NP + tid] = acc;
      }
    }
    __syncthreads();
    // -- A[t, s]: every exponent a difference <= 0 inside the mask ----------
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (ty < rows) {
        for (int n = 0; n < N; ++n) {
          float rt[4], lt[4], qv[4], ls[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = min(ty + 16 * i, C - 1);
            rt[i] = rs[t * NP + n];
            lt[i] = prm.pre ? (t > 0 ? Ls[(t - 1) * NP + n] : 0.f) : Ls[t * NP + n];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = min(tx + 16 * j, C - 1);
            qv[j] = qs[s * NP + n];
            ls[j] = Ls[s * NP + n];
          }
          // blocks j > i lie wholly above the diagonal (s > t): skipped
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j <= i; ++j)
              acc[i][j] = fmaf(rt[i] * qv[j], __expf(fminf(lt[i] - ls[j], 0.f)),
                               acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          const bool vis = prm.pre ? s < t : s <= t;
          if (t < C && s < C) As[t * CP + s] = (vis && t < rows) ? acc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();
    // -- r * exp(Lr) and q * exp(L[c-1] - L) in place ------------------------
    for (int i = tid; i < C * N; i += NT) {
      const int t = i / N, n = i % N;
      const float lr = prm.pre ? (t > 0 ? Ls[(t - 1) * NP + n] : 0.f) : Ls[t * NP + n];
      rs[t * NP + n] *= __expf(lr);
      qs[t * NP + n] *= __expf(Ls[(C - 1) * NP + n] - Ls[t * NP + n]);
    }
    __syncthreads();
    // -- y = A p + (r exp(Lr)) S^T ---------------------------------------------
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      int tr[4], mc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) tr[i] = min(ty + 16 * i, C - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) mc[j] = min(tx + 16 * j, M - 1);
      for (int s = 0; s < rows; ++s) {
        float av[4], pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[tr[i] * CP + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = ps[s * M + mc[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], pv[j], acc[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float rv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rv[i] = rs[tr[i] * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = Ss[mc[j] * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(rv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          if (t < rows && m < M) y[(long long)(c0 + t) * M + m] = acc[i][j];
        }
      }
    }
    __syncthreads();
    // -- S <- S exp(L[c-1]) + p^T (q exp(L[c-1] - L)) -------------------------
    {
      float acc[4][4];
      int mr[4], nc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mr[i] = min(ty + 16 * i, M - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) nc[j] = min(tx + 16 * j, N - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dec = __expf(Ls[(C - 1) * NP + nc[j]]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = Ss[mr[i] * NP + nc[j]] * dec;
      }
      for (int s = 0; s < rows; ++s) {
        float pv[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[s * M + mr[i]];
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[j] = qs[s * NP + nc[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], qv[j], acc[i][j]);
      }
      __syncthreads();  // every thread has read S before any writes it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = tx + 16 * j;
          if (m < M && n < N) Ss[m * NP + n] = acc[i][j];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < M * N; i += NT) {
    const int m = i / N, n = i % N;
    prm.s_fin[bh * M * N + i] = Ss[m * NP + n];
  }
}

extern "C" int repro_linear_scan(const void* p, const void* q, const void* a,
                                 const void* r, const void* s0, void* y,
                                 void* s_fin, int BH, int T, int M, int N,
                                 int C, int pre, void* stream) {
  if (BH < 1 || T < 1 || M < 1 || N < 1 || M > DMAX || N > DMAX || C < 1 ||
      C > CMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanParams prm;
  prm.p = static_cast<const float*>(p);
  prm.q = static_cast<const float*>(q);
  prm.a = static_cast<const float*>(a);
  prm.r = static_cast<const float*>(r);
  prm.s0 = static_cast<const float*>(s0);
  prm.y = static_cast<float*>(y);
  prm.s_fin = static_cast<float*>(s_fin);
  prm.T = T; prm.M = M; prm.N = N; prm.C = C; prm.pre = pre;
  const size_t smem = sizeof(float) * ((size_t)C * M + 3 * (size_t)C * (N + 1) +
                                       (size_t)C * (C + 1) + (size_t)M * (N + 1));
  cudaError_t err = cudaFuncSetAttribute(
      linear_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_scan_kernel<<<BH, NT, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  REPRO_RETURN_LAUNCH_STATUS();
}
