// linear_scan_bwd: the gradient of the linear scan of csrc/linear_scan.cu,
//   S_t = S_{t-1} * diag(a_t) + p_t ⊗ q_t,      y_t = S_{t-1 or t} r_t,
// given dy (BH, T, M) and the cotangent ds_fin (BH, M, N) of the final state
// (or null for zeros): dp (BH, T, M), dq / dr (BH, T, N), ds0 (BH, M, N) and
// dla (BH, T, N), the gradient with respect to log a of the function the
// forward kernel computes (it takes log max(a, 1e-38)): a * da where
// a >= 1e-38, 0 below, so no da / a is ever formed.  All f32.
//
// Replaces no TPU kernel: the reference differentiates its sequential oracle
// linear_scan_ref (src/repro/kernels/linear_scan/ref.py:23) under AD, the
// gradient of linear_scan_pallas (src/repro/kernels/linear_scan/kernel.py:104).
// It is row 11 of the port's kernel table.
//
// With G the cotangent of the state after row t (ds_fin after the last row),
// going backward G <- G diag(a_t) + dy_t r_tᵀ (the readout term entering G
// before the decay under post-readout, after it under readout_pre); then
// dp_t = G q_t, dq_t = Gᵀ p_t, dr_t = S_{t-1 or t}ᵀ dy_t, ds0 the last G and
// dla_t = a_t Σ_m G ⊙ S_{t-1}.  dla is formed from that product's terms,
// each of which carries a_t's factor: never as the identity's suffix sum
// Σ_{u >= t} (r_u ⊙ dr_u − q_u ⊙ dq_u), whose terms cancel where the decays
// are strong (its error is then a share of dr and dq, not of dla: 4e-4 of
// dla at a = e^-8, every digit at a = 1e-13).
//
// One block of BWD_THREADS a sequence, in two passes over chunks of BWD_C
// rows.  Pass 1 walks the chunks forward and writes each chunk's starting
// state to the caller's scratch (BH, chunks, M, N), as the forward's
// prefill route carries it.  Pass 2 walks them in reverse with the carried
// cotangent K (the G after the chunk's last row) in registers; with L the
// inclusive prefix of log max(a, 1e-38) over the chunk, Lr_u = L_{u-1} (0 at
// u = 0) under readout_pre or L_u, ρ(u) = u - 1 or u the row whose state row
// u reads, and (u, s) visible when s <= ρ(u):
//   E[u, s] = exp(Lr_u − L_s)  (per channel, the visible pairs, kept)
//   A[u, s] = Σ_n r_u q_s E          P[u, s] = dy_u · p_s
//   dp_s    = Σ_u A[u, s] dy_u + K (q_s ⊙ exp(L_end − L_s))
//   dr_u    = exp(Lr_u) ⊙ (S_startᵀ dy_u) + Σ_s P[u, s] q_s ⊙ E[u, s]
//   dq_s    = exp(L_end − L_s) ⊙ (Kᵀ p_s) + Σ_u P[u, s] r_u ⊙ E[u, s]
//   dla_t   = exp(L_end) ⊙ Σ_m K ⊙ S_start + Σ_{s < t} q_s ⊙ dqK_s
//             + Σ_{ρ(u) >= t} r_u ⊙ drS_u + Σ_{s < t <= ρ(u)} P[u, s] r_u q_s E[u, s]
//   K      <- K diag(exp(L_end)) + Σ_u dy_u ⊗ (r_u ⊙ exp(Lr_u))
// with dqK and drS the K and S_start terms of dq and dr.  Every exponent is
// a difference of prefix log-decays that is <= 0.  Every sum runs in a fixed
// order and nothing is atomic, so two runs on equal inputs give equal bits.
// f32 on the CUDA cores: TF32 would change the results.
//
// Bound on this card: at the training shape (BH 256, T 1024, M = N = 64)
// the function reads p, q, a, r, dy (0.34 GB) and writes dp, dq, dla, dr
// (0.27 GB): 0.18 ms at HBM rate; its products (10 M N f32 operations a
// row, the state pass included, the pair terms and dla's, 13.8 GFLOP under
// readout_pre) take 0.21 ms at the f32 rate: operations.  This first kernel
// keeps every operand in shared memory and reads it by scalar loads, so
// shared-memory bandwidth bounds it; the chunk states round trip 0.27 GB
// through device memory, and E (136 pairs x 64 channels) takes 35 KB of the
// 108.5 KB a block (two blocks an SM).
#include <cstdint>

#include "common.cuh"

#define BWD_C 16        // rows of a chunk
#define BWD_DMAX 64     // largest M and N
#define BWD_THREADS 256
#define BWD_TINY 1e-38f

struct ScanBwdParams {
  const float* p;
  const float* q;
  const float* a;
  const float* r;
  const float* s0;      // (BH, M, N) or null for zeros
  const float* dy;      // (BH, T, M)
  const float* ds_fin;  // (BH, M, N) or null for zeros
  float* dp;            // (BH, T, M)
  float* dq;            // (BH, T, N)
  float* dla;           // (BH, T, N)
  float* dr;            // (BH, T, N)
  float* ds0;           // (BH, M, N)
  float* states;        // scratch (BH, chunks, M, N)
  int T, M, N, pre;
};

// shared-memory rows are BWD_DMAX + 1 floats apart (conflict-free scalar
// loads down a column)
#define RS (BWD_DMAX + 1)
#define CS (BWD_C + 1)
#define NPAIR (BWD_C * (BWD_C + 1) / 2)  // the pairs s <= u of a chunk

// floats of dynamic shared memory: p, dy, q, r, L, exp(L_end - L), exp(Lr),
// the S_start term of dr and the K term of dq (BWD_C rows each), A and P,
// K and the chunk's starting state (BWD_DMAX rows each), E (a row a pair)
// and Σ_m K ⊙ S_start
__host__ __device__ inline int scan_bwd_smem_bytes() {
  return 4 * (9 * BWD_C * RS + 2 * BWD_C * CS + 2 * BWD_DMAX * RS
              + NPAIR * RS + RS);
}

// the row of pair (u, s), s <= u, in E
__device__ __forceinline__ int pair_row(int u, int s) {
  return u * (u + 1) / 2 + s;
}

__global__ void __launch_bounds__(BWD_THREADS)
scan_bwd_kernel(ScanBwdParams prm) {
  extern __shared__ __align__(16) float smem[];
  float* sp = smem;                // [BWD_C][RS] p
  float* sy = sp + BWD_C * RS;     // dy
  float* sq = sy + BWD_C * RS;     // q
  float* sr = sq + BWD_C * RS;     // r
  float* sL = sr + BWD_C * RS;     // L, the prefix of log a
  float* sEq = sL + BWD_C * RS;    // exp(L_end - L_s)
  float* sEr = sEq + BWD_C * RS;   // exp(Lr_u)
  float* sdrS = sEr + BWD_C * RS;  // the S_start term of dr
  float* sdqK = sdrS + BWD_C * RS; // the K term of dq
  float* sA = sdqK + BWD_C * RS;   // [BWD_C][CS] A
  float* sP = sA + BWD_C * CS;     // P
  float* sK = sP + BWD_C * CS;     // [BWD_DMAX][RS] K
  float* sS = sK + BWD_DMAX * RS;  // the chunk's starting state
  float* sE = sS + BWD_DMAX * RS;  // [NPAIR][RS] E
  float* sKS = sE + NPAIR * RS;    // [RS] Σ_m K ⊙ S_start

  const int T = prm.T, M = prm.M, N = prm.N;
  const bool pre = prm.pre;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = blockIdx.x;
  const int nchunks = (T + BWD_C - 1) / BWD_C;
  const float* p = prm.p + bh * T * M;
  const float* q = prm.q + bh * T * N;
  const float* a = prm.a + bh * T * N;
  const float* r = prm.r + bh * T * N;
  const float* dy = prm.dy + bh * T * M;
  float* states = prm.states + bh * nchunks * M * N;

  // the state tiles: thread (ty, tx) holds [m = ty + 16 j][n = tx + 16 i]
  float S[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * j, n = tx + 16 * i;
      S[j][i] = (prm.s0 && m < M && n < N) ? prm.s0[(bh * M + m) * N + n] : 0.f;
    }

  // rows [c0, c0 + rows) of x (width W) into a [BWD_C][RS] array
  auto load = [&](float* dst, const float* src, int c0, int rows, int W) {
    for (int i = tid; i < rows * W; i += BWD_THREADS) {
      const int t = i / W, c = i - t * W;
      dst[t * RS + c] = src[(long long)(c0 + t) * W + c];
    }
  };
  // L: log max(a, 1e-38) summed down the rows, a thread a channel
  auto prefix_log = [&](int c0, int rows) {
    for (int i = tid; i < rows * N; i += BWD_THREADS) {
      const int t = i / N, c = i - t * N;
      sL[t * RS + c] = logf(fmaxf(a[(long long)(c0 + t) * N + c], BWD_TINY));
    }
    __syncthreads();
    if (tid < N) {
      float acc = 0.f;
      for (int t = 0; t < rows; ++t) {
        acc += sL[t * RS + tid];
        sL[t * RS + tid] = acc;
      }
    }
    __syncthreads();
  };
  // exp(L_end - L_s) and exp(Lr_u), every exponent <= 0
  auto exp_tables = [&](int rows) {
    for (int i = tid; i < rows * N; i += BWD_THREADS) {
      const int t = i / N, n = i - t * N;
      const float lt = sL[t * RS + n];
      sEq[t * RS + n] = expf(sL[(rows - 1) * RS + n] - lt);
      sEr[t * RS + n] = expf(pre ? (t > 0 ? sL[(t - 1) * RS + n] : 0.f) : lt);
    }
  };

  // -- pass 1: each chunk's starting state, forward -------------------------
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * BWD_C, rows = min(BWD_C, T - c0);
    float* st = states + (long long)ci * M * N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty + 16 * j, n = tx + 16 * i;
        if (m < M && n < N) st[m * N + n] = S[j][i];
      }
    load(sp, p, c0, rows, M);
    load(sq, q, c0, rows, N);
    prefix_log(c0, rows);
    exp_tables(rows);
    __syncthreads();
    // S <- S diag(exp(L_end)) + Σ_s p_s ⊗ (q_s ⊙ exp(L_end - L_s))
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = tx + 16 * i;
      if (n >= N) continue;
      const float dec = expf(sL[(rows - 1) * RS + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) S[j][i] *= dec;
      for (int s = 0; s < rows; ++s) {
        const float qh = sq[s * RS + n] * sEq[s * RS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = ty + 16 * j;
          if (m < M) S[j][i] = fmaf(sp[s * RS + m], qh, S[j][i]);
        }
      }
    }
    __syncthreads();  // this chunk's rows read before the next one lands
  }

  // -- the carried cotangent K = ds_fin ---------------------------------------
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * j, n = tx + 16 * i;
      const float g = (prm.ds_fin && m < M && n < N)
                          ? prm.ds_fin[(bh * M + m) * N + n] : 0.f;
      if (m < M && n < N) sK[m * RS + n] = g;
      S[j][i] = g;  // the registers hold K from here on
    }

  // -- pass 2: the chunks in reverse ------------------------------------------
  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int c0 = ci * BWD_C, rows = min(BWD_C, T - c0);
    const float* st = states + (long long)ci * M * N;
    load(sp, p, c0, rows, M);
    load(sy, dy, c0, rows, M);
    load(sq, q, c0, rows, N);
    load(sr, r, c0, rows, N);
    for (int i = tid; i < M * N; i += BWD_THREADS) {
      const int m = i / N, n = i - m * N;
      sS[m * RS + n] = st[i];
    }
    prefix_log(c0, rows);
    exp_tables(rows);
    // E over the visible pairs (0 elsewhere), and P, a pair a thread
    for (int i = tid; i < NPAIR * N; i += BWD_THREADS) {
      const int pr = i / N, n = i - pr * N;
      int u = 0;
      while ((u + 1) * (u + 2) / 2 <= pr) ++u;
      const int s = pr - u * (u + 1) / 2;
      float e = 0.f;
      if (u < rows && (pre ? s < u : true))
        e = expf((pre ? sL[(u - 1) * RS + n] : sL[u * RS + n])
                 - sL[s * RS + n]);
      sE[pr * RS + n] = e;
    }
    {
      const int u = tid >> 4, s = tid & 15;
      float pv = 0.f;
      if (u < rows && s < rows && (pre ? s < u : s <= u))
        for (int m = 0; m < M; ++m)
          pv = fmaf(sy[u * RS + m], sp[s * RS + m], pv);
      sP[u * CS + s] = pv;
    }
    __syncthreads();
    // A, a pair a thread
    {
      const int u = tid >> 4, s = tid & 15;
      float av = 0.f;
      if (u < rows && s < rows && (pre ? s < u : s <= u)) {
        const float* e = sE + pair_row(u, s) * RS;
        for (int n = 0; n < N; ++n)
          av = fmaf(sr[u * RS + n] * sq[s * RS + n], e[n], av);
      }
      sA[u * CS + s] = av;
    }
    __syncthreads();
    // dp, dr and dq: row tid / 16, columns tid % 16 + 16 k
    {
      const int t = tid >> 4;
      if (t < rows) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int m = tx + 16 * k;
          if (m >= M) continue;
          float acc = 0.f;
          for (int u = 0; u < rows; ++u)
            acc = fmaf(sA[u * CS + t], sy[u * RS + m], acc);
          for (int n = 0; n < N; ++n)
            acc = fmaf(sK[m * RS + n], sq[t * RS + n] * sEq[t * RS + n], acc);
          prm.dp[(bh * T + c0 + t) * M + m] = acc;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = tx + 16 * k;
          if (n >= N) continue;
          // dr_t: the starting state's readout, then the chunk's pairs
          float drs = 0.f;
          for (int m = 0; m < M; ++m)
            drs = fmaf(sS[m * RS + n], sy[t * RS + m], drs);
          drs *= sEr[t * RS + n];
          sdrS[t * RS + n] = drs;
          float acc = drs;
          const int last = pre ? t - 1 : t;
          for (int s = 0; s <= last; ++s)
            acc = fmaf(sP[t * CS + s] * sq[s * RS + n],
                       sE[pair_row(t, s) * RS + n], acc);
          prm.dr[(bh * T + c0 + t) * N + n] = acc;
          // dq_t: the carried cotangent, then the chunk's pairs
          float dqk = 0.f;
          for (int m = 0; m < M; ++m)
            dqk = fmaf(sK[m * RS + n], sp[t * RS + m], dqk);
          dqk *= sEq[t * RS + n];
          sdqK[t * RS + n] = dqk;
          float acq = dqk;
          for (int u = pre ? t + 1 : t; u < rows; ++u)
            acq = fmaf(sP[u * CS + t] * sr[u * RS + n],
                       sE[pair_row(u, t) * RS + n], acq);
          prm.dq[(bh * T + c0 + t) * N + n] = acq;
        }
      }
      if (tid < N) {  // Σ_m K ⊙ S_start
        float ks = 0.f;
        for (int m = 0; m < M; ++m)
          ks = fmaf(sK[m * RS + tid], sS[m * RS + tid], ks);
        sKS[tid] = ks;
      }
    }
    __syncthreads();  // sK, sA read; the dr and dq terms in shared memory
    // dla_t: a (row, channel) a work item
    for (int i = tid; i < rows * N; i += BWD_THREADS) {
      const int t = i / N, n = i - t * N;
      float v = expf(sL[(rows - 1) * RS + n]) * sKS[n];
      for (int s = 0; s < t; ++s)
        v = fmaf(sq[s * RS + n], sdqK[s * RS + n], v);
      for (int u = pre ? t + 1 : t; u < rows; ++u) {
        v = fmaf(sr[u * RS + n], sdrS[u * RS + n], v);
        float w = 0.f;  // the pairs (u, s < t) that straddle t
        for (int s = 0; s < t; ++s)
          w = fmaf(sP[u * CS + s] * sq[s * RS + n],
                   sE[pair_row(u, s) * RS + n], w);
        v = fmaf(sr[u * RS + n], w, v);
      }
      prm.dla[(bh * T + c0 + t) * N + n] =
          a[(long long)(c0 + t) * N + n] < BWD_TINY ? 0.f : v;
    }
    // K <- K diag(exp(L_end)) + Σ_u dy_u ⊗ (r_u ⊙ exp(Lr_u)), in registers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = tx + 16 * i;
      if (n >= N) continue;
      const float dec = expf(sL[(rows - 1) * RS + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) S[j][i] *= dec;
      for (int u = 0; u < rows; ++u) {
        const float rh = sr[u * RS + n] * sEr[u * RS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = ty + 16 * j;
          if (m < M) S[j][i] = fmaf(sy[u * RS + m], rh, S[j][i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty + 16 * j, n = tx + 16 * i;
        if (m < M && n < N) sK[m * RS + n] = S[j][i];
      }
    __syncthreads();  // this chunk's rows read before the previous one lands
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * j, n = tx + 16 * i;
      if (m < M && n < N) prm.ds0[(bh * M + m) * N + n] = S[j][i];
    }
}

extern "C" int repro_linear_scan_bwd(const void* p, const void* q,
                                     const void* a, const void* r,
                                     const void* s0, const void* dy,
                                     const void* ds_fin, void* dp, void* dq,
                                     void* dla, void* dr, void* ds0,
                                     void* states, int BH, int T, int M, int N,
                                     int pre, void* stream) {
  if (BH < 1 || T < 1 || M < 1 || N < 1 || M > BWD_DMAX || N > BWD_DMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanBwdParams prm;
  prm.p = static_cast<const float*>(p);
  prm.q = static_cast<const float*>(q);
  prm.a = static_cast<const float*>(a);
  prm.r = static_cast<const float*>(r);
  prm.s0 = static_cast<const float*>(s0);
  prm.dy = static_cast<const float*>(dy);
  prm.ds_fin = static_cast<const float*>(ds_fin);
  prm.dp = static_cast<float*>(dp);
  prm.dq = static_cast<float*>(dq);
  prm.dla = static_cast<float*>(dla);
  prm.dr = static_cast<float*>(dr);
  prm.ds0 = static_cast<float*>(ds0);
  prm.states = static_cast<float*>(states);
  prm.T = T; prm.M = M; prm.N = N; prm.pre = pre;
  const int smem = scan_bwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_kernel<<<BH, BWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      prm);
  REPRO_RETURN_LAUNCH_STATUS();
}
