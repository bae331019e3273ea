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
// Two routes, picked on the host by plan.scan_route:
//
// * "prefill" (T > 1).  One block of SCAN_THREADS per sequence walks its
//   chunks of C rows (C <= 64; instances of CI = 16, 32 and 64 rows, the
//   ragged last chunk padded with p = q = r = 0 and a = 1, which leave S and
//   L unchanged).  With L the inclusive prefix sum of log(max(a, 1e-38))
//   over the chunk, Lr = L_{t-1} (readout_pre, 0 at t = 0) or L_t, and
//   sub-chunks of SCAN_SUB rows (b_i = 16 i - 1 the row before sub-chunk i,
//   e_j = 16 j + 15 the last row of sub-chunk j, L_{-1} = 0):
//     A[t, s] = sum_n r q exp(Lr_t - L_s)              t, s in one sub-chunk
//             = sum_n R~_t D_ij Q~_s                    t in i > j, s in j
//       R~_t = r_t exp(Lr_t - L_{b_i}),  Q~_s = q_s exp(L_{e_j} - L_s),
//       D_ij = exp(L_{b_i} - L_{e_j})  (the secondary chunking of Yang et
//       al., Gated Linear Attention, 2023: per-pair exponentials only on the
//       diagonal sub-blocks, about 3.7 x fewer than per pair over the chunk)
//     y_t   = sum_{s} A[t, s] p_s + sum_n (R~_t exp(L_{b_i})) S[:, n]
//     S    <- S exp(L_{c-1}) + sum_s p_s ⊗ (Q~_s exp(L_{c-1} - L_{e_j}))
//   Every exponent is <= 0.  The next chunk's rows land by cp.async in a
//   second buffer while this chunk computes, issued in four parts, one
//   before each of the first four passes; L is a shuffle scan over the
//   rows, a warp a channel at a time; every entry of A is one
//   work item dealt round the block (a strict pair of a diagonal
//   sub-block, a diagonal entry, or an off-diagonal entry), its channels
//   read 16 bytes at a time; the state stays in registers (each thread a
//   4 x 4 tile) and is written transposed to shared memory once a chunk
//   for y's 16-byte loads.  The served shape (M = N = 64) has its own
//   instances with the widths compiled in.  Shared memory at C = M = N = 64
//   is 204 KiB (one block an SM); at C = 32 it is 106 KiB (two), the
//   served chunk (plan.SCAN_CHUNK).  f32 on the CUDA cores: TF32 would
//   change the results.
// * "decode" (T = 1).  The state is streamed: a block of 8 warps takes
//   DEC_ROWS rows of S of one sequence, a half-warp a row, 16-byte loads;
//   S' = S diag(a) + p ⊗ q is written back and y is reduced over the row
//   by shuffles from S (readout_pre) or S'.
//
// Bound on this card: a prefill layer at the served shapes (BH 256, T 2000,
// M = N = 64) reads 0.54 GB and writes 0.13 GB, about 0.2 ms at HBM rate;
// its (c + 1) c (M + N) + 4 c M N f32 operations a chunk take about 0.16 ms
// at the f32 rate with c = 32: bytes.  A decode step reads and writes its
// 4 MiB of state: bytes, 2.5 us.
#include <cstdint>

#include "common.cuh"

#define CMAX 64
#define DMAX 64
#define SCAN_SUB 16
#define SCAN_THREADS 256
#define DEC_ROWS 16

// route codes (plan.SCAN_ROUTES)
enum ScanRoute { kScanPrefill = 0, kScanDecode = 1 };

struct ScanParams {
  const float* p;
  const float* q;
  const float* a;
  const float* r;
  const float* s0;  // (BH, M, N) or null for zeros
  float* y;         // (BH, T, M)
  float* s_fin;     // (BH, M, N)
  int T, M, N, C, pre, vec;
};

// Dynamic shared memory of a prefill block of CI rows, M4 / N4 the widths
// rounded up to 4: two staged chunks (p, then q, a, r in rows of N4 + 4),
// the weights A, R~ and Q~, the state transposed, and the tables (exp(L_b),
// exp(L_end - L_e), D, the chunk's decay).
__host__ __device__ inline int scan_smem_bytes(int CI, int M4, int N4) {
  return 4 * (2 * CI * (M4 + 3 * (N4 + 4)) + CI * (CI + 1) + 2 * CI * (N4 + 4)
              + N4 * M4 + (CI / 16 * (CI / 16 + 3) / 2 + 1) * N4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The k-th pair of a lower triangle in row order: (t, s) with s < t
// (strict: (1,0), (2,0), (2,1), ...) or s <= t ((0,0), (1,0), (1,1), ...).
__device__ __forceinline__ void tri_pair(int k, bool strict, int& t, int& s) {
  int tt = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  while ((tt + 1) * (tt + 2) / 2 <= k) ++tt;
  while (tt * (tt + 1) / 2 > k) --tt;
  s = k - tt * (tt + 1) / 2;
  t = strict ? tt + 1 : tt;
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// exp(a - b) lane by lane (every caller's a - b is <= 0)
__device__ __forceinline__ float4 expd4(float4 a, float4 b) {
  return make_float4(__expf(a.x - b.x), __expf(a.y - b.y), __expf(a.z - b.z),
                     __expf(a.w - b.w));
}

// acc += a * b lane by lane
__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

// A prefill block of CI rows.  D = 64 is the served shape (M = N = 64,
// aligned): the widths are compile-time constants, so every loop over them
// unrolls and every index is a shift; D = 0 takes any M, N <= 64.  Loops
// over channels step by 4: the shared-memory rows are padded to N4 with
// zeros (and log a = 0), so 16-byte loads never read past a row.
template <int CI, int D>
__global__ void __launch_bounds__(SCAN_THREADS, CI >= 64 ? 1 : 2)
scan_prefill_kernel(ScanParams prm) {
  constexpr int NT = SCAN_THREADS;
  constexpr int NSUB = CI / SCAN_SUB;
  constexpr int NPAIR = NSUB * (NSUB - 1) / 2;  // off-diagonal sub-blocks
  constexpr int STRICT = SCAN_SUB * (SCAN_SUB - 1) / 2;  // s < t a sub-block
  constexpr int RY = CI / 16;  // rows of y a thread
  constexpr int CP = CI + 1;
  extern __shared__ __align__(16) float smem[];
  const int T = prm.T, C = prm.C;
  const int M = D ? D : prm.M, N = D ? D : prm.N;
  const bool pre = prm.pre, vec = D ? true : prm.vec;
  const int M4 = (M + 3) & ~3, N4 = (N + 3) & ~3, NQ = N4 + 4, NV = N4 / 4;
  const int set_floats = CI * (M4 + 3 * NQ);
  float* W = smem + 2 * set_floats;  // [CI][CP] the weights A
  float* Rt = W + CI * CP;           // [CI][NQ] R~, then R~ exp(L_b)
  float* Qt = Rt + CI * NQ;          // [CI][NQ] Q~, then Q~ exp(L_end - L_e)
  float* St = Qt + CI * NQ;          // [N4][M4] the state, transposed
  // the tables, N4 apart: exp(L_{b_i}) (NSUB), exp(L_end - L_{e_j}) (NSUB),
  // D for each pair i > j (NPAIR), exp(L_end) (1)
  float* Eb = St + N4 * M4;
  float* Fj = Eb + NSUB * N4;
  float* Dij = Fj + NSUB * N4;
  float* dec = Dij + NPAIR * N4;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = blockIdx.x;
  const float* p = prm.p + bh * T * M;
  const float* q = prm.q + bh * T * N;
  const float* a = prm.a + bh * T * N;
  const float* r = prm.r + bh * T * N;
  float* y = prm.y + bh * T * M;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // rows [t0, t1) of chunk c0 into buffer set `set`, by cp.async (16-byte
  // copies when aligned, else 4-byte); rows past the chunk and columns past
  // M or N land as zeros.  The next chunk is loaded in four such parts,
  // one before each of the first four passes, so no pass stalls on issuing
  // all of them.
  auto load_rows = [&](int set, int c0, int t0, int t1) {
    float* P = smem + set * set_floats;
    float* ops[3] = {P + CI * M4, P + CI * M4 + CI * NQ,
                     P + CI * M4 + 2 * CI * NQ};
    const float* src[3] = {q, a, r};
    const int rows = min(C, T - c0);
    if (vec) {
      const int ms = M4 / 4, ns = N4 / 4;
      for (int i = tid; i < (t1 - t0) * ms; i += NT) {
        const int t = t0 + i / ms, c = 4 * (i % ms);
        const bool ok = t < rows;
        cp_async16(P + t * M4 + c, ok ? p + (long long)(c0 + t) * M + c : p, ok);
      }
      for (int i = tid; i < (t1 - t0) * ns; i += NT) {
        const int t = t0 + i / ns, c = 4 * (i % ns);
        const bool ok = t < rows;
        const long long g = (long long)(c0 + t) * N + c;
#pragma unroll
        for (int o = 0; o < 3; ++o)
          cp_async16(ops[o] + t * NQ + c, ok ? src[o] + g : src[o], ok);
      }
    } else {
      for (int i = tid; i < (t1 - t0) * M4; i += NT) {
        const int t = t0 + i / M4, c = i % M4;
        const bool ok = t < rows && c < M;
        cp_async4(P + t * M4 + c, ok ? p + (long long)(c0 + t) * M + c : p, ok);
      }
      for (int i = tid; i < (t1 - t0) * N4; i += NT) {
        const int t = t0 + i / N4, c = i % N4;
        const bool ok = t < rows && c < N;
        const long long g = (long long)(c0 + t) * N + c;
#pragma unroll
        for (int o = 0; o < 3; ++o)
          cp_async4(ops[o] + t * NQ + c, ok ? src[o] + g : src[o], ok);
      }
    }
    cp_async_commit();
  };
  // part `part` of 4 of the next chunk, if there is one
  auto load_part = [&](int it, int c0, int part) {
    if (c0 + C < T)
      load_rows((it + 1) & 1, c0 + C, part * CI / 4, (part + 1) * CI / 4);
  };

  // the state: thread (ty, tx) holds S[m = 4 tx + j][n = 4 ty + i]
  const bool owns_s = 4 * ty < N4 && 4 * tx < M4;
  float S[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 4 * tx + j, n = 4 * ty + i;
      S[i][j] = (prm.s0 && m < M && n < N) ? prm.s0[(bh * M + m) * N + n] : 0.f;
    }
  for (int i = tid; i < CI * CP; i += NT) W[i] = 0.f;  // A's upper part stays 0
  if (owns_s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(St + (4 * ty + i) * M4 + 4 * tx,
          make_float4(S[i][0], S[i][1], S[i][2], S[i][3]));

  load_rows(0, 0, 0, CI);
  for (int c0 = 0, it = 0; c0 < T; c0 += C, ++it) {
    cp_async_wait_all();
    __syncthreads();  // the chunk landed; St holds the state before it
    load_part(it, c0, 0);
    const int rows = min(C, T - c0);
    float* P = smem + (it & 1) * set_floats;
    float* Q = P + CI * M4;
    float* L = Q + CI * NQ;  // a, then its prefix
    float* Rr = L + CI * NQ;

    // -- L: the prefix of log a over the chunk's rows, a warp a channel at a
    //    time (32 rows a pass, a shuffle scan, the pass's total carried)
    for (int n = tid >> 5; n < N4; n += NT / 32) {
      const int lane = tid & 31;
      float carry = 0.f;
#pragma unroll
      for (int base = 0; base < CI; base += 32) {
        const int t = base + lane;
        float v = (t < CI && t < rows && n < N)
                      ? __logf(fmaxf(L[t * NQ + n], 1e-38f)) : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (t < CI) L[t * NQ + n] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    // -- R~, Q~ and the tables; every exponent a difference <= 0 ----------
    load_part(it, c0, 1);
    for (int i = tid; i < CI * NV; i += NT) {
      const int t = i / NV, n = 4 * (i - t * NV), sub = t / SCAN_SUB;
      const float4 lt = ld4(L + t * NQ + n);
      const float4 lr = !pre ? lt : t > 0 ? ld4(L + (t - 1) * NQ + n) : zero4;
      const float4 lb = sub > 0 ? ld4(L + (SCAN_SUB * sub - 1) * NQ + n) : zero4;
      const float4 le = ld4(L + (SCAN_SUB * sub + SCAN_SUB - 1) * NQ + n);
      st4(Rt + t * NQ + n, mul4(ld4(Rr + t * NQ + n), expd4(lr, lb)));
      st4(Qt + t * NQ + n, mul4(ld4(Q + t * NQ + n), expd4(le, lt)));
    }
    for (int i = tid; i < (2 * NSUB + NPAIR + 1) * NV; i += NT) {
      const int row = i / NV, n = 4 * (i - row * NV);
      const float4 lend = ld4(L + (CI - 1) * NQ + n);
      float4 hi, lo;  // the table entry is exp(hi - lo)
      if (row < NSUB) {
        hi = row > 0 ? ld4(L + (SCAN_SUB * row - 1) * NQ + n) : zero4;
        lo = zero4;
      } else if (row < 2 * NSUB) {
        hi = lend;
        lo = ld4(L + (SCAN_SUB * (row - NSUB) + SCAN_SUB - 1) * NQ + n);
      } else if (row < 2 * NSUB + NPAIR) {
        int bi, bj;
        tri_pair(row - 2 * NSUB, true, bi, bj);
        hi = ld4(L + (SCAN_SUB * bi - 1) * NQ + n);
        lo = ld4(L + (SCAN_SUB * bj + SCAN_SUB - 1) * NQ + n);
      } else {
        hi = lend;
        lo = zero4;
      }
      st4(Eb + row * N4 + n, expd4(hi, lo));
    }
    __syncthreads();

    // -- A, one entry a work item: the strict pairs of the diagonal
    //    sub-blocks (per-pair exponentials), their diagonal (post only:
    //    exp 0 = 1), the off-diagonal blocks (R~ D Q~) ------------------
    load_part(it, c0, 2);
    {
      constexpr int NSTRICT = NSUB * STRICT, NOFF = NPAIR * SCAN_SUB * SCAN_SUB;
      const int ndiag = pre ? 0 : CI;
      for (int k = tid; k < NSTRICT + ndiag + NOFF; k += NT) {
        int t, s;
        float4 acc = zero4;
        if (k < NSTRICT) {
          const int sub = k / STRICT;
          tri_pair(k - sub * STRICT, true, t, s);
          t += SCAN_SUB * sub;
          s += SCAN_SUB * sub;
          const float* lr = L + (pre ? t - 1 : t) * NQ;
          for (int n = 0; n < N4; n += 4)
            fma4(acc, mul4(ld4(Rr + t * NQ + n), ld4(Q + s * NQ + n)),
                 expd4(ld4(lr + n), ld4(L + s * NQ + n)));
        } else if (k < NSTRICT + ndiag) {
          t = s = k - NSTRICT;
          for (int n = 0; n < N4; n += 4)
            fma4(acc, ld4(Rr + t * NQ + n), ld4(Q + s * NQ + n));
        } else {
          const int e = k - NSTRICT - ndiag;
          const int pr = e / (SCAN_SUB * SCAN_SUB);
          const int w = e - pr * SCAN_SUB * SCAN_SUB;
          int bi, bj;
          tri_pair(pr, true, bi, bj);
          t = SCAN_SUB * bi + w / SCAN_SUB;
          s = SCAN_SUB * bj + w % SCAN_SUB;
          const float* dp = Dij + pr * N4;
          for (int n = 0; n < N4; n += 4)
            fma4(acc, mul4(ld4(Rt + t * NQ + n), ld4(dp + n)),
                 ld4(Qt + s * NQ + n));
        }
        W[t * CP + s] = (acc.x + acc.y) + (acc.z + acc.w);
      }
    }
    __syncthreads();

    // -- R~ exp(L_b) and Q~ exp(L_end - L_e) in place -----------------------
    for (int i = tid; i < CI * NV; i += NT) {
      const int t = i / NV, n = 4 * (i - t * NV), sub = t / SCAN_SUB;
      st4(Rt + t * NQ + n, mul4(ld4(Rt + t * NQ + n), ld4(Eb + sub * N4 + n)));
      st4(Qt + t * NQ + n, mul4(ld4(Qt + t * NQ + n), ld4(Fj + sub * N4 + n)));
    }
    __syncthreads();

    // -- y = A p + (r exp(Lr)) S^T: rows RY ty + i, columns 4 tx + j --------
    load_part(it, c0, 3);
    if (4 * tx < M4) {
      const int tb = RY * ty;
      float acc[RY][4] = {};
      for (int s = 0; s < tb + RY; ++s) {  // A is zero past each row's last s
        const float4 pv = ld4(P + s * M4 + 4 * tx);
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          const float w = W[(tb + i) * CP + s];
          acc[i][0] = fmaf(w, pv.x, acc[i][0]);
          acc[i][1] = fmaf(w, pv.y, acc[i][1]);
          acc[i][2] = fmaf(w, pv.z, acc[i][2]);
          acc[i][3] = fmaf(w, pv.w, acc[i][3]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float4 sv = ld4(St + n * M4 + 4 * tx);
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          const float rh = Rt[(tb + i) * NQ + n];
          acc[i][0] = fmaf(rh, sv.x, acc[i][0]);
          acc[i][1] = fmaf(rh, sv.y, acc[i][1]);
          acc[i][2] = fmaf(rh, sv.z, acc[i][2]);
          acc[i][3] = fmaf(rh, sv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int t = tb + i;
        if (t >= rows) continue;
        float* yr = y + (long long)(c0 + t) * M + 4 * tx;
        if (vec) {
          *reinterpret_cast<float4*>(yr) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * tx + j < M) yr[j] = acc[i][j];
        }
      }
    }
    // -- S <- S exp(L_end) + p^T (q exp(L_end - L)), in registers -----------
    if (owns_s) {
      const float4 dv = ld4(dec + 4 * ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) S[i][j] *= at4(dv, i);
      for (int s = 0; s < rows; ++s) {
        const float4 qh = ld4(Qt + s * NQ + 4 * ty);
        const float4 pv = ld4(P + s * M4 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qi = at4(qh, i);
          S[i][0] = fmaf(qi, pv.x, S[i][0]);
          S[i][1] = fmaf(qi, pv.y, S[i][1]);
          S[i][2] = fmaf(qi, pv.z, S[i][2]);
          S[i][3] = fmaf(qi, pv.w, S[i][3]);
        }
      }
    }
    __syncthreads();  // every read of St (and of this chunk's buffers) done
    if (owns_s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(St + (4 * ty + i) * M4 + 4 * tx,
          make_float4(S[i][0], S[i][1], S[i][2], S[i][3]));
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 4 * tx + j, n = 4 * ty + i;
      if (m < M && n < N) prm.s_fin[(bh * M + m) * N + n] = S[i][j];
    }
}

template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_decode_kernel(ScanParams prm) {
  const int M = prm.M, N = prm.N;
  const int lane = threadIdx.x & 31, l = lane & 15;
  const int m = blockIdx.y * DEC_ROWS + (threadIdx.x >> 5) * 2 + (lane >> 4);
  const long long bh = blockIdx.x;
  const bool row = m < M;
  const float pm = row ? prm.p[bh * M + m] : 0.f;
  const float* qv = prm.q + bh * N;
  const float* av = prm.a + bh * N;
  const float* rv = prm.r + bh * N;
  const long long srow = (bh * M + m) * N;
  float part = 0.f;
  if (VEC) {
    const int n = 4 * l;
    if (row && n < N) {
      const float4 a4 = ld4(av + n), q4 = ld4(qv + n), r4 = ld4(rv + n);
      const float4 s4 = prm.s0 ? ld4(prm.s0 + srow + n)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 o;
      o.x = fmaf(pm, q4.x, s4.x * a4.x);
      o.y = fmaf(pm, q4.y, s4.y * a4.y);
      o.z = fmaf(pm, q4.z, s4.z * a4.z);
      o.w = fmaf(pm, q4.w, s4.w * a4.w);
      const float4 u = prm.pre ? s4 : o;
      part = u.x * r4.x + u.y * r4.y + u.z * r4.z + u.w * r4.w;
      *reinterpret_cast<float4*>(prm.s_fin + srow + n) = o;
    }
  } else {
    for (int n = l; n < N; n += 16) {
      if (!row) break;
      const float s = prm.s0 ? prm.s0[srow + n] : 0.f;
      const float o = fmaf(pm, qv[n], s * av[n]);
      part += (prm.pre ? s : o) * rv[n];
      prm.s_fin[srow + n] = o;
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (row && l == 0) prm.y[bh * M + m] = part;
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int CI, int D>
static int launch_prefill(const ScanParams& prm, int BH, cudaStream_t stream) {
  const int smem = scan_smem_bytes(CI, (prm.M + 3) & ~3, (prm.N + 3) & ~3);
  cudaError_t err = cudaFuncSetAttribute(
      scan_prefill_kernel<CI, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_prefill_kernel<CI, D><<<BH, SCAN_THREADS, smem, stream>>>(prm);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <int CI>
static int launch_prefill(const ScanParams& prm, int BH, cudaStream_t stream) {
  if (prm.vec && prm.M == 64 && prm.N == 64)
    return launch_prefill<CI, 64>(prm, BH, stream);
  return launch_prefill<CI, 0>(prm, BH, stream);
}

extern "C" int repro_linear_scan(const void* p, const void* q, const void* a,
                                 const void* r, const void* s0, void* y,
                                 void* s_fin, int BH, int T, int M, int N,
                                 int C, int pre, int route, void* stream) {
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
  prm.vec = M % 4 == 0 && N % 4 == 0 && aligned16(p) && aligned16(q) &&
            aligned16(a) && aligned16(r) && aligned16(y) && aligned16(s_fin) &&
            (s0 == nullptr || aligned16(s0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kScanDecode) {
    if (T != 1) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(BH, (M + DEC_ROWS - 1) / DEC_ROWS);
    if (prm.vec)
      scan_decode_kernel<true><<<grid, SCAN_THREADS, 0, s>>>(prm);
    else
      scan_decode_kernel<false><<<grid, SCAN_THREADS, 0, s>>>(prm);
    REPRO_RETURN_LAUNCH_STATUS();
  }
  if (route != kScanPrefill) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 16) return launch_prefill<16>(prm, BH, s);
  if (C <= 32) return launch_prefill<32>(prm, BH, s);
  return launch_prefill<64>(prm, BH, s);
}
