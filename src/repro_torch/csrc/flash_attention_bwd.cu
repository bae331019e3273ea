// flash_attention_bwd: the gradient of flash_attention.cu's forward,
//   dq, dk, dv of  out[n, t, h] = softmax_k(scale q[n, t, h] . k[n, k, h / G])
//                                  v[n, k, h / G]
// over the keys visible to query position q_pos = q_offset[n] + t (the
// forward's masks: k < valid_len[n] and, when causal, k <= q_pos or both in
// the prefix window [0, prefix_len)).
//
// It is the gradient of the forward that replaces flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py:80, pallas_call at :125), a
// kernel with no backward on the TPU: the reference trains through its
// plain oracle (flash_attention_ref) under jax.value_and_grad.  So there is
// no TPU kernel to translate, and the formulas are the standard ones, with
// P recomputed from the forward's row log-sum-exp (lse = m + log l, which
// flash_attention.cu writes beside the output):
//   P   = exp(scale q k^T - lse)  (0 where masked)
//   dv  = P^T dO
//   dP  = dO v^T
//   dS  = P o (dP - delta),  delta = rowsum(dO o O)
//   dq  = scale dS k,   dk = scale dS^T q.
//
// Three passes, no atomics, so every gradient is the same bit for bit from
// run to run:
//   1. delta_kernel: one warp a (n, t, h) row, delta in f32;
//   2. dkdv_kernel: one block a (key tile, kv head, n), looping over the
//      query rows that can see the tile (the G heads of the group are the
//      rows of one tile, row = t G + g, as in the forward) and holding the
//      tile's dk and dv in registers;
//   3. dq_kernel: one block a (64-row query tile, kv head, n), looping over
//      the key tiles the tile's rows can see and holding its dq.
// Every block of a pass writes its own output rows, dk and dv of keys no
// row sees as zeros.
//
// Layout: q, dq (N, Tq, H, D), k, dk (N, Tk, KH, D), v, dv (N, Tk, KH, Dv),
// o, dO (N, Tq, H, Dv), contiguous, N folding ranks and batch; lse and delta
// (N, Tq, H) f32; q_offset, valid_len (N,) int32.  f32, f16 and bf16 in,
// f32 accumulation, the gradients in the input type.
//
// CUDA cores.  A block is 256 threads in a 16 x 16 layout: thread (ty, tx)
// owns rows ty + 16 i of a 64-row query tile and keys tx + 16 j of a key
// tile of BK = 16 KA keys for the score tiles S and dP, and, for the
// gradients it holds, rows (dq) or keys (dk, dv) ty + 16 a and columns
// tx + 16 c (c < NT, NT 16-column groups covering max(D, Dv)).  Operands
// sit in shared memory in f32, transposed (column-major, one column of
// padding), so a thread's products walk contiguous columns: q scaled (D x
// 65), dO (Dv x 65), k (D x (BK + 1)), v (Dv x (BK + 1)), then P and dS
// (64 x (BK + 1)).  KA = 4 (64 keys) up to 128 columns, 2 (32 keys) above,
// which keeps a block under 227 KB at D = Dv = 256.
//
// Bound on this card: operations, 2.5 times the forward's (S again, dP, dv,
// dq and dk: 5 products of Tq x Tk x D against the forward's 2, halved under
// the causal mask), at the f32 CUDA-core rate for f32 and at the tensor-core
// rate for 16-bit operands; this kernel runs the CUDA cores (tensor cores,
// TMA and a second route are later work).
#include "common.cuh"

#include <math_constants.h>

#define BWD_BQ 64
#define BWD_NT 256
#define BWD_NEG_INF (-1e30f)

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  const int* q_offset;
  const int* valid_len;
  int N, Tq, Tk, H, KH, D, Dv, G, causal, prefix_len;
  float scale;
};

__host__ __device__ inline size_t bwd_smem_floats(int D, int Dv, int BK) {
  return (size_t)(D + Dv) * (BWD_BQ + 1) + (size_t)(D + Dv) * (BK + 1) +
         2 * (size_t)BWD_BQ * (BK + 1) + 2 * BWD_BQ;
}

// -- pass 1 ------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BWD_NT) delta_kernel(BwdParams p) {
  const long long rows = (long long)p.N * p.Tq * p.H;
  const long long row = (long long)blockIdx.x * (BWD_NT / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = static_cast<const T*>(p.o) + row * p.Dv;
  const T* d = static_cast<const T*>(p.dout) + row * p.Dv;
  float s = 0.f;
  for (int c = lane; c < p.Dv; c += 32) s = fmaf(to_f32(o[c]), to_f32(d[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[row] = s;
}

// -- shared routines ---------------------------------------------------------

// Stage rows [i0, i0 + 64) (row = t G + g, head kh G + g) of a (N, Tq, H,
// C) operand of sequence n, times mul, transposed into dst (C x 65); rows
// past `rows` as zeros.
template <typename T>
__device__ __forceinline__ void bwd_stage_rows(float* dst, const T* src,
                                               int n, int i0, int rows,
                                               int Tq, int H, int G, int kh,
                                               int C, float mul) {
  for (int e = threadIdx.x; e < BWD_BQ * C; e += BWD_NT) {
    const int i = e / C, c = e % C;
    const int row = i0 + i;
    float val = 0.f;
    if (row < rows) {
      const int t = row / G, h = kh * G + row % G;
      val = to_f32(src[(((long long)n * Tq + t) * H + h) * C + c]) * mul;
    }
    dst[c * (BWD_BQ + 1) + i] = val;
  }
}

// Stage keys [k0, k0 + BK) of kv head kh of a (N, Tk, KH, C) operand,
// transposed into dst (C x (BK + 1)); keys at or past kend as zeros.
template <typename T>
__device__ __forceinline__ void bwd_stage_keys(float* dst, const T* src,
                                               int n, int k0, int kend,
                                               int Tk, int KH, int kh, int C,
                                               int BK) {
  for (int e = threadIdx.x; e < BK * C; e += BWD_NT) {
    const int j = e / C, c = e % C;
    const int kp = k0 + j;
    dst[c * (BK + 1) + j] =
        kp < kend ? to_f32(src[(((long long)n * Tk + kp) * KH + kh) * C + c])
                  : 0.f;
  }
}

// The rows' lse and delta of the tile starting at i0 into ls / ds (64 each);
// rows past `rows` get lse = +inf (p = 0).
__device__ __forceinline__ void bwd_stage_stats(float* ls, float* ds,
                                                const BwdParams& p, int n,
                                                int i0, int rows, int kh) {
  for (int i = threadIdx.x; i < BWD_BQ; i += BWD_NT) {
    const int row = i0 + i;
    float l = CUDART_INF_F, d = 0.f;
    if (row < rows) {
      const int t = row / p.G, h = kh * p.G + row % p.G;
      const long long at = ((long long)n * p.Tq + t) * p.H + h;
      l = p.lse[at];
      d = p.delta[at];
    }
    ls[i] = l;
    ds[i] = d;
  }
}

// One (query tile, key tile) step: S = q_scaled k^T and dP = dO v^T from the
// staged operands, then P and dS into ps / dss (64 x (BK + 1)).  Key
// k0 + j is visible to a row at qpos under the forward's masks.
template <int KA>
__device__ __forceinline__ void bwd_scores(
    const float* qt, const float* dot, const float* kt, const float* vt,
    const float* ls, const float* dls, float* ps, float* dss, int D, int Dv,
    int i0, int rows, int G, int qoff, int k0, int vlen, int causal,
    int prefix_len) {
  constexpr int BK = 16 * KA;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][KA], dp[4][KA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KA; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qa[4], kb[KA];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = qt[d * (BWD_BQ + 1) + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < KA; ++j) kb[j] = kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KA; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
  }
  for (int c = 0; c < Dv; ++c) {
    float da[4], vb[KA];
#pragma unroll
    for (int i = 0; i < 4; ++i) da[i] = dot[c * (BWD_BQ + 1) + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < KA; ++j) vb[j] = vt[c * (BK + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KA; ++j) dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = i0 + r;
    const bool rvalid = row < rows;
    const int qpos = qoff + (rvalid ? row / G : 0);
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      const int kp = k0 + tx + 16 * j;
      bool vis = rvalid && kp < vlen;
      if (causal)
        vis = vis && (kp <= qpos || (kp < prefix_len && qpos < prefix_len));
      const float pv = vis ? expf(s[i][j] - ls[r]) : 0.f;
      ps[r * (BK + 1) + tx + 16 * j] = pv;
      dss[r * (BK + 1) + tx + 16 * j] = vis ? pv * (dp[i][j] - dls[r]) : 0.f;
    }
  }
}

// -- pass 2: dk and dv ---------------------------------------------------------

template <typename T, int NT, int KA>
__global__ void __launch_bounds__(BWD_NT) dkdv_kernel(BwdParams p) {
  constexpr int BK = 16 * KA;
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv, G = p.G;
  float* qt = smem;                              // [D][65]  q scaled
  float* dot = qt + D * (BWD_BQ + 1);            // [Dv][65] dO
  float* kt = dot + Dv * (BWD_BQ + 1);           // [D][BK + 1]
  float* vt = kt + D * (BK + 1);                 // [Dv][BK + 1]
  float* ps = vt + Dv * (BK + 1);                // [64][BK + 1] P
  float* dss = ps + BWD_BQ * (BK + 1);           // [64][BK + 1] dS
  float* ls = dss + BWD_BQ * (BK + 1);           // [64] lse
  float* dls = ls + BWD_BQ;                      // [64] delta
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, n = blockIdx.z;
  const int rows = p.Tq * G;
  const int qoff = p.q_offset[n];
  const int vlen = min(p.valid_len[n], p.Tk);
  const T* q = static_cast<const T*>(p.q);
  const T* dO = static_cast<const T*>(p.dout);

  float dk[KA][NT], dv[KA][NT];
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c) dk[a][c] = dv[a][c] = 0.f;

  if (k0 < vlen) {
    bwd_stage_keys(kt, static_cast<const T*>(p.k), n, k0, vlen, p.Tk, p.KH,
                   kh, D, BK);
    bwd_stage_keys(vt, static_cast<const T*>(p.v), n, k0, vlen, p.Tk, p.KH,
                   kh, Dv, BK);
    // the first row that can see a key of the tile: every row inside the
    // prefix window, else the causal frontier
    int row0 = 0;
    if (p.causal && k0 >= p.prefix_len) row0 = max(k0 - qoff, 0) * G;
    for (int i0 = row0; i0 < rows; i0 += BWD_BQ) {
      __syncthreads();                         // previous tile consumed
      bwd_stage_rows(qt, q, n, i0, rows, p.Tq, p.H, G, kh, D, p.scale);
      bwd_stage_rows(dot, dO, n, i0, rows, p.Tq, p.H, G, kh, Dv, 1.f);
      bwd_stage_stats(ls, dls, p, n, i0, rows, kh);
      __syncthreads();
      bwd_scores<KA>(qt, dot, kt, vt, ls, dls, ps, dss, D, Dv, i0, rows, G,
                     qoff, k0, vlen, p.causal, p.prefix_len);
      __syncthreads();
      for (int r = 0; r < BWD_BQ; ++r) {
        float pa[KA], sa[KA];
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          pa[a] = ps[r * (BK + 1) + ty + 16 * a];
          sa[a] = dss[r * (BK + 1) + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          const int col = tx + 16 * c;
          const float dov = col < Dv ? dot[col * (BWD_BQ + 1) + r] : 0.f;
          const float qv = col < D ? qt[col * (BWD_BQ + 1) + r] : 0.f;
#pragma unroll
          for (int a = 0; a < KA; ++a) {
            dv[a][c] = fmaf(pa[a], dov, dv[a][c]);
            dk[a][c] = fmaf(sa[a], qv, dk[a][c]);
          }
        }
      }
    }
  }

  T* gk = static_cast<T*>(p.dk);
  T* gv = static_cast<T*>(p.dv);
#pragma unroll
  for (int a = 0; a < KA; ++a) {
    const int kp = k0 + ty + 16 * a;
    if (kp >= p.Tk) continue;
    const long long at = ((long long)n * p.Tk + kp) * p.KH + kh;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) gk[at * D + col] = from_f32<T>(dk[a][c]);
      if (col < Dv) gv[at * Dv + col] = from_f32<T>(dv[a][c]);
    }
  }
}

// -- pass 3: dq ----------------------------------------------------------------

template <typename T, int NT, int KA>
__global__ void __launch_bounds__(BWD_NT) dq_kernel(BwdParams p) {
  constexpr int BK = 16 * KA;
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv, G = p.G;
  float* qt = smem;
  float* dot = qt + D * (BWD_BQ + 1);
  float* kt = dot + Dv * (BWD_BQ + 1);
  float* vt = kt + D * (BK + 1);
  float* ps = vt + Dv * (BK + 1);
  float* dss = ps + BWD_BQ * (BK + 1);
  float* ls = dss + BWD_BQ * (BK + 1);
  float* dls = ls + BWD_BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.x * BWD_BQ, kh = blockIdx.y, n = blockIdx.z;
  const int rows = p.Tq * G;
  const int qoff = p.q_offset[n];
  const int vlen = min(p.valid_len[n], p.Tk);
  // the last key any row of the tile sees, plus one (the forward's
  // att_key_end)
  int kend = vlen;
  if (p.causal) {
    const int t_first = i0 / G, t_last = (min(i0 + BWD_BQ, rows) - 1) / G;
    int frontier = qoff + t_last + 1;
    if (qoff + t_first < p.prefix_len) frontier = max(frontier, p.prefix_len);
    kend = min(vlen, frontier);
  }

  bwd_stage_rows(qt, static_cast<const T*>(p.q), n, i0, rows, p.Tq, p.H, G,
                 kh, D, p.scale);
  bwd_stage_rows(dot, static_cast<const T*>(p.dout), n, i0, rows, p.Tq, p.H,
                 G, kh, Dv, 1.f);
  bwd_stage_stats(ls, dls, p, n, i0, rows, kh);

  float dq[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NT; ++c) dq[i][c] = 0.f;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                           // previous tile consumed
    bwd_stage_keys(kt, k, n, k0, kend, p.Tk, p.KH, kh, D, BK);
    bwd_stage_keys(vt, v, n, k0, kend, p.Tk, p.KH, kh, Dv, BK);
    __syncthreads();
    bwd_scores<KA>(qt, dot, kt, vt, ls, dls, ps, dss, D, Dv, i0, rows, G,
                   qoff, k0, kend, p.causal, p.prefix_len);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dss[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < D ? kt[col * (BK + 1) + j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(sa[i], kv, dq[i][c]);
      }
    }
  }

  T* g = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= rows) continue;
    const int t = row / G, h = kh * G + row % G;
    const long long at = ((long long)n * p.Tq + t) * p.H + h;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) g[at * D + col] = from_f32<T>(dq[i][c] * p.scale);
    }
  }
}

// -- host side -------------------------------------------------------------------

template <typename T, int NT>
static int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr int KA = NT > 8 ? 2 : 4;
  const size_t smem = sizeof(float) * bwd_smem_floats(p.D, p.Dv, 16 * KA);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)p.N * p.Tq * p.H;
  delta_kernel<T><<<(unsigned)((rows + BWD_NT / 32 - 1) / (BWD_NT / 32)),
                    BWD_NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel<T, NT, KA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gk((p.Tk + 16 * KA - 1) / (16 * KA), p.KH, p.N);
  dkdv_kernel<T, NT, KA><<<gk, BWD_NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<T, NT, KA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gq((p.Tq * p.G + BWD_BQ - 1) / BWD_BQ, p.KH, p.N);
  dq_kernel<T, NT, KA><<<gq, BWD_NT, smem, stream>>>(p);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_bwd(const BwdParams& p, cudaStream_t stream) {
  const int cols = p.D > p.Dv ? p.D : p.Dv;
  if (cols <= 32) return launch_bwd<T, 2>(p, stream);
  if (cols <= 64) return launch_bwd<T, 4>(p, stream);
  if (cols <= 128) return launch_bwd<T, 8>(p, stream);
  return launch_bwd<T, 16>(p, stream);
}

// dq, dk, dv of the forward's output from dO; every tensor contiguous in
// the layout above, `delta` (N, Tq, H) f32 scratch the caller allocates.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* q_offset, const void* valid_len, int N, int Tq,
    int Tk, int H, int KH, int D, int Dv, int causal, int prefix_len,
    float scale, int dtype, void* stream) {
  if (D < 1 || Dv < 1 || D > 256 || Dv > 256 || KH < 1 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || Tq == 0 || Tk == 0 || H == 0) return 0;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_offset = static_cast<const int*>(q_offset);
  p.valid_len = static_cast<const int*>(valid_len);
  p.N = N; p.Tq = Tq; p.Tk = Tk; p.H = H; p.KH = KH; p.D = D; p.Dv = Dv;
  p.G = H / KH; p.causal = causal; p.prefix_len = prefix_len;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_bwd<float>(p, s);
    case kF16: return dispatch_bwd<__half>(p, s);
    case kBF16: return dispatch_bwd<__nv_bfloat16>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
