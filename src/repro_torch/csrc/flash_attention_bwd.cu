// flash_attention_bwd: the gradient of flash_attention.cu's forward,
//   dq, dk, dv of  out[n, t, h] = softmax_k(scale q[n, t, h] . k[n, k, h / G])
//                                  v[n, k, h / G]
// over the keys visible to query position q_pos = q_offset[n] + t (the
// forward's masks: k < valid_len[n] and, when causal, k <= q_pos or both in
// the prefix window [0, prefix_len)).
//
// No TPU kernel is replaced.  This is the gradient of the forward that
// replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:80, pallas_call at :125), a kernel with no backward on the TPU:
// the reference trains through its plain oracle (flash_attention_ref) under
// jax.value_and_grad.  The formulas are the standard ones, with P
// recomputed from the forward's row log-sum-exp (lse = m + log l, which
// flash_attention.cu writes beside the output):
//   P   = exp(scale q k^T - lse)  (0 where masked)
//   dv  = P^T dO
//   dP  = dO v^T
//   dS  = P o (dP - delta),  delta = rowsum(dO o O)
//   dq  = scale dS k,   dk = scale dS^T q.
//
// No atomics on either route, so every gradient is the same bit for bit
// from run to run: a rows pass, then a block per (64-key tile, kv head, n)
// that owns its keys' dk and dv, then a block per (64-row query tile, kv
// head, n) that owns its rows' dq; dk and dv of keys no row sees are zeros.
// The price is seven products a (query tile, key tile) pair where an
// atomic dq would need five: S and dP are formed in both passes.
//
// Layout: q, dq (N, Tq, H, D), k, dk (N, Tk, KH, D), v, dv (N, Tk, KH, Dv),
// o, dO (N, Tq, H, Dv), contiguous, N folding ranks and batch; lse (N, Tq,
// H) f32; q_offset, valid_len (N,) int32; `delta` f32 scratch the caller
// allocates (its size depends on the route, below).  The G = H / KH query
// heads of a kv head are the rows of one tile, row = t G + g, as in the
// forward.  f32, f16 and bf16 in, f32 accumulation, the gradients in the
// input type.
//
// Bound on this card: operations, five products of (visible pairs) x D or
// Dv (S, dP, dv, dq, dk: 2 (3 D + 2 Dv) flops a visible (row, key) pair)
// at 989 TFLOP/s for 16-bit operands (67 TFLOP/s in f32 on the CUDA cores).
//
// Two routes, picked before launch by one rule (repro_torch/kernels/
// plan.py attention_bwd_route; the entry point checks it again and refuses
// a tensor-core launch off it):
//
// * tensor cores (bwd_rows_kernel, dkdv_tc_kernel or dkdv_wide_kernel,
//   dq_tc_kernel): f16 and bf16 with D a multiple of 16 in [16, 128] or 192
//   (deepseek-v3's MLA heads: the wide instance, below), Dv a multiple of
//   16 in [16, 128], G dividing 64, 16-byte-aligned operands.  `delta`
//   holds 3 N KH Rp values, Rp the rows Tq G of a kv head rounded up to
//   the 64-row tile.
//   - bwd_rows_kernel: one thread a (n, kv head, row) of the padded tile
//     order writes the row's lse log2(e), delta and key end (the forward's
//     masks make every row see a prefix of the keys, [0, rend)); a padded
//     row gets +inf, 0 and 0.  So a tile's three rows of stats are 768
//     contiguous bytes that one bulk copy each brings in, and the mask is
//     one compare a score against its row's rend.
//   - dkdv_tc_kernel: a producer warp and one consumer warpgroup.  K and V
//     of the block's 64 keys are loaded once by TMA; the producer streams
//     the 64-row query tiles that can see them (from the causal frontier,
//     widened to the prefix window, rounded down to a tile) into a ring of
//     BWD_TC_STAGES stages (q and dO boxes, the rows' stats) with full /
//     empty mbarriers.  Per tile the warpgroup runs
//       S^T = K q^T and dP^T = V dO^T   wgmma m64n64k16, both operands
//                                       K-major (row-major boxes);
//       P^T = 2^(S^T scale log2(e) - lse log2(e)), dS^T = P^T o (dP^T -
//       delta), each masked by a select (a masked dP may be NaN);
//       dv += P^T dO and dk += dS^T q  wgmma m64n{W}k16 in the RS form:
//                                       the accumulator fragment, rounded
//                                       to the operand type, is A's
//                                       register fragment; dO and q are read
//                                       through the transpose bit.
//     dk and dv stay in registers and are written once (dk times scale).
//   - dq_tc_kernel: the forward's loop shape: q and dO of the block's 64
//     rows are loaded once, the producer streams the K and V tiles the
//     rows see (attention.cuh's att_key_end); per tile S = q K^T and dP =
//     dO V^T (m64n64k16), P and dS as above, dq += dS K (RS, K through the
//     transpose bit).  K rows past the tile's key end are zeroed in shared
//     memory first (0 x NaN is NaN inside wgmma; a cache's rows past
//     valid_len may hold anything).
//   W = max(D, Dv) is the narrow instance: both accumulators are W wide,
//   and a narrower operand's columns past its width are TMA's zero fill
//   (D = 80 is two 64-column boxes, the second read 16 columns deep).  The S and dP
//   contractions run D / 16 and Dv / 16 k16 steps.  Every box is 128-byte
//   swizzled; positions past Tq or Tk read as zero.  Both grids are 1-D
//   with the heaviest tiles first under the causal mask (the dk/dv pass by
//   ascending key tile, the dq pass by descending query tile).
//   What this does about the CUDA-core route's limits: the seven products
//   run on the tensor cores (one wgmma a 16-deep step of a 64 x 64 or 64 x
//   W tile) instead of f32 FMAs; operands arrive by TMA in the 16-bit type,
//   swizzled, without the threads' loads, transposes and __syncthreads, and
//   the loads of the next tile overlap this one's products; P and dS never
//   leave registers.  Deviations from the CUDA-core route, held to the same
//   tolerances: P and dS are rounded to the operand type before their
//   products, the exponentials are the SFU's 2^x, scale multiplies S in f32
//   (and dk, dq at the end) instead of being folded into q.
//   Registers (ptxas, sm_90a, bf16): the dk/dv pass at W = 80 holds dk and
//   dv (80 a thread) beside the S^T and dP^T fragments (64) in 189
//   registers without a spill, so two blocks still share an SM (10 warps
//   x 192 x 32 <= 65,536); asking ptxas for two blocks (__launch_bounds__
//   min 2) capped it at 168 and spilled 1,172 bytes, and the pass took 2.4
//   times as long.  At W = 128 it takes 237 (one block an SM).  The dq
//   pass takes 149 at W = 80.  chip_smoke.py logs every instance's count.
//   The wide instance (D = 192, Dv up to 128) cannot hold dk and dv in one
//   warpgroup (224 accumulators beside the score fragments), so its dk/dv
//   pass (dkdv_wide_kernel) splits them over two consumer warpgroups,
//   each forming S^T itself; its dq pass is dq_tc_kernel with dq 192 wide
//   and the D- and Dv-wide operands 3 and 2 boxes (bwd_tc_wide_smem_bytes:
//   the stages hold what each operand needs, not max(D, Dv) columns of
//   each).  Its waits trap after about ten seconds instead of hanging.
//
// * CUDA cores (delta_kernel, dkdv_kernel, dq_kernel): f32 and every shape
//   off the rule.  `delta` holds N Tq H values.
//   1. delta_kernel: one warp a (n, t, h) row, delta in f32;
//   2. dkdv_kernel: one block a (key tile, kv head, n), looping over the
//      query rows that can see the tile and holding the tile's dk and dv in
//      registers;
//   3. dq_kernel: one block a (64-row query tile, kv head, n), looping over
//      the key tiles the tile's rows can see and holding its dq.
//   A block is 256 threads in a 16 x 16 layout: thread (ty, tx) owns rows
//   ty + 16 i of a 64-row query tile and keys tx + 16 j of a key tile of BK
//   = 16 KA keys for the score tiles S and dP, and, for the gradients it
//   holds, rows (dq) or keys (dk, dv) ty + 16 a and columns tx + 16 c (c <
//   NT, NT 16-column groups covering max(D, Dv)).  Operands sit in shared
//   memory in f32, transposed (column-major, one column of padding), so a
//   thread's products walk contiguous columns: q scaled (D x 65), dO (Dv x
//   65), k (D x (BK + 1)), v (Dv x (BK + 1)), then P and dS (64 x (BK +
//   1)).  KA = 4 (64 keys) up to 128 columns, 2 (32 keys) above, which
//   keeps a block under 227 KB at D = Dv = 256.
#include "attention.cuh"

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

// -- the tensor-core route (TMA + wgmma) -------------------------------------

#define BWD_TC_STAGES 2
#define BWD_TC_THREADS 160

constexpr int BWD_TC_CONSUMERS = 128;       // one warpgroup, 64 rows or keys
constexpr int BWD_BOX = 64 * 128;           // one box: 64 rows of 128 bytes
constexpr int BWD_ROW_STATS = 3 * 64 * 4;   // a tile's lse log2(e), delta, rend
static_assert(BWD_TC_THREADS == BWD_TC_CONSUMERS + 32, "one producer warp");
static_assert(BWD_BQ == 64 && ATT_TC_BK == 64, "wgmma m64 / n64 tiles");

// Dynamic shared memory of a tensor-core pass whose operands are `nbox`
// 64-column boxes wide: 1024 bytes of slack for the swizzle's alignment,
// the block's resident pair (K and V, or q and dO), the stages' streamed
// pairs, the stages' row stats and the barriers (full and empty of each
// stage, and the resident pair's).
__host__ __device__ inline int bwd_tc_smem_bytes(int nbox) {
  return 1024 + (2 + 2 * BWD_TC_STAGES) * nbox * BWD_BOX
         + BWD_TC_STAGES * BWD_ROW_STATS + 8 * (2 * BWD_TC_STAGES + 1);
}

// The same layout with the D-wide operands (q, K) kb boxes and the Dv-wide
// ones (dO, V) vb boxes: the wide instance's (below).  At kb = vb = nbox it
// is bwd_tc_smem_bytes(nbox).
__host__ __device__ inline int bwd_tc_wide_smem_bytes(int kb, int vb) {
  return 1024 + (1 + BWD_TC_STAGES) * (kb + vb) * BWD_BOX
         + BWD_TC_STAGES * BWD_ROW_STATS + 8 * (2 * BWD_TC_STAGES + 1);
}

struct BwdTcSmem {
  uint32_t base;        // shared-window address, 1024-byte aligned
  unsigned char* gen;   // the same byte through a generic pointer
  int kb, vb;           // boxes of a D-wide (q, K) and a Dv-wide (dO, V) tile
  // i = 0: K (dk/dv pass) or q (dq pass); i = 1: V or dO
  __device__ uint32_t res(int i) const { return base + i * kb * BWD_BOX; }
  // i = 0: q (dk/dv pass) or K (dq pass); i = 1: dO or V
  __device__ uint32_t op(int s, int i) const {
    return base + ((1 + s) * (kb + vb) + i * kb) * BWD_BOX;
  }
  __device__ uint32_t stats_off(int s) const {
    return (1 + BWD_TC_STAGES) * (kb + vb) * BWD_BOX + s * BWD_ROW_STATS;
  }
  __device__ uint32_t stats(int s) const { return base + stats_off(s); }
  __device__ const float* lse2(int s) const {
    return reinterpret_cast<const float*>(gen + stats_off(s));
  }
  __device__ const float* delta(int s) const { return lse2(s) + 64; }
  __device__ const int* rend(int s) const {
    return reinterpret_cast<const int*>(lse2(s) + 128);
  }
  __device__ uint32_t bar(int i) const {
    return base + stats_off(BWD_TC_STAGES) + 8 * i;
  }
  __device__ uint32_t full(int s) const { return bar(s); }
  __device__ uint32_t empty(int s) const { return bar(BWD_TC_STAGES + s); }
  __device__ uint32_t resfull() const { return bar(2 * BWD_TC_STAGES); }
};

using BwdPipe = StagePipe<BWD_TC_STAGES>;

// Every thread of the block calls it once (it syncs the block).  A stage's
// empty barrier waits on every consumer warp.
__device__ inline BwdTcSmem bwd_tc_smem_init(unsigned char* raw, int kb,
                                             int vb, int consumers) {
  BwdTcSmem sm;
  const uint32_t raw_s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  sm.base = (raw_s + 1023) & ~1023u;
  sm.gen = raw + (sm.base - raw_s);
  sm.kb = kb;
  sm.vb = vb;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_TC_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), consumers / 32);
    }
    mbar_init(sm.resfull(), 1);
    fence_mbar_init();
  }
  __syncthreads();
  return sm;
}

// `bytes` (a multiple of 16) from global src (16-byte aligned) to shared
// dst, completing on the barrier at bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The tensor-core route's launch arguments besides the maps: the rows
// pass's output (lse log2(e), delta, rend: each N KH Rp values, rows of kv
// head kh of sequence n from (n KH + kh) Rp on).
struct BwdTcArgs {
  BwdParams p;
  float* stats;
  int Rp;
};

// -- rows pass

// One thread a row of the padded tile order: o and dO read as 16-byte
// vectors (Dv is a multiple of 16 on this route).
template <typename T>
__global__ void __launch_bounds__(BWD_NT) bwd_rows_kernel(BwdTcArgs a) {
  const BwdParams& p = a.p;
  const long long total = (long long)p.N * p.KH * a.Rp;
  const long long w = (long long)blockIdx.x * BWD_NT + threadIdx.x;
  if (w >= total) return;
  const int r = (int)(w % a.Rp);
  const long long nk = w / a.Rp;
  const int kh = (int)(nk % p.KH), n = (int)(nk / p.KH);
  float s = 0.f, l2 = CUDART_INF_F;
  int rend = 0;
  if (r < p.Tq * p.G) {
    const int t = r / p.G, h = kh * p.G + r % p.G;
    const long long row = ((long long)n * p.Tq + t) * p.H + h;
    const uint4* o = reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.o) + row * p.Dv);
    const uint4* d = reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.dout) + row * p.Dv);
    for (int c = 0; c < p.Dv / 8; ++c) {
      const uint4 ov = o[c], dv = d[c];
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(to_f32(oe[e]), to_f32(de[e]), s);
    }
    l2 = p.lse[row] * ATT_LOG2E;
    const int qpos = p.q_offset[n] + t;
    rend = min(p.valid_len[n], p.Tk);
    if (p.causal)
      rend = min(rend, qpos < p.prefix_len ? max(qpos + 1, p.prefix_len)
                                           : qpos + 1);
  }
  a.stats[w] = l2;
  a.stats[total + w] = s;
  reinterpret_cast<int*>(a.stats)[2 * total + w] = rend;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 64, f32) = A B^T over `ksteps` 16-deep steps, A and B (64 rows,
// K-major, 64-column boxes) at shared addresses a and b; committed as one
// group, not waited for
template <typename T>
__device__ __forceinline__ void bwd_scores_tc(float (&d)[32], uint32_t a,
                                              uint32_t b, int ksteps) {
  for (int kk = 0; kk < ksteps; ++kk) {
    // 16 columns are 32 bytes of each 128-byte row; 64-column boxes
    // BWD_BOX apart; 8-row groups 1024 bytes apart
    const uint32_t off = (kk >> 2) * BWD_BOX + (kk & 3) * 32;
    att_wgmma_s<T>(d, tc_desc(a + off, 16, 1024), tc_desc(b + off, 16, 1024),
                   kk > 0);
  }
  wgmma_commit();
}

// acc (64 x W) += A (64 x 64, the fragments a) times the 64 x W operand at
// shared address b (64 rows, 64-column boxes, N-major); not committed
template <typename T, int W>
__device__ __forceinline__ void bwd_acc_tc(float (&acc)[W / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    // 16 rows are 2048 bytes of each box; 64-column boxes BWD_BOX apart
    // (leading byte offset); 8-row groups 1024 apart
    att_wgmma_o<T, W>(acc, a[kk], tc_desc(b + kk * 16 * 128, BWD_BOX, 1024));
}

// Producer: `nbox` 64-column boxes of a 5-D map at (kh0, pos, n) into dst
__device__ __forceinline__ void bwd_load_boxes(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int nbox,
                                               int kh0, int pos, int n) {
  for (int c = 0; c < nbox; ++c)
    tma_load_5d(dst + c * BWD_BOX, map, bar, c * 64, kh0, pos, n, 0);
}

// The first row of the padded tile order that can see key k0: every row
// in the prefix window, else the causal frontier; rounded down to a tile.
__device__ __forceinline__ int bwd_first_row(const BwdParams& p, int k0,
                                             int qoff) {
  if (!p.causal || k0 < p.prefix_len) return 0;
  return max(k0 - qoff, 0) * p.G / BWD_BQ * BWD_BQ;
}

// P^T = 2^(S^T scale log2(e) - lse log2(e)) in place of S^T's fragment
// (s[4 j + 2 h + e]: key key0 + 8 h, row 8 j + c0 + e of the tile), 0
// where the row's key end hides the key
__device__ __forceinline__ void bwd_pt_tc(float (&s)[32], int key0, int c0,
                                          const float* l2, const int* re,
                                          float scale2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + c0 + e;
      const float lo = l2[col];
      const int lim = re[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        s[i] = key0 + 8 * h < lim ? att_exp2(fmaf(s[i], scale2, -lo)) : 0.f;
      }
    }
}

// The dk/dv pass's block: its key tile, kv head and sequence, and the
// query tiles that can see the keys (from row0 on, ntiles of them).
struct BwdKeyBlock {
  int kh, n, k0, row0, ntiles;
};

__device__ __forceinline__ BwdKeyBlock bwd_key_block(const BwdParams& p) {
  BwdKeyBlock b;
  const int heads = p.KH * p.N;
  const int kt = blockIdx.x / heads, rest = blockIdx.x % heads;
  b.kh = rest % p.KH;
  b.n = rest / p.KH;
  b.k0 = kt * ATT_TC_BK;
  const int vlen = min(p.valid_len[b.n], p.Tk);
  b.row0 = bwd_first_row(p, b.k0, p.q_offset[b.n]);
  b.ntiles = b.k0 < vlen
                 ? max((p.Tq * p.G - b.row0 + BWD_BQ - 1) / BWD_BQ, 0)
                 : 0;
  return b;
}

// Producer of the dk/dv pass: K and V of the block's keys once, then q, dO
// and the rows' stats of each query tile into the next stage.
__device__ __forceinline__ void bwd_key_producer(
    const BwdTcSmem& sm, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* dmap, const BwdTcArgs& a,
    const BwdKeyBlock& b) {
  const BwdParams& p = a.p;
  const long long seg = ((long long)b.n * p.KH + b.kh) * a.Rp;
  const long long total = (long long)p.N * p.KH * a.Rp;
  BwdPipe pipe;
  mbar_expect_tx(sm.resfull(), (sm.kb + sm.vb) * BWD_BOX);
  bwd_load_boxes(sm.res(0), kmap, sm.resfull(), sm.kb, b.kh, b.k0, b.n);
  bwd_load_boxes(sm.res(1), vmap, sm.resfull(), sm.vb, b.kh, b.k0, b.n);
  for (int it = 0; it < b.ntiles; ++it) {
    const int i0 = b.row0 + it * BWD_BQ;
    mbar_wait_trap(sm.empty(pipe.stage), pipe.phase ^ 1);
    const uint32_t full = sm.full(pipe.stage);
    mbar_expect_tx(full, (sm.kb + sm.vb) * BWD_BOX + BWD_ROW_STATS);
    bwd_load_boxes(sm.op(pipe.stage, 0), qmap, full, sm.kb, b.kh * p.G,
                   i0 / p.G, b.n);
    bwd_load_boxes(sm.op(pipe.stage, 1), dmap, full, sm.vb, b.kh * p.G,
                   i0 / p.G, b.n);
    for (int j = 0; j < 3; ++j)
      bulk_load(sm.stats(pipe.stage) + j * 256,
                a.stats + j * total + seg + i0, 256, full);
    pipe.advance();
  }
}

// -- dk/dv pass: one block a (64-key tile, kv head, n), key tiles ascending
// (the heaviest first under the causal mask)

template <typename T, int W>
__global__ void __launch_bounds__(BWD_TC_THREADS, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap dmap, BwdTcArgs a) {
  extern __shared__ unsigned char tc_smem[];
  constexpr int NBOX = (W + 63) / 64;
  const BwdParams& p = a.p;
  const BwdTcSmem sm = bwd_tc_smem_init(tc_smem, NBOX, NBOX,
                                        BWD_TC_CONSUMERS);
  const BwdKeyBlock b = bwd_key_block(p);
  const int kh = b.kh, n = b.n, k0 = b.k0, ntiles = b.ntiles;
  if (threadIdx.x == BWD_TC_CONSUMERS) {
    if (ntiles > 0) bwd_key_producer(sm, &qmap, &kmap, &vmap, &dmap, a, b);
    return;
  }
  if (threadIdx.x > BWD_TC_CONSUMERS) return;
  BwdPipe pipe;

  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3);
  const int key0 = k0 + att_tc_row0();     // the thread's keys: key0, + 8
  const float scale2 = p.scale * ATT_LOG2E;
  float dk[W / 2], dv[W / 2];
#pragma unroll
  for (int j = 0; j < W / 2; ++j) dk[j] = dv[j] = 0.f;
  if (ntiles > 0) mbar_wait(sm.resfull(), 0);
  for (int it = 0; it < ntiles; ++it) {
    const int stage = pipe.stage;
    mbar_wait(sm.full(stage), pipe.phase);
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    att_fence_regs(s);
    att_fence_regs(dp);
    wgmma_fence();
    bwd_scores_tc<T>(s, sm.res(0), sm.op(stage, 0), p.D / 16);    // S^T
    bwd_scores_tc<T>(dp, sm.res(1), sm.op(stage, 1), p.Dv / 16);  // dP^T
    wgmma_wait<1>();
    att_fence_regs(s);
    const float* dl = sm.delta(stage);
    const int* re = sm.rend(stage);
    bwd_pt_tc(s, key0, c0, sm.lse2(stage), re, scale2);
    wgmma_wait<0>();
    att_fence_regs(dp);
    // dS^T, and both A fragments packed a register pair at a time, so P^T
    // and dS^T in f32 die as the fragments fill
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 8 * (i >> 2) + c0, key = key0 + 8 * ((i >> 1) & 1);
      const float d0 = key < re[col] ? s[i] * (dp[i] - dl[col]) : 0.f;
      const float d1 =
          key < re[col + 1] ? s[i + 1] * (dp[i + 1] - dl[col + 1]) : 0.f;
      pa[i >> 3][(i & 7) >> 1] = att_pack<T>(s[i], s[i + 1]);
      sa[i >> 3][(i & 7) >> 1] = att_pack<T>(d0, d1);
    }
    att_fence_regs(dv);
    att_fence_regs(dk);
    wgmma_fence();
    bwd_acc_tc<T, W>(dv, pa, sm.op(stage, 1));    // dv += P^T dO
    bwd_acc_tc<T, W>(dk, sa, sm.op(stage, 0));    // dk += dS^T q
    wgmma_commit();
    wgmma_wait<0>();
    att_fence_regs(dv);
    att_fence_regs(dk);
    if (lane == 0) mbar_arrive(sm.empty(stage));
    pipe.advance();
  }

  T* gk = static_cast<T*>(p.dk);
  T* gv = static_cast<T*>(p.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.Tk) continue;
    const long long at = ((long long)n * p.Tk + key) * p.KH + kh;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + c0;
      if (col < p.D)
        store2(gk + at * p.D + col, dk[4 * j + 2 * h] * p.scale,
               dk[4 * j + 2 * h + 1] * p.scale);
      if (col < p.Dv)
        store2(gv + at * p.Dv + col, dv[4 * j + 2 * h],
               dv[4 * j + 2 * h + 1]);
    }
  }
}

// -- the wide dk/dv pass: D = 192 (MLA's heads), Dv up to 128
//
// One warpgroup would hold dk (64 x 192: 96 a thread), dv (64 x 128: 64)
// and the S^T and dP^T fragments (64): 224 accumulators, past what ptxas
// can give a thread beside its addresses and packed fragments (255).  So
// the pass splits over two consumer warpgroups on the same stages:
// warpgroup 0 owns dk and forms S^T, dP^T and dS^T; warpgroup 1 owns dv
// and forms S^T again (D / 16 = 12 m64n64k16 steps: the five products'
// 40 steps a tile become 52) for P^T.  Neither waits on the other: each
// warp releases a stage itself (the empty barrier counts all 8), so P^T
// never crosses shared memory and no named barrier joins them; every wait
// traps after about ten seconds (mbar_wait_trap), so a lost arrival is a
// launch error, not a hung card.  A block of 288 threads caps ptxas at 168
// registers a thread, and warpgroup 0's dk, S^T and dP^T (160 values)
// spill 1,188 bytes there (a 384-thread block whose producer warpgroup
// gave registers to the consumers by setmaxnreg compiled to the same 168
// and the same spill, and ran no faster).  K (3
// boxes) and V (2) stay resident, q and dO stream in stages of 3 + 2
// boxes: bwd_tc_wide_smem_bytes(3, 2) = 125,480 bytes, one block an SM.

// Warpgroup 0: dk += dS^T q over the block's query tiles; stores dk.
template <typename T, int WD>
__device__ __forceinline__ void bwd_wide_dk(const BwdTcSmem& sm,
                                            const BwdParams& p,
                                            const BwdKeyBlock& b) {
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3);
  const int key0 = b.k0 + att_tc_row0();   // the thread's keys: key0, + 8
  const float scale2 = p.scale * ATT_LOG2E;
  float dk[WD / 2];
#pragma unroll
  for (int j = 0; j < WD / 2; ++j) dk[j] = 0.f;
  BwdPipe pipe;
  if (b.ntiles > 0) mbar_wait_trap(sm.resfull(), 0);
  for (int it = 0; it < b.ntiles; ++it) {
    const int stage = pipe.stage;
    mbar_wait_trap(sm.full(stage), pipe.phase);
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    att_fence_regs(s);
    att_fence_regs(dp);
    wgmma_fence();
    bwd_scores_tc<T>(s, sm.res(0), sm.op(stage, 0), p.D / 16);    // S^T
    bwd_scores_tc<T>(dp, sm.res(1), sm.op(stage, 1), p.Dv / 16);  // dP^T
    wgmma_wait<1>();
    att_fence_regs(s);
    const float* dl = sm.delta(stage);
    const int* re = sm.rend(stage);
    bwd_pt_tc(s, key0, c0, sm.lse2(stage), re, scale2);
    wgmma_wait<0>();
    att_fence_regs(dp);
    uint32_t sa[4][4];      // dS^T, packed a register pair at a time
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 8 * (i >> 2) + c0, key = key0 + 8 * ((i >> 1) & 1);
      const float d0 = key < re[col] ? s[i] * (dp[i] - dl[col]) : 0.f;
      const float d1 =
          key < re[col + 1] ? s[i + 1] * (dp[i + 1] - dl[col + 1]) : 0.f;
      sa[i >> 3][(i & 7) >> 1] = att_pack<T>(d0, d1);
    }
    att_fence_regs(dk);
    wgmma_fence();
    bwd_acc_tc<T, WD>(dk, sa, sm.op(stage, 0));   // dk += dS^T q
    wgmma_commit();
    wgmma_wait<0>();
    att_fence_regs(dk);
    if (lane == 0) mbar_arrive(sm.empty(stage));
    pipe.advance();
  }
  T* gk = static_cast<T*>(p.dk);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.Tk) continue;
    const long long at = ((long long)b.n * p.Tk + key) * p.KH + b.kh;
#pragma unroll
    for (int j = 0; j < WD / 8; ++j) {
      const int col = 8 * j + c0;
      if (col < p.D)
        store2(gk + at * p.D + col, dk[4 * j + 2 * h] * p.scale,
               dk[4 * j + 2 * h + 1] * p.scale);
    }
  }
}

// Warpgroup 1: dv += P^T dO over the same tiles; stores dv.
template <typename T, int WV>
__device__ __forceinline__ void bwd_wide_dv(const BwdTcSmem& sm,
                                            const BwdParams& p,
                                            const BwdKeyBlock& b) {
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3);
  const int key0 = b.k0 + att_tc_row0() - 64;   // warpgroup 1's rows
  const float scale2 = p.scale * ATT_LOG2E;
  float dv[WV / 2];
#pragma unroll
  for (int j = 0; j < WV / 2; ++j) dv[j] = 0.f;
  BwdPipe pipe;
  if (b.ntiles > 0) mbar_wait_trap(sm.resfull(), 0);
  for (int it = 0; it < b.ntiles; ++it) {
    const int stage = pipe.stage;
    mbar_wait_trap(sm.full(stage), pipe.phase);
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    att_fence_regs(s);
    wgmma_fence();
    bwd_scores_tc<T>(s, sm.res(0), sm.op(stage, 0), p.D / 16);    // S^T
    wgmma_wait<0>();
    att_fence_regs(s);
    bwd_pt_tc(s, key0, c0, sm.lse2(stage), sm.rend(stage), scale2);
    uint32_t pa[4][4];      // P^T, packed
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      pa[i >> 3][(i & 7) >> 1] = att_pack<T>(s[i], s[i + 1]);
    att_fence_regs(dv);
    wgmma_fence();
    bwd_acc_tc<T, WV>(dv, pa, sm.op(stage, 1));   // dv += P^T dO
    wgmma_commit();
    wgmma_wait<0>();
    att_fence_regs(dv);
    if (lane == 0) mbar_arrive(sm.empty(stage));
    pipe.advance();
  }
  T* gv = static_cast<T*>(p.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.Tk) continue;
    const long long at = ((long long)b.n * p.Tk + key) * p.KH + b.kh;
#pragma unroll
    for (int j = 0; j < WV / 8; ++j) {
      const int col = 8 * j + c0;
      if (col < p.Dv)
        store2(gv + at * p.Dv + col, dv[4 * j + 2 * h],
               dv[4 * j + 2 * h + 1]);
    }
  }
}

#define BWD_WIDE_THREADS 288
constexpr int BWD_WIDE_CONSUMERS = 256;     // two warpgroups
static_assert(BWD_WIDE_THREADS == BWD_WIDE_CONSUMERS + 32, "one producer");

template <typename T, int WD, int WV>
__global__ void __launch_bounds__(BWD_WIDE_THREADS, 1)
dkdv_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap dmap, BwdTcArgs a) {
  extern __shared__ unsigned char tc_smem[];
  const BwdTcSmem sm = bwd_tc_smem_init(tc_smem, (WD + 63) / 64,
                                        (WV + 63) / 64, BWD_WIDE_CONSUMERS);
  const BwdKeyBlock b = bwd_key_block(a.p);
  if (threadIdx.x == BWD_WIDE_CONSUMERS) {
    if (b.ntiles > 0) bwd_key_producer(sm, &qmap, &kmap, &vmap, &dmap, a, b);
    return;
  }
  if (threadIdx.x > BWD_WIDE_CONSUMERS) return;
  if (threadIdx.x < BWD_TC_CONSUMERS)
    bwd_wide_dk<T, WD>(sm, a.p, b);
  else
    bwd_wide_dv<T, WV>(sm, a.p, b);
}

// -- dq pass: one block a (64-row query tile, kv head, n), query tiles
// descending (the heaviest first under the causal mask)

template <typename T, int W, int KB, int VB>
__global__ void __launch_bounds__(BWD_TC_THREADS, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap dmap, BwdTcArgs a) {
  extern __shared__ unsigned char tc_smem[];
  const BwdParams& p = a.p;
  const BwdTcSmem sm = bwd_tc_smem_init(tc_smem, KB, VB, BWD_TC_CONSUMERS);
  const int heads = p.KH * p.N;
  const int qtiles = a.Rp / BWD_BQ;
  const int qt = qtiles - 1 - (int)(blockIdx.x / heads);
  const int rest = blockIdx.x % heads;
  const int kh = rest % p.KH, n = rest / p.KH;
  const int i0 = qt * BWD_BQ, G = p.G, rows = p.Tq * G;
  const int vlen = min(p.valid_len[n], p.Tk);
  const int kend = att_key_end(i0, rows, G, p.q_offset[n], vlen, p.causal,
                               p.prefix_len);
  const int ntiles = kend > 0 ? (kend + ATT_TC_BK - 1) / ATT_TC_BK : 0;
  BwdPipe pipe;
  if (threadIdx.x == BWD_TC_CONSUMERS) {
    if (ntiles == 0) return;
    mbar_expect_tx(sm.resfull(), (KB + VB) * BWD_BOX);
    bwd_load_boxes(sm.res(0), &qmap, sm.resfull(), KB, kh * G, i0 / G, n);
    bwd_load_boxes(sm.res(1), &dmap, sm.resfull(), VB, kh * G, i0 / G, n);
    for (int it = 0; it < ntiles; ++it) {
      mbar_wait_trap(sm.empty(pipe.stage), pipe.phase ^ 1);
      const uint32_t full = sm.full(pipe.stage);
      mbar_expect_tx(full, (KB + VB) * BWD_BOX);
      bwd_load_boxes(sm.op(pipe.stage, 0), &kmap, full, KB, kh,
                     it * ATT_TC_BK, n);
      bwd_load_boxes(sm.op(pipe.stage, 1), &vmap, full, VB, kh,
                     it * ATT_TC_BK, n);
      pipe.advance();
    }
    return;
  }
  if (threadIdx.x > BWD_TC_CONSUMERS) return;

  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3);
  const int r0 = i0 + att_tc_row0();       // the thread's rows: r0, + 8
  const long long seg = ((long long)n * p.KH + kh) * a.Rp;
  const long long total = (long long)p.N * p.KH * a.Rp;
  float lo[2], de[2];
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lo[h] = a.stats[seg + r0 + 8 * h];
    de[h] = a.stats[total + seg + r0 + 8 * h];
    lim[h] = reinterpret_cast<const int*>(a.stats)[2 * total + seg + r0 +
                                                   8 * h];
  }
  const float scale2 = p.scale * ATT_LOG2E;
  float dq[W / 2];
#pragma unroll
  for (int j = 0; j < W / 2; ++j) dq[j] = 0.f;
  if (ntiles > 0) mbar_wait_trap(sm.resfull(), 0);
  for (int it = 0; it < ntiles; ++it) {
    const int kl0 = it * ATT_TC_BK;
    const int stage = pipe.stage;
    mbar_wait_trap(sm.full(stage), pipe.phase);
    if (kl0 + ATT_TC_BK > kend) {
      // K's rows [j0, 64) of every box to zero (whole 128-byte rows, so the
      // swizzle does not matter); V's may stay, dP is masked by a select
      const int j0 = kend - kl0;
      const int per_box = (ATT_TC_BK - j0) * 8;   // 16-byte chunks
      for (int e = threadIdx.x; e < KB * per_box; e += BWD_TC_CONSUMERS) {
        const uint32_t addr = sm.op(stage, 0) + (e / per_box) * BWD_BOX
                              + (j0 + (e % per_box) / 8) * 128
                              + (e % 8) * 16;
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                     "r"(0), "r"(0), "r"(0), "r"(0) : "memory");
      }
      fence_proxy_async_shared();
      asm volatile("bar.sync 1, %0;" ::"n"(BWD_TC_CONSUMERS) : "memory");
    }
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
    att_fence_regs(s);
    att_fence_regs(dp);
    wgmma_fence();
    bwd_scores_tc<T>(s, sm.res(0), sm.op(stage, 0), p.D / 16);    // S
    bwd_scores_tc<T>(dp, sm.res(1), sm.op(stage, 1), p.Dv / 16);  // dP
    wgmma_wait<1>();
    att_fence_regs(s);
    // s[4 j + 2 h + e]: row r0 + 8 h, key kl0 + 8 j + c0 + e
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const bool vis = kl0 + 8 * (i >> 2) + c0 + (i & 1) < lim[h];
      s[i] = vis ? att_exp2(fmaf(s[i], scale2, -lo[h])) : 0.f;
    }
    wgmma_wait<0>();
    att_fence_regs(dp);
    uint32_t sa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, key = kl0 + 8 * (i >> 2) + c0;
      const float d0 = key < lim[h] ? s[i] * (dp[i] - de[h]) : 0.f;
      const float d1 = key + 1 < lim[h] ? s[i + 1] * (dp[i + 1] - de[h]) : 0.f;
      sa[i >> 3][(i & 7) >> 1] = att_pack<T>(d0, d1);
    }
    att_fence_regs(dq);
    wgmma_fence();
    bwd_acc_tc<T, W>(dq, sa, sm.op(stage, 0));    // dq += dS K
    wgmma_commit();
    wgmma_wait<0>();
    att_fence_regs(dq);
    if (lane == 0) mbar_arrive(sm.empty(stage));
    pipe.advance();
  }

  T* g = static_cast<T*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= rows) continue;
    const int t = row / G, head = kh * G + row % G;
    const long long at = ((long long)n * p.Tq + t) * p.H + head;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + c0;
      if (col < p.D)
        store2(g + at * p.D + col, dq[4 * j + 2 * h] * p.scale,
               dq[4 * j + 2 * h + 1] * p.scale);
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

// -- host side of the tensor-core route -------------------------------------

// The route rule, checked again at launch: 16-bit operands, D a multiple of
// 16 in [16, 128] or 192 (MLA's heads, the wide instance), Dv a multiple of
// 16 in [16, 128], G dividing 64, and 16-byte-aligned pointers of what TMA,
// the bulk copies and the rows pass's vector loads read (the maps refuse
// byte strides off 16).
static bool bwd_tc_route_ok(int dtype, int D, int Dv, int G,
                            std::initializer_list<const void*> ptrs) {
  if (dtype != kBF16 && dtype != kF16) return false;
  auto head_ok = [](int x) { return x >= 16 && x <= 128 && x % 16 == 0; };
  if (!(head_ok(D) || D == 192) || !head_ok(Dv)) return false;
  if (G < 1 || 64 % G != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// A contiguous (N, T, heads, C) operand as the 5-D map (C, heads, T, N, 1)
// with box (64 columns, box_heads, box_pos).
static int bwd_map(CUtensorMap* map, const void* base, int dtype, int C,
                   int heads, int T, int N, int box_heads, int box_pos) {
  const long long dims[5] = {C, heads, T, N, 1};
  const long long el[4] = {C, (long long)heads * C, (long long)T * heads * C,
                           0};
  return att_tc_map(map, base, dtype, dims, el, box_heads, box_pos);
}

// The tensor maps of q, dO, K and V, and the rows pass (lse log2(e),
// delta and key end of every padded row into a.stats).
template <typename T>
static int bwd_tc_prologue(const BwdParams& p, int dtype, BwdTcArgs& a,
                           CUtensorMap& qmap, CUtensorMap& kmap,
                           CUtensorMap& vmap, CUtensorMap& dmap,
                           cudaStream_t stream) {
  a.p = p;
  a.stats = p.delta;
  a.Rp = (p.Tq * p.G + BWD_BQ - 1) / BWD_BQ * BWD_BQ;
  int err = bwd_map(&qmap, p.q, dtype, p.D, p.H, p.Tq, p.N, p.G,
                    BWD_BQ / p.G);
  if (err == 0)
    err = bwd_map(&dmap, p.dout, dtype, p.Dv, p.H, p.Tq, p.N, p.G,
                  BWD_BQ / p.G);
  if (err == 0)
    err = bwd_map(&kmap, p.k, dtype, p.D, p.KH, p.Tk, p.N, 1, ATT_TC_BK);
  if (err == 0)
    err = bwd_map(&vmap, p.v, dtype, p.Dv, p.KH, p.Tk, p.N, 1, ATT_TC_BK);
  if (err != 0) return err;
  const long long total = (long long)p.N * p.KH * a.Rp;
  bwd_rows_kernel<T><<<(unsigned)((total + BWD_NT - 1) / BWD_NT), BWD_NT, 0,
                       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
static int launch_bwd_tc(const BwdParams& p, int dtype, cudaStream_t stream) {
  BwdTcArgs a;
  CUtensorMap qmap, kmap, vmap, dmap;
  const int err = bwd_tc_prologue<T>(p, dtype, a, qmap, kmap, vmap, dmap,
                                     stream);
  if (err != 0) return err;
  constexpr int NBOX = (W + 63) / 64;
  const int smem = bwd_tc_smem_bytes(NBOX);
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_tc_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned heads = (unsigned)(p.KH * p.N);
  const unsigned ktiles = (unsigned)((p.Tk + ATT_TC_BK - 1) / ATT_TC_BK);
  dkdv_tc_kernel<T, W><<<ktiles * heads, BWD_TC_THREADS, smem, stream>>>(
      qmap, kmap, vmap, dmap, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_tc_kernel<T, W, NBOX, NBOX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_tc_kernel<T, W, NBOX, NBOX><<<(unsigned)(a.Rp / BWD_BQ) * heads,
                                   BWD_TC_THREADS, smem, stream>>>(
      qmap, kmap, vmap, dmap, a);
  REPRO_RETURN_LAUNCH_STATUS();
}

// The wide instance (D = 192, Dv up to 128): the two-warpgroup dk/dv pass,
// then the dq pass with dq 192 wide, q and K three boxes, dO and V two.
template <typename T>
static int launch_bwd_tc_wide(const BwdParams& p, int dtype,
                              cudaStream_t stream) {
  BwdTcArgs a;
  CUtensorMap qmap, kmap, vmap, dmap;
  const int err = bwd_tc_prologue<T>(p, dtype, a, qmap, kmap, vmap, dmap,
                                     stream);
  if (err != 0) return err;
  const int smem = bwd_tc_wide_smem_bytes(3, 2);
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_wide_kernel<T, 192, 128>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned heads = (unsigned)(p.KH * p.N);
  const unsigned ktiles = (unsigned)((p.Tk + ATT_TC_BK - 1) / ATT_TC_BK);
  dkdv_wide_kernel<T, 192, 128><<<ktiles * heads, BWD_WIDE_THREADS, smem,
                                  stream>>>(qmap, kmap, vmap, dmap, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_tc_kernel<T, 192, 3, 2>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_tc_kernel<T, 192, 3, 2><<<(unsigned)(a.Rp / BWD_BQ) * heads,
                               BWD_TC_THREADS, smem, stream>>>(
      qmap, kmap, vmap, dmap, a);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_bwd_tc(const BwdParams& p, int dtype,
                           cudaStream_t stream) {
  if (p.D == 192) return launch_bwd_tc_wide<T>(p, dtype, stream);
  switch (p.D > p.Dv ? p.D : p.Dv) {
    case 16: return launch_bwd_tc<T, 16>(p, dtype, stream);
    case 32: return launch_bwd_tc<T, 32>(p, dtype, stream);
    case 48: return launch_bwd_tc<T, 48>(p, dtype, stream);
    case 64: return launch_bwd_tc<T, 64>(p, dtype, stream);
    case 80: return launch_bwd_tc<T, 80>(p, dtype, stream);
    case 96: return launch_bwd_tc<T, 96>(p, dtype, stream);
    case 112: return launch_bwd_tc<T, 112>(p, dtype, stream);
    case 128: return launch_bwd_tc<T, 128>(p, dtype, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq, dk, dv of the forward's output from dO on `route` (kRouteSimt or
// kRouteWgmma, plan.attention_bwd_route's pick); every tensor contiguous in
// the layout above, `delta` f32 scratch the caller allocates: N Tq H values
// on the CUDA cores, 3 N KH Rp on the tensor cores.  A tensor-core launch
// off the rule is refused, not run.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* q_offset, const void* valid_len, int N, int Tq,
    int Tk, int H, int KH, int D, int Dv, int causal, int prefix_len,
    float scale, int dtype, int route, void* stream) {
  if (D < 1 || Dv < 1 || D > 256 || Dv > 256 || KH < 1 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      !bwd_tc_route_ok(dtype, D, Dv, H / KH, {q, k, v, o, dout, delta}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route != kRouteWgmma && route != kRouteSimt)
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
  if (route == kRouteWgmma) {
    if (dtype == kF16) return dispatch_bwd_tc<__half>(p, dtype, s);
    return dispatch_bwd_tc<__nv_bfloat16>(p, dtype, s);
  }
  switch (dtype) {
    case kF32: return dispatch_bwd<float>(p, s);
    case kF16: return dispatch_bwd<__half>(p, s);
    case kBF16: return dispatch_bwd<__nv_bfloat16>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
