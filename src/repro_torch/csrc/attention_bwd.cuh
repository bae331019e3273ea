// The CUDA-core passes of attention's gradient, item by item, shared by
// flash_attention_bwd.cu (row 10: one item a block of each pass) and
// ring_attention_bwd.cu (row 14: the items of every ring step dealt to a
// cooperative grid).  The formulas are flash_attention_bwd.cu's:
//   P  = exp(scale q k^T - lse)  (0 where masked)
//   dv = P^T dO,  dP = dO v^T,  dS = P o (dP - delta),  delta = rowsum(dO o O)
//   dq = scale dS k,   dk = scale dS^T q.
//
// The tile is attention.cuh's: ATT_BQ = 64 query rows (row = t G + g, head
// kh G + g) by BK = 16 KA keys, ATT_NT = 256 threads in a 16 x 16 layout;
// thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j of the score
// tiles S and dP and, for the gradients it holds, rows (dq) or keys (dk,
// dv) ty + 16 a and columns tx + 16 c (c < NT, NT 16-column groups
// covering max(D, Dv)).  Operands sit in shared memory in f32, transposed
// (column-major, one column of padding), so a thread's products walk
// contiguous columns: q scaled (D x 65), dO (Dv x 65), k (D x (BK + 1)),
// v (Dv x (BK + 1)), then P and dS (64 x (BK + 1)), the rows' lse and
// delta (64 each): bwd_smem_floats() of them.  KA = 4 (64 keys) up to 128
// columns, 2 (32 keys) above, which keeps a block under 227 KB at D = Dv =
// 256.
//
// A key run is one sequence of a (., Tk, KH, C) operand whose key j sits at
// global position kbase + j (flash: the whole sequence, kbase = 0; the
// ring: one stripe).  Key kbase + j is visible to a row at query position
// qpos when j < Tk, kbase + j < vlen and, if causal, kbase + j <= qpos or
// both lie in the prefix window [0, prefix_len).
#pragma once

#include <math_constants.h>

#include "attention.cuh"

static_assert(ATT_BQ == 64 && ATT_NT == 256, "a 16 x 16 layout, 64 rows");

__host__ __device__ inline size_t bwd_smem_floats(int D, int Dv, int BK) {
  return (size_t)(D + Dv) * (ATT_BQ + 1) + (size_t)(D + Dv) * (BK + 1) +
         2 * (size_t)ATT_BQ * (BK + 1) + 2 * ATT_BQ;
}

// One work item's operands: the query side (rows of sequence n of q and dO,
// (N, Tq, H, D | Dv), and of lse and delta, (N, Tq, H) f32) and one key run
// (sequence kn of k and v, (., Tk, KH, D | Dv)).
template <typename T>
struct BwdItem {
  const T* q;
  const T* dout;
  const float* lse;
  const float* delta;
  const T* k;
  const T* v;
  long long n, kn;
  int Tq, H, G, qoff;     // query t sits at global position qoff + t
  int Tk, KH, kh, kbase;  // key j at kbase + j
  int D, Dv, vlen, causal, prefix_len;
  float scale;
};

// delta = rowsum(dO o O) of `rows` (N Tq H) rows of o and dO, one warp a
// row, grid-stride from warp `w0` over `wstride` warps.
template <typename T>
__device__ __forceinline__ void bwd_delta_rows(float* delta, const T* o,
                                               const T* dout, long long rows,
                                               int Dv, long long w0,
                                               long long wstride) {
  const int lane = threadIdx.x % 32;
  for (long long row = w0; row < rows; row += wstride) {
    const T* ro = o + row * Dv;
    const T* rd = dout + row * Dv;
    float s = 0.f;
    for (int c = lane; c < Dv; c += 32)
      s = fmaf(to_f32(ro[c]), to_f32(rd[c]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) delta[row] = s;
  }
}

// Stage rows [i0, i0 + 64) (row = t G + g, head kh G + g) of a (N, Tq, H,
// C) operand of sequence n, times mul, transposed into dst (C x 65); rows
// past `rows` as zeros.
template <typename T>
__device__ __forceinline__ void bwd_stage_rows(float* dst, const T* src,
                                               long long n, int i0, int rows,
                                               int Tq, int H, int G, int kh,
                                               int C, float mul) {
  for (int e = threadIdx.x; e < ATT_BQ * C; e += ATT_NT) {
    const int i = e / C, c = e % C;
    const int row = i0 + i;
    float val = 0.f;
    if (row < rows) {
      const int t = row / G, h = kh * G + row % G;
      val = to_f32(src[((n * Tq + t) * H + h) * C + c]) * mul;
    }
    dst[c * (ATT_BQ + 1) + i] = val;
  }
}

// Stage keys [k0, k0 + BK) of kv head kh of a (N, Tk, KH, C) operand,
// transposed into dst (C x (BK + 1)); keys at or past kend as zeros.
template <typename T>
__device__ __forceinline__ void bwd_stage_keys(float* dst, const T* src,
                                               long long n, int k0, int kend,
                                               int Tk, int KH, int kh, int C,
                                               int BK) {
  for (int e = threadIdx.x; e < BK * C; e += ATT_NT) {
    const int j = e / C, c = e % C;
    const int kp = k0 + j;
    dst[c * (BK + 1) + j] =
        kp < kend ? to_f32(src[((n * Tk + kp) * KH + kh) * C + c]) : 0.f;
  }
}

// The rows' lse and delta of the tile starting at i0 into ls / ds (64 each);
// rows past `rows` get lse = +inf (p = 0).
template <typename T>
__device__ __forceinline__ void bwd_stage_stats(float* ls, float* ds,
                                                const BwdItem<T>& it, int i0,
                                                int rows) {
  for (int i = threadIdx.x; i < ATT_BQ; i += ATT_NT) {
    const int row = i0 + i;
    float l = CUDART_INF_F, d = 0.f;
    if (row < rows) {
      const int t = row / it.G, h = it.kh * it.G + row % it.G;
      const long long at = (it.n * it.Tq + t) * it.H + h;
      l = it.lse[at];
      d = it.delta[at];
    }
    ls[i] = l;
    ds[i] = d;
  }
}

// One (query tile, key tile) step: S = q_scaled k^T and dP = dO v^T from the
// staged operands, then P and dS into ps / dss (64 x (BK + 1)).  Local key
// k0 + j of the run (global kbase + k0 + j) is visible to a row at qpos
// when k0 + j < klim and under the forward's masks.
template <int KA>
__device__ __forceinline__ void bwd_scores(
    const float* qt, const float* dot, const float* kt, const float* vt,
    const float* ls, const float* dls, float* ps, float* dss, int D, int Dv,
    int i0, int rows, int G, int qoff, int k0, int kbase, int klim,
    int vlen, int causal, int prefix_len) {
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
    for (int i = 0; i < 4; ++i) qa[i] = qt[d * (ATT_BQ + 1) + ty + 16 * i];
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
    for (int i = 0; i < 4; ++i) da[i] = dot[c * (ATT_BQ + 1) + ty + 16 * i];
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
      const int kl = k0 + tx + 16 * j;
      const int kp = kbase + kl;
      bool vis = rvalid && kl < klim && kp < vlen;
      if (causal)
        vis = vis && (kp <= qpos || (kp < prefix_len && qpos < prefix_len));
      const float pv = vis ? expf(s[i][j] - ls[r]) : 0.f;
      ps[r * (BK + 1) + tx + 16 * j] = pv;
      dss[r * (BK + 1) + tx + 16 * j] = vis ? pv * (dp[i][j] - dls[r]) : 0.f;
    }
  }
}

// The keys of the run an item may read: [0, Tk) cut at vlen.
template <typename T>
__device__ __forceinline__ int bwd_key_limit(const BwdItem<T>& it) {
  return max(min(it.Tk, it.vlen - it.kbase), 0);
}

// dk and dv of the run's keys [k0, k0 + BK) of kv head it.kh, summed over
// every query row that sees one of them, added into the thread's dk / dv
// (keys ty + 16 a, columns tx + 16 c; dk carries the scale).  Begins with a
// barrier, so the caller may reuse the shared memory between items.
template <typename T, int NT, int KA>
__device__ __forceinline__ void bwd_dkdv_tile(float* smem,
                                              const BwdItem<T>& it, int k0,
                                              float (&dk)[KA][NT],
                                              float (&dv)[KA][NT]) {
  constexpr int BK = 16 * KA;
  const int D = it.D, Dv = it.Dv, G = it.G;
  float* qt = smem;                              // [D][65]  q scaled
  float* dot = qt + D * (ATT_BQ + 1);            // [Dv][65] dO
  float* kt = dot + Dv * (ATT_BQ + 1);           // [D][BK + 1]
  float* vt = kt + D * (BK + 1);                 // [Dv][BK + 1]
  float* ps = vt + Dv * (BK + 1);                // [64][BK + 1] P
  float* dss = ps + ATT_BQ * (BK + 1);           // [64][BK + 1] dS
  float* ls = dss + ATT_BQ * (BK + 1);           // [64] lse
  float* dls = ls + ATT_BQ;                      // [64] delta
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int rows = it.Tq * G;
  const int klim = bwd_key_limit(it);
  if (k0 >= klim) return;
  __syncthreads();                               // the previous item's reads
  bwd_stage_keys(kt, it.k, it.kn, k0, klim, it.Tk, it.KH, it.kh, D, BK);
  bwd_stage_keys(vt, it.v, it.kn, k0, klim, it.Tk, it.KH, it.kh, Dv, BK);
  // the first row that can see a key of the tile: every row inside the
  // prefix window, else the causal frontier
  int row0 = 0;
  if (it.causal && it.kbase + k0 >= it.prefix_len)
    row0 = max(it.kbase + k0 - it.qoff, 0) * G;
  for (int i0 = row0; i0 < rows; i0 += ATT_BQ) {
    __syncthreads();                             // previous tile consumed
    bwd_stage_rows(qt, it.q, it.n, i0, rows, it.Tq, it.H, G, it.kh, D,
                   it.scale);
    bwd_stage_rows(dot, it.dout, it.n, i0, rows, it.Tq, it.H, G, it.kh, Dv,
                   1.f);
    bwd_stage_stats(ls, dls, it, i0, rows);
    __syncthreads();
    bwd_scores<KA>(qt, dot, kt, vt, ls, dls, ps, dss, D, Dv, i0, rows, G,
                   it.qoff, k0, it.kbase, klim, it.vlen, it.causal,
                   it.prefix_len);
    __syncthreads();
    for (int r = 0; r < ATT_BQ; ++r) {
      float pa[KA], sa[KA];
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        pa[a] = ps[r * (BK + 1) + ty + 16 * a];
        sa[a] = dss[r * (BK + 1) + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const int col = tx + 16 * c;
        const float dov = col < Dv ? dot[col * (ATT_BQ + 1) + r] : 0.f;
        const float qv = col < D ? qt[col * (ATT_BQ + 1) + r] : 0.f;
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          dv[a][c] = fmaf(pa[a], dov, dv[a][c]);
          dk[a][c] = fmaf(sa[a], qv, dk[a][c]);
        }
      }
    }
  }
}

// Stage the query tile [i0, i0 + 64) of kv head it.kh for bwd_dq_keys: q
// scaled, dO and the rows' lse and delta.  Begins with a barrier.
template <typename T>
__device__ __forceinline__ void bwd_stage_query_tile(float* smem,
                                                     const BwdItem<T>& it,
                                                     int i0, int BK) {
  const int D = it.D, Dv = it.Dv, rows = it.Tq * it.G;
  float* qt = smem;
  float* dot = qt + D * (ATT_BQ + 1);
  float* ls = dot + Dv * (ATT_BQ + 1) + (D + Dv) * (BK + 1) +
              2 * ATT_BQ * (BK + 1);
  __syncthreads();                               // the previous item's reads
  bwd_stage_rows(qt, it.q, it.n, i0, rows, it.Tq, it.H, it.G, it.kh, D,
                 it.scale);
  bwd_stage_rows(dot, it.dout, it.n, i0, rows, it.Tq, it.H, it.G, it.kh, Dv,
                 1.f);
  bwd_stage_stats(ls, ls + ATT_BQ, it, i0, rows);
}

// dq of the staged query tile [i0, i0 + 64) from the run's keys [0, kend)
// (kend <= bwd_key_limit), added into the thread's dq (rows ty + 16 i,
// columns tx + 16 c; without the scale).
template <typename T, int NT, int KA>
__device__ __forceinline__ void bwd_dq_keys(float* smem, const BwdItem<T>& it,
                                            int i0, int kend,
                                            float (&dq)[4][NT]) {
  constexpr int BK = 16 * KA;
  const int D = it.D, Dv = it.Dv, G = it.G;
  float* qt = smem;
  float* dot = qt + D * (ATT_BQ + 1);
  float* kt = dot + Dv * (ATT_BQ + 1);
  float* vt = kt + D * (BK + 1);
  float* ps = vt + Dv * (BK + 1);
  float* dss = ps + ATT_BQ * (BK + 1);
  float* ls = dss + ATT_BQ * (BK + 1);
  float* dls = ls + ATT_BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int rows = it.Tq * G;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                             // previous tile consumed
    bwd_stage_keys(kt, it.k, it.kn, k0, kend, it.Tk, it.KH, it.kh, D, BK);
    bwd_stage_keys(vt, it.v, it.kn, k0, kend, it.Tk, it.KH, it.kh, Dv, BK);
    __syncthreads();
    bwd_scores<KA>(qt, dot, kt, vt, ls, dls, ps, dss, D, Dv, i0, rows, G,
                   it.qoff, k0, it.kbase, kend, it.vlen, it.causal,
                   it.prefix_len);
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
}

// The keys [0, kend) of the run that some row of the query tile [i0, i0 +
// 64) sees: the run's limit cut at the tile's causal frontier (widened to
// the prefix window), in the run's local positions.
template <typename T>
__device__ __forceinline__ int bwd_tile_key_end(const BwdItem<T>& it,
                                                int i0) {
  const int kend = att_key_end(i0, it.Tq * it.G, it.G, it.qoff, it.vlen,
                               it.causal, it.prefix_len);
  return max(min(bwd_key_limit(it), kend - it.kbase), 0);
}

// -- the tensor-core route (TMA + wgmma) ---------------------------------------
//
// The pieces row 10's tensor-core passes (flash_attention_bwd.cu) and row
// 14's (ring_attention_bwd.cu) share: a block of one consumer warpgroup
// and one producer warp; a resident pair (K and V, or q and dO) and
// BWD_TC_STAGES stages of the streamed pair and the rows' stats, every
// box 64 rows of 128 bytes, 128-byte swizzled; S^T / S and dP^T / dP by
// wgmma m64n64k16 from shared memory, the gradients in the RS form.

#define BWD_TC_STAGES 2
#define BWD_TC_THREADS 160

constexpr int BWD_TC_CONSUMERS = 128;       // one warpgroup, 64 rows or keys
constexpr int BWD_BOX = 64 * 128;           // one box: 64 rows of 128 bytes
constexpr int BWD_ROW_STATS = 3 * 64 * 4;   // a tile's lse log2(e), delta, rend
static_assert(BWD_TC_THREADS == BWD_TC_CONSUMERS + 32, "one producer warp");
static_assert(ATT_BQ == 64 && ATT_TC_BK == 64, "wgmma m64 / n64 tiles");

// Dynamic shared memory of a tensor-core pass whose operands are `nbox`
// 64-column boxes wide: 1024 bytes of slack for the swizzle's alignment,
// the block's resident pair (K and V, or q and dO), the stages' streamed
// pairs, the stages' row stats and the barriers (full and empty of each
// stage, and the resident pair's).
__host__ __device__ inline int bwd_tc_smem_bytes(int nbox) {
  return 1024 + (2 + 2 * BWD_TC_STAGES) * nbox * BWD_BOX
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

// Producer: `nbox` 64-column boxes of a 5-D map at (kh0, pos, n, d4) into
// dst
__device__ __forceinline__ void bwd_load_boxes(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int nbox,
                                               int kh0, int pos, int n,
                                               int d4 = 0) {
  for (int c = 0; c < nbox; ++c)
    tma_load_5d(dst + c * BWD_BOX, map, bar, c * 64, kh0, pos, n, d4);
}

// P^T = 2^(S^T scale log2(e) - lse log2(e)) in place of S^T's fragment
// (s[4 j + 2 h + e]: key key0 + 8 h, row 8 j + c0 + e of the tile), 0
// where the row's key end hides the key or the key sits at or past kcap
__device__ __forceinline__ void bwd_pt_tc(float (&s)[32], int key0, int c0,
                                          const float* l2, const int* re,
                                          float scale2,
                                          int kcap = 0x7fffffff) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + c0 + e;
      const float lo = l2[col];
      const int lim = min(re[col], kcap);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        s[i] = key0 + 8 * h < lim ? att_exp2(fmaf(s[i], scale2, -lo)) : 0.f;
      }
    }
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
