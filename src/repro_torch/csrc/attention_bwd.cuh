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
  int xbytes;           // the exchange tiles' bytes (the 256-wide layout's)
  // i = 0: K (dk/dv pass) or q (dq pass); i = 1: V or dO
  __device__ uint32_t res(int i) const { return base + i * kb * BWD_BOX; }
  // i = 0: q (dk/dv pass) or K (dq pass); i = 1: dO or V
  __device__ uint32_t op(int s, int i) const {
    return base + ((1 + s) * (kb + vb) + i * kb) * BWD_BOX;
  }
  __device__ uint32_t boxes_end() const {
    return (1 + BWD_TC_STAGES) * (kb + vb) * BWD_BOX;
  }
  // the 256-wide layout's exchange tiles, after the boxes: P and dS in the
  // operand type (one box each) and P in f32
  __device__ uint32_t xp16() const { return base + boxes_end(); }
  __device__ uint32_t xds() const { return base + boxes_end() + BWD_BOX; }
  __device__ float* xp32() const {
    return reinterpret_cast<float*>(gen + boxes_end() + 2 * BWD_BOX);
  }
  __device__ uint32_t stats_off(int s) const {
    return boxes_end() + xbytes + s * BWD_ROW_STATS;
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
  // the 256-wide layout's loader state, after the barriers
  template <typename S>
  __device__ S* loads() const {
    return reinterpret_cast<S*>(gen + stats_off(BWD_TC_STAGES) +
                                8 * (2 * BWD_TC_STAGES + 1));
  }
};

using BwdPipe = StagePipe<BWD_TC_STAGES>;

// Every thread of the block calls it once (it syncs the block).  A stage's
// empty barrier waits on every consumer warp.  `xbytes`: the exchange
// tiles of the 256-wide layout (BWD_W_XBYTES), 0 in the others.
__device__ inline BwdTcSmem bwd_tc_smem_init(unsigned char* raw, int kb,
                                             int vb, int consumers,
                                             int xbytes = 0) {
  BwdTcSmem sm;
  const uint32_t raw_s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  sm.base = (raw_s + 1023) & ~1023u;
  sm.gen = raw + (sm.base - raw_s);
  sm.kb = kb;
  sm.vb = vb;
  sm.xbytes = xbytes;
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

// -- the 256-wide pair step (D = Dv = 256) ------------------------------------
//
// One warpgroup cannot hold a 64-key tile's dk and dv at 256 columns (256
// accumulators a thread) beside its score fragments, so the 256-wide
// instances (flash_attention_bwd.cu's passes and ring_attention_bwd.cu's
// items) run four consumer warpgroups, BWD_W_THREADS = 512 threads, and no
// producer warp: a 17th warp would put five warps on one of the SM's four
// schedulers and cap ptxas at 96 registers a thread (16,384 registers a
// scheduler), where 16 warps leave 128.  A (64-key tile, 64-row query
// tile) pair, bwd_w_kv_pair in a dk/dv item, bwd_w_q_pair in a dq item:
//  * warpgroup 0 forms S (S^T in a dk/dv item) and warpgroup 1 dP (dP^T),
//    each once a pair, 32 f32 a thread; warpgroup 0 turns S into P and
//    writes it to shared memory twice: in f32 in its fragment order (xp32,
//    16 KB) and, for a dk/dv item, rounded to the operand type as a 64 x 64
//    K-major tile, 128-byte swizzled as TMA would write it (xp16, 8 KB);
//    warpgroup 1 reads P back in f32, forms dS = P o (dP - delta) and writes
//    it rounded to the operand type (xds, 8 KB).  P and dS are rounded where
//    the narrow instances round them; dS takes P in f32, as there;
//  * then every warpgroup runs its share of the products with both operands
//    in shared memory (wgmma's SS form, the 16-bit operand through the
//    transpose bit): in a dk/dv item warpgroup w holds one 64 x 128 f32
//    slice, 64 registers a thread: dv[:, :128] and dv[:, 128:] (P^T dO),
//    dk[:, :128] and dk[:, 128:] (dS^T q); in a dq item one 64 x 64 slice of
//    dq (dS K), 32 a thread.
// Named barriers order the exchange: 1 (every consumer) once the scores
// are formed and the last pair's products are done with the tiles, 2
// (warpgroups 0 and 1) for P in f32, 3 (every consumer) before the
// products read P and dS, 4 (every consumer) after a dq item's key rows
// past its end are zeroed, 5 (warpgroups 0-2 arrive, 3 waits) once every
// product of the pair is done.  The block's loads are issued by one
// thread of warpgroup 3 (BWD_W_LOADER) through a loader the caller gives,
// at two hooks: scores_done(item_end) after barrier 1 (the resident pair
// is free once an item's last scores are formed) and products_done()
// after barrier 5 (the pair's stage is free: the pair two ahead lands
// there while the next one runs).  No empty barriers; every value is
// still written by one thread in one order: no atomics.
// Shared memory (bwd_w_smem_bytes): the narrow layout at four boxes an
// operand (its empty barriers unused), the exchange tiles after the boxes
// and the loader's state after the barriers (BWD_W_LOADS bytes: only the
// loading thread reads it, so it takes no register of the others),
// 232,104 bytes of the card's 232,448 a block.

#define BWD_W_THREADS 512

constexpr int BWD_W_CONSUMERS = 512;        // four warpgroups
constexpr int BWD_W_LOADER = 384;           // warpgroup 3's first thread
constexpr int BWD_W_XBYTES = 2 * BWD_BOX + 64 * 64 * 4;
static_assert(BWD_W_THREADS == BWD_W_CONSUMERS, "no producer warp");

// The loader's state in shared memory: BWD_W_LOADS bytes after the
// barriers; a block of a pass keeps its next tile, its tiles, the loads'
// (stage, phase) and its coordinates (kv head, sequence, first row)
// (ring_attention_bwd.cu keeps its cursors and the step there).
constexpr int BWD_W_LOADS = 128;
struct BwdWLoads {
  int tile, ntiles, stage;
  uint32_t phase;
  int kh, n, row0;
};

__host__ __device__ inline int bwd_w_smem_bytes() {
  return 1024 + (2 + 2 * BWD_TC_STAGES) * 4 * BWD_BOX + 2 * BWD_BOX
         + 64 * 64 * 4 + BWD_TC_STAGES * BWD_ROW_STATS
         + 8 * (2 * BWD_TC_STAGES + 1) + BWD_W_LOADS;
}

// The first of the two rows (of S, or of an accumulator) a thread owns in
// its warpgroup's tile: 16 warp + lane / 4 (the other is 8 below it).
__device__ __forceinline__ int bwd_w_row0() {
  return 16 * ((threadIdx.x / 32) & 3) + threadIdx.x % 32 / 4;
}

__device__ __forceinline__ void bwd_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bwd_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of element (m, k) of a 64 x 64 16-bit K-major tile,
// 128-byte swizzled: 16-byte chunk k / 8 of row m sits at chunk (k / 8) ^
// (m % 8).
__device__ __forceinline__ uint32_t bwd_swz(int m, int k) {
  return m * 128 + ((((k >> 3) ^ m) & 7) << 4) + (k & 7) * 2;
}

__device__ __forceinline__ void bwd_st32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}

#define BWD_WGMMA_SS64T(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31 "                                                   \
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "l"(da), "l"(db), "r"(1))

#define BWD_WGMMA_SS128T(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "                     \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(1))

// acc (64 x N, N = 64 or 128) += A (64 x 64, K-major, one swizzled box at
// shared address a) times the 64 x N operand at shared address b (64 rows,
// 64-column boxes, N-major); committed and waited for
template <typename T, int N>
__device__ __forceinline__ void bwd_w_acc(float (&d)[N / 2], uint32_t a,
                                          uint32_t b) {
  static_assert(N == 64 || N == 128, "a 256-wide slice");
  att_fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = tc_desc(a + kk * 32, 16, 1024);
    const uint64_t db = tc_desc(b + kk * 16 * 128, BWD_BOX, 1024);
    if constexpr (N == 64) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        BWD_WGMMA_SS64T(bf16);
      } else {
        BWD_WGMMA_SS64T(f16);
      }
    } else {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        BWD_WGMMA_SS128T(bf16);
      } else {
        BWD_WGMMA_SS128T(f16);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  att_fence_regs(d);
}

// Warpgroups 0 and 1: S (or S^T) from the pair (a0, b0) and dP (or dP^T)
// from (a1, b1) over `ksteps` 16-deep steps each, one a warpgroup, into s.
template <typename T>
__device__ __forceinline__ void bwd_w_scores(float (&s)[32], int wg,
                                             uint32_t a0, uint32_t b0,
                                             uint32_t a1, uint32_t b1,
                                             int ksteps) {
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  att_fence_regs(s);
  wgmma_fence();
  bwd_scores_tc<T>(s, wg == 0 ? a0 : a1, wg == 0 ? b0 : b1, ksteps);
  wgmma_wait<0>();
  att_fence_regs(s);
}

// The end of a pair: once every warpgroup's products are done, the loader
// fills the pair's stage (warpgroups 0-2 arrive and go on to the next
// pair's scores; warpgroup 3 waits).
template <typename L>
__device__ __forceinline__ void bwd_w_pair_end(int wg, L& ld) {
  if (wg < 3) {
    bwd_bar_arrive(5, BWD_W_CONSUMERS);
  } else {
    bwd_bar_sync(5, BWD_W_CONSUMERS);
    ld.products_done();
  }
}

// One pair of a dk/dv item: the stage's query tile against the resident 64
// keys (key0: the thread's first key, global; visible below its row's key
// end and kcap).  acc is the warpgroup's slice (above); D = Dv = 256;
// item_end: the item's last pair.
template <typename T, typename L>
__device__ __forceinline__ void bwd_w_kv_pair(const BwdTcSmem& sm, int stage,
                                              float (&acc)[64], int key0,
                                              int kcap, float scale2, L& ld,
                                              bool item_end) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int c0 = 2 * (threadIdx.x & 3), m0 = bwd_w_row0();
  const int* re = sm.rend(stage);
  float s[32];
  if (wg < 2) {
    // S^T = K q^T (warpgroup 0), dP^T = V dO^T (warpgroup 1)
    bwd_w_scores<T>(s, wg, sm.res(0), sm.op(stage, 0), sm.res(1),
                    sm.op(stage, 1), 16);
    if (wg == 0) bwd_pt_tc(s, key0, c0, sm.lse2(stage), re, scale2, kcap);
  }
  bwd_bar_sync(1, BWD_W_CONSUMERS);   // the last pair's products are done
  if (wg == 3) ld.scores_done(item_end);
  float* xp = sm.xp32();
  if (wg == 0) {
    // s[4 j + 2 h + e]: key m0 + 8 h, row 8 j + c0 + e of the query tile
#pragma unroll
    for (int i = 0; i < 32; ++i) xp[i * 128 + t] = s[i];
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      bwd_st32(sm.xp16() + bwd_swz(m0 + 8 * ((i >> 1) & 1),
                                   8 * (i >> 2) + c0),
               att_pack<T>(s[i], s[i + 1]));
    fence_proxy_async_shared();
    bwd_bar_arrive(2, 256);
  } else if (wg == 1) {
    bwd_bar_sync(2, 256);             // P in f32
    const float* dl = sm.delta(stage);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = 8 * (i >> 2) + c0, h = (i >> 1) & 1;
      const int key = key0 + 8 * h;
      const float d0 = key < min(re[col], kcap)
                           ? xp[i * 128 + t] * (s[i] - dl[col]) : 0.f;
      const float d1 = key < min(re[col + 1], kcap)
                           ? xp[(i + 1) * 128 + t] * (s[i + 1] - dl[col + 1])
                           : 0.f;
      bwd_st32(sm.xds() + bwd_swz(m0 + 8 * h, col), att_pack<T>(d0, d1));
    }
    fence_proxy_async_shared();
  }
  bwd_bar_sync(3, BWD_W_CONSUMERS);   // P^T and dS^T in place
  // dv[:, 128 (w & 1) ..] += P^T dO, dk[:, 128 (w & 1) ..] += dS^T q
  bwd_w_acc<T, 128>(acc, wg < 2 ? sm.xp16() : sm.xds(),
                    sm.op(stage, wg < 2 ? 1 : 0) + (wg & 1) * 2 * BWD_BOX);
  bwd_w_pair_end(wg, ld);
}

// One pair of a dq item: the stage's 64 keys (local kl0 ..; the item's
// keys end at kend) against the resident query tile; the thread's rows see
// local keys below cap[h] (h: its rows m0 and m0 + 8), their lse log2(e)
// lo and delta de.  acc is the warpgroup's 64-column slice of dq.
template <typename T, typename L>
__device__ __forceinline__ void bwd_w_q_pair(const BwdTcSmem& sm, int stage,
                                             float (&acc)[32], int kl0,
                                             int kend, const int (&cap)[2],
                                             const float (&lo)[2],
                                             const float (&de)[2],
                                             float scale2, L& ld,
                                             bool item_end) {
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int c0 = 2 * (threadIdx.x & 3), m0 = bwd_w_row0();
  if (kl0 + ATT_TC_BK > kend) {
    // K's rows [j0, 64) of its four boxes to zero (whole 128-byte rows);
    // V's may stay, dP is masked by a select
    const int j0 = kend - kl0;
    const int per_box = (ATT_TC_BK - j0) * 8;   // 16-byte chunks
    for (int e = threadIdx.x; e < 4 * per_box; e += BWD_W_CONSUMERS) {
      const uint32_t addr = sm.op(stage, 0) + (e / per_box) * BWD_BOX +
                            (j0 + (e % per_box) / 8) * 128 + (e % 8) * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                   "r"(0), "r"(0), "r"(0), "r"(0) : "memory");
    }
    fence_proxy_async_shared();
    bwd_bar_sync(4, BWD_W_CONSUMERS);
  }
  float s[32];
  if (wg < 2) {
    // S = q K^T (warpgroup 0), dP = dO V^T (warpgroup 1)
    bwd_w_scores<T>(s, wg, sm.res(0), sm.op(stage, 0), sm.res(1),
                    sm.op(stage, 1), 16);
    if (wg == 0) {
      // s[4 j + 2 h + e]: row m0 + 8 h, local key kl0 + 8 j + c0 + e
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const bool vis = kl0 + 8 * (i >> 2) + c0 + (i & 1) < cap[h];
        s[i] = vis ? att_exp2(fmaf(s[i], scale2, -lo[h])) : 0.f;
      }
    }
  }
  bwd_bar_sync(1, BWD_W_CONSUMERS);   // the last pair's products are done
  if (wg == 3) ld.scores_done(item_end);
  float* xp = sm.xp32();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) xp[i * 128 + t] = s[i];
    bwd_bar_arrive(2, 256);
  } else if (wg == 1) {
    bwd_bar_sync(2, 256);             // P in f32
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, key = kl0 + 8 * (i >> 2) + c0;
      const float d0 =
          key < cap[h] ? xp[i * 128 + t] * (s[i] - de[h]) : 0.f;
      const float d1 = key + 1 < cap[h]
                           ? xp[(i + 1) * 128 + t] * (s[i + 1] - de[h])
                           : 0.f;
      bwd_st32(sm.xds() + bwd_swz(m0 + 8 * h, 8 * (i >> 2) + c0),
               att_pack<T>(d0, d1));
    }
    fence_proxy_async_shared();
  }
  bwd_bar_sync(3, BWD_W_CONSUMERS);   // dS in place
  // dq[:, 64 w ..] += dS K
  bwd_w_acc<T, 64>(acc, sm.xds(), sm.op(stage, 0) + wg * BWD_BOX);
  bwd_w_pair_end(wg, ld);
}
