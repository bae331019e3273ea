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
//   dq_tc_kernel; dkdv_w_kernel and dq_w_kernel at 256): f16 and bf16 with
//   D a multiple of 16 in [16, 128] or 192 (deepseek-v3's MLA heads: the
//   wide instance, below) and Dv a multiple of 16 in [16, 128], or D = Dv
//   = 256 (paligemma-3b's heads: the 256-wide instance, below), G dividing
//   64, 16-byte-aligned operands.  `delta`
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
//   The 256-wide instance (D = Dv = 256) runs both passes on
//   attention_bwd.cuh's pair step: four consumer warpgroups share each
//   (key tile, query tile) pair, S and dP formed once a pair by warpgroups
//   0 and 1 and exchanged through shared memory as P and dS, every product
//   in wgmma's SS form; in the dk/dv pass each warpgroup holds a 128-column
//   slice of dk or dv, in the dq pass a 64-column slice of dq.  No producer
//   warp: one consumer thread issues the loads at the pair step's barriers
//   (BwdWLoader), which leaves ptxas 128 registers a thread.
//
// * CUDA cores (delta_kernel, dkdv_kernel, dq_kernel): f32 and every shape
//   off the rule.  `delta` holds N Tq H values.  Their item routines live in
//   attention_bwd.cuh, which the ring's gradient (ring_attention_bwd.cu)
//   runs too.
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
#include "attention_bwd.cuh"

#define BWD_BQ 64
#define BWD_NT 256

// the CUDA-core passes' tile is attention_bwd.cuh's (attention.cuh's)
static_assert(BWD_BQ == ATT_BQ && BWD_NT == ATT_NT, "one 64-row tile");

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

// The work item of sequence n, kv head kh: its queries and its whole K/V.
template <typename T>
__device__ __forceinline__ BwdItem<T> bwd_item(const BwdParams& p, int n,
                                               int kh) {
  BwdItem<T> it;
  it.q = static_cast<const T*>(p.q);
  it.dout = static_cast<const T*>(p.dout);
  it.lse = p.lse;
  it.delta = p.delta;
  it.k = static_cast<const T*>(p.k);
  it.v = static_cast<const T*>(p.v);
  it.n = it.kn = n;
  it.Tq = p.Tq; it.H = p.H; it.G = p.G; it.qoff = p.q_offset[n];
  it.Tk = p.Tk; it.KH = p.KH; it.kh = kh; it.kbase = 0;
  it.D = p.D; it.Dv = p.Dv; it.vlen = min(p.valid_len[n], p.Tk);
  it.causal = p.causal; it.prefix_len = p.prefix_len; it.scale = p.scale;
  return it;
}

// -- pass 1 ------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BWD_NT) delta_kernel(BwdParams p) {
  const long long rows = (long long)p.N * p.Tq * p.H;
  bwd_delta_rows(p.delta, static_cast<const T*>(p.o),
                 static_cast<const T*>(p.dout), rows, p.Dv,
                 (long long)blockIdx.x * (BWD_NT / 32) + threadIdx.x / 32,
                 rows);
}

// -- pass 2: dk and dv ---------------------------------------------------------

template <typename T, int NT, int KA>
__global__ void __launch_bounds__(BWD_NT) dkdv_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * 16 * KA;
  const BwdItem<T> it = bwd_item<T>(p, blockIdx.z, blockIdx.y);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float dk[KA][NT], dv[KA][NT];
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int c = 0; c < NT; ++c) dk[a][c] = dv[a][c] = 0.f;
  bwd_dkdv_tile<T, NT, KA>(smem, it, k0, dk, dv);

  T* gk = static_cast<T*>(p.dk);
  T* gv = static_cast<T*>(p.dv);
#pragma unroll
  for (int a = 0; a < KA; ++a) {
    const int kp = k0 + ty + 16 * a;
    if (kp >= p.Tk) continue;
    const long long at = ((long long)it.n * p.Tk + kp) * p.KH + it.kh;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) gk[at * p.D + col] = from_f32<T>(dk[a][c]);
      if (col < p.Dv) gv[at * p.Dv + col] = from_f32<T>(dv[a][c]);
    }
  }
}

// -- pass 3: dq ----------------------------------------------------------------

template <typename T, int NT, int KA>
__global__ void __launch_bounds__(BWD_NT) dq_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * BWD_BQ;
  const BwdItem<T> it = bwd_item<T>(p, blockIdx.z, blockIdx.y);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  bwd_stage_query_tile(smem, it, i0, 16 * KA);
  float dq[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NT; ++c) dq[i][c] = 0.f;
  bwd_dq_keys<T, NT, KA>(smem, it, i0, bwd_tile_key_end(it, i0), dq);

  T* g = static_cast<T*>(p.dq);
  const int rows = p.Tq * p.G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= rows) continue;
    const int t = row / p.G, h = it.kh * p.G + row % p.G;
    const long long at = ((long long)it.n * p.Tq + t) * p.H + h;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) g[at * p.D + col] = from_f32<T>(dq[i][c] * p.scale);
    }
  }
}

// -- the tensor-core route (TMA + wgmma) -------------------------------------

// The same layout with the D-wide operands (q, K) kb boxes and the Dv-wide
// ones (dO, V) vb boxes: the wide instance's (below).  At kb = vb = nbox it
// is bwd_tc_smem_bytes(nbox).
__host__ __device__ inline int bwd_tc_wide_smem_bytes(int kb, int vb) {
  return 1024 + (1 + BWD_TC_STAGES) * (kb + vb) * BWD_BOX
         + BWD_TC_STAGES * BWD_ROW_STATS + 8 * (2 * BWD_TC_STAGES + 1);
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

// The first row of the padded tile order that can see key k0: every row
// in the prefix window, else the causal frontier; rounded down to a tile.
__device__ __forceinline__ int bwd_first_row(const BwdParams& p, int k0,
                                             int qoff) {
  if (!p.causal || k0 < p.prefix_len) return 0;
  return max(k0 - qoff, 0) * p.G / BWD_BQ * BWD_BQ;
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

// The dk/dv pass's loads: K and V of the block's keys (the resident pair),
// and q, dO and the rows' stats of query tile i0 into stage s.
__device__ __forceinline__ void bwd_key_res_load(const BwdTcSmem& sm,
                                                 const CUtensorMap* kmap,
                                                 const CUtensorMap* vmap,
                                                 const BwdKeyBlock& b) {
  mbar_expect_tx(sm.resfull(), (sm.kb + sm.vb) * BWD_BOX);
  bwd_load_boxes(sm.res(0), kmap, sm.resfull(), sm.kb, b.kh, b.k0, b.n);
  bwd_load_boxes(sm.res(1), vmap, sm.resfull(), sm.vb, b.kh, b.k0, b.n);
}

__device__ __forceinline__ void bwd_key_tile_load(
    const BwdTcSmem& sm, const CUtensorMap* qmap, const CUtensorMap* dmap,
    const BwdTcArgs& a, const BwdKeyBlock& b, int i0, int s) {
  const BwdParams& p = a.p;
  const long long seg = ((long long)b.n * p.KH + b.kh) * a.Rp;
  const long long total = (long long)p.N * p.KH * a.Rp;
  const uint32_t full = sm.full(s);
  mbar_expect_tx(full, (sm.kb + sm.vb) * BWD_BOX + BWD_ROW_STATS);
  bwd_load_boxes(sm.op(s, 0), qmap, full, sm.kb, b.kh * p.G, i0 / p.G, b.n);
  bwd_load_boxes(sm.op(s, 1), dmap, full, sm.vb, b.kh * p.G, i0 / p.G, b.n);
  for (int j = 0; j < 3; ++j)
    bulk_load(sm.stats(s) + j * 256, a.stats + j * total + seg + i0, 256,
              full);
}

// Producer of the dk/dv pass: the resident pair once, then each query
// tile into the next stage once the consumers release it.
__device__ __forceinline__ void bwd_key_producer(
    const BwdTcSmem& sm, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* dmap, const BwdTcArgs& a,
    const BwdKeyBlock& b) {
  BwdPipe pipe;
  bwd_key_res_load(sm, kmap, vmap, b);
  for (int it = 0; it < b.ntiles; ++it) {
    mbar_wait_trap(sm.empty(pipe.stage), pipe.phase ^ 1);
    bwd_key_tile_load(sm, qmap, dmap, a, b, b.row0 + it * BWD_BQ,
                      pipe.stage);
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

// The dq pass's loads: q and dO of the block's rows (from position t0:
// the resident pair), and K and V of key tile `it` into stage s.
__device__ __forceinline__ void bwd_query_res_load(const BwdTcSmem& sm,
                                                   const CUtensorMap* qmap,
                                                   const CUtensorMap* dmap,
                                                   int kh, int n, int t0,
                                                   int G) {
  mbar_expect_tx(sm.resfull(), (sm.kb + sm.vb) * BWD_BOX);
  bwd_load_boxes(sm.res(0), qmap, sm.resfull(), sm.kb, kh * G, t0, n);
  bwd_load_boxes(sm.res(1), dmap, sm.resfull(), sm.vb, kh * G, t0, n);
}

__device__ __forceinline__ void bwd_query_tile_load(const BwdTcSmem& sm,
                                                    const CUtensorMap* kmap,
                                                    const CUtensorMap* vmap,
                                                    int kh, int n, int it,
                                                    int s) {
  const uint32_t full = sm.full(s);
  mbar_expect_tx(full, (sm.kb + sm.vb) * BWD_BOX);
  bwd_load_boxes(sm.op(s, 0), kmap, full, sm.kb, kh, it * ATT_TC_BK, n);
  bwd_load_boxes(sm.op(s, 1), vmap, full, sm.vb, kh, it * ATT_TC_BK, n);
}

// Producer of the dq pass: the resident pair once, then each of its ntiles
// key tiles into the next stage once the consumers release it.
__device__ __forceinline__ void bwd_query_producer(
    const BwdTcSmem& sm, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* dmap, int kh, int n, int t0,
    int G, int ntiles) {
  if (ntiles == 0) return;
  BwdPipe pipe;
  bwd_query_res_load(sm, qmap, dmap, kh, n, t0, G);
  for (int it = 0; it < ntiles; ++it) {
    mbar_wait_trap(sm.empty(pipe.stage), pipe.phase ^ 1);
    bwd_query_tile_load(sm, kmap, vmap, kh, n, it, pipe.stage);
    pipe.advance();
  }
}

// The dq pass's block: its query tile (descending: the heaviest first
// under the causal mask), kv head and sequence, and its key end.
struct BwdQueryBlock {
  int kh, n, i0, kend, ntiles;
};

__device__ __forceinline__ BwdQueryBlock bwd_query_block(const BwdTcArgs& a) {
  const BwdParams& p = a.p;
  BwdQueryBlock b;
  const int heads = p.KH * p.N;
  const int qtiles = a.Rp / BWD_BQ;
  const int qt = qtiles - 1 - (int)(blockIdx.x / heads);
  const int rest = blockIdx.x % heads;
  b.kh = rest % p.KH;
  b.n = rest / p.KH;
  b.i0 = qt * BWD_BQ;
  const int vlen = min(p.valid_len[b.n], p.Tk);
  b.kend = att_key_end(b.i0, p.Tq * p.G, p.G, p.q_offset[b.n], vlen,
                       p.causal, p.prefix_len);
  b.ntiles = b.kend > 0 ? (b.kend + ATT_TC_BK - 1) / ATT_TC_BK : 0;
  return b;
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
  const BwdQueryBlock b = bwd_query_block(a);
  const int kh = b.kh, n = b.n, i0 = b.i0, kend = b.kend, ntiles = b.ntiles;
  const int G = p.G, rows = p.Tq * G;
  BwdPipe pipe;
  if (threadIdx.x == BWD_TC_CONSUMERS) {
    bwd_query_producer(sm, &qmap, &kmap, &vmap, &dmap, kh, n, i0 / G, G,
                       ntiles);
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

// -- the 256-wide passes: D = Dv = 256 (paligemma-3b's heads) on
// attention_bwd.cuh's pair step (four consumer warpgroups, no producer
// warp), the blocks of the passes above; one thread of warpgroup 3 loads
// the resident pair and the first two tiles, then each tile two ahead as
// the pair step's hooks call it.

// The block's stream of tiles, by BWD_W_LOADER: the next tile into the
// loads' next stage.  Its state (BwdWLoads: the block's coordinates, the
// next tile, the loads' (stage, phase)) lives in shared memory, so it
// holds no register of the consumers.  KEYS: the dk/dv pass (q, dO and the
// rows' stats of query tiles, maps m0 and m1 = q and dO), else the dq pass
// (K and V of key tiles, m0 and m1 = K and V).
template <bool KEYS>
struct BwdWLoader {
  const BwdTcSmem& sm;
  const CUtensorMap *m0, *m1;
  const BwdTcArgs& a;
  __device__ void fill() const {
    BwdWLoads& ls = *sm.loads<BwdWLoads>();
    if (ls.tile >= ls.ntiles) return;
    if constexpr (KEYS)
      bwd_key_tile_load(sm, m0, m1, a,
                        BwdKeyBlock{ls.kh, ls.n, 0, ls.row0, ls.ntiles},
                        ls.row0 + ls.tile * BWD_BQ, ls.stage);
    else
      bwd_query_tile_load(sm, m0, m1, ls.kh, ls.n, ls.tile, ls.stage);
    ++ls.tile;
    if (++ls.stage == BWD_TC_STAGES) {
      ls.stage = 0;
      ls.phase ^= 1;
    }
  }
  // the block's coordinates, then its first two tiles (BWD_W_LOADER)
  __device__ void start(int kh, int n, int row0, int ntiles) const {
    BwdWLoads& ls = *sm.loads<BwdWLoads>();
    ls = BwdWLoads{0, ntiles, 0, 0, kh, n, row0};
    fill();
    fill();
  }
  __device__ void scores_done(bool) const {}
  __device__ void products_done() const {
    if (threadIdx.x == BWD_W_LOADER) fill();
  }
};

template <typename T>
__global__ void __launch_bounds__(BWD_W_THREADS, 1)
dkdv_w_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap dmap, BwdTcArgs a) {
  extern __shared__ unsigned char tc_smem[];
  const BwdParams& p = a.p;
  const BwdTcSmem sm = bwd_tc_smem_init(tc_smem, 4, 4, BWD_W_CONSUMERS,
                                        BWD_W_XBYTES);
  const BwdKeyBlock b = bwd_key_block(p);
  const BwdWLoader<true> ld{sm, &qmap, &dmap, a};
  if (threadIdx.x == BWD_W_LOADER && b.ntiles > 0) {
    bwd_key_res_load(sm, &kmap, &vmap, b);
    ld.start(b.kh, b.n, b.row0, b.ntiles);
  }
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3);
  const int key0 = b.k0 + bwd_w_row0();    // the thread's keys: key0, + 8
  const float scale2 = p.scale * ATT_LOG2E;
  float acc[64];                           // dv or dk, 128 columns
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  BwdPipe pipe;
  if (b.ntiles > 0) mbar_wait_trap(sm.resfull(), 0);
  for (int it = 0; it < b.ntiles; ++it) {
    const int stage = pipe.stage;
    mbar_wait_trap(sm.full(stage), pipe.phase);
    bwd_w_kv_pair<T>(sm, stage, acc, key0, 0x7fffffff, scale2, ld,
                     it == b.ntiles - 1);
    pipe.advance();
  }
  // warpgroups 0 and 1 hold dv, 2 and 3 dk (times scale)
  T* g = static_cast<T*>(wg < 2 ? p.dv : p.dk);
  const float mul = wg < 2 ? 1.f : p.scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= p.Tk) continue;
    const long long at = ((long long)b.n * p.Tk + key) * p.KH + b.kh;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store2(g + at * 256 + (wg & 1) * 128 + 8 * j + c0,
             acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_W_THREADS, 1)
dq_w_kernel(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap dmap, BwdTcArgs a) {
  extern __shared__ unsigned char tc_smem[];
  const BwdParams& p = a.p;
  const BwdTcSmem sm = bwd_tc_smem_init(tc_smem, 4, 4, BWD_W_CONSUMERS,
                                        BWD_W_XBYTES);
  const BwdQueryBlock b = bwd_query_block(a);
  const int G = p.G, rows = p.Tq * G;
  const BwdWLoader<false> ld{sm, &kmap, &vmap, a};
  if (threadIdx.x == BWD_W_LOADER && b.ntiles > 0) {
    bwd_query_res_load(sm, &qmap, &dmap, b.kh, b.n, b.i0 / G, G);
    ld.start(b.kh, b.n, 0, b.ntiles);
  }
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3);
  const int r0 = b.i0 + bwd_w_row0();      // the thread's rows: r0, + 8
  const long long seg = ((long long)b.n * p.KH + b.kh) * a.Rp;
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
  float acc[32];                           // dq, 64 columns
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  BwdPipe pipe;
  if (b.ntiles > 0) mbar_wait_trap(sm.resfull(), 0);
  for (int it = 0; it < b.ntiles; ++it) {
    const int stage = pipe.stage;
    mbar_wait_trap(sm.full(stage), pipe.phase);
    bwd_w_q_pair<T>(sm, stage, acc, it * ATT_TC_BK, b.kend, lim, lo, de,
                    scale2, ld, it == b.ntiles - 1);
    pipe.advance();
  }
  T* g = static_cast<T*>(p.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= rows) continue;
    const int t = row / G, head = b.kh * G + row % G;
    const long long at = ((long long)b.n * p.Tq + t) * p.H + head;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store2(g + at * 256 + wg * 64 + 8 * j + c0,
             acc[4 * j + 2 * h] * p.scale, acc[4 * j + 2 * h + 1] * p.scale);
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
// 16 in [16, 128] or 192 (MLA's heads, the wide instance) with Dv a
// multiple of 16 in [16, 128], or D = Dv = 256 (paligemma-3b's heads, the
// 256-wide instance), G dividing 64, and 16-byte-aligned pointers of what
// TMA, the bulk copies and the rows pass's vector loads read (the maps
// refuse byte strides off 16).
static bool bwd_tc_route_ok(int dtype, int D, int Dv, int G,
                            std::initializer_list<const void*> ptrs) {
  if (dtype != kBF16 && dtype != kF16) return false;
  auto head_ok = [](int x) { return x >= 16 && x <= 128 && x % 16 == 0; };
  if (!(((head_ok(D) || D == 192) && head_ok(Dv)) || (D == 256 && Dv == 256)))
    return false;
  if (G < 1 || 64 % G != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
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

// The 256-wide instance (D = Dv = 256): both passes on the pair step.
template <typename T>
static int launch_bwd_tc_w256(const BwdParams& p, int dtype,
                              cudaStream_t stream) {
  BwdTcArgs a;
  CUtensorMap qmap, kmap, vmap, dmap;
  const int err = bwd_tc_prologue<T>(p, dtype, a, qmap, kmap, vmap, dmap,
                                     stream);
  if (err != 0) return err;
  const int smem = bwd_w_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_w_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned heads = (unsigned)(p.KH * p.N);
  const unsigned ktiles = (unsigned)((p.Tk + ATT_TC_BK - 1) / ATT_TC_BK);
  dkdv_w_kernel<T><<<ktiles * heads, BWD_W_THREADS, smem, stream>>>(
      qmap, kmap, vmap, dmap, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_w_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_w_kernel<T><<<(unsigned)(a.Rp / BWD_BQ) * heads, BWD_W_THREADS, smem,
                   stream>>>(qmap, kmap, vmap, dmap, a);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_bwd_tc(const BwdParams& p, int dtype,
                           cudaStream_t stream) {
  if (p.D == 192) return launch_bwd_tc_wide<T>(p, dtype, stream);
  if (p.D == 256) return launch_bwd_tc_w256<T>(p, dtype, stream);
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
