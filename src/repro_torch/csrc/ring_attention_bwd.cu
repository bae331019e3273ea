// fused_ring_attention_bwd: the gradient of ring attention (ring_attention.cu,
// row 9) for every virtual rank in ONE cooperative launch, on the forward's
// schedule.
//
// No TPU kernel is replaced: the reference's TPU kernel (src/repro/kernels/
// ring_attention/fused.py:362) has no VJP.  The reference trains through its
// emulation, whose whole schedule carries a hand-written VJP (ring_bwd,
// fused.py:169-219, on the per-stripe pieces chain_grads, kernel.py:409):
// the arrivals replayed, each stripe's cotangents sent back to their owner
// and summed there in one canonical order.  This kernel computes the same
// gradient with row 10's math (flash_attention_bwd.cu) on each stripe as it
// arrives, with the GLOBAL log-sum-exp of each row (row 9 writes it beside
// the output) and delta = rowsum(dO o O):
//   P = exp(scale q k^T - lse)  (0 where masked),   dS = P o (dO v^T - delta)
//   dq += scale dS k,   dk_stripe = scale dS^T q,   dv_stripe = P^T dO.
// The chain form's per-stripe states and merges are gone: with the global
// lse each stripe's share of the gradient is exact on its own.
//
// The launch (one cooperative grid, every block co-resident; the fences are
// grid-wide barriers, as in the forward):
//  0. every rank seeds both directions' slot 0 with its stripe
//     (ring_attention.cuh) and computes delta of its rows; barrier.
//  1. each step of the schedule (the forward's _schedule_table): the puts of
//     the next step's stripes into the neighbours' next slots, then the
//     step's items, dealt to the blocks heaviest first, then a barrier:
//     * a dk/dv item per (ring, rank, live direction, b, kv head, key tile of
//       the stripe): attention_bwd.cuh's bwd_dkdv_tile over the rank's
//       query rows that see the tile, dk and dv (summed over the G query
//       heads of the kv head) held in registers, then stored in f32 into the
//       partial slot (owner of the stripe, fold index): the put back to the
//       owner.  A tile no row sees stores zeros;
//     * a dq item per (ring, rank, b, kv head, 64-row query tile): the tile
//       staged once, its f32 dq carry loaded (zero at the first step), the
//       step's stripes folded in fold order (clockwise before counter-
//       clockwise) with bwd_dq_keys, up to the tile's key end (a stripe no
//       row sees is skipped), and the carry stored, or on the last step dq
//       written in the operand type.
//  2. after the last barrier each owner sums its stripe's partials in the
//     canonical order (own stripe, then the clockwise deliveries by
//     ascending step, then the counter-clockwise ones: `canon`, the fold
//     indices in that order) and casts dk and dv to the operand type.
// No atomics: every value is written by one thread in one order, so the
// gradient is the same bit for bit from run to run.  The steps above are
// the CUDA-core route's; the tensor-core route's differ in their items'
// shapes (below).
//
// The deal: every block of a step waits at its barrier for the slowest,
// and under the causal mask a dk/dv item's query tiles range from none to
// all the rank's, so the items are dealt heaviest first: `order` holds,
// for each step, a permutation of its items by descending work (a dk/dv
// item's query tiles, a dq item's key tiles over the step's stripes,
// fused.py's _item_order, built on the host from the plan and the shapes
// alone), dealt a round of the grid at a time, each round in the
// direction the last did not take (ring_deal).  No item's arithmetic
// changes with the order.
//
// Two routes, picked before launch by one rule (repro_torch/kernels/
// ring_attention/fused.py ring_bwd_route: row 10's plan.attention_bwd_route
// without its wide instance; the entry point checks it again and refuses a
// tensor-core launch off it):
// * tensor cores (ring_bwd_tc_kernel, below): f16 and bf16 with D and Dv
//   multiples of 16 in [16, 128] (the narrow instances, W = 64 and 128) or
//   D = Dv = 256 (paligemma-3b's heads: the 256-wide instance on
//   attention_bwd.cuh's pair step, four consumer warpgroups, row 10's at
//   that width too), G dividing 64, 16-byte-aligned operands: row 10's
//   dk/dv and dq passes (TMA + wgmma, attention_bwd.cuh) as the items,
//   with a rows pass first;
// * CUDA cores (ring_bwd_kernel): f32 and every shape off the rule, MLA's
//   D = 192 and a width of 256 beside another among them:
//   attention_bwd.cuh's item routines, the ones row 10's dkdv_kernel and
//   dq_kernel run.  Like row 10's routes both form S and dP in both item
//   kinds: seven products a visible (row, key) pair where the bound counts
//   five.
//
// Bound on this card: operations, 2 (3 D + 2 Dv) flops a visible (row, key)
// pair (S, dP, dv, dq, dk), at 989 TFLOP/s for 16-bit operands (the tensor
// cores' rate; 67 TFLOP/s in f32).
//
// Layout (the forward's): q, dq (rings, n, B, tq, H, D), o, dO (rings, n, B,
// tq, H, Dv), k, dk (rings, n, B, tk, KH, D), v, dv (.., Dv), contiguous;
// lse (rings, n, B, tq, H) f32; delta the same on the CUDA cores, the rows
// pass's stats on the tensor cores (below); bufk / bufv (rings, n, 2,
// slots, B, tk, KH, D / Dv); dq_acc f32 like q; part_k / part_v (rings, n
// owners, nfolds, B, tk, KH, D / Dv) f32; q0 / vlen (rings, n, B) int32;
// order int32, each step's items in turn.
#include <cooperative_groups.h>

#include "attention_bwd.cuh"
#include "ring_attention.cuh"

namespace cg = cooperative_groups;

struct RingBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* bufk;
  void* bufv;
  float* dq_acc;
  float* part_k;
  float* part_v;
  void* dq;
  void* dk;
  void* dv;
  const int* sched;
  const int* order;     // each step's items in the order they are dealt
  const int* canon;
  const int* q0;
  const int* vlen;
  int nsteps, nfolds, rings, n, slots, B, tq, tk, H, KH, D, Dv, G, causal;
  float scale;
  // the tensor-core route: `delta` holds the rows' stats (lse log2(e),
  // delta, key end; each seqs KH Rp values), Rp the rows of a kv head's
  // query tiles, tq G rounded up to 64
  int Rp;
};

// The slot buffers' layout, for the seed and the puts.
__device__ __forceinline__ RingSlots ring_slots(const RingBwdParams& p) {
  return {p.bufk, p.bufv, p.rings, p.n, p.slots, p.B, p.tk, p.KH, p.D, p.Dv};
}

// The query side of sequence nb = (g n + r) B + b, kv head kh; its key run
// is set per stripe by ring_bwd_run.
template <typename T>
__device__ __forceinline__ BwdItem<T> ring_bwd_item(const RingBwdParams& p,
                                                    long long nb, int kh) {
  BwdItem<T> it;
  it.q = static_cast<const T*>(p.q);
  it.dout = static_cast<const T*>(p.dout);
  it.lse = p.lse;
  it.delta = p.delta;
  it.k = nullptr;
  it.v = nullptr;
  it.n = nb;
  it.kn = 0;
  it.Tq = p.tq; it.H = p.H; it.G = p.G; it.qoff = p.q0[nb];
  it.Tk = p.tk; it.KH = p.KH; it.kh = kh; it.kbase = 0;
  it.D = p.D; it.Dv = p.Dv; it.vlen = min(p.vlen[nb], p.n * p.tk);
  it.causal = p.causal; it.prefix_len = 0; it.scale = p.scale;
  return it;
}

// Point the item's key run at the stripe in direction dir's slot of rank gr
// (batch row b), whose first key sits at global position src tk.
template <typename T>
__device__ __forceinline__ void ring_bwd_run(BwdItem<T>& it,
                                             const RingBwdParams& p,
                                             long long gr, int b, int dir,
                                             int slot, int src) {
  const long long sk = (long long)p.B * p.tk * p.KH * p.D;
  const long long sv = (long long)p.B * p.tk * p.KH * p.Dv;
  const long long base = (gr * 2 + dir) * p.slots + slot;
  it.k = static_cast<const T*>(p.bufk) + base * sk;
  it.v = static_cast<const T*>(p.bufv) + base * sv;
  it.kn = b;
  it.kbase = src * p.tk;
}

// The position in a step's order of this block's j-th item, or past the
// step's `items` where it has none: the order is dealt a round of the grid
// at a time, round k to blocks 0 .. grid - 1 when k is even and grid - 1 ..
// 0 when odd, so the block that takes a round's heaviest item takes the
// next round's lightest.
__device__ __forceinline__ long long ring_deal(int j) {
  return (long long)j * gridDim.x +
         ((j & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// dk and dv of every owner: the sum of its stripe's (owner, fold)
// partials in the canonical order (`canon`), cast to the operand type;
// grid-stride from thread gtid.
template <typename T>
__device__ __forceinline__ void ring_owner_sums(const RingBwdParams& p,
                                                long long gtid,
                                                long long gstride) {
  for (int which = 0; which < 2; ++which) {
    const int C = which == 0 ? p.D : p.Dv;
    const float* part = which == 0 ? p.part_k : p.part_v;
    T* out = static_cast<T*>(which == 0 ? p.dk : p.dv);
    const long long per = (long long)p.B * p.tk * p.KH * C;
    const long long total = (long long)p.rings * p.n * per;
    for (long long e = gtid; e < total; e += gstride) {
      const long long owner = e / per, i = e % per;
      const float* slab = part + owner * p.nfolds * per + i;
      float acc = slab[(long long)p.canon[0] * per];
      for (int j = 1; j < p.nfolds; ++j)
        acc += slab[(long long)p.canon[j] * per];
      out[e] = from_f32<T>(acc);
    }
  }
}

template <typename T, int NT, int KA>
__global__ void __launch_bounds__(ATT_NT) ring_bwd_kernel(RingBwdParams p) {
  constexpr int BK = 16 * KA;
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int G = p.G, rows = p.tq * G;
  const int qtiles = (rows + ATT_BQ - 1) / ATT_BQ;
  const int ktiles = (p.tk + BK - 1) / BK;
  const long long seqs = (long long)p.rings * p.n * p.B;

  // 0. the seed and the rows' delta
  ring_copy_stripes<T>(ring_slots(p), static_cast<const T*>(p.k),
                       static_cast<const T*>(p.v), 0, 0, true, false, false);
  bwd_delta_rows(p.delta, static_cast<const T*>(p.o),
                 static_cast<const T*>(p.dout), seqs * p.tq * p.H, p.Dv,
                 ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32,
                 (long long)gridDim.x * blockDim.x / 32);
  grid.sync();

  // 1. the schedule
  int folds = 0;
  long long dealt = 0;         // the order table's rows of earlier steps
  for (int st = 0; st < p.nsteps; ++st) {
    const int* row = p.sched + st * kStepCols;
    const int s = row[kStepIndex];
    const int slot = s % p.slots, nxt = (s + 1) % p.slots;
    const bool first = st == 0, last = st == p.nsteps - 1;
    // each live direction's fold index (clockwise first: the fold order)
    int fold[2];
    fold[0] = row[kComputeCw] ? folds++ : -1;
    fold[1] = row[kComputeCcw] ? folds++ : -1;
    const int ndirs = (fold[0] >= 0) + (fold[1] >= 0);
    // puts: the next step's stripes, into slots no block reads this step
    if (row[kSendCw] || row[kSendCcw])
      ring_copy_stripes<T>(ring_slots(p), nullptr, nullptr, slot, nxt,
                           false, row[kSendCw], row[kSendCcw]);

    const long long kv_items = seqs * p.KH * ktiles * ndirs;
    const long long items = kv_items + seqs * p.KH * qtiles;
    const int* ord = p.order + dealt;
    dealt += items;
    for (int j = 0; (long long)j * gridDim.x < items; ++j) {
      const long long wd = ring_deal(j);
      if (wd >= items) continue;
      const long long wi = ord[wd];
      if (wi < kv_items) {
        // dk and dv of one key tile of one arrived stripe
        const int kt = (int)(wi % ktiles);
        long long rest = wi / ktiles;
        const int kh = (int)(rest % p.KH);
        rest /= p.KH;
        const long long nb = rest % seqs;
        const int dir = (rest / seqs == 0 && fold[0] >= 0) ? 0 : 1;
        const long long gr = nb / p.B;
        const int b = (int)(nb % p.B), r = (int)(gr % p.n);
        const int src = ring_src(r, s, dir, p.n);
        BwdItem<T> it = ring_bwd_item<T>(p, nb, kh);
        ring_bwd_run(it, p, gr, b, dir, slot, src);
        float dk[KA][NT], dv[KA][NT];
#pragma unroll
        for (int a = 0; a < KA; ++a)
#pragma unroll
          for (int c = 0; c < NT; ++c) dk[a][c] = dv[a][c] = 0.f;
        bwd_dkdv_tile<T, NT, KA>(smem, it, kt * BK, dk, dv);
        // the put back: the stripe's owner's partial of this fold
        const long long owner = gr - r + src;
        const long long slab = (owner * p.nfolds + fold[dir]) * p.B + b;
        float* pk = p.part_k + slab * p.tk * p.KH * p.D;
        float* pv = p.part_v + slab * p.tk * p.KH * p.Dv;
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          const int kl = kt * BK + ty + 16 * a;
          if (kl >= p.tk) continue;
          const long long at = (long long)kl * p.KH + kh;
#pragma unroll
          for (int c = 0; c < NT; ++c) {
            const int col = tx + 16 * c;
            if (col < p.D) pk[at * p.D + col] = dk[a][c];
            if (col < p.Dv) pv[at * p.Dv + col] = dv[a][c];
          }
        }
      } else {
        // dq of one 64-row query tile over the step's stripes
        const long long wq = wi - kv_items;
        const int qt = (int)(wq % qtiles);
        const long long rest = wq / qtiles;
        const int kh = (int)(rest % p.KH);
        const long long nb = rest / p.KH;
        const long long gr = nb / p.B;
        const int b = (int)(nb % p.B), r = (int)(gr % p.n);
        const int i0 = qt * ATT_BQ;
        BwdItem<T> it = ring_bwd_item<T>(p, nb, kh);
        bwd_stage_query_tile(smem, it, i0, BK);
        float dq[4][NT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rw = i0 + ty + 16 * i;
          const long long at =
              (nb * p.tq + rw / G) * p.H + kh * G + rw % G;
#pragma unroll
          for (int c = 0; c < NT; ++c) {
            const int col = tx + 16 * c;
            dq[i][c] = !first && rw < rows && col < p.D
                           ? p.dq_acc[at * p.D + col]
                           : 0.f;
          }
        }
        for (int dir = 0; dir < 2; ++dir) {
          if (fold[dir] < 0) continue;
          ring_bwd_run(it, p, gr, b, dir, slot, ring_src(r, s, dir, p.n));
          const int kend = bwd_tile_key_end(it, i0);
          if (kend > 0) bwd_dq_keys<T, NT, KA>(smem, it, i0, kend, dq);
        }
        T* gq = static_cast<T*>(p.dq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rw = i0 + ty + 16 * i;
          if (rw >= rows) continue;
          const long long at =
              (nb * p.tq + rw / G) * p.H + kh * G + rw % G;
#pragma unroll
          for (int c = 0; c < NT; ++c) {
            const int col = tx + 16 * c;
            if (col >= p.D) continue;
            if (last)
              gq[at * p.D + col] = from_f32<T>(dq[i][c] * p.scale);
            else
              p.dq_acc[at * p.D + col] = dq[i][c];
          }
        }
      }
    }
    grid.sync();  // fence: the next step's stripes have landed
  }

  // 2. each owner's sum of its stripe's partials, in the canonical order
  ring_owner_sums<T>(p, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                     (long long)gridDim.x * blockDim.x);
}

// -- the tensor-core route ----------------------------------------------------
//
// Row 10's tensor-core passes (dkdv_tc_kernel, dq_tc_kernel) as the items
// of the same schedule, in one cooperative launch of blocks of one consumer
// warpgroup and one producer warp (attention_bwd.cuh's narrow layout, W 64
// or 128 by max(D, Dv)): the rows pass (each padded row's lse log2(e),
// delta and global key end) runs first, beside the seed; then every step's
// items, dealt to the blocks as on the CUDA cores:
// * a dk/dv item keeps K and V of its 64 keys of the arrived stripe
//   resident (TMA from the slot, by a map over the slots) and streams the
//   rank's query tiles that see them (q, dO and the rows' stats) through
//   the stages; dk and dv stay in registers and go to the (owner, fold) f32
//   partial in the accumulator fragment's layout;
// * a dq item keeps q and dO of its 64 rows resident and streams the K and
//   V tiles of each live direction's stripe up to the tile's key end; its
//   f32 carry is loaded into and stored from the accumulator fragment.
// The producer walks the same items as the consumers, so the stages'
// (stage, phase) carry across items and steps; the resident pair has a
// full and an empty barrier, the producer reloading it once the four
// consumer warps release it.  The 256-wide instance (D = Dv = 256) runs
// the same items on attention_bwd.cuh's pair step: four consumer
// warpgroups, each holding a 128-column slice of dk or dv (a 64-column
// slice of dq), and no producer warp: one consumer thread walks the items
// ahead with two cursors (RingWLoader) and issues the loads at the pair
// step's barriers.  A key's mask is one compare against its
// row's global key end, capped at the stripe's end (keys past it are the
// next stripe's, or past the valid length); the rows of the last K tile of
// a dq item past its key end are zeroed in shared memory (0 x NaN is NaN
// inside wgmma).  Puts land by generic stores and TMA reads them, so every
// thread fences the async proxy after its stores and after each barrier.
// Every wait traps after about ten seconds instead of hanging the card.

// The shared memory of the narrow instances: attention_bwd.cuh's narrow
// layout and one barrier more, the resident pair's empty one (the 256-wide
// instance takes attention_bwd.cuh's 256-wide layout as it is).
__host__ __device__ inline int ring_bwd_tc_smem_bytes(int nbox) {
  return bwd_tc_smem_bytes(nbox) + 8;
}

// A dk/dv item of step s: its stripe (direction, source, slot depth), its
// 64 keys from local k0, their global cap (the stripe's end cut at the
// valid length) and the query tiles that see them (from row0, ntiles).
struct RingKvItem {
  long long nb, gr;
  int dir, kh, b, r, src, k0, kbase, kcap, row0, ntiles;
};

__device__ __forceinline__ RingKvItem ring_kv_item(const RingBwdParams& p,
                                                   long long wi, int ktiles,
                                                   long long seqs,
                                                   const int (&fold)[2],
                                                   int s) {
  RingKvItem it;
  const int kt = (int)(wi % ktiles);
  long long rest = wi / ktiles;
  it.kh = (int)(rest % p.KH);
  rest /= p.KH;
  it.nb = rest % seqs;
  it.dir = (rest / seqs == 0 && fold[0] >= 0) ? 0 : 1;
  it.gr = it.nb / p.B;
  it.b = (int)(it.nb % p.B);
  it.r = (int)(it.gr % p.n);
  it.src = ring_src(it.r, s, it.dir, p.n);
  it.k0 = kt * ATT_TC_BK;
  it.kbase = it.src * p.tk;
  const int vlen = min(p.vlen[it.nb], p.n * p.tk);
  const int klim = max(min(p.tk, vlen - it.kbase), 0);
  it.kcap = it.kbase + klim;
  it.row0 = p.causal ? max(it.kbase + it.k0 - p.q0[it.nb], 0) * p.G /
                           ATT_BQ * ATT_BQ
                     : 0;
  it.ntiles = it.k0 < klim
                  ? max((p.tq * p.G - it.row0 + ATT_BQ - 1) / ATT_BQ, 0)
                  : 0;
  return it;
}

// A dq item: its 64 rows from i0 and, for each direction, the stripe's
// keys it sees (local [0, kend)) in nt 64-key tiles (0: not live or none).
struct RingQItem {
  long long nb, gr;
  int kh, b, r, i0, src[2], kend[2], nt[2];
};

__device__ __forceinline__ RingQItem ring_q_item(const RingBwdParams& p,
                                                 long long wq, int qtiles,
                                                 const int (&fold)[2],
                                                 int s) {
  RingQItem q;
  const int qt = (int)(wq % qtiles);
  const long long rest = wq / qtiles;
  q.kh = (int)(rest % p.KH);
  q.nb = rest / p.KH;
  q.gr = q.nb / p.B;
  q.b = (int)(q.nb % p.B);
  q.r = (int)(q.gr % p.n);
  q.i0 = qt * ATT_BQ;
  const int vlen = min(p.vlen[q.nb], p.n * p.tk);
  const int kend = att_key_end(q.i0, p.tq * p.G, p.G, p.q0[q.nb], vlen,
                               p.causal, 0);
  for (int dir = 0; dir < 2; ++dir) {
    q.src[dir] = ring_src(q.r, s, dir, p.n);
    const int kbase = q.src[dir] * p.tk;
    const int klim = max(min(p.tk, vlen - kbase), 0);
    q.kend[dir] = fold[dir] < 0 ? 0 : max(min(klim, kend - kbase), 0);
    q.nt[dir] = (q.kend[dir] + ATT_TC_BK - 1) / ATT_TC_BK;
  }
  return q;
}

// One step of the schedule as the tensor-core kernel's producer and
// consumers walk it: its items in the order they are dealt (`ord`, the
// heaviest first), how many are dk/dv items, and the stripes' fold indices.
struct RingTcStep {
  const int* ord;
  long long items, kv_items;
  int s, slot, fold[2];
  bool first, last;
};

// The loads of both tensor-core routes.  A dk/dv item: K and V of its 64
// keys from the stripe's slot (the resident pair), then q, dO and the
// rows' stats of its query tile i0 (heads from h0 of sequence nb, the
// stats from seg) into stage s.
template <int NBOX>
__device__ __forceinline__ void ring_kv_res_load(const BwdTcSmem& sm,
                                                 const CUtensorMap* kmap,
                                                 const CUtensorMap* vmap,
                                                 const RingBwdParams& p,
                                                 const RingKvItem& it,
                                                 int slot) {
  const int d4 = (int)((it.gr * 2 + it.dir) * p.slots + slot);
  mbar_expect_tx(sm.resfull(), 2 * NBOX * BWD_BOX);
  bwd_load_boxes(sm.res(0), kmap, sm.resfull(), NBOX, it.kh, it.k0, it.b,
                 d4);
  bwd_load_boxes(sm.res(1), vmap, sm.resfull(), NBOX, it.kh, it.k0, it.b,
                 d4);
}

template <int NBOX>
__device__ __forceinline__ void ring_kv_tile_load(
    const BwdTcSmem& sm, const CUtensorMap* qmap, const CUtensorMap* dmap,
    const RingBwdParams& p, int h0, int nb, int i0, long long seg, int s,
    long long total) {
  const uint32_t full = sm.full(s);
  mbar_expect_tx(full, 2 * NBOX * BWD_BOX + BWD_ROW_STATS);
  bwd_load_boxes(sm.op(s, 0), qmap, full, NBOX, h0, i0 / p.G, nb);
  bwd_load_boxes(sm.op(s, 1), dmap, full, NBOX, h0, i0 / p.G, nb);
  for (int j = 0; j < 3; ++j)
    bulk_load(sm.stats(s) + j * 256, p.delta + j * total + seg + i0, 256,
              full);
}

// A dq item: q and dO of its 64 rows (the resident pair), then K and V of
// key tile kt of the slot at depth d4 (its first nt[0] tiles are direction
// 0's stripe's, then direction 1's) into stage s.
template <int NBOX>
__device__ __forceinline__ void ring_q_res_load(const BwdTcSmem& sm,
                                                const CUtensorMap* qmap,
                                                const CUtensorMap* dmap,
                                                const RingBwdParams& p,
                                                const RingQItem& q) {
  mbar_expect_tx(sm.resfull(), 2 * NBOX * BWD_BOX);
  bwd_load_boxes(sm.res(0), qmap, sm.resfull(), NBOX, q.kh * p.G,
                 q.i0 / p.G, (int)q.nb);
  bwd_load_boxes(sm.res(1), dmap, sm.resfull(), NBOX, q.kh * p.G,
                 q.i0 / p.G, (int)q.nb);
}

template <int NBOX>
__device__ __forceinline__ void ring_q_tile_load(const BwdTcSmem& sm,
                                                 const CUtensorMap* kmap,
                                                 const CUtensorMap* vmap,
                                                 int kh, int b, int kt,
                                                 int d4, int s) {
  const uint32_t full = sm.full(s);
  mbar_expect_tx(full, 2 * NBOX * BWD_BOX);
  bwd_load_boxes(sm.op(s, 0), kmap, full, NBOX, kh, kt * ATT_TC_BK, b, d4);
  bwd_load_boxes(sm.op(s, 1), vmap, full, NBOX, kh, kt * ATT_TC_BK, b, d4);
}

// The producer warp of the narrow instances: each dealt item's resident
// pair, then its streamed tiles.  It walks the same items as the
// consumers, so the stages' (stage, phase) and the resident pair's phase
// carry across items and steps.
template <int NBOX>
__device__ __forceinline__ void ring_tc_produce(
    const BwdTcSmem& sm, uint32_t resempty, const CUtensorMap* qmap,
    const CUtensorMap* kmap, const CUtensorMap* vmap,
    const CUtensorMap* dmap, const RingBwdParams& p, const RingTcStep& st,
    int ktiles, int qtiles, long long seqs, long long total, BwdPipe& pipe,
    uint32_t& resphase) {
  for (int j = 0; (long long)j * gridDim.x < st.items; ++j) {
    const long long wd = ring_deal(j);
    if (wd >= st.items) continue;
    const long long wi = st.ord[wd];
    if (wi < st.kv_items) {
      const RingKvItem it = ring_kv_item(p, wi, ktiles, seqs, st.fold, st.s);
      if (it.ntiles == 0) continue;
      mbar_wait_trap(resempty, resphase ^ 1);
      ring_kv_res_load<NBOX>(sm, kmap, vmap, p, it, st.slot);
      resphase ^= 1;
      for (int t = 0; t < it.ntiles; ++t) {
        mbar_wait_trap(sm.empty(pipe.stage), pipe.phase ^ 1);
        ring_kv_tile_load<NBOX>(sm, qmap, dmap, p, it.kh * p.G, (int)it.nb,
                                it.row0 + t * ATT_BQ,
                                (it.nb * p.KH + it.kh) * p.Rp, pipe.stage,
                                total);
        pipe.advance();
      }
    } else {
      const RingQItem q = ring_q_item(p, wi - st.kv_items, qtiles, st.fold,
                                      st.s);
      if (q.nt[0] + q.nt[1] == 0) continue;
      mbar_wait_trap(resempty, resphase ^ 1);
      ring_q_res_load<NBOX>(sm, qmap, dmap, p, q);
      resphase ^= 1;
      for (int t = 0; t < q.nt[0] + q.nt[1]; ++t) {
        const int dir = t < q.nt[0] ? 0 : 1;
        mbar_wait_trap(sm.empty(pipe.stage), pipe.phase ^ 1);
        ring_q_tile_load<NBOX>(sm, kmap, vmap, q.kh, q.b,
                               dir == 0 ? t : t - q.nt[0],
                               (int)((q.gr * 2 + dir) * p.slots + st.slot),
                               pipe.stage);
        pipe.advance();
      }
    }
  }
}

// The consumers of the narrow instances (W = 64, 128: one warpgroup).
template <typename T, int W>
__device__ __forceinline__ void ring_tc_consume(
    const BwdTcSmem& sm, uint32_t resempty, const RingBwdParams& p,
    const RingTcStep& st, int ktiles, int qtiles, long long seqs,
    const float* st_l2, const float* st_de, const int* st_re, BwdPipe& pipe,
    uint32_t& resphase) {
  constexpr int NBOX = (W + 63) / 64;
  const int G = p.G, rows = p.tq * G;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3);
  const float scale2 = p.scale * ATT_LOG2E;
  for (int j = 0; (long long)j * gridDim.x < st.items; ++j) {
    const long long wd = ring_deal(j);
    if (wd >= st.items) continue;
    const long long wi = st.ord[wd];
    if (wi < st.kv_items) {
      // dk and dv of 64 keys of an arrived stripe
      float dk[W / 2], dv[W / 2];
#pragma unroll
      for (int j = 0; j < W / 2; ++j) dk[j] = dv[j] = 0.f;
      {
        const RingKvItem it = ring_kv_item(p, wi, ktiles, seqs, st.fold, st.s);
        const int key0 = it.kbase + it.k0 + att_tc_row0();  // global
        if (it.ntiles > 0) {
          mbar_wait_trap(sm.resfull(), resphase);
          for (int t = 0; t < it.ntiles; ++t) {
            const int stage = pipe.stage;
            mbar_wait_trap(sm.full(stage), pipe.phase);
            float sc[32], dp[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
            att_fence_regs(sc);
            att_fence_regs(dp);
            wgmma_fence();
            bwd_scores_tc<T>(sc, sm.res(0), sm.op(stage, 0), p.D / 16);
            bwd_scores_tc<T>(dp, sm.res(1), sm.op(stage, 1), p.Dv / 16);
            wgmma_wait<1>();
            att_fence_regs(sc);
            const float* dl = sm.delta(stage);
            const int* re = sm.rend(stage);
            bwd_pt_tc(sc, key0, c0, sm.lse2(stage), re, scale2, it.kcap);
            wgmma_wait<0>();
            att_fence_regs(dp);
            uint32_t pa[4][4], sa[4][4];
#pragma unroll
            for (int i = 0; i < 32; i += 2) {
              const int col = 8 * (i >> 2) + c0;
              const int key = key0 + 8 * ((i >> 1) & 1);
              const float d0 = key < min(re[col], it.kcap)
                                   ? sc[i] * (dp[i] - dl[col])
                                   : 0.f;
              const float d1 = key < min(re[col + 1], it.kcap)
                                   ? sc[i + 1] * (dp[i + 1] - dl[col + 1])
                                   : 0.f;
              pa[i >> 3][(i & 7) >> 1] = att_pack<T>(sc[i], sc[i + 1]);
              sa[i >> 3][(i & 7) >> 1] = att_pack<T>(d0, d1);
            }
            att_fence_regs(dv);
            att_fence_regs(dk);
            wgmma_fence();
            bwd_acc_tc<T, W>(dv, pa, sm.op(stage, 1));   // dv += P^T dO
            bwd_acc_tc<T, W>(dk, sa, sm.op(stage, 0));   // dk += dS^T q
            wgmma_commit();
            wgmma_wait<0>();
            att_fence_regs(dv);
            att_fence_regs(dk);
            if (lane == 0) mbar_arrive(sm.empty(stage));
            pipe.advance();
          }
          if (lane == 0) mbar_arrive(resempty);
          resphase ^= 1;
        }
      }
      // the put back: the stripe's owner's partial of this fold (the item
      // derived again: its fields need no register across the tiles)
      const RingKvItem it = ring_kv_item(p, st.ord[wd], ktiles, seqs,
                                         st.fold, st.s);
      const long long owner = it.gr - it.r + it.src;
      const int fold = it.dir == 0 ? st.fold[0] : st.fold[1];
      const long long slab = (owner * p.nfolds + fold) * p.B + it.b;
      float* pk = p.part_k + slab * p.tk * p.KH * p.D;
      float* pv = p.part_v + slab * p.tk * p.KH * p.Dv;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl = it.k0 + att_tc_row0() + 8 * h;
        if (kl >= p.tk) continue;
        const long long at = (long long)kl * p.KH + it.kh;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int col = 8 * j + c0;
          if (col < p.D)
            *reinterpret_cast<float2*>(pk + at * p.D + col) =
                make_float2(dk[4 * j + 2 * h] * p.scale,
                            dk[4 * j + 2 * h + 1] * p.scale);
          if (col < p.Dv)
            *reinterpret_cast<float2*>(pv + at * p.Dv + col) =
                make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        }
      }
    } else {
      // dq of 64 rows over the step's stripes, in fold order
      const RingQItem q = ring_q_item(p, wi - st.kv_items, qtiles, st.fold,
                                      st.s);
      const int r0 = q.i0 + att_tc_row0();   // the thread's rows: + 8
      const long long seg = (q.nb * p.KH + q.kh) * p.Rp;
      float lo[2], de[2];
      int lim[2];
      long long at[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rw = r0 + 8 * h;
        lo[h] = st_l2[seg + rw];
        de[h] = st_de[seg + rw];
        lim[h] = st_re[seg + rw];
        at[h] = rw < rows ? (q.nb * p.tq + rw / G) * p.H + q.kh * G + rw % G
                          : -1;
      }
      float dq[W / 2];
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + c0;
          float2 c = make_float2(0.f, 0.f);
          if (!st.first && at[h] >= 0 && col < p.D)
            c = *reinterpret_cast<const float2*>(p.dq_acc + at[h] * p.D +
                                                 col);
          dq[4 * j + 2 * h] = c.x;
          dq[4 * j + 2 * h + 1] = c.y;
        }
      if (q.nt[0] + q.nt[1] > 0) {
        mbar_wait_trap(sm.resfull(), resphase);
        for (int dir = 0; dir < 2; ++dir) {
          // (selects, not an index: the arrays stay in registers)
          const int kbase = (dir == 0 ? q.src[0] : q.src[1]) * p.tk;
          const int kend = dir == 0 ? q.kend[0] : q.kend[1];
          const int nt = dir == 0 ? q.nt[0] : q.nt[1];
          for (int t = 0; t < nt; ++t) {
            const int kl0 = t * ATT_TC_BK;
            const int stage = pipe.stage;
            mbar_wait_trap(sm.full(stage), pipe.phase);
            if (kl0 + ATT_TC_BK > kend) {
              // K's rows [j0, 64) of every box to zero (whole 128-byte
              // rows); V's may stay, dP is masked by a select
              const int j0 = kend - kl0;
              const int per_box = (ATT_TC_BK - j0) * 8;
              for (int e = threadIdx.x; e < NBOX * per_box;
                   e += BWD_TC_CONSUMERS) {
                const uint32_t addr = sm.op(stage, 0) +
                                      (e / per_box) * BWD_BOX +
                                      (j0 + (e % per_box) / 8) * 128 +
                                      (e % 8) * 16;
                asm volatile(
                    "st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                    "r"(0), "r"(0), "r"(0), "r"(0)
                    : "memory");
              }
              fence_proxy_async_shared();
              asm volatile("bar.sync 1, %0;" ::"n"(BWD_TC_CONSUMERS)
                           : "memory");
            }
            float sc[32], dp[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
            att_fence_regs(sc);
            att_fence_regs(dp);
            wgmma_fence();
            bwd_scores_tc<T>(sc, sm.res(0), sm.op(stage, 0), p.D / 16);
            bwd_scores_tc<T>(dp, sm.res(1), sm.op(stage, 1), p.Dv / 16);
            wgmma_wait<1>();
            att_fence_regs(sc);
            // sc[4 j + 2 h + e]: row r0 + 8 h, local key kl0 + 8 j + c0 + e;
            // visible below the row's global key end and the stripe's
            const int cap[2] = {min(lim[0] - kbase, kend),
                                min(lim[1] - kbase, kend)};
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const int h = (i >> 1) & 1;
              const bool vis = kl0 + 8 * (i >> 2) + c0 + (i & 1) < cap[h];
              sc[i] = vis ? att_exp2(fmaf(sc[i], scale2, -lo[h])) : 0.f;
            }
            wgmma_wait<0>();
            att_fence_regs(dp);
            uint32_t sa[4][4];
#pragma unroll
            for (int i = 0; i < 32; i += 2) {
              const int h = (i >> 1) & 1, key = kl0 + 8 * (i >> 2) + c0;
              const float d0 = key < cap[h] ? sc[i] * (dp[i] - de[h]) : 0.f;
              const float d1 =
                  key + 1 < cap[h] ? sc[i + 1] * (dp[i + 1] - de[h]) : 0.f;
              sa[i >> 3][(i & 7) >> 1] = att_pack<T>(d0, d1);
            }
            att_fence_regs(dq);
            wgmma_fence();
            bwd_acc_tc<T, W>(dq, sa, sm.op(stage, 0));   // dq += dS K
            wgmma_commit();
            wgmma_wait<0>();
            att_fence_regs(dq);
            if (lane == 0) mbar_arrive(sm.empty(stage));
            pipe.advance();
          }
        }
        if (lane == 0) mbar_arrive(resempty);
        resphase ^= 1;
      }
      T* gq = static_cast<T*>(p.dq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (at[h] < 0) continue;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int col = 8 * j + c0;
          if (col >= p.D) continue;
          if (st.last)
            store2(gq + at[h] * p.D + col, dq[4 * j + 2 * h] * p.scale,
                   dq[4 * j + 2 * h + 1] * p.scale);
          else
            *reinterpret_cast<float2*>(p.dq_acc + at[h] * p.D + col) =
                make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// The 256-wide instance's loads, issued by BWD_W_LOADER at the pair
// step's hooks (attention_bwd.cuh): two cursors over the block's items of
// the step (ring_deal), one for the stages (the pair two ahead of the
// consumers) and one for the resident pair (the next item with tiles, once
// the last scores of the current one are formed).  Items without tiles are
// skipped, as the consumers skip their pairs.  Its state lives in shared
// memory (RingWLoads; the loads' (stage, phase) kept across steps), with
// the stage cursor's item's coordinates, so a pair's load reads no device
// memory: an item is derived once, when the cursor reaches it.
struct RingWLoads {
  RingTcStep step;     // the step (written by thread 0 at its start)
  int sj, rj;          // the stage and resident cursors' item ordinals
  int tile, nt;        // the stage cursor's next tile, its item's tiles
  int stage;
  uint32_t phase;
  int kv;              // its item: a dk/dv item (1) or a dq item (0)
  int c[5];            // dk/dv: first head, sequence, first row; dq: kv
                       // head, batch row, both slots' depths, nt[0]
  long long seg;       // dk/dv: the rows' stats offset
};
static_assert(sizeof(RingWLoads) <= BWD_W_LOADS, "the layout's bytes");

struct RingWLoader {
  const BwdTcSmem& sm;
  const CUtensorMap *qmap, *kmap, *vmap, *dmap;
  const RingBwdParams& p;
  const RingTcStep& st;
  int ktiles, qtiles;
  long long seqs, total;

  // the position of item ordinal j and its tiles (0 past the step's)
  __device__ int tiles_of(int j) const {
    const long long wd = ring_deal(j);
    if (wd >= st.items) return 0;
    const long long wi = st.ord[wd];
    if (wi < st.kv_items)
      return ring_kv_item(p, wi, ktiles, seqs, st.fold, st.s).ntiles;
    const RingQItem q = ring_q_item(p, wi - st.kv_items, qtiles, st.fold,
                                    st.s);
    return q.nt[0] + q.nt[1];
  }
  // the first item ordinal from j on with tiles (past the step's: none)
  __device__ int seek(int j) const {
    while ((long long)j * gridDim.x < st.items && tiles_of(j) == 0) ++j;
    return j;
  }
  __device__ bool live(int j) const {
    return (long long)j * gridDim.x < st.items;
  }
  __device__ void load_res(int j) const {
    if (!live(j)) return;
    const long long wi = st.ord[ring_deal(j)];
    if (wi < st.kv_items)
      ring_kv_res_load<4>(
          sm, kmap, vmap, p,
          ring_kv_item(p, wi, ktiles, seqs, st.fold, st.s), st.slot);
    else
      ring_q_res_load<4>(sm, qmap, dmap, p,
                         ring_q_item(p, wi - st.kv_items, qtiles, st.fold,
                                     st.s));
  }
  // the stage cursor to item ordinal j: its tiles and coordinates
  __device__ void enter(RingWLoads& ls, int j) const {
    ls.sj = j;
    ls.tile = 0;
    if (!live(j)) return;
    const long long wi = st.ord[ring_deal(j)];
    ls.kv = wi < st.kv_items;
    if (ls.kv) {
      const RingKvItem it = ring_kv_item(p, wi, ktiles, seqs, st.fold,
                                         st.s);
      ls.nt = it.ntiles;
      ls.c[0] = it.kh * p.G;
      ls.c[1] = (int)it.nb;
      ls.c[2] = it.row0;
      ls.seg = (it.nb * p.KH + it.kh) * p.Rp;
    } else {
      const RingQItem q = ring_q_item(p, wi - st.kv_items, qtiles, st.fold,
                                      st.s);
      ls.nt = q.nt[0] + q.nt[1];
      ls.c[0] = q.kh;
      ls.c[1] = q.b;
      ls.c[2] = (int)((q.gr * 2) * p.slots + st.slot);
      ls.c[3] = (int)((q.gr * 2 + 1) * p.slots + st.slot);
      ls.c[4] = q.nt[0];
    }
  }
  __device__ void load_stage(RingWLoads& ls) const {
    if (!live(ls.sj)) return;
    const int t = ls.tile;
    if (ls.kv) {
      ring_kv_tile_load<4>(sm, qmap, dmap, p, ls.c[0], ls.c[1],
                              ls.c[2] + t * ATT_BQ, ls.seg, ls.stage, total);
    } else {
      const int dir1 = t >= ls.c[4];
      ring_q_tile_load<4>(sm, kmap, vmap, ls.c[0], ls.c[1],
                             dir1 ? t - ls.c[4] : t,
                             dir1 ? ls.c[3] : ls.c[2], ls.stage);
    }
    if (++ls.stage == BWD_TC_STAGES) {
      ls.stage = 0;
      ls.phase ^= 1;
    }
    if (++ls.tile == ls.nt) enter(ls, seek(ls.sj + 1));
  }
  // the step's first resident pair and first two tiles
  __device__ void start() const {
    if (threadIdx.x != BWD_W_LOADER) return;
    RingWLoads& ls = *sm.loads<RingWLoads>();
    ls.rj = seek(0);
    enter(ls, ls.rj);
    load_res(ls.rj);
    load_stage(ls);
    load_stage(ls);
  }
  __device__ void scores_done(bool item_end) const {
    if (threadIdx.x != BWD_W_LOADER || !item_end) return;
    RingWLoads& ls = *sm.loads<RingWLoads>();
    ls.rj = seek(ls.rj + 1);
    load_res(ls.rj);
  }
  __device__ void products_done() const {
    if (threadIdx.x == BWD_W_LOADER) load_stage(*sm.loads<RingWLoads>());
  }
};

// The consumers of the 256-wide instance (D = Dv = 256: four warpgroups on
// attention_bwd.cuh's pair step; warpgroup w's slice of dk/dv or dq).
template <typename T>
__device__ __forceinline__ void ring_w_consume(
    const BwdTcSmem& sm, const RingBwdParams& p, const RingTcStep& st,
    int ktiles, int qtiles, long long seqs, const float* st_l2,
    const float* st_de, const int* st_re, const RingWLoader& ld,
    BwdPipe& pipe, uint32_t& resphase) {
  const int G = p.G, rows = p.tq * G;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane & 3), m0 = bwd_w_row0();
  const float scale2 = p.scale * ATT_LOG2E;
  ld.start();
  for (int j = 0; (long long)j * gridDim.x < st.items; ++j) {
    const long long wd = ring_deal(j);
    if (wd >= st.items) continue;
    const long long wi = st.ord[wd];
    if (wi < st.kv_items) {
      // dk and dv of 64 keys of an arrived stripe: warpgroups 0 and 1 hold
      // dv's halves, 2 and 3 dk's
      float acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0.f;
      {
        const RingKvItem it = ring_kv_item(p, wi, ktiles, seqs, st.fold,
                                           st.s);
        const int key0 = it.kbase + it.k0 + m0;   // global
        const int kcap = it.kcap, ntiles = it.ntiles;
        if (ntiles > 0) {
          mbar_wait_trap(sm.resfull(), resphase);
          for (int t = 0; t < ntiles; ++t) {
            const int stage = pipe.stage;
            mbar_wait_trap(sm.full(stage), pipe.phase);
            bwd_w_kv_pair<T>(sm, stage, acc, key0, kcap, scale2, ld,
                             t == ntiles - 1);
            pipe.advance();
          }
          resphase ^= 1;
        }
      }
      // the put back: the stripe's owner's partial of this fold (the item
      // derived again: its fields need no register across the pairs)
      const RingKvItem it = ring_kv_item(p, st.ord[wd], ktiles, seqs,
                                         st.fold, st.s);
      const long long owner = it.gr - it.r + it.src;
      const int fold = it.dir == 0 ? st.fold[0] : st.fold[1];
      const long long slab = (owner * p.nfolds + fold) * p.B + it.b;
      float* part = (wg < 2 ? p.part_v : p.part_k) +
                    slab * p.tk * p.KH * 256 + (wg & 1) * 128;
      const float mul = wg < 2 ? 1.f : p.scale;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl = it.k0 + m0 + 8 * h;
        if (kl >= p.tk) continue;
        const long long at = (long long)kl * p.KH + it.kh;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(part + at * 256 + 8 * j + c0) =
              make_float2(acc[4 * j + 2 * h] * mul,
                          acc[4 * j + 2 * h + 1] * mul);
      }
    } else {
      // dq of 64 rows over the step's stripes, in fold order: warpgroup w
      // holds columns [64 w, 64 w + 64)
      const RingQItem q = ring_q_item(p, wi - st.kv_items, qtiles, st.fold,
                                      st.s);
      const int r0 = q.i0 + m0;             // the thread's rows: + 8
      const long long seg = (q.nb * p.KH + q.kh) * p.Rp;
      float lo[2], de[2];
      int lim[2];
      long long at[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rw = r0 + 8 * h;
        lo[h] = st_l2[seg + rw];
        de[h] = st_de[seg + rw];
        lim[h] = st_re[seg + rw];
        at[h] = rw < rows ? (q.nb * p.tq + rw / G) * p.H + q.kh * G + rw % G
                          : -1;
      }
      float acc[32];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 c = make_float2(0.f, 0.f);
          if (!st.first && at[h] >= 0)
            c = *reinterpret_cast<const float2*>(p.dq_acc + at[h] * 256 +
                                                 wg * 64 + 8 * j + c0);
          acc[4 * j + 2 * h] = c.x;
          acc[4 * j + 2 * h + 1] = c.y;
        }
      const int nt = q.nt[0] + q.nt[1];
      if (nt > 0) {
        mbar_wait_trap(sm.resfull(), resphase);
        for (int t = 0; t < nt; ++t) {
          const int dir = t < q.nt[0] ? 0 : 1;
          const int kbase = (dir == 0 ? q.src[0] : q.src[1]) * p.tk;
          const int kend = dir == 0 ? q.kend[0] : q.kend[1];
          const int cap[2] = {min(lim[0] - kbase, kend),
                              min(lim[1] - kbase, kend)};
          const int stage = pipe.stage;
          mbar_wait_trap(sm.full(stage), pipe.phase);
          bwd_w_q_pair<T>(sm, stage, acc,
                          (dir == 0 ? t : t - q.nt[0]) * ATT_TC_BK, kend,
                          cap, lo, de, scale2, ld, t == nt - 1);
          pipe.advance();
        }
        resphase ^= 1;
      }
      T* gq = static_cast<T*>(p.dq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (at[h] < 0) continue;
        const long long col0 = at[h] * 256 + wg * 64 + c0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (st.last)
            store2(gq + col0 + 8 * j, acc[4 * j + 2 * h] * p.scale,
                   acc[4 * j + 2 * h + 1] * p.scale);
          else
            *reinterpret_cast<float2*>(p.dq_acc + col0 + 8 * j) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(W == 256 ? BWD_W_THREADS : BWD_TC_THREADS,
                                  1)
ring_bwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap dmap,
                   RingBwdParams p) {
  extern __shared__ unsigned char tc_smem[];
  constexpr int NBOX = (W + 63) / 64;
  // the narrow instances: one consumer warpgroup and a producer warp; the
  // 256-wide one: four consumer warpgroups, one of whose threads loads
  constexpr int CONSUMERS = W == 256 ? BWD_W_CONSUMERS : BWD_TC_CONSUMERS;
  const BwdTcSmem sm = bwd_tc_smem_init(tc_smem, NBOX, NBOX, CONSUMERS,
                                        W == 256 ? BWD_W_XBYTES : 0);
  // the resident pair's empty barrier (the narrow instances')
  const uint32_t resempty = sm.bar(2 * BWD_TC_STAGES + 1);
  if (W != 256 && threadIdx.x == 0) {
    mbar_init(resempty, CONSUMERS / 32);
    fence_mbar_init();
  }
  if (W == 256 && threadIdx.x == BWD_W_LOADER) {
    RingWLoads& ls = *sm.loads<RingWLoads>();
    ls.stage = 0;
    ls.phase = 0;
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int G = p.G, rows = p.tq * G;
  const int qtiles = p.Rp / ATT_BQ;
  const int ktiles = (p.tk + ATT_TC_BK - 1) / ATT_TC_BK;
  const long long seqs = (long long)p.rings * p.n * p.B;
  const long long total = seqs * p.KH * p.Rp;
  float* st_l2 = p.delta;
  float* st_de = p.delta + total;
  int* st_re = reinterpret_cast<int*>(p.delta + 2 * total);

  // 0. the seed, and the rows pass (one thread a padded row: o and dO in
  // 16-byte vectors, Dv being a multiple of 16 on this route)
  ring_copy_stripes<T>(ring_slots(p), static_cast<const T*>(p.k),
                       static_cast<const T*>(p.v), 0, 0, true, false, false);
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < total; w += (long long)gridDim.x * blockDim.x) {
    const int rw = (int)(w % p.Rp);
    const long long nk = w / p.Rp;
    const int kh = (int)(nk % p.KH);
    const long long nb = nk / p.KH;
    float d = 0.f, l2 = CUDART_INF_F;
    int rend = 0;
    if (rw < rows) {
      const int t = rw / G, h = kh * G + rw % G;
      const long long at = (nb * p.tq + t) * p.H + h;
      const uint4* o = reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.o) + at * p.Dv);
      const uint4* g = reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.dout) + at * p.Dv);
      for (int c = 0; c < p.Dv / 8; ++c) {
        const uint4 ov = o[c], gv = g[c];
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(to_f32(oe[e]), to_f32(ge[e]), d);
      }
      l2 = p.lse[at] * ATT_LOG2E;
      rend = min(p.vlen[nb], p.n * p.tk);
      if (p.causal) rend = min(rend, p.q0[nb] + t + 1);
    }
    st_l2[w] = l2;
    st_de[w] = d;
    st_re[w] = rend;
  }
  fence_proxy_async_global();  // the seed and the stats, before TMA reads
  grid.sync();
  fence_proxy_async_global();

  BwdPipe pipe;
  uint32_t resphase = 0;
  int folds = 0;
  long long dealt = 0;         // the order table's rows of earlier steps
  for (int step = 0; step < p.nsteps; ++step) {
    const int* row = p.sched + step * kStepCols;
    RingTcStep st;
    st.s = row[kStepIndex];
    st.slot = st.s % p.slots;
    const int nxt = (st.s + 1) % p.slots;
    st.first = step == 0;
    st.last = step == p.nsteps - 1;
    st.fold[0] = row[kComputeCw] ? folds++ : -1;
    st.fold[1] = row[kComputeCcw] ? folds++ : -1;
    const int ndirs = (st.fold[0] >= 0) + (st.fold[1] >= 0);
    if (row[kSendCw] || row[kSendCcw])
      ring_copy_stripes<T>(ring_slots(p), nullptr, nullptr, st.slot, nxt,
                           false, row[kSendCw], row[kSendCcw]);
    fence_proxy_async_global();  // the puts, before TMA reads them
    st.kv_items = seqs * p.KH * ktiles * ndirs;
    st.items = st.kv_items + seqs * p.KH * qtiles;
    st.ord = p.order + dealt;
    dealt += st.items;

    if constexpr (W == 256) {
      // the step in shared memory: read where it is used, it holds no
      // register of the four warpgroups across the pairs
      RingWLoads& ls = *sm.loads<RingWLoads>();
      if (threadIdx.x == 0) ls.step = st;
      __syncthreads();
      const RingWLoader ld{sm, &qmap, &kmap, &vmap, &dmap, p,
                           ls.step, ktiles, qtiles, seqs, total};
      ring_w_consume<T>(sm, p, ls.step, ktiles, qtiles, seqs, st_l2, st_de,
                        st_re, ld, pipe, resphase);
    } else if (threadIdx.x == CONSUMERS) {
      ring_tc_produce<NBOX>(sm, resempty, &qmap, &kmap, &vmap, &dmap, p, st,
                            ktiles, qtiles, seqs, total, pipe, resphase);
    } else if (threadIdx.x < CONSUMERS) {
      ring_tc_consume<T, W>(sm, resempty, p, st, ktiles, qtiles, seqs, st_l2,
                            st_de, st_re, pipe, resphase);
    }
    grid.sync();  // fence: the next step's stripes have landed
    fence_proxy_async_global();
  }

  // 2. each owner's sum of its stripe's partials, in the canonical order
  ring_owner_sums<T>(p, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                     (long long)gridDim.x * blockDim.x);
}

template <typename T, int NT>
static int launch(const RingBwdParams& p, cudaStream_t stream) {
  constexpr int KA = NT > 8 ? 2 : 4;
  const size_t smem = sizeof(float) * bwd_smem_floats(p.D, p.Dv, 16 * KA);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ring_bwd_kernel<T, NT, KA>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the cooperative grid: as many blocks as fit the card at once
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, ATT_NT,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  RingBwdParams args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(per_sm * sms),
                                    dim3(ATT_NT), argv, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch(const RingBwdParams& p, cudaStream_t stream) {
  const int cols = p.D > p.Dv ? p.D : p.Dv;
  if (cols <= 32) return launch<T, 2>(p, stream);
  if (cols <= 64) return launch<T, 4>(p, stream);
  if (cols <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

// The tensor-core route's rule, checked again at launch: 16-bit operands,
// D and Dv multiples of 16 in [16, 128] (row 10's narrow instance; its
// wide D = 192 is not instantiated here) or D = Dv = 256 (the 256-wide
// instance), G dividing 64, 16-byte-aligned pointers of what TMA, the bulk
// copies and the rows pass read.
static bool ring_bwd_tc_route_ok(int dtype, int D, int Dv, int G,
                                 std::initializer_list<const void*> ptrs) {
  if (dtype != kBF16 && dtype != kF16) return false;
  auto head_ok = [](int x) { return x >= 16 && x <= 128 && x % 16 == 0; };
  if (!((head_ok(D) && head_ok(Dv)) || (D == 256 && Dv == 256)) || G < 1 ||
      64 % G != 0)
    return false;
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return true;
}

template <typename T, int W>
static int launch_tc(const RingBwdParams& p, int dtype,
                     cudaStream_t stream) {
  // q and dO (seqs, tq, H, C) as row 10's maps; the slots (rings n 2
  // slots, B, tk, KH, C) as the forward's
  CUtensorMap qmap, dmap, kmap, vmap;
  const long long seqs = (long long)p.rings * p.n * p.B;
  const long long sdepth = (long long)p.rings * p.n * 2 * p.slots;
  const long long kd[5] = {p.D, p.KH, p.tk, p.B, sdepth};
  const long long vd[5] = {p.Dv, p.KH, p.tk, p.B, sdepth};
  const long long ks[4] = {p.D, (long long)p.KH * p.D,
                           (long long)p.tk * p.KH * p.D,
                           (long long)p.B * p.tk * p.KH * p.D};
  const long long vs[4] = {p.Dv, (long long)p.KH * p.Dv,
                           (long long)p.tk * p.KH * p.Dv,
                           (long long)p.B * p.tk * p.KH * p.Dv};
  int err = bwd_map(&qmap, p.q, dtype, p.D, p.H, p.tq, (int)seqs, p.G,
                    ATT_BQ / p.G);
  if (err == 0)
    err = bwd_map(&dmap, p.dout, dtype, p.Dv, p.H, p.tq, (int)seqs, p.G,
                  ATT_BQ / p.G);
  if (err == 0) err = att_tc_map(&kmap, p.bufk, dtype, kd, ks, 1, ATT_TC_BK);
  if (err == 0) err = att_tc_map(&vmap, p.bufv, dtype, vd, vs, 1, ATT_TC_BK);
  if (err != 0) return err;
  constexpr int NBOX = (W + 63) / 64;
  constexpr int THREADS = W == 256 ? BWD_W_THREADS : BWD_TC_THREADS;
  const int smem = W == 256 ? bwd_w_smem_bytes()
                            : ring_bwd_tc_smem_bytes(NBOX);
  auto kern = ring_bwd_tc_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  RingBwdParams args = p;
  void* argv[] = {&qmap, &kmap, &vmap, &dmap, &args};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(per_sm * sms),
                                  dim3(THREADS), argv, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_tc(const RingBwdParams& p, int dtype,
                       cudaStream_t stream) {
  // three instances, W = 64 and 128 (one and two boxes: a narrower D or
  // Dv is TMA's zero fill past its columns, and the products' k-steps are
  // D / 16 and Dv / 16; row 10 has one instance a width, these two keep
  // this source's build within the others') and 256 (D = Dv = 256, the
  // 256-wide pair step)
  if (p.D == 256) return launch_tc<T, 256>(p, dtype, stream);
  return (p.D > 64 || p.Dv > 64) ? launch_tc<T, 128>(p, dtype, stream)
                                 : launch_tc<T, 64>(p, dtype, stream);
}

// dq, dk, dv of the ring's output from dO, given its lse, on `route`
// (kRouteSimt, or kRouteWgmma under ring_bwd_tc_route_ok, plan's
// ring_bwd_route; a tensor-core launch off the rule is refused); the
// scratch (delta: seqs tq H values on the CUDA cores, 3 seqs KH Rp on the
// tensor cores; the slots, dq_acc, the partials) the caller allocates as
// above.  Every rank folds each stripe once: nfolds == n.
extern "C" int repro_ring_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* bufk, void* bufv,
    void* dq_acc, void* part_k, void* part_v, void* dq, void* dk, void* dv,
    const void* sched, int nsteps, const void* order, const void* canon,
    int nfolds, const void* q0, const void* vlen, int rings, int n,
    int slots, int B, int tq, int tk, int H, int KH, int D, int Dv,
    int causal, float scale, int dtype, int route, void* stream) {
  if (D < 1 || Dv < 1 || D > 256 || Dv > 256 || KH < 1 || H % KH != 0 ||
      n < 1 || nfolds != n || nsteps < 1 || slots < (n > 1 ? 2 : 1) ||
      (route != kRouteSimt && route != kRouteWgmma))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma &&
      !ring_bwd_tc_route_ok(dtype, D, Dv, H / KH,
                            {q, k, v, o, dout, delta, bufk, bufv, dq_acc,
                             part_k, part_v}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rings == 0 || B == 0 || tq == 0 || tk == 0 || H == 0) return 0;
  RingBwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.bufk = bufk; p.bufv = bufv;
  p.dq_acc = static_cast<float*>(dq_acc);
  p.part_k = static_cast<float*>(part_k);
  p.part_v = static_cast<float*>(part_v);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.sched = static_cast<const int*>(sched);
  p.order = static_cast<const int*>(order);
  p.canon = static_cast<const int*>(canon);
  p.q0 = static_cast<const int*>(q0);
  p.vlen = static_cast<const int*>(vlen);
  p.nsteps = nsteps; p.nfolds = nfolds; p.rings = rings; p.n = n;
  p.slots = slots; p.B = B; p.tq = tq; p.tk = tk; p.H = H; p.KH = KH;
  p.D = D; p.Dv = Dv; p.G = H / KH; p.causal = causal; p.scale = scale;
  p.Rp = (tq * p.G + ATT_BQ - 1) / ATT_BQ * ATT_BQ;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) {
    if (dtype == kF16) return dispatch_tc<__half>(p, dtype, s);
    return dispatch_tc<__nv_bfloat16>(p, dtype, s);
  }
  switch (dtype) {
    case kF32: return dispatch<float>(p, s);
    case kF16: return dispatch<__half>(p, s);
    case kBF16: return dispatch<__nv_bfloat16>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
