// fused_ring_attention: the whole bidirectional ring attention of every
// virtual rank in ONE cooperative launch.
//
// Replaces fused_ring_attention_tpu (src/repro/kernels/ring_attention/
// fused.py:346, pallas_call at :362; body _fused_attention_kernel at :238).
// Each rank holds its queries and one K/V stripe of tk keys; the stripes
// rotate around the ring in both directions, and each rank folds every
// stripe that reaches it into an online-softmax carry (m, l, acc) in f32,
// in the schedule's order, then normalizes.  On the TPU each device ran
// its own copy of the kernel and a put was a remote DMA into the
// neighbour's VMEM slot.  Here all n ranks live on one card:
//
// * a put is a store of the rank's current stripe into the neighbour's next
//   slot of a device-memory slot buffer (ring, rank, direction, slot, B, tk,
//   KH, D) — direction 0 (clockwise) goes to rank + 1, direction 1 to
//   rank - 1 — and the fence is a grid-wide barrier (cooperative launch,
//   grid sized from occupancy so every block is co-resident), as in
//   ring_matmul.cu;
// * each step's work is a list of (ring, rank, b, kv head, 64-row query
//   tile) items dealt to the blocks; an item loads its carry from device
//   memory (f32, one row per (t, g) pair), folds the stripe of each live
//   direction with attention.cuh's tile routine (clockwise before
//   counter-clockwise, the merge order of AttentionRingPlan.fold_steps()),
//   and stores the carry, or on the last step writes the normalized output;
// * q_offset and valid_len come per (ring, rank, b) from int32 device
//   tensors (the query start already includes the rank's own rows when the
//   queries are sharded), so a serving chunk's offsets never reach the
//   host.  An item skips the keys of a stripe that no row of its tile can
//   see (past valid_len or in the causal future): a fully masked stripe is
//   the identity of the merge, so the skip changes no result.
//
// The schedule (RingPlan.schedule(): per step its compute/send flags) comes
// from the host as an int32 table, so kernel and emulation run the same
// records.  Bound on this card: operations, 2 pairs (D + Dv) flops over the
// visible (query, key) pairs; at the served chunk (512 queries, 8 heads on
// 1 kv head, D = 256, a 4096-row cache over 2 ranks) a few tens of
// microseconds at the bf16 tensor-core rate.  Each item folds its stripes
// with one of attention.cuh's two routes, by its rule (plan.attention_
// route), decided before launch:
//
// * tensor cores (ring_attention_tc_kernel): the TMA + wgmma tile (the
//   rule's widths: D and Dv each a multiple of 16 in [16, 128], or 256; one
//   instance a Dv).  The queries and the slot buffers are 5-D tensor maps
//   built once a launch;
//   a box is one stripe deep, so a tile's keys past tk read zeros, never
//   the next stripe.  Stripes land in the slots by generic stores (the
//   seed and the puts) and the next step reads them through TMA, so every
//   thread fences the async proxy after its stores and after each grid
//   barrier.  The producer walks the same items and stripes as the
//   consumers, so the mbarrier stages' (stage, phase) carry across items
//   and steps; q has its own full / empty pair.  The carry is loaded and
//   stored in the accumulator fragment's layout.  No setmaxnreg: the roles
//   meet at every grid barrier;
// * CUDA cores (ring_attention_kernel): f32 and shapes off the rule,
//   att_fold per stripe.
//
// The carry stays in device memory between steps, and each stripe is
// copied at memory speed per step; a carry in registers and per-slot
// release/acquire flags in place of the grid barrier are later work.
//
// Layout: q (rings, n, B, tq, H, D), k (rings, n, B, tk, KH, D), v (rings, n,
// B, tk, KH, Dv) and out (rings, n, B, tq, H, Dv), contiguous; bufk / bufv
// (rings, n, 2, slots, B, tk, KH, D / Dv); cm, cl (items' rows) and cacc
// (rows x Dv) f32, rows indexed ((((g n + r) B + b) KH + kh) tq G + row).
#include <cooperative_groups.h>

#include "attention.cuh"

namespace cg = cooperative_groups;

// columns of one schedule row (repro_torch/kernels/ring_attention/fused.py)
enum { kStepIndex = 0, kComputeCw, kComputeCcw, kSendCw, kSendCcw, kStepCols };

struct RingAttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* bufk;
  void* bufv;
  float* cm;
  float* cl;
  float* cacc;
  const int* sched;
  const int* q0;
  const int* vlen;
  int nsteps, rings, n, slots, B, tq, tk, H, KH, D, Dv, G, BK, causal;
  float scale;
};

template <typename T>
__device__ __forceinline__ void copy_stripes(const RingAttnParams& p,
                                             const T* k, const T* v,
                                             int slot_from, int slot_to,
                                             bool seed, bool send_cw,
                                             bool send_ccw) {
  // seed: my stripe -> both of my directions' slot 0;
  // else: my direction-d slot -> the neighbour's next slot
  const long long sk = (long long)p.B * p.tk * p.KH * p.D;
  const long long sv = (long long)p.B * p.tk * p.KH * p.Dv;
  const long long per = sk + sv;
  const long long total = (long long)p.rings * p.n * per;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  T* bk = static_cast<T*>(p.bufk);
  T* bv = static_cast<T*>(p.bufv);
  auto slot_k = [&](long long gr, int dir, int s) {
    return bk + ((gr * 2 + dir) * p.slots + s) * sk;
  };
  auto slot_v = [&](long long gr, int dir, int s) {
    return bv + ((gr * 2 + dir) * p.slots + s) * sv;
  };
  for (long long e = gtid; e < total; e += gstride) {
    const long long gr = e / per;          // ring * n + rank
    const long long i = e % per;
    const int g = (int)(gr / p.n), r = (int)(gr % p.n);
    const long long right = (long long)g * p.n + (r + 1) % p.n;
    const long long left = (long long)g * p.n + (r + p.n - 1) % p.n;
    if (i < sk) {
      if (seed) {
        const T x = k[gr * sk + i];
        slot_k(gr, 0, 0)[i] = x;
        slot_k(gr, 1, 0)[i] = x;
      } else {
        if (send_cw) slot_k(right, 0, slot_to)[i] = slot_k(gr, 0, slot_from)[i];
        if (send_ccw) slot_k(left, 1, slot_to)[i] = slot_k(gr, 1, slot_from)[i];
      }
    } else {
      const long long j = i - sk;
      if (seed) {
        const T x = v[gr * sv + j];
        slot_v(gr, 0, 0)[j] = x;
        slot_v(gr, 1, 0)[j] = x;
      } else {
        if (send_cw) slot_v(right, 0, slot_to)[j] = slot_v(gr, 0, slot_from)[j];
        if (send_ccw) slot_v(left, 1, slot_to)[j] = slot_v(gr, 1, slot_from)[j];
      }
    }
  }
}

template <typename T, int DVT>
__global__ void __launch_bounds__(ATT_NT)
ring_attention_kernel(RingAttnParams p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int G = p.G, rows = p.tq * G;
  const int tiles = (rows + ATT_BQ - 1) / ATT_BQ;
  const long long items = (long long)p.rings * p.n * p.B * p.KH * tiles;
  const long long sk = (long long)p.B * p.tk * p.KH * p.D;
  const long long sv = (long long)p.B * p.tk * p.KH * p.Dv;
  const T* bk = static_cast<const T*>(p.bufk);
  const T* bv = static_cast<const T*>(p.bufv);

  copy_stripes<T>(p, static_cast<const T*>(p.k), static_cast<const T*>(p.v),
                  0, 0, true, false, false);
  grid.sync();

  for (int st = 0; st < p.nsteps; ++st) {
    const int* row = p.sched + st * kStepCols;
    const int s = row[kStepIndex];
    const int slot = s % p.slots, nxt = (s + 1) % p.slots;
    const bool first = st == 0, last = st == p.nsteps - 1;
    // puts: the next step's stripes, into slots no block reads this step
    if (row[kSendCw] || row[kSendCcw])
      copy_stripes<T>(p, nullptr, nullptr, slot, nxt, false, row[kSendCw],
                      row[kSendCcw]);

    for (long long wi = blockIdx.x; wi < items; wi += gridDim.x) {
      const int tile = (int)(wi % tiles);
      const long long seq = wi / tiles;      // ((g n + r) B + b) KH + kh
      const int kh = (int)(seq % p.KH);
      const long long nb = seq / p.KH;       // (g n + r) B + b
      const int b = (int)(nb % p.B);
      const long long gr = nb / p.B;         // g n + r
      const int r = (int)(gr % p.n);
      const int i0 = tile * ATT_BQ;
      const int qoff = p.q0[nb];
      const int vlen = min(p.vlen[nb], p.n * p.tk);
      const int kend = att_key_end(i0, rows, G, qoff, vlen, p.causal, 0);

      const T* q = static_cast<const T*>(p.q) +
                   nb * (long long)p.tq * p.H * p.D;
      att_stage_q(smem, q, (long long)p.H * p.D, (long long)p.D, i0, rows, G,
                  kh, p.D, p.scale);
      int qpos[4];
      bool rvalid[4];
      att_rows(i0, rows, G, qoff, qpos, rvalid);
      const long long crow = seq * rows + i0 + ty;   // carry row of a = 0
      float m[4], l[4], acc[4][DVT];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const long long cr = crow + 16 * a;
        const bool live = !first && rvalid[a];
        m[a] = live ? p.cm[cr] : ATT_NEG_INF;
        l[a] = live ? p.cl[cr] : 0.f;
#pragma unroll
        for (int c = 0; c < DVT; ++c) {
          const int col = tx + 16 * c;
          acc[a][c] = live && col < p.Dv ? p.cacc[cr * p.Dv + col] : 0.f;
        }
      }

      for (int dir = 0; dir < 2; ++dir) {
        if (!row[dir == 0 ? kComputeCw : kComputeCcw]) continue;
        const int src = dir == 0 ? ((r - s) % p.n + p.n) % p.n : (r + s) % p.n;
        const int kpos0 = src * p.tk;
        const int nkeys = min(p.tk, kend - kpos0);
        if (nkeys <= 0) continue;           // fully masked: the identity
        const long long base = (gr * 2 + dir) * p.slots + slot;
        const T* k = bk + base * sk + (long long)b * p.tk * p.KH * p.D +
                     (long long)kh * p.D;
        const T* v = bv + base * sv + (long long)b * p.tk * p.KH * p.Dv +
                     (long long)kh * p.Dv;
        att_fold<T, DVT>(smem, k, (long long)p.KH * p.D, v,
                         (long long)p.KH * p.Dv, p.D, p.Dv, p.BK, nkeys,
                         kpos0, vlen, p.causal, 0, qpos, rvalid, m, l, acc);
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (!rvalid[a]) continue;
        const long long cr = crow + 16 * a;
        if (last) {
          const int rw = i0 + ty + 16 * a;
          const int t = rw / G, h = kh * G + rw % G;
          T* o = static_cast<T*>(p.o) +
                 (nb * p.tq + t) * (long long)p.H * p.Dv + (long long)h * p.Dv;
          const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
          for (int c = 0; c < DVT; ++c) {
            const int col = tx + 16 * c;
            if (col < p.Dv) o[col] = from_f32<T>(acc[a][c] * inv);
          }
        } else {
          if (tx == 0) {
            p.cm[cr] = m[a];
            p.cl[cr] = l[a];
          }
#pragma unroll
          for (int c = 0; c < DVT; ++c) {
            const int col = tx + 16 * c;
            if (col < p.Dv) p.cacc[cr * p.Dv + col] = acc[a][c];
          }
        }
      }
    }
    grid.sync();  // fence: the next step's stripes have landed
  }
}

template <typename T, int DVT>
static int launch(const RingAttnParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * att_smem_floats(p.D, p.Dv, p.BK);
  auto kern = ring_attention_kernel<T, DVT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, ATT_NT,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  RingAttnParams args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(per_sm * sms),
                                    dim3(ATT_NT), argv, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_dv(const RingAttnParams& p, cudaStream_t stream) {
  if (p.Dv <= 16) return launch<T, 1>(p, stream);
  if (p.Dv <= 32) return launch<T, 2>(p, stream);
  if (p.Dv <= 64) return launch<T, 4>(p, stream);
  if (p.Dv <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

// -- the tensor-core route ---------------------------------------------------

// The work item wi of a step: (ring, rank, b, kv head, 64-row query tile).
struct RingItem {
  int tile, kh, b, r, i0, qoff, vlen, kend;
  long long seq, nb, gr;  // ((g n + r) B + b) KH + kh, (g n + r) B + b, g n + r
};

__device__ __forceinline__ RingItem ring_item(const RingAttnParams& p,
                                              long long wi, int tiles,
                                              int rows) {
  RingItem it;
  it.tile = (int)(wi % tiles);
  it.seq = wi / tiles;
  it.kh = (int)(it.seq % p.KH);
  it.nb = it.seq / p.KH;
  it.b = (int)(it.nb % p.B);
  it.gr = it.nb / p.B;
  it.r = (int)(it.gr % p.n);
  it.i0 = it.tile * ATT_BQ;
  it.qoff = p.q0[it.nb];
  it.vlen = min(p.vlen[it.nb], p.n * p.tk);
  it.kend = att_key_end(it.i0, rows, p.G, it.qoff, it.vlen, p.causal, 0);
  return it;
}

// The keys of stripe dir that item it folds at step s (0: skipped, a fully
// masked stripe being the identity of the merge), and its first position.
__device__ __forceinline__ int ring_nkeys(const RingAttnParams& p,
                                          const RingItem& it, const int* row,
                                          int dir, int& kpos0) {
  if (!row[dir == 0 ? kComputeCw : kComputeCcw]) return 0;
  const int s = row[kStepIndex];
  const int src =
      dir == 0 ? ((it.r - s) % p.n + p.n) % p.n : (it.r + s) % p.n;
  kpos0 = src * p.tk;
  return max(min(p.tk, it.kend - kpos0), 0);
}

template <typename T, int DV>
__global__ void __launch_bounds__(ATT_TC_THREADS, 1)
ring_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         RingAttnParams p) {
  extern __shared__ unsigned char tc_smem[];
  const AttTcSmem sm = att_tc_smem_init(tc_smem, p.D, DV);
  cg::grid_group grid = cg::this_grid();
  const int G = p.G, rows = p.tq * G;
  const int tiles = (rows + ATT_BQ - 1) / ATT_BQ;
  const long long items = (long long)p.rings * p.n * p.B * p.KH * tiles;
  const int lane = threadIdx.x % 32;

  copy_stripes<T>(p, static_cast<const T*>(p.k), static_cast<const T*>(p.v),
                  0, 0, true, false, false);
  fence_proxy_async_global();  // the seed, before TMA reads it
  grid.sync();
  fence_proxy_async_global();

  AttPipe pipe;
  uint32_t qphase = 0;
  for (int st = 0; st < p.nsteps; ++st) {
    const int* row = p.sched + st * kStepCols;
    const int s = row[kStepIndex];
    const int slot = s % p.slots, nxt = (s + 1) % p.slots;
    const bool first = st == 0, last = st == p.nsteps - 1;
    // puts: the next step's stripes, into slots no block reads this step
    if (row[kSendCw] || row[kSendCcw])
      copy_stripes<T>(p, nullptr, nullptr, slot, nxt, false, row[kSendCw],
                      row[kSendCcw]);
    fence_proxy_async_global();  // the puts, before TMA reads them

    if (threadIdx.x == ATT_TC_CONSUMERS) {
      for (long long wi = blockIdx.x; wi < items; wi += gridDim.x) {
        const RingItem it = ring_item(p, wi, tiles, rows);
        att_tc_load_q(sm, qphase, &qmap, it.kh * G, it.i0 / G, it.b,
                      (int)it.gr);
        for (int dir = 0; dir < 2; ++dir) {
          int kpos0 = 0;
          const int nkeys = ring_nkeys(p, it, row, dir, kpos0);
          if (nkeys > 0)
            att_tc_load_kv(sm, pipe, &kmap, &vmap, it.kh, 0,
                           (nkeys + ATT_TC_BK - 1) / ATT_TC_BK, it.b,
                           (int)((it.gr * 2 + dir) * p.slots + slot));
        }
      }
    } else if (threadIdx.x < ATT_TC_CONSUMERS) {
      const int r0 = att_tc_row0();
      for (long long wi = blockIdx.x; wi < items; wi += gridDim.x) {
        const RingItem it = ring_item(p, wi, tiles, rows);
        int qpos[2];
        bool rvalid[2];
        att_tc_rows(it.i0, rows, G, it.qoff, qpos, rvalid);
        const long long crow = it.seq * rows + it.i0 + r0;  // row h = 0
        float m[2], l[2], o[DV / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long cr = crow + 8 * h;
          const bool live = !first && rvalid[h];
          m[h] = live ? p.cm[cr] : ATT_NEG_INF;
          l[h] = live ? p.cl[cr] : 0.f;
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            const float2 a =
                live ? *reinterpret_cast<const float2*>(
                           p.cacc + cr * DV + 8 * j + 2 * (lane & 3))
                     : make_float2(0.f, 0.f);
            o[4 * j + 2 * h] = a.x;
            o[4 * j + 2 * h + 1] = a.y;
          }
        }
        mbar_wait(sm.qfull(), qphase);
        qphase ^= 1;
        for (int dir = 0; dir < 2; ++dir) {
          int kpos0 = 0;
          const int nkeys = ring_nkeys(p, it, row, dir, kpos0);
          if (nkeys > 0)
            att_tc_fold<T, DV>(sm, pipe, 0,
                               (nkeys + ATT_TC_BK - 1) / ATT_TC_BK, nkeys,
                               kpos0, it.vlen, p.causal, 0, qpos, rvalid,
                               p.scale, m, l, o);
        }
        if (lane == 0) mbar_arrive(sm.qempty());

#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!rvalid[h]) continue;
          const long long cr = crow + 8 * h;
          if (last) {
            const int rw = it.i0 + r0 + 8 * h;
            const int t = rw / G, head = it.kh * G + rw % G;
            T* o_row = static_cast<T*>(p.o) +
                       (it.nb * p.tq + t) * (long long)p.H * DV +
                       (long long)head * DV;
            const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
            for (int j = 0; j < DV / 8; ++j)
              store2(o_row + 8 * j + 2 * (lane & 3), o[4 * j + 2 * h] * inv,
                     o[4 * j + 2 * h + 1] * inv);
          } else {
            if ((lane & 3) == 0) {
              p.cm[cr] = m[h];
              p.cl[cr] = l[h];
            }
#pragma unroll
            for (int j = 0; j < DV / 8; ++j)
              *reinterpret_cast<float2*>(p.cacc + cr * DV + 8 * j +
                                         2 * (lane & 3)) =
                  make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    grid.sync();  // fence: the next step's stripes have landed
    fence_proxy_async_global();
  }
}

template <typename T, int DV>
static int launch_tc(const RingAttnParams& p, int dtype,
                     cudaStream_t stream) {
  if (!att_tc_route_ok(dtype, p.D, p.Dv, p.G, p.BK,
                       {p.q, p.bufk, p.bufv}))
    return static_cast<int>(cudaErrorInvalidValue);
  // q (rings n, B, tq, H, D) and the slots (rings n 2 slots, B, tk, KH,
  // D / Dv), contiguous
  CUtensorMap qmap, kmap, vmap;
  const long long depth = (long long)p.rings * p.n;
  const long long sdepth = depth * 2 * p.slots;
  const long long qd[5] = {p.D, p.H, p.tq, p.B, depth};
  const long long kd[5] = {p.D, p.KH, p.tk, p.B, sdepth};
  const long long vd[5] = {p.Dv, p.KH, p.tk, p.B, sdepth};
  const long long qs[4] = {p.D, (long long)p.H * p.D,
                           (long long)p.tq * p.H * p.D,
                           (long long)p.B * p.tq * p.H * p.D};
  const long long ks[4] = {p.D, (long long)p.KH * p.D,
                           (long long)p.tk * p.KH * p.D,
                           (long long)p.B * p.tk * p.KH * p.D};
  const long long vs[4] = {p.Dv, (long long)p.KH * p.Dv,
                           (long long)p.tk * p.KH * p.Dv,
                           (long long)p.B * p.tk * p.KH * p.Dv};
  int err = att_tc_map(&qmap, p.q, dtype, qd, qs, p.G, ATT_BQ / p.G);
  if (err == 0) err = att_tc_map(&kmap, p.bufk, dtype, kd, ks, 1, ATT_TC_BK);
  if (err == 0) err = att_tc_map(&vmap, p.bufv, dtype, vd, vs, 1, ATT_TC_BK);
  if (err != 0) return err;
  const int smem = att_tc_smem_bytes(p.D, DV);
  auto kern = ring_attention_tc_kernel<T, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the cooperative grid: as many blocks as fit the card at once
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    ATT_TC_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  RingAttnParams args = p;
  void* argv[] = {&qmap, &kmap, &vmap, &args};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(per_sm * sms),
                                  dim3(ATT_TC_THREADS), argv, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_tc(const RingAttnParams& p, int dtype,
                       cudaStream_t stream) {
  // one instance a width the rule admits (D stays a runtime value)
  switch (p.Dv) {
    case 16: return launch_tc<T, 16>(p, dtype, stream);
    case 32: return launch_tc<T, 32>(p, dtype, stream);
    case 48: return launch_tc<T, 48>(p, dtype, stream);
    case 64: return launch_tc<T, 64>(p, dtype, stream);
    case 80: return launch_tc<T, 80>(p, dtype, stream);
    case 96: return launch_tc<T, 96>(p, dtype, stream);
    case 112: return launch_tc<T, 112>(p, dtype, stream);
    case 128: return launch_tc<T, 128>(p, dtype, stream);
    case 256: return launch_tc<T, 256>(p, dtype, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_ring_attention(
    const void* q, const void* k, const void* v, void* o, void* bufk,
    void* bufv, void* cm, void* cl, void* cacc, const void* sched, int nsteps,
    const void* q0, const void* vlen, int rings, int n, int slots, int B,
    int tq, int tk, int H, int KH, int D, int Dv, int BK, int causal,
    float scale, int dtype, int route, void* stream) {
  if (Dv > 256 || BK % 16 != 0 || BK < 16 || BK > 64 || H % KH != 0 ||
      n < 1 || slots < (n > 1 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  RingAttnParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.bufk = bufk; p.bufv = bufv;
  p.cm = static_cast<float*>(cm);
  p.cl = static_cast<float*>(cl);
  p.cacc = static_cast<float*>(cacc);
  p.sched = static_cast<const int*>(sched);
  p.q0 = static_cast<const int*>(q0);
  p.vlen = static_cast<const int*>(vlen);
  p.nsteps = nsteps; p.rings = rings; p.n = n; p.slots = slots; p.B = B;
  p.tq = tq; p.tk = tk; p.H = H; p.KH = KH; p.D = D; p.Dv = Dv;
  p.G = H / KH; p.BK = BK; p.causal = causal; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) {
    switch (dtype) {
      case kF16: return dispatch_tc<__half>(p, dtype, s);
      case kBF16: return dispatch_tc<__nv_bfloat16>(p, dtype, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return dispatch_dv<float>(p, s);
    case kF16: return dispatch_dv<__half>(p, s);
    case kBF16: return dispatch_dv<__nv_bfloat16>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
