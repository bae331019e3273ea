// The gradient of the grouped expert MLP: the tile routines shared by
// expert_mlp_bwd.cu (row 12) and moe_dispatch_bwd.cu (row 13).
//
// No TPU kernel is replaced: the reference trains its expert MLP through
// jnp.einsum under AD (src/repro/models/layers.py:831-881), and its dropless
// dispatch through the emulation of fused_moe_dispatch_tpu.  These are the
// gradient of expert_mlp.cuh's forward, y = (silu(x wg) * (x wu)).astype(x)
// @ wd, for the cotangent dy, in three passes:
//
//   A, rows:  g = x wg, u = x wu (recomputed, f32), dh = dy wd^T (f32);
//             h = silu(g) u, dg = dh u silu'(g), du = dh silu(g), each
//             rounded to x's dtype into a scratch in device memory;
//   B, dx:    dx = dg wg^T + du wu^T (f32 accumulation, rounded once), the
//             rows past each count as zeros;
//   C, dW:    dwg = x^T dg, dwu = x^T du, dwd = h^T dy, K over every live
//             row of every source in a fixed order (source by source, row
//             by row), each dW element written once: no atomics and no
//             split K, so the gradients are the same bit for bit from run
//             to run.
//
// A caller runs every pass-A item, synchronises, every pass-B item, and
// (once all its sources' pass A has run) every pass-C item.
//
// Bound on this card at the training shape: bytes.  The three weights are
// read once and the three dW written once (6 d f bytes of 16-bit data an
// expert); the operations are 16 d f a live (token, choice) row (the g and
// u recompute, dh, dx's two products, the three dW).  At qwen3-moe's d =
// 4096, f = 1536 with 64 experts on each of 4 ranks that is 19.3 GB (5.8 ms
// at 3.35 TB/s) against 3.3e12 operations (3.3 ms at 989 TFLOP/s) at about
// 32,768 live rows.
//
// Two routes, picked on the host by one stated rule (repro_torch/kernels/
// plan.py expert_bwd_route, checked again by each C entry point):
//
// * tensor cores (exb_tc_*): f16/bf16 with d and f multiples of 64 and
//   16-byte-aligned pointers and strides.  The rows of one weight set (one
//   expert's weights) come from several sources (a rank's sources, the
//   ring's offsets), each with a few live rows in a padded block: at
//   qwen3-moe's a2a call about 26 live rows a block of 80.  So the route
//   first packs, on the card from the counts (exb_build_pack, no host
//   read), each weight set's live rows over all its sources into
//   consecutive 64-row tiles (ExbPack), copies the live rows of x and dy
//   there (padding rows zero), and runs every pass over packed tiles.
//   Passes A and B take one item per (packed tile, 128 columns), each
//   set's items side by side, so the blocks that run together read one
//   set's weight tiles from device memory once and find them in L2 for its
//   other tiles (the padded layout read each weight tile once for every
//   source and 64-row tile); every item costs the same, however the rows
//   are spread over the experts.  Pass C runs K over the packed rows, one
//   64-row step for up to 64 rows of a set, keeps an item's x and dy boxes
//   in shared memory while each column block's dg, du and h stream past
//   them (the padded layout re-read all five for every 64 x 64 output
//   tile), and splits a set's column blocks into as many items as it has
//   tiles.  A block is two consumer warpgroups and one producer warp,
//   persistent over a pass's items; the producer streams 64-deep K steps
//   of 64 x 64 boxes (EXB_STAGES stages, 128-byte swizzled) by TMA, the
//   consumers run wgmma m64n64k16 with f32 accumulators.  In passes A and
//   B both warpgroups read the tile's row boxes (warpgroup w takes 64 of
//   the item's columns; the rows are wgmma's N); pass C shares each tile's
//   dg, du and h boxes (warpgroup w takes 64 rows of d).  Every operand is
//   read in place through wgmma's transpose bits: pass A's weight tiles
//   MN-major (g, u) and w_down K-major (dh = dy wd^T); pass B's w_gate and
//   w_up K-major (their f is the contraction); pass C's row tiles MN-major
//   on both sides (the rows are the contraction).  Pass B stores each live
//   row's dx at that row of the caller's layout; pass C rounds its six
//   output tiles into shared memory in TMA's 128-byte swizzle and writes
//   them out by TMA stores.
// * CUDA cores (exb_*_tile): f32 and every shape off the rule; 256 threads
//   each keeping 4 x 4 register tiles (three in passes A and C, one in B)
//   over five (EX_BK, 64 + EX_PAD) f32 tiles in shared memory, over the
//   padded blocks and a scratch of every padded row.
#pragma once

#include "expert_mlp.cuh"

#define EXB_BR 64       // rows of a packed tile (passes A, B) and a K step (C)
#define EXB_STAGES 3
#define EXB_BOXES 8     // 64 x 64 boxes a stage holds at most (pass A)
#define EXB_SLOTS 3     // pass C's x and dy slots, one a packed tile
#define EXB_OUT_TILES 6 // pass C's output tiles, three a warpgroup
#define EXB_THREADS 288

constexpr int EXB_BOX_BYTES = 64 * 64 * 2;
constexpr int EXB_CONSUMERS = 256;  // two warpgroups
constexpr int EXB_C_BOXES = 3;      // a stage's boxes in pass C (dg, du, h)
// the boxes of pass C's stages, slots and output tiles, over which passes
// A and B lay their stages
constexpr int EXB_RING_BOXES =
    EXB_STAGES * EXB_C_BOXES + 4 * EXB_SLOTS + EXB_OUT_TILES;
static_assert(EXB_THREADS == EXB_CONSUMERS + 32, "one producer warp");
static_assert(EXB_STAGES * EXB_BOXES <= EXB_RING_BOXES,
              "passes A and B fit in pass C's boxes");

// One problem of the CUDA-core route: one expert's row block from one
// source, and that expert's weights.
template <typename T>
struct ExbProblem {
  const T* x;   // (C, d)
  const T* dy;  // (C, d)
  T* dx;        // (C, d)
  T* dg;        // (C, f) scratch
  T* du;        // (C, f) scratch
  T* h;         // (C, f) scratch
  const T* wg;  // (d, f)
  const T* wu;  // (d, f)
  const T* wd;  // (f, d)
  int live;     // rows [0, live) carry tokens
};

// h, dg and du of one element from f32 g, u and dh, rounded to T
template <typename T>
__device__ __forceinline__ void exb_grads(float g, float u, float dh, T* h,
                                          T* dg, T* du, long long at) {
  const float s = 1.f / (1.f + expf(-g));
  h[at] = from_f32<T>(ex_silu(g) * u);
  dg[at] = from_f32<T>(dh * u * (s * (1.f + g * (1.f - s))));
  du[at] = from_f32<T>(dh * (g * s));
}

// -- the CUDA-core route ------------------------------------------------------

typedef float ExbTile[EX_BK][EX_BM + EX_PAD];

struct ExbSmem {
  ExbTile t[5];
};

// dst[k][m] = A[(m0 + m) * lda + k0 + k] for m0 + m < rows, k0 + k < K;
// else 0 (a tile of a row-major matrix, transposed).
template <typename T>
__device__ __forceinline__ void exb_load_t(const T* __restrict__ A,
                                           long long lda, int rows, int K,
                                           int m0, int k0, ExbTile& dst) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (EX_BM * EX_BK) / EX_THREADS; ++i) {
    const int e = t + i * EX_THREADS;
    const int m = e / EX_BK, k = e % EX_BK;
    const int gm = m0 + m, gk = k0 + k;
    dst[k][m] = (gm < rows && gk < K) ? to_f32(A[gm * lda + gk]) : 0.f;
  }
}

// dst[k][n] = B[(k0 + k) * ldb + n0 + n] for k0 + k < K, n0 + n < N; else 0.
template <typename T>
__device__ __forceinline__ void exb_load_n(const T* __restrict__ B,
                                           long long ldb, int K, int N,
                                           int k0, int n0, ExbTile& dst) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (EX_BK * EX_BN) / EX_THREADS; ++i) {
    const int e = t + i * EX_THREADS;
    const int k = e / EX_BN, n = e % EX_BN;
    const int gk = k0 + k, gn = n0 + n;
    dst[k][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * ldb + gn]) : 0.f;
  }
}

// acc[i][j] += a[k][4 ty + i] b[k][4 tx + j] over the EX_BK k of a tile
__device__ __forceinline__ void exb_fma(float (&acc)[4][4], const ExbTile& a,
                                        const ExbTile& b, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < EX_BK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[k][tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
  }
}

__device__ __forceinline__ void exb_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Pass A: rows [m0, m0 + 64) x columns [n0, n0 + 64) of f.  Every thread
// of the block calls it (it syncs).
template <typename T>
__device__ void exb_rows_tile(const ExbProblem<T>& p, int d, int f, int m0,
                              int n0, ExbSmem& sm) {
  if (m0 >= p.live) return;  // uniform over the block
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const bool busy = m0 + ty * 4 < p.live;
  float ag[4][4], au[4][4], ah[4][4];
  exb_zero(ag);
  exb_zero(au);
  exb_zero(ah);
  for (int k0 = 0; k0 < d; k0 += EX_BK) {
    exb_load_t<T>(p.x, d, p.live, d, m0, k0, sm.t[0]);
    exb_load_t<T>(p.dy, d, p.live, d, m0, k0, sm.t[1]);
    exb_load_n<T>(p.wg, f, d, f, k0, n0, sm.t[2]);
    exb_load_n<T>(p.wu, f, d, f, k0, n0, sm.t[3]);
    exb_load_t<T>(p.wd, d, f, d, n0, k0, sm.t[4]);  // [k][n] = wd[n][k]
    __syncthreads();
    if (busy) {
      exb_fma(ag, sm.t[0], sm.t[2], ty, tx);
      exb_fma(au, sm.t[0], sm.t[3], ty, tx);
      exb_fma(ah, sm.t[1], sm.t[4], ty, tx);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= p.live) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < f)
        exb_grads<T>(ag[i][j], au[i][j], ah[i][j], p.h, p.dg, p.du,
                     (long long)gm * f + gn);
    }
  }
}

// Pass B: dx rows [m0, m0 + 64) x columns [n0, n0 + 64) of d, zeros for
// the rows [live, C).  Every thread of the block calls it (it syncs).
template <typename T>
__device__ void exb_dx_tile(const ExbProblem<T>& p, int C, int d, int f,
                            int m0, int n0, ExbSmem& sm) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4];
  exb_zero(acc);
  if (m0 < p.live) {  // uniform over the block
    const bool busy = m0 + ty * 4 < p.live;
    for (int k0 = 0; k0 < f; k0 += EX_BK) {
      exb_load_t<T>(p.dg, f, p.live, f, m0, k0, sm.t[0]);
      exb_load_t<T>(p.du, f, p.live, f, m0, k0, sm.t[1]);
      exb_load_t<T>(p.wg, f, d, f, n0, k0, sm.t[2]);  // [k][n] = wg[n][k]
      exb_load_t<T>(p.wu, f, d, f, n0, k0, sm.t[3]);
      __syncthreads();
      if (busy) {
        exb_fma(acc, sm.t[0], sm.t[2], ty, tx);
        exb_fma(acc, sm.t[1], sm.t[3], ty, tx);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < d)
        p.dx[(long long)gm * d + gn] =
            from_f32<T>(gm < p.live ? acc[i][j] : 0.f);
    }
  }
}

// Pass C: the (k0, j0) tiles of dwg and dwu (d x f) and the (j0, k0) tile
// of dwd (f x d) of weight set wp, K over the live rows of each of its NS
// sources (get(wp, sp)) in order.  Every thread of the block calls it.
template <typename T, typename Get>
__device__ void exb_dw_tile(const Get& get, long long wp, int NS, int d,
                            int f, int k0, int j0, T* dwg, T* dwu, T* dwd,
                            ExbSmem& sm) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float ag[4][4], au[4][4], ad[4][4];
  exb_zero(ag);
  exb_zero(au);
  exb_zero(ad);
  for (int sp = 0; sp < NS; ++sp) {
    const ExbProblem<T> p = get(wp, sp);
    for (int r0 = 0; r0 < p.live; r0 += EX_BK) {
      exb_load_n<T>(p.x, d, p.live, d, r0, k0, sm.t[0]);
      exb_load_n<T>(p.dy, d, p.live, d, r0, k0, sm.t[1]);
      exb_load_n<T>(p.dg, f, p.live, f, r0, j0, sm.t[2]);
      exb_load_n<T>(p.du, f, p.live, f, r0, j0, sm.t[3]);
      exb_load_n<T>(p.h, f, p.live, f, r0, j0, sm.t[4]);
      __syncthreads();
      exb_fma(ag, sm.t[0], sm.t[2], ty, tx);
      exb_fma(au, sm.t[0], sm.t[3], ty, tx);
      exb_fma(ad, sm.t[4], sm.t[1], ty, tx);
      __syncthreads();
    }
  }
  const long long wo = wp * (long long)d * f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = ty * 4 + i, b = tx * 4 + j;
      if (k0 + a < d && j0 + b < f) {
        const long long at = wo + (long long)(k0 + a) * f + j0 + b;
        dwg[at] = from_f32<T>(ag[i][j]);
        dwu[at] = from_f32<T>(au[i][j]);
      }
      if (j0 + a < f && k0 + b < d)
        dwd[wo + (long long)(j0 + a) * d + k0 + b] = from_f32<T>(ad[i][j]);
    }
}

// Item counts and decoding of the CUDA-core passes: NW weight sets x NS
// sources x 64-row tiles x 64-column tiles (A, B; the row tile fastest), or
// NW x d tiles x f tiles (C; the f tile fastest).
__host__ __device__ __forceinline__ long long exb_rows_items(long long NW,
                                                             int NS, int C,
                                                             int cols) {
  return NW * NS * ((C + EX_BM - 1) / EX_BM) * ((cols + EX_BN - 1) / EX_BN);
}

__host__ __device__ __forceinline__ long long exb_dw_items(long long NW, int d,
                                                           int f) {
  return NW * ((d + EX_BM - 1) / EX_BM) * ((f + EX_BN - 1) / EX_BN);
}

// pass A (rows_pass) or B item -> (weight set, source, first row, first col)
__device__ __forceinline__ void exb_rows_item(long long item, int NS, int C,
                                              int cols, long long& wp,
                                              int& sp, int& m0, int& n0) {
  const int mt = (C + EX_BM - 1) / EX_BM, nt = (cols + EX_BN - 1) / EX_BN;
  m0 = (int)(item % mt) * EX_BM;
  item /= mt;
  sp = (int)(item % NS);
  item /= NS;
  n0 = (int)(item % nt) * EX_BN;
  wp = item / nt;
}

template <typename T, typename Get>
__device__ void exb_simt_item(int pass, long long item, int NS, int C, int d,
                              int f, const Get& get, T* dwg, T* dwu, T* dwd,
                              ExbSmem& sm) {
  if (pass == 2) {
    const int nj = (f + EX_BN - 1) / EX_BN, nk = (d + EX_BM - 1) / EX_BM;
    const int j0 = (int)(item % nj) * EX_BN;
    const int k0 = (int)((item / nj) % nk) * EX_BM;
    exb_dw_tile<T>(get, item / nj / nk, NS, d, f, k0, j0, dwg, dwu, dwd, sm);
    return;
  }
  long long wp;
  int sp, m0, n0;
  exb_rows_item(item, NS, C, pass == 0 ? f : d, wp, sp, m0, n0);
  const ExbProblem<T> p = get(wp, sp);
  if (pass == 0)
    exb_rows_tile<T>(p, d, f, m0, n0, sm);
  else
    exb_dx_tile<T>(p, C, d, f, m0, n0, sm);
}

// -- the tensor-core route ----------------------------------------------------

// Dynamic shared memory: 1024 bytes of slack for the swizzle's alignment,
// pass C's stages (EXB_C_BOXES boxes each), x and dy slots and output
// tiles (passes A and B lay their stages of up to EXB_BOXES boxes in the
// same bytes), then the full and empty barriers of each stage and of each
// of pass C's slots.
__host__ __device__ inline int exb_smem_bytes() {
  return 1024
         + (EXB_STAGES * EXB_C_BOXES + 4 * EXB_SLOTS + EXB_OUT_TILES)
               * EXB_BOX_BYTES
         + 8 * (2 * EXB_STAGES + 2 * EXB_SLOTS);
}

// The packed rows.  Weight set wp gathers the live rows of its NS sources,
// source by source and row by row, into ceil(rows / 64) consecutive 64-row
// tiles of a layout of at most PT tiles (the caller's bound); the rows of
// its last tile past the live ones are padding, zero in the packed x and
// dy.  The work area holds the int32 metadata exb_build_pack writes:
// meta[0] the tiles in use, meta[1 + t] the weight set of tile t (t < PT),
// then each weight set's first tile, then each weight set's NS + 1 row
// offsets (where each source's rows start, then its rows in all); then,
// 8-byte aligned, rowoff[p]: the element offset of packed row p's source
// row in the caller's layout of x, dy and dx, or -1 for a padding row.
struct ExbPack {
  const int* meta;
  const long long* rowoff;
  long long NW;
  int NS, PT;
  __device__ int tiles() const { return meta[0]; }
  __device__ int set_of(long long t) const { return meta[1 + t]; }
  __device__ int first(long long wp) const { return meta[1 + PT + wp]; }
  __device__ const int* seg(long long wp) const {
    return meta + 1 + PT + NW + wp * (NS + 1);
  }
  __device__ int ntiles(long long wp) const {
    return (seg(wp)[NS] + EXB_BR - 1) / EXB_BR;
  }
};

__host__ __device__ inline long long exb_meta_words(long long NW, int NS,
                                                    int PT) {
  return 1 + PT + NW * (NS + 2);
}

// int32 words of the work area: the metadata, then the row offsets
__host__ __device__ inline long long exb_work_words(long long NW, int NS,
                                                    int PT) {
  const long long m = exb_meta_words(NW, NS, PT);
  return m + (m & 1) + 2LL * PT * EXB_BR;
}

__host__ __device__ inline ExbPack exb_pack_view(void* work, long long NW,
                                                 int NS, int PT) {
  const long long m = exb_meta_words(NW, NS, PT);
  const int* meta = static_cast<const int*>(work);
  return ExbPack{meta, reinterpret_cast<const long long*>(meta + m + (m & 1)),
                 NW, NS, PT};
}

// The scratch of the route, in the packed layout: x and dy (PT * 64 rows
// of d), then dg, du and h (PT * 64 rows of f).
template <typename T>
struct ExbPlanes {
  T* xp;
  T* dyp;
  T* dg;
  T* du;
  T* h;
};

template <typename T>
__host__ __device__ inline ExbPlanes<T> exb_planes(void* scratch, int PT,
                                                   int d, int f) {
  T* p = static_cast<T*>(scratch);
  const long long R = (long long)PT * EXB_BR;
  return ExbPlanes<T>{p, p + R * d, p + 2 * R * d, p + 2 * R * d + R * f,
                      p + 2 * R * d + 2 * R * f};
}

// One block fills the metadata from live(wp, s) (each clamped to [0, C]),
// a block-wide scan of the weight sets' tile counts.  More tiles than PT (a
// caller's bound that does not hold) traps: a launch error the wrapper
// raises, not a write past the buffers.
template <typename Live>
__device__ void exb_build_pack(long long NW, int NS, int C, int PT,
                               Live live, int* meta) {
  int* first = meta + 1 + PT;
  int* seg = first + NW;
  int base = 0;
  for (long long w0 = 0; w0 < NW; w0 += blockDim.x) {
    const long long wp = w0 + threadIdx.x;
    int tiles = 0;
    if (wp < NW) {
      int n = 0;
      for (int s = 0; s < NS; ++s) {
        seg[wp * (NS + 1) + s] = n;
        n += min(max(live(wp, s), 0), C);
      }
      seg[wp * (NS + 1) + NS] = n;
      tiles = (n + EXB_BR - 1) / EXB_BR;
    }
    int total;
    const int off = base + ex_block_scan(tiles, total);
    if (off + tiles > PT) __trap();
    if (wp < NW) first[wp] = off;
    for (int t = 0; t < tiles; ++t) meta[1 + off + t] = (int)wp;
    base += total;
  }
  if (threadIdx.x == 0) meta[0] = base;
}

// The packed rows of source `only` (of every source where only < 0) copied
// from x and dy into xp and dyp, one warp a row, 16 bytes a lane, warps
// warp0, warp0 + warps, ... of a grid-wide numbering.  With `first` set it
// also writes every row's rowoff and zeroes the padding rows.  src(wp, s,
// r) is the element offset of row r of source s of weight set wp in x's
// layout.
template <typename T, typename Src>
__device__ void exb_pack_rows(const ExbPack& pk, int d, int only, bool first,
                              const T* x, const T* dy, T* xp, T* dyp,
                              long long* rowoff, Src src, long long warp0,
                              long long warps) {
  const int lane = threadIdx.x % 32;
  const int vec = d * (int)sizeof(T) / 16;
  const long long rows = (long long)pk.tiles() * EXB_BR;
  for (long long p = warp0; p < rows; p += warps) {
    const int wp = pk.set_of(p / EXB_BR);
    const int* seg = pk.seg(wp);
    const int local = (int)(p - (long long)pk.first(wp) * EXB_BR);
    int s = 0;
    while (s < pk.NS && seg[s + 1] <= local) ++s;  // NS: a padding row
    const long long off = s < pk.NS ? src(wp, s, local - seg[s]) : -1;
    if (first && lane == 0) rowoff[p] = off;
    uint4* xo = reinterpret_cast<uint4*>(xp + p * d);
    uint4* yo = reinterpret_cast<uint4*>(dyp + p * d);
    if (off < 0) {
      if (first)
        for (int v = lane; v < vec; v += 32)
          xo[v] = yo[v] = make_uint4(0, 0, 0, 0);
    } else if (only < 0 || s == only) {
      const uint4* xi = reinterpret_cast<const uint4*>(x + off);
      const uint4* yi = reinterpret_cast<const uint4*>(dy + off);
      for (int v = lane; v < vec; v += 32) {
        xo[v] = xi[v];
        yo[v] = yi[v];
      }
    }
  }
}

struct ExbTcSmem {
  uint32_t base;  // shared-window address of stage 0, 1024-byte aligned
  // box i of stage s in a pass whose stages hold nbox boxes
  __device__ uint32_t box(int nbox, int s, int i) const {
    return base + (s * nbox + i) * EXB_BOX_BYTES;
  }
  // pass C's slot sl, box i: x and dy of warpgroup 0, then of 1
  __device__ uint32_t slot(int sl, int i) const {
    return base + (EXB_STAGES * EXB_C_BOXES + 4 * sl + i) * EXB_BOX_BYTES;
  }
  // pass C's output tile t (warpgroup t / 3's dwg, dwu, dwd), 64 rows of
  // 128 bytes
  __device__ uint32_t out(int t) const {
    return slot(EXB_SLOTS, t);
  }
  __device__ uint32_t full(int s) const {
    return base + EXB_RING_BOXES * EXB_BOX_BYTES + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(EXB_STAGES + s); }
  __device__ uint32_t xfull(int sl) const { return full(2 * EXB_STAGES + sl); }
  __device__ uint32_t xempty(int sl) const {
    return full(2 * EXB_STAGES + EXB_SLOTS + sl);
  }
};

using ExbPipe = StagePipe<EXB_STAGES>;

// Every thread of the block calls it once (it syncs the block).  A full
// barrier waits on the producer's arrival and its bytes, an empty one on
// the 8 consumer warps (both warpgroups release every stage and slot).
__device__ inline ExbTcSmem exb_smem_init(unsigned char* raw) {
  ExbTcSmem sm;
  sm.base = (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023)
            & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < EXB_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), EXB_CONSUMERS / 32);
    }
    for (int sl = 0; sl < EXB_SLOTS; ++sl) {
      mbar_init(sm.xfull(sl), 1);
      mbar_init(sm.xempty(sl), EXB_CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  return sm;
}

// wgmma m64n64k16, f32 accumulators, both operands from shared memory;
// TA / TB: A / B read MN-major through the transpose bit (1) or K-major (0).
#define EXB_MMA_ASM(TY, TA, TB)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY     \
               " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                 \
               "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "          \
               "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "          \
               "%30, %31}, %32, %33, p, 1, 1, " #TA ", " #TB ";\n}\n"       \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
                 "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
                 "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
                 "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])          \
               : "l"(da), "l"(db), "r"(1))

template <typename T, int TA, int TB>
struct ExbMma;
#define EXB_MMA_SPEC(TA, TB)                                                 \
  template <>                                                                \
  struct ExbMma<__nv_bfloat16, TA, TB> {                                     \
    static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,  \
                                               uint64_t db) {                \
      EXB_MMA_ASM(bf16, TA, TB);                                             \
    }                                                                        \
  };                                                                         \
  template <>                                                                \
  struct ExbMma<__half, TA, TB> {                                            \
    static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,  \
                                               uint64_t db) {                \
      EXB_MMA_ASM(f16, TA, TB);                                              \
    }                                                                        \
  };
EXB_MMA_SPEC(1, 0)
EXB_MMA_SPEC(0, 0)
EXB_MMA_SPEC(1, 1)

// a 64 x 64 box read MN-major (its 64 contiguous elements are M or N): a
// k16 step is 16 of its 128-byte rows
__device__ __forceinline__ uint64_t exb_mn(uint32_t box, int kk) {
  return tc_desc(box + kk * 2048, EXB_BOX_BYTES, 1024);
}
// ... read K-major (its 64 contiguous elements are K): a k16 step is 32
// bytes of each row, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t exb_k(uint32_t box, int kk) {
  return tc_desc(box + kk * 32, 16, 1024);
}

__device__ __forceinline__ void exb_fence3(float (&a)[32], float (&b)[32],
                                           float (&c)[32]) {
  ex_fence_acc(a);
  ex_fence_acc(b);
  ex_fence_acc(c);
}

__device__ __forceinline__ void exb_zero3(float (&a)[32], float (&b)[32],
                                          float (&c)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = b[i] = c[i] = 0.f;
}

// The producer's K step: `nbox` boxes into the next stage once its
// consumers have released it; load(stage) issues them.
template <typename Load>
__device__ __forceinline__ void exb_produce(const ExbTcSmem& sm, ExbPipe& pipe,
                                            int nbox, const Load& load) {
  mbar_wait_trap(sm.empty(pipe.stage), pipe.phase ^ 1);
  const uint32_t full = sm.full(pipe.stage);
  mbar_expect_tx(full, nbox * EXB_BOX_BYTES);
  load(pipe.stage, full);
  pipe.advance();
}

// The consumers' K step: wait for the stage, run mma(stage) (which issues
// the step's wgmma, one group, or none for a warpgroup with no tile in the
// step), wait for the group and release the stage.  No group stays in
// flight past the step: the compiler does not know that wgmma writes the
// accumulators late, and may copy them between registers at a loop's exit
// (a copy of an in-flight accumulator reads it stale).
template <typename Fence, typename Mma>
__device__ __forceinline__ void exb_consume(const ExbTcSmem& sm, ExbPipe& pipe,
                                            const Fence& fence,
                                            const Mma& mma) {
  mbar_wait_trap(sm.full(pipe.stage), pipe.phase);
  fence();
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  mma(pipe.stage);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence();
  if (threadIdx.x % 32 == 0) mbar_arrive(sm.empty(pipe.stage));
  pipe.advance();
}

// the 256 consumer threads alone (named barrier 1; the producer warp runs
// on)
__device__ __forceinline__ void exb_consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Byte offset of element (r, c) of a 64 x 64 16-bit tile in shared memory
// (1024-byte aligned): row r's 16-byte chunks permuted by r & 7, TMA's
// 128-byte swizzle, so the 8 rows a warp's accumulator stores touch at
// once fall in 8 different bank groups.
__device__ __forceinline__ uint32_t exb_tile_at(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// two f32 values rounded into one 32-bit word of two 16-bit elements, a
// at the lower address
template <typename T>
__device__ __forceinline__ uint32_t exb_pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t exb_pack2<__nv_bfloat16>(float a,
                                                             float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t exb_pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator i of consumer thread (warp, lane) of its warpgroup: row m
// (wgmma's M) and column n (N)
__device__ __forceinline__ void exb_acc_at(int i, int& m, int& n) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  m = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
  n = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
}

// The items of passes A and B: (packed tile, 128 columns), each weight
// set's items in a run of its own, the tile fastest, so the blocks that
// run together read one set's weight boxes (from device memory once, the
// rest from L2) and its tiles' row boxes again for each column block while
// they are still in L2; every item costs the same.  it -> the set, its
// tile (among the set's) and the column block.
struct ExbTileItem {
  long long wp;
  int t, tiles, col0;
};

__device__ __forceinline__ ExbTileItem exb_tile_item(const ExbPack& pk,
                                                     long long it, int ncol) {
  ExbTileItem r;
  r.wp = pk.set_of(it / ncol);
  const long long local = it - (long long)pk.first(r.wp) * ncol;
  r.tiles = pk.ntiles(r.wp);
  r.t = (int)(local % r.tiles);
  r.col0 = (int)(local / r.tiles) * 128;
  return r;
}

// Pass A: items (packed tile, 128 columns of f); warpgroup w takes the
// columns col0 + 64 w.  Per 64-deep K step of d the producer loads the
// set's w_gate, w_up and w_down boxes of both column halves and the tile's
// x and dy boxes, which both warpgroups read.  M is f's columns, N the
// tile's rows, K d; padding rows are zero in x and dy, so their h, dg and
// du come out as zeros.  The weight set's weight-map coordinates are
// (wp % E, wp / E).  Where f is an odd multiple of 64 the last column
// block's upper half is neither loaded nor computed.
template <typename T>
__device__ void exb_tc_rows_pass(const ExbTcSmem& sm, ExbPipe& pipe,
                                 const ExbPack& pk, int E, int d, int f,
                                 const CUtensorMap* wgm, const CUtensorMap* wum,
                                 const CUtensorMap* wdm, const CUtensorMap* xm,
                                 const CUtensorMap* dym,
                                 const ExbPlanes<T>& pl) {
  const int ncol = (f + 127) / 128, nk = d / 64, w = threadIdx.x / 128;
  const long long items = (long long)pk.tiles() * ncol;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const ExbTileItem c = exb_tile_item(pk, it, ncol);
    const int halves = c.col0 + 64 < f ? 2 : 1;
    const int e = (int)(c.wp % E), q = (int)(c.wp / E);
    const int row0 = (pk.first(c.wp) + c.t) * EXB_BR;
    if (threadIdx.x == EXB_CONSUMERS) {
      for (int kb = 0; kb < nk; ++kb)
        exb_produce(sm, pipe, 3 * halves + 2, [&](int s, uint32_t full) {
          const int k0 = kb * 64;
          auto box = [&](int i) { return sm.box(EXB_BOXES, s, i); };
          tma_load_5d(box(0), xm, full, k0, row0, 0, 0, 0);
          tma_load_5d(box(1), dym, full, k0, row0, 0, 0, 0);
          for (int h = 0; h < halves; ++h) {
            const int col = c.col0 + 64 * h;
            tma_load_5d(box(2 + 3 * h), wgm, full, col, k0, e, q, 0);
            tma_load_5d(box(3 + 3 * h), wum, full, col, k0, e, q, 0);
            tma_load_5d(box(4 + 3 * h), wdm, full, k0, col, e, q, 0);
          }
        });
    } else if (threadIdx.x < EXB_CONSUMERS) {
      const bool mine = w < halves;  // uniform over the warpgroup
      float ag[32], au[32], ah[32];
      exb_zero3(ag, au, ah);
      auto fence = [&] { exb_fence3(ag, au, ah); };
      for (int kb = 0; kb < nk; ++kb)
        exb_consume(sm, pipe, fence, [&](int s) {
          if (!mine) return;
          auto box = [&](int i) { return sm.box(EXB_BOXES, s, i); };
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bx = exb_k(box(0), kk);
            ExbMma<T, 1, 0>::run(ag, exb_mn(box(2 + 3 * w), kk), bx);
            ExbMma<T, 1, 0>::run(au, exb_mn(box(3 + 3 * w), kk), bx);
            ExbMma<T, 0, 0>::run(ah, exb_k(box(4 + 3 * w), kk),
                                 exb_k(box(1), kk));
          }
        });
      if (mine) {
        const int col = c.col0 + 64 * w;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          int m, r;
          exb_acc_at(i, m, r);
          exb_grads<T>(ag[i], au[i], ah[i], pl.h, pl.dg, pl.du,
                       (long long)(row0 + r) * f + col + m);
        }
      }
    }
  }
}

// Pass B: items (packed tile, 128 columns of d), walked as pass A's, K
// over f; warpgroup w takes the columns c0 + 64 w.  Per step the producer
// loads the w_gate and w_up boxes of both halves and the tile's dg and du
// boxes.  M is d's columns, N the rows; dx = dg wg^T + du wu^T in one
// accumulator, and each live row's dx is stored at its row of the caller's
// layout, dx + rowoff (padding rows are skipped).  Where d is an odd
// multiple of 64 the last column block's upper half is neither loaded nor
// stored.
template <typename T>
__device__ void exb_tc_dx_pass(const ExbTcSmem& sm, ExbPipe& pipe,
                               const ExbPack& pk, int E, int d, int f,
                               const CUtensorMap* wgm, const CUtensorMap* wum,
                               const CUtensorMap* dgm, const CUtensorMap* dum,
                               T* dx) {
  const int ncol = (d + 127) / 128, nk = f / 64, w = threadIdx.x / 128;
  const long long items = (long long)pk.tiles() * ncol;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const ExbTileItem c = exb_tile_item(pk, it, ncol);
    const int halves = c.col0 + 64 < d ? 2 : 1;
    const int e = (int)(c.wp % E), q = (int)(c.wp / E);
    const int row0 = (pk.first(c.wp) + c.t) * EXB_BR;
    if (threadIdx.x == EXB_CONSUMERS) {
      for (int kb = 0; kb < nk; ++kb)
        exb_produce(sm, pipe, 2 * halves + 2, [&](int s, uint32_t full) {
          const int k0 = kb * 64;
          auto box = [&](int i) { return sm.box(EXB_BOXES, s, i); };
          tma_load_5d(box(0), dgm, full, k0, row0, 0, 0, 0);
          tma_load_5d(box(1), dum, full, k0, row0, 0, 0, 0);
          for (int h = 0; h < halves; ++h) {
            tma_load_5d(box(2 + 2 * h), wgm, full, k0, c.col0 + 64 * h, e, q,
                        0);
            tma_load_5d(box(3 + 2 * h), wum, full, k0, c.col0 + 64 * h, e, q,
                        0);
          }
        });
    } else if (threadIdx.x < EXB_CONSUMERS) {
      const bool mine = w < halves;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      auto fence = [&] { ex_fence_acc(acc); };
      for (int kb = 0; kb < nk; ++kb)
        exb_consume(sm, pipe, fence, [&](int s) {
          if (!mine) return;
          auto box = [&](int i) { return sm.box(EXB_BOXES, s, i); };
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            ExbMma<T, 0, 0>::run(acc, exb_k(box(2 + 2 * w), kk),
                                 exb_k(box(0), kk));
            ExbMma<T, 0, 0>::run(acc, exb_k(box(3 + 2 * w), kk),
                                 exb_k(box(1), kk));
          }
        });
      if (mine) {
        const long long r0 = row0;
        const int col = c.col0 + 64 * w;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          int m, r;
          exb_acc_at(i, m, r);
          const long long off = pk.rowoff[r0 + r];
          if (off >= 0) dx[off + col + m] = from_f32<T>(acc[i]);
        }
      }
    }
  }
}

// Pass C: items (weight set, 128 rows of d, a run of 64-column blocks j0
// of f); for each j0 in turn, K over the set's packed tiles in order, one
// 64-row step each.  A set of n tiles has n items for each 128 rows of d,
// its nj column blocks in n runs of ceil(nj / n), so that every item costs
// about the same; a set with no live row has one item for each 128 rows,
// which writes zeros.  Warpgroup w computes dwg and dwu (M = d, N = f: x^T
// dg, x^T du) and dwd (M = f, N = d: h^T dy) of its 64 rows k0 + 64 w of
// d, then the six tiles go out.  Tile t's x and dy boxes (both warpgroups'
// rows of d) sit in slot t % EXB_SLOTS while the producer streams each
// tile's dg, du and h boxes (columns j0) through the stages: a set of at
// most EXB_SLOTS tiles loads them once an item, a set of more once for
// every j0.  Where d is an odd multiple of 64 the last item's upper half
// is neither loaded nor stored.
template <typename T>
__device__ void exb_tc_dw_pass(const ExbTcSmem& sm, ExbPipe& pipe,
                               const ExbPack& pk, int d, int f,
                               const CUtensorMap* xm, const CUtensorMap* dym,
                               const CUtensorMap* dgm, const CUtensorMap* dum,
                               const CUtensorMap* hm, const CUtensorMap* dwgm,
                               const CUtensorMap* dwum,
                               const CUtensorMap* dwdm) {
  const int nj = f / 64, nkt = (d + 127) / 128, w = threadIdx.x / 128;
  const long long T_ = pk.tiles();
  const long long items = (T_ + pk.NW) * nkt;
  uint32_t xphase = 0;  // bit sl: slot sl's phase, kept by each role
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int k0 = (int)(it % nkt) * 128;
    const long long entry = it / nkt;
    long long wp;
    int tiles, j_lo, j_hi;
    if (entry < T_) {  // run entry - first of the set's tiles
      wp = pk.set_of(entry);
      tiles = pk.ntiles(wp);
      const int run = (nj + tiles - 1) / tiles;
      j_lo = (int)(entry - pk.first(wp)) * run;
      j_hi = min(nj, j_lo + run);
    } else {           // a set with no live row: zeros
      wp = entry - T_;
      tiles = pk.ntiles(wp);
      j_lo = 0;
      j_hi = tiles ? 0 : nj;
    }
    if (j_lo >= j_hi) continue;  // uniform over the block
    const int halves = k0 + 64 < d ? 2 : 1;
    const int first = pk.first(wp);
    const bool keep = tiles <= EXB_SLOTS;  // the slots hold every tile
    if (threadIdx.x == EXB_CONSUMERS) {
      for (int j = j_lo; j < j_hi; ++j)
        for (int t = 0; t < tiles; ++t) {
          const int r0 = (first + t) * EXB_BR, sl = t % EXB_SLOTS;
          if (!keep || j == j_lo) {
            mbar_wait_trap(sm.xempty(sl), ((xphase >> sl) & 1) ^ 1);
            mbar_expect_tx(sm.xfull(sl), 2 * halves * EXB_BOX_BYTES);
            for (int h = 0; h < halves; ++h) {
              tma_load_5d(sm.slot(sl, 2 * h), xm, sm.xfull(sl), k0 + 64 * h,
                          r0, 0, 0, 0);
              tma_load_5d(sm.slot(sl, 2 * h + 1), dym, sm.xfull(sl),
                          k0 + 64 * h, r0, 0, 0, 0);
            }
            xphase ^= 1u << sl;
          }
          exb_produce(sm, pipe, EXB_C_BOXES, [&](int s, uint32_t full) {
            auto box = [&](int i) { return sm.box(EXB_C_BOXES, s, i); };
            tma_load_5d(box(0), dgm, full, 64 * j, r0, 0, 0, 0);
            tma_load_5d(box(1), dum, full, 64 * j, r0, 0, 0, 0);
            tma_load_5d(box(2), hm, full, 64 * j, r0, 0, 0, 0);
          });
        }
    } else if (threadIdx.x < EXB_CONSUMERS) {
      const bool mine = w < halves;
      for (int j = j_lo; j < j_hi; ++j) {
        float ag[32], au[32], ad[32];
        exb_zero3(ag, au, ad);
        auto fence = [&] { exb_fence3(ag, au, ad); };
        for (int t = 0; t < tiles; ++t) {
          const int sl = t % EXB_SLOTS;
          if (!keep || j == j_lo) {
            mbar_wait_trap(sm.xfull(sl), (xphase >> sl) & 1);
            xphase ^= 1u << sl;
          }
          exb_consume(sm, pipe, fence, [&](int s) {
            if (!mine) return;
            auto box = [&](int i) { return sm.box(EXB_C_BOXES, s, i); };
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t ax = exb_mn(sm.slot(sl, 2 * w), kk);
              ExbMma<T, 1, 1>::run(ag, ax, exb_mn(box(0), kk));
              ExbMma<T, 1, 1>::run(au, ax, exb_mn(box(1), kk));
              ExbMma<T, 1, 1>::run(ad, exb_mn(box(2), kk),
                                   exb_mn(sm.slot(sl, 2 * w + 1), kk));
            }
          });
          if ((!keep || j == j_hi - 1) && threadIdx.x % 32 == 0)
            mbar_arrive(sm.xempty(sl));
        }
        // the six tiles rounded into shared memory in TMA's 128-byte
        // swizzle (each row's 16-byte chunks permuted by the row, which also
        // spreads the accumulators' stores over the banks), then out by TMA
        // stores that run on while the next column block is computed
        if (threadIdx.x == 0) bulk_wait_read();  // the last tiles are read
        exb_consumers_sync();
        if (mine) {
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            int m, n;
            exb_acc_at(i, m, n);
            const uint32_t at = exb_tile_at(m, n);
            st_shared_b32(sm.out(3 * w) + at, exb_pack2<T>(ag[i], ag[i + 1]));
            st_shared_b32(sm.out(3 * w + 1) + at,
                          exb_pack2<T>(au[i], au[i + 1]));
            st_shared_b32(sm.out(3 * w + 2) + at,
                          exb_pack2<T>(ad[i], ad[i + 1]));
          }
        }
        fence_proxy_async_shared();
        exb_consumers_sync();
        if (threadIdx.x == 0) {
          for (int o = 0; o < 3 * halves; ++o) {
            const int kc = k0 + 64 * (o / 3);
            if (o % 3 == 2)
              tma_store_5d(dwdm, sm.out(o), kc, 64 * j, (int)wp, 0, 0);
            else
              tma_store_5d(o % 3 ? dwum : dwgm, sm.out(o), 64 * j, kc,
                           (int)wp, 0, 0);
          }
          bulk_commit();
        }
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}
