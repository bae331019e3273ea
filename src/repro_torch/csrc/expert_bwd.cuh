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
//             rounded to x's dtype into a scratch in device memory, for the
//             live rows (the rest of a row tile as zeros);
//   B, dx:    dx = dg wg^T + du wu^T (f32 accumulation, rounded once), the
//             rows past each count as zeros;
//   C, dW:    dwg = x^T dg, dwu = x^T du, dwd = h^T dy, one block an
//             (expert, 64 x 64 output tile), K over every live row of every
//             source in a fixed order (source by source, row tiles in
//             increasing order), written once: no atomics and no split K,
//             so the gradients are the same bit for bit from run to run.
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
// 32,768 live rows.  This first design re-reads row tiles from L2 (pass A
// reads each row tile once for every 64 columns of f, pass C each for every
// output tile), which its L2 must serve.
//
// Two routes, picked on the host by one stated rule (repro_torch/kernels/
// plan.py expert_bwd_route, checked again by each C entry point):
//
// * tensor cores (exb_tc_*): f16/bf16 with d and f multiples of 64 and
//   16-byte-aligned pointers and strides.  A block is one consumer
//   warpgroup and one producer warp, persistent over a pass's items; the
//   producer streams 64-deep K steps of 64 x 64 boxes (EXB_BOXES a stage,
//   EXB_STAGES stages, 128-byte swizzled) by TMA, the consumers run wgmma
//   m64n64k16 with f32 accumulators.  Rows are always 64-row tiles (N = 64
//   in passes A and B, K in pass C); TMA zero-fills rows past C.  Every
//   operand is read in place through wgmma's transpose bits: pass A's
//   weight tiles MN-major (g, u) and w_down K-major (dh = dy wd^T); pass
//   B's w_gate and w_up K-major (their f is the contraction); pass C's row
//   tiles MN-major on both sides (the rows are the contraction).  Passes A
//   and B run only the row tiles with live rows (a list built on the card,
//   ex_tc_build_list<EXB_BR>); pass B first writes every row past its count
//   as zeros (ex_zero_dead_rows).  Pass C rounds its three output tiles
//   into shared memory (each row's 16-byte chunks permuted by the row, so
//   the accumulators' stores meet no bank conflict) and writes them out in
//   16-byte stores, 8 threads a 128-byte row: stored straight from the
//   accumulators, 2-byte stores spread over 8 rows a warp instruction, the
//   dW writes took 18 of pass C's 28 ms on an H100 at the training call
//   (x of 4 x 2 x 64 x 80 rows, d 4096, f 1536, 40,960 live rows).
// * CUDA cores (exb_*_tile): f32 and every shape off the rule; 256 threads
//   each keeping 4 x 4 register tiles (three in passes A and C, one in B)
//   over five (EX_BK, 64 + EX_PAD) f32 tiles in shared memory.
#pragma once

#include "expert_mlp.cuh"

#define EXB_BR 64       // rows of a row tile (passes A, B) and a K step (C)
#define EXB_STAGES 4
#define EXB_BOXES 5     // 64 x 64 boxes a stage
#define EXB_THREADS 160

constexpr int EXB_BOX_BYTES = 64 * 64 * 2;
static_assert(EXB_THREADS == EX_TC_CONSUMERS + 32, "one producer warp");

// Where a problem's operands sit for TMA: the x and dy maps and their
// coordinates past (k, row, e), the scratch maps' past (j, row, e), and the
// weight maps' past (column, k, e).
struct ExbCoord {
  const CUtensorMap* xm;
  const CUtensorMap* dym;
  int x3, x4, s3, s4, e, wq;
};

// One problem: one expert's row block from one source, and that expert's
// weights.
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
  ExbCoord c;
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
// the stages of EXB_BOXES boxes, pass C's three 64 x 64 output tiles, then
// each stage's full and empty barriers.
__host__ __device__ inline int exb_smem_bytes() {
  return 1024 + EXB_STAGES * EXB_BOXES * EXB_BOX_BYTES + 3 * EXB_BOX_BYTES
         + 16 * EXB_STAGES;
}

// Entries of a pass's work list over `problems` problems of C rows.
__host__ __device__ inline long long exb_list_len(long long problems, int C) {
  return 1 + problems * ((C + EXB_BR - 1) / EXB_BR);
}

struct ExbTcSmem {
  uint32_t base;  // shared-window address of stage 0, 1024-byte aligned
  __device__ uint32_t box(int s, int i) const {
    return base + (s * EXB_BOXES + i) * EXB_BOX_BYTES;
  }
  // pass C's output tile t (dwg, dwu, dwd), 64 rows of 128 bytes
  __device__ uint32_t out(int t) const {
    return base + (EXB_STAGES * EXB_BOXES + t) * EXB_BOX_BYTES;
  }
  __device__ uint32_t full(int s) const {
    return base + (EXB_STAGES * EXB_BOXES + 3) * EXB_BOX_BYTES + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(EXB_STAGES + s); }
};

using ExbPipe = StagePipe<EXB_STAGES>;

// Every thread of the block calls it once (it syncs the block).
__device__ inline ExbTcSmem exb_smem_init(unsigned char* raw) {
  ExbTcSmem sm;
  sm.base = (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023)
            & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < EXB_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), EX_TC_CONSUMERS / 32);
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

// mbar_wait that traps after about ten seconds on the SM clock: a lost
// arrival becomes a launch error the wrapper raises, not a hung card.
__device__ __forceinline__ void exb_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

// The producer's K step: `nbox` boxes into the next stage once its
// consumers have released it; load(stage) issues them.
template <typename Load>
__device__ __forceinline__ void exb_produce(const ExbTcSmem& sm, ExbPipe& pipe,
                                            int nbox, const Load& load) {
  exb_wait(sm.empty(pipe.stage), pipe.phase ^ 1);
  const uint32_t full = sm.full(pipe.stage);
  mbar_expect_tx(full, nbox * EXB_BOX_BYTES);
  load(pipe.stage, full);
  pipe.advance();
}

// The consumers' K step: wait for the stage, run mma(stage) (which issues
// the step's wgmma, one group), wait for the group and release the stage.
// No group stays in flight past the step: the compiler does not know that
// wgmma writes the accumulators late, and may copy them between registers
// at a loop's exit (a copy of an in-flight accumulator reads it stale).
template <typename Fence, typename Mma>
__device__ __forceinline__ void exb_consume(const ExbTcSmem& sm, ExbPipe& pipe,
                                            const Fence& fence,
                                            const Mma& mma) {
  exb_wait(sm.full(pipe.stage), pipe.phase);
  fence();
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  mma(pipe.stage);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence();
  if (threadIdx.x % 32 == 0) mbar_arrive(sm.empty(pipe.stage));
  pipe.advance();
}

// the 128 consumer threads alone (named barrier 1; the producer warp runs
// on)
__device__ __forceinline__ void exb_consumers_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// Byte offset of element (r, c) of a 64 x 64 16-bit tile in shared memory:
// row r's 16-byte chunks permuted by r & 7, so the 8 rows a warp's
// accumulator stores touch at once fall in 8 different bank groups.
__device__ __forceinline__ uint32_t exb_tile_at(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
  return v;
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

// accumulator i of thread (warp, lane): row m (wgmma's M) and column n (N)
__device__ __forceinline__ void exb_acc_at(int i, int& m, int& n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  m = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
  n = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
}

// Pass A over a work list (entries p * MT + row tile; items (entry, 64
// columns of f), the column fastest; block b takes items b, b + grid, ...).
// prob(p) describes problem p.  M is f's columns, N the 64 rows, K d.
template <typename T, typename Prob>
__device__ void exb_tc_rows_pass(const ExbTcSmem& sm, ExbPipe& pipe,
                                 const int* list, int C, int d, int f,
                                 const CUtensorMap* wgm, const CUtensorMap* wum,
                                 const CUtensorMap* wdm, const Prob& prob) {
  const int MT = (C + EXB_BR - 1) / EXB_BR, nt = f / 64, nk = d / 64;
  const long long items = (long long)list[0] * nt;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int entry = list[1 + it / nt];
    const int col0 = (int)(it % nt) * 64;
    const ExbProblem<T> p = prob(entry / MT);
    const int row0 = (entry % MT) * EXB_BR;
    const ExbCoord& c = p.c;
    if (threadIdx.x == EX_TC_CONSUMERS) {
      for (int kb = 0; kb < nk; ++kb)
        exb_produce(sm, pipe, 5, [&](int s, uint32_t full) {
          const int k0 = kb * 64;
          tma_load_5d(sm.box(s, 0), wgm, full, col0, k0, c.e, c.wq, 0);
          tma_load_5d(sm.box(s, 1), wum, full, col0, k0, c.e, c.wq, 0);
          tma_load_5d(sm.box(s, 2), wdm, full, k0, col0, c.e, c.wq, 0);
          tma_load_5d(sm.box(s, 3), c.xm, full, k0, row0, c.e, c.x3, c.x4);
          tma_load_5d(sm.box(s, 4), c.dym, full, k0, row0, c.e, c.x3, c.x4);
        });
    } else if (threadIdx.x < EX_TC_CONSUMERS) {
      float ag[32], au[32], ah[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ag[i] = au[i] = ah[i] = 0.f;
      auto fence = [&] { exb_fence3(ag, au, ah); };
      for (int kb = 0; kb < nk; ++kb)
        exb_consume(sm, pipe, fence, [&](int s) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bx = exb_k(sm.box(s, 3), kk);
            ExbMma<T, 1, 0>::run(ag, exb_mn(sm.box(s, 0), kk), bx);
            ExbMma<T, 1, 0>::run(au, exb_mn(sm.box(s, 1), kk), bx);
            ExbMma<T, 0, 0>::run(ah, exb_k(sm.box(s, 2), kk),
                                 exb_k(sm.box(s, 4), kk));
          }
        });
      const int rows = min(p.live - row0, EXB_BR);
      const int lim = min(C - row0, EXB_BR);  // the tile's rows inside C
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        int m, r;
        exb_acc_at(i, m, r);
        const long long at = (long long)(row0 + r) * f + col0 + m;
        if (r < rows) {
          exb_grads<T>(ag[i], au[i], ah[i], p.h, p.dg, p.du, at);
        } else if (r < lim) {  // read by pass C's 64-row K steps
          p.h[at] = from_f32<T>(0.f);
          p.dg[at] = from_f32<T>(0.f);
          p.du[at] = from_f32<T>(0.f);
        }
      }
    }
  }
}

// Pass B over the same list: items (entry, 64 columns of d).  M is d's
// columns, N the rows, K f; dx = dg wg^T + du wu^T in one accumulator.
template <typename T, typename Prob>
__device__ void exb_tc_dx_pass(const ExbTcSmem& sm, ExbPipe& pipe,
                               const int* list, int C, int d, int f,
                               const CUtensorMap* wgm, const CUtensorMap* wum,
                               const CUtensorMap* dgm, const CUtensorMap* dum,
                               const Prob& prob) {
  const int MT = (C + EXB_BR - 1) / EXB_BR, nt = d / 64, nk = f / 64;
  const long long items = (long long)list[0] * nt;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int entry = list[1 + it / nt];
    const int col0 = (int)(it % nt) * 64;
    const ExbProblem<T> p = prob(entry / MT);
    const int row0 = (entry % MT) * EXB_BR;
    const ExbCoord& c = p.c;
    if (threadIdx.x == EX_TC_CONSUMERS) {
      for (int kb = 0; kb < nk; ++kb)
        exb_produce(sm, pipe, 4, [&](int s, uint32_t full) {
          const int k0 = kb * 64;
          tma_load_5d(sm.box(s, 0), wgm, full, k0, col0, c.e, c.wq, 0);
          tma_load_5d(sm.box(s, 1), wum, full, k0, col0, c.e, c.wq, 0);
          tma_load_5d(sm.box(s, 2), dgm, full, k0, row0, c.e, c.s3, c.s4);
          tma_load_5d(sm.box(s, 3), dum, full, k0, row0, c.e, c.s3, c.s4);
        });
    } else if (threadIdx.x < EX_TC_CONSUMERS) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      auto fence = [&] { ex_fence_acc(acc); };
      for (int kb = 0; kb < nk; ++kb)
        exb_consume(sm, pipe, fence, [&](int s) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            ExbMma<T, 0, 0>::run(acc, exb_k(sm.box(s, 0), kk),
                                 exb_k(sm.box(s, 2), kk));
            ExbMma<T, 0, 0>::run(acc, exb_k(sm.box(s, 1), kk),
                                 exb_k(sm.box(s, 3), kk));
          }
        });
      const int rows = min(p.live - row0, EXB_BR);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        int m, r;
        exb_acc_at(i, m, r);
        if (r < rows)
          p.dx[(long long)(row0 + r) * d + col0 + m] = from_f32<T>(acc[i]);
      }
    }
  }
}

// Pass C: items (weight set, 64 rows of d, 64 columns of f), the f tile
// fastest; K over the live rows of each source get(wp, sp), sp < NS, in
// 64-row steps.  dwg and dwu have M = d, N = f (x^T dg, x^T du); dwd has
// M = f, N = d (h^T dy).  A weight set with no live row writes zeros.
template <typename T, typename Get>
__device__ void exb_tc_dw_pass(const ExbTcSmem& sm, ExbPipe& pipe,
                               long long NW, int NS, int d, int f,
                               const CUtensorMap* dgm, const CUtensorMap* dum,
                               const CUtensorMap* hm, const Get& get, T* dwg,
                               T* dwu, T* dwd) {
  const int nj = f / 64, nkt = d / 64;
  const long long items = NW * nj * nkt;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int j0 = (int)(it % nj) * 64;
    const int k0 = (int)((it / nj) % nkt) * 64;
    const long long wp = it / nj / nkt;
    if (threadIdx.x == EX_TC_CONSUMERS) {
      for (int sp = 0; sp < NS; ++sp) {
        const ExbProblem<T> p = get(wp, sp);
        const ExbCoord& c = p.c;
        for (int r0 = 0; r0 < p.live; r0 += EXB_BR)
          exb_produce(sm, pipe, 5, [&](int s, uint32_t full) {
            tma_load_5d(sm.box(s, 0), c.xm, full, k0, r0, c.e, c.x3, c.x4);
            tma_load_5d(sm.box(s, 1), c.dym, full, k0, r0, c.e, c.x3, c.x4);
            tma_load_5d(sm.box(s, 2), dgm, full, j0, r0, c.e, c.s3, c.s4);
            tma_load_5d(sm.box(s, 3), dum, full, j0, r0, c.e, c.s3, c.s4);
            tma_load_5d(sm.box(s, 4), hm, full, j0, r0, c.e, c.s3, c.s4);
          });
      }
    } else if (threadIdx.x < EX_TC_CONSUMERS) {
      float ag[32], au[32], ad[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ag[i] = au[i] = ad[i] = 0.f;
      auto fence = [&] { exb_fence3(ag, au, ad); };
      for (int sp = 0; sp < NS; ++sp) {
        const int live = get(wp, sp).live;
        for (int r0 = 0; r0 < live; r0 += EXB_BR)
          exb_consume(sm, pipe, fence, [&](int s) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t ax = exb_mn(sm.box(s, 0), kk);
              ExbMma<T, 1, 1>::run(ag, ax, exb_mn(sm.box(s, 2), kk));
              ExbMma<T, 1, 1>::run(au, ax, exb_mn(sm.box(s, 3), kk));
              ExbMma<T, 1, 1>::run(ad, exb_mn(sm.box(s, 4), kk),
                                   exb_mn(sm.box(s, 1), kk));
            }
          });
      }
      // the three tiles through shared memory, rounded, then out in
      // 16-byte stores, a row's 128 bytes by 8 neighbouring threads (a
      // thread's own accumulators are 2-element runs of 8 rows)
      exb_consumers_sync();  // the previous item's tiles are out
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        int m, n;
        exb_acc_at(i, m, n);
        const uint32_t at = exb_tile_at(m, n);
        st_shared_b32(sm.out(0) + at, exb_pack2<T>(ag[i], ag[i + 1]));
        st_shared_b32(sm.out(1) + at, exb_pack2<T>(au[i], au[i + 1]));
        st_shared_b32(sm.out(2) + at, exb_pack2<T>(ad[i], ad[i + 1]));
      }
      exb_consumers_sync();
      const long long wo = wp * (long long)d * f;
      for (int q = threadIdx.x; q < 3 * 512; q += EX_TC_CONSUMERS) {
        const int t = q / 512, r = (q % 512) / 8, c8 = q % 8;
        const uint4 v = ld_shared_v4(sm.out(t) + exb_tile_at(r, 8 * c8));
        T* dst = t == 2 ? dwd + wo + (long long)(j0 + r) * d + k0
                        : (t ? dwu : dwg) + wo + (long long)(k0 + r) * f + j0;
        *reinterpret_cast<uint4*>(dst + 8 * c8) = v;
      }
    }
  }
}
