// The grouped expert-MLP tile routines shared by expert_mlp.cu and
// moe_dispatch.cu.
//
// They replace the body of the TPU kernel _expert_mlp_kernel
// (src/repro/kernels/moe_dispatch/kernel.py:27, launched at :44) and the
// grouped MLP the fused dispatch kernel inlines (_grouped_mlp,
// src/repro/kernels/moe_dispatch/fused.py:186): per expert,
//   g = x @ w_gate, u = x @ w_up      (f32 accumulation)
//   h = silu(g) * u, rounded to x's dtype
//   y = h @ w_down                    (f32 accumulation, cast)
// in two passes: the gate/up pass writes h for the live rows into a scratch
// buffer in device memory, the down pass reads h back.  A caller runs every
// gate/up tile, synchronises, then every down tile.  Two routes, chosen on
// the host before launch by one stated rule (repro_torch/kernels/plan.py
// expert_route, checked again by each C entry point), never on a failure:
// the tensor cores (ex_tc_*, below) for f16/bf16 with d and f multiples of
// 64 and 16-byte-aligned pointers and strides, the CUDA cores
// (gate_up_tile / down_tile) for f32 and every shape off the rule.
//
// Live rows.  Each problem (one expert's row block) carries a live-row
// count: rows at or past it are zero in the dispatch layouts, so their
// output is exactly zero (silu(0) * 0 @ w_down = 0).  The routines compute
// no product for them.  CUDA cores: a tile wholly past the count skips its
// K loop, a thread whose four rows are all past it skips its FMAs, and
// down_tile writes those rows as zeros.  Tensor cores: a list built on the
// card from the counts (ex_tc_build_list) holds only the row tiles with
// live rows, the passes run only those, and ex_zero_dead_rows writes every
// row past its count as zeros, 16 bytes a lane.
//
// Row independence.  CUDA cores: every output element is one thread's sum
// over K in increasing k.  Tensor cores: every output element is one
// accumulator of one wgmma chain over K in increasing 16-deep steps; the
// rows of a tile are wgmma's N columns, and a column of the product depends
// on that row's operand column and the weights alone.  Neither route
// splits K across threads or blocks, so a row's result depends on that row
// and the weights alone: the fused dispatch kernel and this kernel give
// the same bits for the same row, whatever the other rows of its block.
//
// Bound on this card: bytes at decode, bytes at a prefill chunk too.  A
// (token, choice) pair costs 2 * 3 * d * f flops; the weights of every
// expert that receives a row are read once (3 d f elements).  At
// qwen3-moe's d = 4096, f = 1536 a decode step's 32 pairs touch at most 32
// experts (1.2 GB, 0.36 ms at 3.35 TB/s) and a 512-token chunk's 4096
// pairs do 155 GFLOP (0.16 ms at 989 TFLOP/s) while reading up to all 128
// experts (4.8 GB, 1.44 ms).
//
// CUDA-core route: 256 threads each keep a 4 x 4 accumulator (two of them
// in the gate/up pass) and read their A and B fragments as float4s from
// f32 tiles in shared memory, 24.5 KiB a block; the x tile's rows are
// padded by 4 floats so its transposed stores spread over 8 banks.
//
// Tensor-core route ("swap AB"): a decode block holds 1-2 live rows, so the
// rows sit in wgmma's N dimension (n = 8 .. 128, the smallest instance
// that holds the tile's live rows) and the weights in its M: one item is
// EX_TC_BM = 64 weight columns x one row tile of up to EX_TC_BR = 128 rows.
// A block is one consumer warpgroup and one producer warp, persistent over
// the items of a pass.  The producer streams, per 64-deep K step, the
// weight tile(s) (64 columns x 64 K rows, row-major (K, cols), so
// MN-major: wgmma reads it through the transpose bit, as matmul.cuh reads
// B) and the row tile (8-row boxes of 64 K columns, K-major) by TMA into a
// ring of EX_TC_STAGES shared-memory stages, every box 128-byte swizzled;
// the gate/up pass loads w_gate and w_up together so that two f32
// accumulators share each landed row tile, and its epilogue writes
// h = silu(g) * u rounded to x's dtype.  The instance and the list are
// mirrored in the planner (expert_tile_n, expert_live_tiles).
#pragma once

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

#define EX_BM 64
#define EX_BK 32
#define EX_BN 64
#define EX_PAD 4
#define EX_THREADS 256

struct ExSmem {
  float a[EX_BK][EX_BM + EX_PAD];  // x or h tile, transposed: a[k][m]
  float b[EX_BK][EX_BN];  // w_gate or w_down tile
  float c[EX_BK][EX_BN];  // w_up tile
};

// One problem: one expert's row block and that expert's weights.
template <typename T>
struct ExProblem {
  const T* x;   // (C, d) input rows
  const T* wg;  // (d, f)
  const T* wu;  // (d, f)
  const T* wd;  // (f, d)
  T* h;         // (C, f) scratch
  T* y;         // (C, d) output
  int live;     // rows [0, live) carry tokens
};

__device__ __forceinline__ float ex_silu(float g) { return g / (1.f + expf(-g)); }

// A tile (EX_BM rows x EX_BK of K), transposed into sm.a; rows >= live and
// k >= K read as zero.
template <typename T>
__device__ __forceinline__ void ex_load_a(const T* __restrict__ A, long long lda,
                                          int live, int K, int m0, int k0,
                                          ExSmem& sm) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (EX_BM * EX_BK) / EX_THREADS; ++i) {
    int e = t + i * EX_THREADS;
    int m = e / EX_BK, k = e % EX_BK;
    int gm = m0 + m, gk = k0 + k;
    sm.a[k][m] = (gm < live && gk < K) ? to_f32(A[gm * lda + gk]) : 0.f;
  }
}

// B tile (EX_BK of K x EX_BN columns) of a row-major (K, N) matrix.
template <typename T>
__device__ __forceinline__ void ex_load_b(const T* __restrict__ B, int K, int N,
                                          int k0, int n0, float (*dst)[EX_BN]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (EX_BK * EX_BN) / EX_THREADS; ++i) {
    int e = t + i * EX_THREADS;
    int k = e / EX_BN, n = e % EX_BN;
    int gk = k0 + k, gn = n0 + n;
    dst[k][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * N + gn]) : 0.f;
  }
}

// h[m0:m0+BM, n0:n0+BN] = round(silu(x wg) * (x wu)) for the live rows.
// Every thread of the block must call it (it syncs).
template <typename T>
__device__ void gate_up_tile(const ExProblem<T>& p, int d, int f, int m0,
                             int n0, ExSmem& sm) {
  if (m0 >= p.live) return;  // uniform over the block
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;  // 16 x 16 threads, 4 x 4 outputs each
  const bool busy = m0 + ty * 4 < p.live;
  float ag[4][4], au[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ag[i][j] = au[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += EX_BK) {
    ex_load_a<T>(p.x, d, p.live, d, m0, k0, sm);
    ex_load_b<T>(p.wg, d, f, k0, n0, sm.b);
    ex_load_b<T>(p.wu, d, f, k0, n0, sm.c);
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int k = 0; k < EX_BK; ++k) {
        float4 a = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
        float4 bg = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
        float4 bu = *reinterpret_cast<const float4*>(&sm.c[k][tx * 4]);
        float av[4] = {a.x, a.y, a.z, a.w};
        float gv[4] = {bg.x, bg.y, bg.z, bg.w};
        float uv[4] = {bu.x, bu.y, bu.z, bu.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ag[i][j] += av[i] * gv[j];
            au[i][j] += av[i] * uv[j];
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= p.live) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < f)
        p.h[(long long)gm * f + gn] = from_f32<T>(ex_silu(ag[i][j]) * au[i][j]);
    }
  }
}

// y[m0:m0+BM, n0:n0+BN] = h @ wd for the live rows, zeros for the rows
// [live, C).  Every thread of the block must call it (it syncs).
template <typename T>
__device__ void down_tile(const ExProblem<T>& p, int C, int f, int d, int m0,
                          int n0, ExSmem& sm) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (m0 < p.live) {  // uniform over the block
    const bool busy = m0 + ty * 4 < p.live;
    for (int k0 = 0; k0 < f; k0 += EX_BK) {
      ex_load_a<T>(p.h, f, p.live, f, m0, k0, sm);
      ex_load_b<T>(p.wd, f, d, k0, n0, sm.b);
      __syncthreads();
      if (busy) {
#pragma unroll
        for (int k = 0; k < EX_BK; ++k) {
          float4 a = *reinterpret_cast<const float4*>(&sm.a[k][ty * 4]);
          float4 b = *reinterpret_cast<const float4*>(&sm.b[k][tx * 4]);
          float av[4] = {a.x, a.y, a.z, a.w};
          float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < d)
        p.y[(long long)gm * d + gn] = from_f32<T>(gm < p.live ? acc[i][j] : 0.f);
    }
  }
}

// Work items.  A pass runs NW weight sets (experts) x NS problems sharing
// each set (sources) x row tiles x column tiles; items that share a weight
// column tile are adjacent, so the blocks reading one weight tile from L2
// run together.  get(wp, sp) returns problem sp of weight set wp.
__host__ __device__ __forceinline__ long long ex_gate_up_items(long long NW, int NS,
                                                               int C, int f) {
  return NW * NS * ((C + EX_BM - 1) / EX_BM) * ((f + EX_BN - 1) / EX_BN);
}

__host__ __device__ __forceinline__ long long ex_down_items(long long NW, int NS,
                                                            int C, int d) {
  return NW * NS * ((C + EX_BM - 1) / EX_BM) * ((d + EX_BN - 1) / EX_BN);
}

template <typename T, typename Get>
__device__ void gate_up_item(long long item, int NS, int C, int d, int f,
                             const Get& get, ExSmem& sm) {
  const int mt = (C + EX_BM - 1) / EX_BM, nt = (f + EX_BN - 1) / EX_BN;
  const int mtile = (int)(item % mt);
  item /= mt;
  const int sp = (int)(item % NS);
  item /= NS;
  const int ntile = (int)(item % nt);
  const ExProblem<T> p = get(item / nt, sp);
  gate_up_tile<T>(p, d, f, mtile * EX_BM, ntile * EX_BN, sm);
}

template <typename T, typename Get>
__device__ void down_item(long long item, int NS, int C, int d, int f,
                          const Get& get, ExSmem& sm) {
  const int mt = (C + EX_BM - 1) / EX_BM, nt = (d + EX_BN - 1) / EX_BN;
  const int mtile = (int)(item % mt);
  item /= mt;
  const int sp = (int)(item % NS);
  item /= NS;
  const int ntile = (int)(item % nt);
  const ExProblem<T> p = get(item / nt, sp);
  down_tile<T>(p, C, f, d, mtile * EX_BM, ntile * EX_BN, sm);
}

// -- the tensor-core route ----------------------------------------------------

#define EX_TC_BM 64        // weight columns an item: wgmma's M
#define EX_TC_BK 64        // K a stage
#define EX_TC_BR 128       // rows a row tile: wgmma's N at most
#define EX_TC_STAGES 6
#define EX_TC_THREADS 160

constexpr int EX_TC_CONSUMERS = 128;                   // one warpgroup
constexpr int EX_TC_W_BYTES = EX_TC_BM * EX_TC_BK * 2;  // one weight box
constexpr int EX_TC_ROW_BYTES = 8 * EX_TC_BK * 2;       // one 8-row box
static_assert(EX_TC_THREADS == EX_TC_CONSUMERS + 32, "one producer warp");
static_assert(EX_TC_BM == 64 && EX_TC_BK == 64, "one 128-byte swizzle box");
static_assert(EX_TC_BR % 8 == 0 && EX_TC_BR <= 256, "wgmma's N");

// Dynamic shared memory: 1024 bytes of slack for the swizzle's alignment,
// the stages (mats weight boxes and a row tile each), then the full and
// empty barriers of each stage.
__host__ __device__ inline int ex_tc_smem_bytes(int mats) {
  return 1024 + EX_TC_STAGES * (mats * 8192 + 128 * EX_TC_BR)
         + 16 * EX_TC_STAGES;
}

// The instance of a row tile of `rows` live rows: the smallest n that
// holds them.
__host__ __device__ inline int ex_tc_n(int rows) {
  return rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : rows <= 64 ? 64
                                                                          : 128;
}

// Entries of a work list over `problems` problems of C rows: the count,
// then at most every row tile of every problem.
__host__ __device__ inline long long ex_tc_list_len(long long problems,
                                                    int C) {
  return 1 + problems * ((C + EX_TC_BR - 1) / EX_TC_BR);
}

struct ExTcSmem {
  uint32_t base;  // shared-window address of stage 0, 1024-byte aligned
  int stride;     // bytes a stage
  __device__ uint32_t w(int s, int m) const {
    return base + s * stride + m * EX_TC_W_BYTES;
  }
  __device__ uint32_t rows(int s) const {
    return base + (s + 1) * stride - 128 * EX_TC_BR;
  }
  __device__ uint32_t full(int s) const {
    return base + EX_TC_STAGES * stride + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(EX_TC_STAGES + s); }
};

using ExTcPipe = StagePipe<EX_TC_STAGES>;

// Every thread of the block calls it once (it syncs the block).  A full
// barrier waits on the producer's arrival and its bytes, an empty one on
// the 4 consumer warps.
__device__ inline ExTcSmem ex_tc_smem_init(unsigned char* raw, int mats) {
  ExTcSmem sm;
  sm.base = (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023)
            & ~1023u;
  sm.stride = mats * EX_TC_W_BYTES + 128 * EX_TC_BR;
  if (threadIdx.x == 0) {
    for (int s = 0; s < EX_TC_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), EX_TC_CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  return sm;
}

// One block builds a pass's work list: list[0] = L, then, problem by
// problem in increasing p, p * MT + t for each row tile t < ceil(live / BR)
// (MT = ceil(C / BR)).  live(p) is problem p's count, clamped to [0, C].
template <typename Live>
__device__ void ex_tc_build_list(long long NP, int C, Live live, int* list) {
  __shared__ int warp_sums[32];
  const int MT = (C + EX_TC_BR - 1) / EX_TC_BR;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  int base = 0;
  for (long long p0 = 0; p0 < NP; p0 += blockDim.x) {
    const long long p = p0 + threadIdx.x;
    const int tiles =
        p < NP ? (min(max(live(p), 0), C) + EX_TC_BR - 1) / EX_TC_BR : 0;
    int incl = tiles;  // inclusive scan: over the warp, then the warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane < nw) warp_sums[lane] = v;
    }
    __syncthreads();
    const int off = base + (warp ? warp_sums[warp - 1] : 0) + incl - tiles;
    for (int t = 0; t < tiles; ++t) list[1 + off + t] = (int)(p * MT + t);
    base += warp_sums[nw - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) list[0] = base;
}

// Rows [live, C) of every problem's (C, d) output as zeros: one warp a row,
// 16 bytes a lane, warps warp0, warp0 + warps, ... of a grid-wide
// numbering.  out(p, live) returns problem p's output and sets its count.
template <typename T, typename Out>
__device__ void ex_zero_dead_rows(long long NP, int C, int d, Out out,
                                  long long warp0, long long warps) {
  const int lane = threadIdx.x % 32;
  const int vec = d * (int)sizeof(T) / 16;
  for (long long r = warp0; r < NP * C; r += warps) {
    const int row = (int)(r % C);
    int live = 0;
    T* y = out(r / C, live);
    if (row < live) continue;
    uint4* dst = reinterpret_cast<uint4*>(y + (long long)row * d);
    for (int v = lane; v < vec; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
  }
}

// One item as both roles see it: the weight map's (expert, rank)
// coordinates, the row map's coordinates past (k, row) (the expert first),
// the row tile and its instance, the weight columns, and where the
// consumers write (at the tile's first row and column, pitch ld).
template <typename T>
struct ExTcJob {
  int e, wq, c3, c4;
  int row0, rows, n, col0;
  T* out;
  long long ld;
};

// Producer (one thread): the nk K steps of a job, each into the next stage
// once its consumers have released it: w0 (and w1) box (64 columns, 64 K
// rows), then n / 8 boxes (64 K columns, 8 rows) of the row map.
template <typename T>
__device__ inline void ex_tc_load(const ExTcSmem& sm, ExTcPipe& pipe,
                                  const CUtensorMap* w0,
                                  const CUtensorMap* w1,
                                  const CUtensorMap* rmap,
                                  const ExTcJob<T>& j, int nk) {
  const uint32_t bytes =
      (w1 ? 2 : 1) * EX_TC_W_BYTES + j.n / 8 * EX_TC_ROW_BYTES;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(sm.empty(pipe.stage), pipe.phase ^ 1);
    const uint32_t full = sm.full(pipe.stage);
    mbar_expect_tx(full, bytes);
    const int k0 = kb * EX_TC_BK;
    tma_load_5d(sm.w(pipe.stage, 0), w0, full, j.col0, k0, j.e, j.wq, 0);
    if (w1)
      tma_load_5d(sm.w(pipe.stage, 1), w1, full, j.col0, k0, j.e, j.wq, 0);
    for (int b = 0; b < j.n / 8; ++b)
      tma_load_5d(sm.rows(pipe.stage) + b * EX_TC_ROW_BYTES, rmap, full, k0,
                  j.row0 + 8 * b, j.e, j.c3, j.c4);
    pipe.advance();
  }
}

// wgmma m64nNk16 with f32 accumulators, A (the weights) MN-major through
// the transpose bit and B (the rows) K-major, both from shared memory.
#define EX_MMA_ASM(SHAPE, TY, REGS, A, B, P, ...)                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"        \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." #TY "." #TY \
               " {" REGS "}, " A ", " B ", p, 1, 1, 1, 0;\n}\n"      \
               : __VA_ARGS__ : "l"(da), "l"(db), "r"(1))
#define EX_MMA_N8(TY)                                                        \
  EX_MMA_ASM("m64n8k16", TY,                                                 \
             "%0, %1, %2, %3",                                               \
             "%4", "%5", "%6",                                               \
             "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]))
#define EX_MMA_N16(TY)                                                       \
  EX_MMA_ASM("m64n16k16", TY,                                                \
             "%0, %1, %2, %3, %4, %5, %6, %7",                               \
             "%8", "%9", "%10",                                              \
             "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
             "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]))
#define EX_MMA_N32(TY)                                                       \
  EX_MMA_ASM("m64n32k16", TY,                                                \
             "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                      \
             "%10, %11, %12, %13, %14, %15",                                 \
             "%16", "%17", "%18",                                            \
             "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
             "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
             "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),               \
             "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]))
#define EX_MMA_N64(TY)                                                       \
  EX_MMA_ASM("m64n64k16", TY,                                                \
             "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                      \
             "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "            \
             "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "            \
             "%30, %31",                                                     \
             "%32", "%33", "%34",                                            \
             "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
             "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
             "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),               \
             "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),             \
             "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
             "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),             \
             "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),             \
             "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]))
#define EX_MMA_N128(TY)                                                      \
  EX_MMA_ASM("m64n128k16", TY,                                               \
             "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                      \
             "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "            \
             "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "            \
             "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "            \
             "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "            \
             "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "            \
             "%60, %61, %62, %63",                                           \
             "%64", "%65", "%66",                                            \
             "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                 \
             "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
             "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),               \
             "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),             \
             "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
             "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),             \
             "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),             \
             "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),             \
             "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),             \
             "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),             \
             "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
             "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),             \
             "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),             \
             "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
             "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),             \
             "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]))

template <typename T, int N>
struct ExMma;
#define EX_MMA_SPEC(N)                                                       \
  template <>                                                                \
  struct ExMma<__nv_bfloat16, N> {                                           \
    static __device__ __forceinline__ void run(float (&d)[N / 2],            \
                                               uint64_t da, uint64_t db) {   \
      EX_MMA_N##N(bf16);                                                     \
    }                                                                        \
  };                                                                         \
  template <>                                                                \
  struct ExMma<__half, N> {                                                  \
    static __device__ __forceinline__ void run(float (&d)[N / 2],            \
                                               uint64_t da, uint64_t db) {   \
      EX_MMA_N##N(f16);                                                      \
    }                                                                        \
  };
EX_MMA_SPEC(8)
EX_MMA_SPEC(16)
EX_MMA_SPEC(32)
EX_MMA_SPEC(64)
EX_MMA_SPEC(128)

// keeps the compiler from moving accumulator reads or writes across wgmma
template <int R>
__device__ __forceinline__ void ex_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Consumers (threads 0-127): a job's nk K steps into a0 (w0's product) and,
// with MATS = 2, a1 (w1's), both sharing each landed row tile; one wgmma
// group stays in flight and a stage is released as soon as the group that
// read it retires.  Then, at accumulator i of thread (warp, lane) — weight
// column 16 warp + lane / 4 (+ 8 for i % 4 >= 2), row 8 (i / 4) + 2 (lane %
// 4) + i % 2 — the rows below `rows` are written: h = silu(a0) * a1
// (MATS = 2) or y = a0 (MATS = 1), rounded to T.
template <typename T, int N, int MATS>
__device__ inline void ex_tc_tile(const ExTcSmem& sm, ExTcPipe& pipe, int nk,
                                  T* out, long long ld, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a0[N / 2], a1[MATS == 2 ? N / 2 : 1];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    a0[i] = 0.f;
    if constexpr (MATS == 2) a1[i] = 0.f;
  }
  int held = -1;  // the stage the group in flight reads
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(sm.full(pipe.stage), pipe.phase);
    ex_fence_acc(a0);
    if constexpr (MATS == 2) ex_fence_acc(a1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t x = sm.rows(pipe.stage);
#pragma unroll
    for (int kk = 0; kk < EX_TC_BK / 16; ++kk) {
      // A: 16 K rows are 2048 bytes, 8-row groups 1024 bytes apart (one
      // 64-column box, so the leading offset is never stepped).  B: 16 K
      // columns are 32 bytes of each 128-byte row, 8-row groups 1024 apart.
      const uint64_t db = tc_desc(x + kk * 32, 16, 1024);
      ExMma<T, N>::run(a0, tc_desc(sm.w(pipe.stage, 0) + kk * 2048,
                                   EX_TC_W_BYTES, 1024), db);
      if constexpr (MATS == 2)
        ExMma<T, N>::run(a1, tc_desc(sm.w(pipe.stage, 1) + kk * 2048,
                                     EX_TC_W_BYTES, 1024), db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    ex_fence_acc(a0);
    if constexpr (MATS == 2) ex_fence_acc(a1);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (held >= 0 && lane == 0) mbar_arrive(sm.empty(held));
    held = pipe.stage;
    pipe.advance();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  ex_fence_acc(a0);
  if constexpr (MATS == 2) ex_fence_acc(a1);
  if (held >= 0 && lane == 0) mbar_arrive(sm.empty(held));
  const int m0 = 16 * warp + lane / 4, r0 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int m = m0 + 8 * ((i >> 1) & 1), r = 8 * (i >> 2) + r0 + (i & 1);
    if (r < rows) {
      float v = a0[i];
      if constexpr (MATS == 2) v = ex_silu(a0[i]) * a1[i];
      out[r * ld + m] = from_f32<T>(v);
    }
  }
}

template <typename T, int MATS>
__device__ inline void ex_tc_job(const ExTcSmem& sm, ExTcPipe& pipe, int nk,
                                 const ExTcJob<T>& j) {
  switch (j.n) {
    case 8: ex_tc_tile<T, 8, MATS>(sm, pipe, nk, j.out, j.ld, j.rows); break;
    case 16: ex_tc_tile<T, 16, MATS>(sm, pipe, nk, j.out, j.ld, j.rows); break;
    case 32: ex_tc_tile<T, 32, MATS>(sm, pipe, nk, j.out, j.ld, j.rows); break;
    case 64: ex_tc_tile<T, 64, MATS>(sm, pipe, nk, j.out, j.ld, j.rows); break;
    default: ex_tc_tile<T, 128, MATS>(sm, pipe, nk, j.out, j.ld, j.rows);
  }
}

// One pass over a work list: the items are (list entry, column tile) with
// the column tile fastest, so blocks side by side read neighbouring
// 128-byte column tiles of the same weight rows (each DRAM page opened
// serves them all) and the same row tile from L2; block b takes items b,
// b + gridDim.x, ...  All items of a pass cost the same K loop, so this
// static deal is balanced.  The producer
// thread and the consumer warpgroup walk the same items, so their (stage,
// phase) stay in step across items and passes.  job(entry, column tile)
// describes an item; MATS = 2 loads w0 and w1 (the gate/up pass).
template <typename T, int MATS, typename Job>
__device__ void ex_tc_pass(const ExTcSmem& sm, ExTcPipe& pipe,
                           const int* list, int nt, int nk,
                           const CUtensorMap* w0, const CUtensorMap* w1,
                           const CUtensorMap* rmap, const Job& job) {
  const long long L = list[0];
  const long long items = L * nt;
  if (threadIdx.x == EX_TC_CONSUMERS) {
    for (long long it = blockIdx.x; it < items; it += gridDim.x)
      ex_tc_load<T>(sm, pipe, w0, MATS == 2 ? w1 : nullptr, rmap,
                    job(list[1 + it / nt], (int)(it % nt)), nk);
  } else if (threadIdx.x < EX_TC_CONSUMERS) {
    for (long long it = blockIdx.x; it < items; it += gridDim.x)
      ex_tc_job<T, MATS>(sm, pipe, nk, job(list[1 + it / nt], (int)(it % nt)));
  }
}

// -- host side of the tensor-core route --------------------------------------

// The route rule, checked again at launch: 16-bit operands, d and f
// multiples of 64, base pointers 16-byte aligned (ex_tc_map refuses byte
// strides off 16).
static bool ex_tc_route_ok(int dtype, int d, int f,
                           std::initializer_list<const void*> ptrs) {
  if (dtype != kBF16 && dtype != kF16) return false;
  if (d < 64 || f < 64 || d % 64 != 0 || f % 64 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// A 16-bit 5-D operand (dims[0] innermost, unit stride) as a TMA map: el[i]
// is the element stride of dim i + 1.  A dim of extent 1 is never stepped,
// so it takes the packed stride instead of its own; every other byte
// stride must be a multiple of 16 (TMA's rule, part of the route's).  The
// box is (64, box1, 1, 1, 1): a weight tile (box1 = 64 K rows) or an
// 8-row box of a row tile.
static int ex_tc_map(CUtensorMap* map, const void* base, int dtype,
                     const long long (&dims)[5], const long long (&el)[4],
                     int box1) {
  long long strides[4];
  long long packed = dims[0] * 2;
  for (int i = 0; i < 4; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed : el[i] * 2;
    if (strides[i] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    packed = strides[i] * dims[i + 1];
  }
  const int box[5] = {64, box1, 1, 1, 1};
  return tc_map_nd(map, base, dtype, 5, dims, strides, box);
}

// The persistent grid of a tensor-core kernel with `smem` bytes of dynamic
// shared memory: as many blocks as the card holds at once.
template <typename Kernel>
static int ex_tc_grid(Kernel kern, int smem, int& blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      EX_TC_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  blocks = per_sm * sms;
  return 0;
}
