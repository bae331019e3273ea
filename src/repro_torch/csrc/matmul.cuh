// The GEMM tile routines shared by matmul.cu and ring_matmul.cu.
//
// Replaces the tile loop of the TPU kernel _mm_kernel
// (src/repro/kernels/ring_matmul/kernel.py:22, launched at :54): one output
// tile, K walked in steps, f32 accumulator, output cast to the input dtype,
// ragged edges handled by the kernel instead of padded.
//
// Bound on this card: operations.  (M, K) @ (K, N) does 2MNK flops on
// (MK + KN + MN) elements; at the main path's 7560 x 30240 x 7560 bf16 that
// is 3.5 ms at 989 TFLOP/s, and only the tensor cores reach that rate.  Two
// routes, chosen on the host before launch by one stated rule
// (repro_torch/kernels/plan.py gemm_route), never on a failure:
//
// * tensor cores (tc_*): bf16/f16 operands whose row pitches K and N are
//   multiples of 8 elements and whose base pointers are 16-byte aligned
//   (TMA's rule).  Persistent 2-CTA clusters, one CTA per SM, walk the
//   output tiles in pairs of (TC_BM x TC_BN) tiles side by side along M.
//   In each CTA one producer thread, in a warp of its own, keeps TMA loads
//   of (TC_BK-deep) K steps in flight into a ring of TC_STAGES shared-
//   memory stages, each signalled by an mbarrier: its own A tile, and half
//   of the pair's shared B tile multicast into both CTAs, so each CTA reads
//   32 KiB of the 48 KiB a stage holds from L2.  Two consumer warpgroups
//   (64 rows each) run wgmma.mma_async (m64n256k16) on the landed stages
//   into 128 f32 registers a thread, keep one wgmma group in flight and
//   release a stage, in both CTAs, as soon as the group that read it
//   retires; a stage is refilled once both CTAs have released it.  Both
//   operands land 128-byte swizzled.  A (row-major (M, K)) is K-major; B
//   (row-major (K, N)) is N-major and read through wgmma's transpose bit,
//   so w is neither copied nor transposed.  A swizzled box is at most 64
//   16-bit elements wide, so a B tile is TC_BN / 64 boxes side by side, and
//   B's descriptor steps from one box to the next by its leading byte
//   offset.  TMA zero-fills rows and columns past the tensor (ragged M, N
//   and K), and the epilogue stores only rows < M and columns < N.  The
//   planner mirrors the tile and stage count (TC_TILE, TC_STAGES) and
//   checks the stages against its budget.
// * CUDA cores (mm_tile): f32, and 16-bit shapes that break the rule.  TF32
//   would change f32 results and wgmma takes tf32 B only K-major.  Bound by
//   the FFMA rate (67 TFLOP/s in f32), so the tile is laid out to keep the
//   FMA pipes fed: one (MM_BM x MM_BN) = 128 x 128 tile per block, 256
//   threads each owning 8 x 8 outputs in registers, so that every k reads
//   four 16-byte fragments from shared memory for 64 FFMAs (a 4 x 4 tile a
//   thread reads two for 16).  K is walked in MM_BK = 16 steps through a ring
//   of MM_STAGES = 3 f32 stages (mm_smem_bytes(), 48.75 KiB, two blocks an
//   SM): f32 lands by 4-byte cp.async, A transposed to k-major on the way
//   (so each k reads a row of it), zero-filled past M, N and K, with the
//   next two steps' copies in flight while the FFMA loop runs; unaligned
//   16-bit operands, which cp.async cannot copy an element at a time, are
//   loaded into registers before the products and stored converted after
//   them.  Ragged M, N and K are handled in the kernel: zero fill and
//   masked stores, never padding on the host.  The planner mirrors the
//   tile, stages and padding (MM_TILE, MM_STAGES, MM_APAD, mm_smem_bytes).
//   Registers (ptxas, sm_90a): 127 for f32 and 128 for the 16-bit
//   instances, no spill, under __launch_bounds__(256, 2).
//   ring_matmul.cu's CUDA-core route runs the same tile inside its
//   cooperative grid, whose size the launch takes from the occupancy of
//   the tile's 256 threads and dynamic shared memory, so it still fits and
//   one tile serves both entry points.  The ring kernel carries its puts'
//   and its jobs' state beside the tile: held to 128 registers for two
//   blocks an SM it spilled 76 to 192 bytes, so it takes no minimum and
//   runs one block an SM.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

#define MM_BM 128
#define MM_BK 16
#define MM_BN 128
#define MM_THREADS 256
#define MM_STAGES 3
#define MM_APAD 4

#define TC_BM 128
#define TC_BK 64
#define TC_BN 256
#define TC_STAGES 4
#define TC_CLUSTER 2

// -- the CUDA-core route -----------------------------------------------------

// A stage: A's (BK, BM) tile k-major (a[k][m]), each k row followed by
// MM_APAD floats of padding, then B's (BK, BN) tile as it lies in memory
// (b[k][n]); f32 whatever T is.
constexpr int MM_A_FLOATS = MM_BK * (MM_BM + MM_APAD);
constexpr int MM_STAGE_FLOATS = MM_A_FLOATS + MM_BK * MM_BN;
static_assert(MM_THREADS == 256 && MM_BM == 128 && MM_BN == 128
              && MM_BK == 16, "the thread layout below");

// Dynamic shared memory of a CUDA-core GEMM block: MM_STAGES stages
__host__ __device__ inline int mm_smem_bytes() {
  return MM_STAGES * (MM_BK * (MM_BM + MM_APAD) + MM_BK * MM_BN) * 4;
}

// Stage K step kt of the tile into stage `st`.  Thread t copies A's
// elements (m, k) = (t / 8 + 32 i, t % 8 + 8 j), i < 4, j < 2 (a warp reads
// 4 rows x 32 bytes and its shared-memory stores, at k (BM + 4) + m, hit 32
// different banks), and B's (k, n) = (t / 128 + 2 i, t % 128), i < 8 (a warp
// reads 128 contiguous bytes).  f32 goes by 4-byte cp.async, zero-filled
// past M, N and K; 16-bit operands (unaligned, else they would take the
// tensor cores) cannot be copied 2 bytes at a time, so their loads land in
// registers (`hold`) and mm_land converts and stores them after the
// products of the current stage.
template <typename T>
__device__ __forceinline__ void mm_fetch(const T* __restrict__ A,
                                         long long lda,
                                         const T* __restrict__ B,
                                         long long ldb, int M, int N, int K,
                                         int m0, int n0, int kt, float* st,
                                         T (&hold)[16]) {
  const int t = threadIdx.x, k0 = kt * MM_BK;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = t / 8 + 32 * (i & 3), k = t % 8 + 8 * (i >> 2);
    const bool ok = m0 + m < M && k0 + k < K;
    const T* src = ok ? A + (long long)(m0 + m) * lda + k0 + k : A;
    if constexpr (std::is_same<T, float>::value)
      cp_async4(st + k * (MM_BM + MM_APAD) + m, src, ok);
    else
      hold[i] = ok ? *src : from_f32<T>(0.f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = t / 128 + 2 * i, n = t % 128;
    const bool ok = k0 + k < K && n0 + n < N;
    const T* src = ok ? B + (long long)(k0 + k) * ldb + n0 + n : B;
    if constexpr (std::is_same<T, float>::value)
      cp_async4(st + MM_A_FLOATS + k * MM_BN + n, src, ok);
    else
      hold[8 + i] = ok ? *src : from_f32<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void mm_land(float* st, const T (&hold)[16]) {
  if constexpr (!std::is_same<T, float>::value) {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      st[(t % 8 + 8 * (i >> 2)) * (MM_BM + MM_APAD) + t / 8 + 32 * (i & 3)] =
          to_f32(hold[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      st[MM_A_FLOATS + (t / 128 + 2 * i) * MM_BN + t % 128] =
          to_f32(hold[8 + i]);
  }
}

// C[m0:m0+BM, n0:n0+BN] = A[m0:, :K] @ B[:K, n0:] for row-major A (lda),
// B (ldb), C (ldc), with `smem` the block's mm_smem_bytes() of dynamic
// shared memory.  Every thread of the block must call it (it syncs).
//
// Thread t of warp w owns rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3} and
// columns tx * 4 + {0..3} and 64 + tx * 4 + {0..3}, with tx = t % 8 + 8 (w
// % 2) and ty = t % 32 / 8 + 4 (w / 2): 8 x 8 f32 accumulators.  Per k it
// reads its 8 values of A and 8 of B as four 16-byte loads (a warp's A
// loads touch 4 float4, its B loads 8: no bank conflict) and runs 64 FFMAs.
// The K loop keeps MM_STAGES - 1 steps in flight: at step kt it waits for
// stage kt, syncs once, issues step kt + MM_STAGES - 1 into the stage step
// kt - 1 used, and multiplies stage kt.
template <typename T>
__device__ void mm_tile(const T* __restrict__ A, long long lda,
                        const T* __restrict__ B, long long ldb,
                        T* __restrict__ C, long long ldc,
                        int M, int N, int K, int m0, int n0, float* smem) {
  const int t = threadIdx.x, w = t / 32;
  const int tx = t % 8 + 8 * (w % 2), ty = t % 32 / 8 + 4 * (w / 2);
  const int nk = (K + MM_BK - 1) / MM_BK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  T hold[16];

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < nk) {
      mm_fetch<T>(A, lda, B, ldb, M, N, K, m0, n0, s,
                  smem + s * MM_STAGE_FLOATS, hold);
      mm_land<T>(smem + s * MM_STAGE_FLOATS, hold);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();
    const int next = kt + MM_STAGES - 1;
    float* nst = smem + next % MM_STAGES * MM_STAGE_FLOATS;
    if (next < nk)
      mm_fetch<T>(A, lda, B, ldb, M, N, K, m0, n0, next, nst, hold);
    cp_async_commit();
    const float* as = smem + kt % MM_STAGES * MM_STAGE_FLOATS;
    const float* bs = as + MM_A_FLOATS;
#pragma unroll
    for (int k = 0; k < MM_BK; ++k) {
      const float* ar = as + k * (MM_BM + MM_APAD) + ty * 4;
      const float* br = bs + k * MM_BN + tx * 4;
      const float4 a0 = *reinterpret_cast<const float4*>(ar);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next < nk) mm_land<T>(nst, hold);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read before the block's next tile refills it

  // four contiguous columns at a time: one 16-byte store for f32 where C's
  // rows and base allow it
  const bool vec = std::is_same<T, float>::value && ldc % 4 == 0
                   && reinterpret_cast<uintptr_t>(C) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
    T* row = C + (long long)gm * ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + 64 * h + tx * 4;
      if constexpr (std::is_same<T, float>::value) {
        if (vec && gn + 3 < N) {
          *reinterpret_cast<float4*>(row + gn) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) row[gn + j] = from_f32<T>(acc[i][4 * h + j]);
    }
  }
}

// -- the tensor-core route ---------------------------------------------------

// Warpgroups 0-1 run wgmma; one more warp loads.  With 9 warps one of the
// SM's four register-file partitions holds 3, so a thread gets at most 168
// registers: room for 128 f32 accumulators and little more.
constexpr int TC_CONSUMERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + 32;
constexpr int TC_BOX = 64;                   // widest 128-byte-swizzled box
constexpr int TC_ACC = TC_BN / 2;            // f32 accumulators per thread
constexpr int TC_A_BYTES = TC_BM * TC_BK * 2;
constexpr int TC_STAGE_BYTES = TC_A_BYTES + TC_BK * TC_BN * 2;
// the stages, 1024-byte aligned for the swizzle, then full[] and empty[]
constexpr int TC_SMEM_BYTES = 1024 + TC_STAGES * TC_STAGE_BYTES
                              + 2 * TC_STAGES * 8;
constexpr int TC_GROUP_M = 16;  // tile rows walked together (L2 reuse)
static_assert(TC_CLUSTER == 2, "a cluster is one pair of M tiles");
static_assert(TC_BN % TC_BOX == 0 && TC_BK == TC_BOX, "tile vs swizzle box");
static_assert(TC_BM == 2 * 64, "one 64-row wgmma slab per consumer warpgroup");
static_assert(TC_BN == 256, "TC_WGMMA is m64n256k16");

#define TC_WGMMA(TY)                                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." #TY "." #TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "     \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "    \
      "%127"                                                                  \
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"                                    \
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),      \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),      \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),      \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),      \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),      \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),      \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),      \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),               \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),               \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),               \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),               \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),               \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),               \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                \
      : "l"(da), "l"(db), "r"(1))

// d (64 x TC_BN, f32) += A (64 x 16, K-major) @ B (16 x TC_BN, N-major)
template <typename T>
__device__ __forceinline__ void tc_wgmma(float (&d)[TC_ACC], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void tc_wgmma<__nv_bfloat16>(float (&d)[TC_ACC],
                                                        uint64_t da,
                                                        uint64_t db) {
  TC_WGMMA(bf16);
}
template <>
__device__ __forceinline__ void tc_wgmma<__half>(float (&d)[TC_ACC],
                                                 uint64_t da, uint64_t db) {
  TC_WGMMA(f16);
}

// keeps the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void tc_fence_acc(float (&d)[TC_ACC]) {
#pragma unroll
  for (int i = 0; i < TC_ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The ring of stages in dynamic shared memory, and where each role is in it.
// Producer and consumers walk the same sequence of (tile, K step) loads, so
// their (stage, phase) stay in step across tiles and, in the ring kernel,
// across its steps: no drain is needed between tiles.
struct TcSmem {
  uint32_t base;  // shared-window address of stage 0, 1024-byte aligned
  __device__ uint32_t a(int s) const { return base + s * TC_STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + TC_A_BYTES; }
  __device__ uint32_t full(int s) const {
    return base + TC_STAGES * TC_STAGE_BYTES + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(TC_STAGES + s); }
};

using TcPipe = StagePipe<TC_STAGES>;

// Every thread of the cluster calls it once (it syncs the cluster): full[s]
// waits on its producer's arrival and the stage's bytes, empty[s] on the 8
// consumer warps of both CTAs (either CTA's producer writes both stages).
__device__ inline TcSmem tc_smem_init(unsigned char* raw) {
  TcSmem sm;
  sm.base = (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023)
            & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), TC_CLUSTER * TC_CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  cluster_sync();
  return sm;
}

// Tile pair t of a (ceil(tiles_m / 2) x tiles_n) grid of pairs, walked
// TC_GROUP_M tile rows at a time so that the clusters in flight share A and
// B panels in L2; the CTA of cluster rank c takes M tile 2 (pair row) + c.
// A pair's second tile may lie past M: its loads read zeros, it stores
// nothing, and it still loads its half of the shared B tile.
__device__ __forceinline__ void tc_tile_origin(int t, int tiles_m, int tiles_n,
                                               int& m0, int& n0) {
  const int pairs_m = (tiles_m + 1) / TC_CLUSTER;
  const int gm = TC_GROUP_M / TC_CLUSTER;
  const int group = gm * tiles_n;
  const int first = (t / group) * gm;
  const int rows = min(pairs_m - first, gm);
  const int within = t % group;
  m0 = ((first + within % rows) * TC_CLUSTER + cluster_rank()) * TC_BM;
  n0 = (within / rows) * TC_BN;
}

__device__ __forceinline__ int tc_pairs(int tiles_m, int tiles_n) {
  return (tiles_m + 1) / TC_CLUSTER * tiles_n;
}

// Producer (one thread of each CTA of the pair): the nk K steps of the tile
// at (m0, n0).  A is box (K, rows) of depth az of its map, loaded for this
// CTA; the B tile, TC_BN / TC_BOX boxes (columns, K) of depth bz of its
// map, is the pair's: each CTA loads half of its boxes into both CTAs.  A
// stage is refilled only once both CTAs' consumers have released it.
__device__ inline void tc_load_tile(const TcSmem& sm, TcPipe& pipe,
                                    const CUtensorMap* amap, int az,
                                    const CUtensorMap* bmap, int bz, int m0,
                                    int n0, int nk) {
  constexpr int half = TC_BN / TC_BOX / TC_CLUSTER;
  const int first = cluster_rank() * half;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(sm.empty(pipe.stage), pipe.phase ^ 1);
    const uint32_t full = sm.full(pipe.stage);
    mbar_expect_tx(full, TC_STAGE_BYTES);
    const int k0 = kb * TC_BK;
    tma_load_3d(sm.a(pipe.stage), amap, full, k0, m0, az);
#pragma unroll
    for (int j = first; j < first + half; ++j)
      tma_load_3d_multicast(sm.b(pipe.stage) + j * TC_BK * TC_BOX * 2, bmap,
                            full, n0 + j * TC_BOX, k0, bz,
                            (1u << TC_CLUSTER) - 1);
    pipe.advance();
  }
}

// Consumers (threads 0-255): the tile's nk K steps, then C[0:rows, 0:cols]
// (C at the tile's origin, pitch ldc) from the f32 accumulators.  Warpgroup
// g owns tile rows 64g..64g+63.
template <typename T>
__device__ inline void tc_mma_tile(const TcSmem& sm, TcPipe& pipe, int nk,
                                   T* C, long long ldc, int rows, int cols) {
  const int g = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  float d[TC_ACC];
#pragma unroll
  for (int i = 0; i < TC_ACC; ++i) d[i] = 0.f;
  int held = -1;  // the stage the group in flight reads
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(sm.full(pipe.stage), pipe.phase);
    tc_fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t a = sm.a(pipe.stage) + g * 64 * TC_BK * 2;
    const uint32_t b = sm.b(pipe.stage);
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      // A: 16 K-columns are 32 bytes of each 128-byte row; 8-row groups
      // 1024 bytes apart.  B: 16 K-rows are 2048 bytes; 8-row groups 1024
      // bytes apart, 64-column boxes TC_BK * 128 bytes apart.
      tc_wgmma<T>(d, tc_desc(a + kk * 32, 16, 1024),
                  tc_desc(b + kk * 16 * TC_BOX * 2, TC_BK * TC_BOX * 2, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    tc_fence_acc(d);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (held >= 0 && lane < TC_CLUSTER)
      mbar_arrive_cluster(sm.empty(held), lane);
    held = pipe.stage;
    pipe.advance();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  tc_fence_acc(d);
  if (lane < TC_CLUSTER) mbar_arrive_cluster(sm.empty(held), lane);
  // accumulator i of thread (warp, lane): row 16 warp + lane / 4 (+ 8 for
  // i % 4 >= 2), columns 8 (i / 4) + 2 (lane % 4) + {0, 1}
  const int r0 = g * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int c = j * 8 + (lane % 4) * 2;  // cols is a multiple of 8
    if (c < cols) {
      if (r0 < rows) store2(C + r0 * ldc + c, d[4 * j], d[4 * j + 1]);
      if (r0 + 8 < rows)
        store2(C + (r0 + 8) * ldc + c, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// -- host side of the tensor-core route --------------------------------------

// The row-major 16-bit tensor (depth, rows, cols) at base as a TMA map whose
// box is (one deep, box_rows, TC_BOX columns), 128-byte swizzled; elements
// past any edge read as zero, so a box never reaches into the next depth.
static int tc_map(CUtensorMap* map, const void* base, int dtype,
                  long long depth, long long rows, long long cols,
                  int box_rows) {
  const long long dims[3] = {cols, rows, depth};
  const long long strides[2] = {cols * 2, rows * cols * 2};
  const int box[3] = {TC_BOX, box_rows, 1};
  return tc_map_nd(map, base, dtype, 3, dims, strides, box);
}

// The route rule, checked again at launch: 16-bit operands, pitches K and N
// multiples of 8 elements, base pointers 16-byte aligned.
static bool tc_route_ok(int dtype, long long K, long long N,
                        std::initializer_list<const void*> ptrs) {
  if (dtype != kBF16 && dtype != kF16) return false;
  if (K % 8 != 0 || N % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// A launch of a tensor-core kernel: TC_THREADS threads and TC_SMEM_BYTES of
// dynamic shared memory a CTA, clusters of TC_CLUSTER CTAs, cooperative
// where the kernel syncs its grid.  size() sets the grid to as many
// clusters as the card holds at once (at most max_clusters): one CTA an SM.
struct TcLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  const void* kernel;
  template <typename Kernel>
  TcLaunch(Kernel k, cudaStream_t stream, bool cooperative)
      : kernel(reinterpret_cast<const void*>(k)) {
    cfg.gridDim = dim3(TC_CLUSTER);
    cfg.blockDim = dim3(TC_THREADS);
    cfg.dynamicSmemBytes = TC_SMEM_BYTES;
    cfg.stream = stream;
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = TC_CLUSTER;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = cooperative ? 2 : 1;
  }
  int size(long long max_clusters = 1LL << 62) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_BYTES);
    int clusters = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (clusters > max_clusters) clusters = static_cast<int>(max_clusters);
    cfg.gridDim = dim3(clusters * TC_CLUSTER);
    return 0;
  }
};
