// The online-softmax tile routines shared by flash_attention.cu and
// ring_attention.cu (whose tensor-core products, maps and key ends
// flash_attention_bwd.cu uses too), on two routes chosen before launch by
// one rule
// (repro_torch/kernels/plan.py attention_route): the tensor cores (TMA +
// wgmma, below) for aligned f16/bf16 tiles, the CUDA cores (att_fold) for
// f32 and every shape off the rule.
//
// CUDA-core route.  A block of ATT_NT = 256 threads owns a tile of ATT_BQ = 64 query rows of
// one kv head.  The rows are (t, g) pairs, g over the G = H / KH query
// heads that share the kv head (row = t * G + g), so a decode step
// (Tq = 1) fills G rows of the tile and reads each K/V tile once for the
// whole group.  Thread (ty, tx) of the 16 x 16 layout owns rows ty + 16a
// (a < 4), score columns tx + 16j and output columns tx + 16c; a row's max
// and sum reduce over the 16 lanes of its half-warp with shuffles.  The
// running max m, denominator l and accumulator acc of a thread's rows live
// in registers, in f32; a masked score counts as -1e30 and contributes
// p = 0, so a row that sees no key keeps l = 0 and comes out as 0 (the
// denominator is clamped at 1e-30).
//
// Shared memory (f32, one column of padding against bank conflicts):
// q^T (D x 65), then per key tile of BK keys k^T (D x (BK + 1)), v (BK x Dv)
// and the probabilities (64 x (BK + 1)) — att_smem_floats() of them.
#pragma once

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

#define ATT_BQ 64
#define ATT_NT 256
#define ATT_NEG_INF (-1e30f)

__host__ __device__ inline size_t att_smem_floats(int D, int Dv, int BK) {
  return (size_t)D * (ATT_BQ + 1) + (size_t)D * (BK + 1) + (size_t)BK * Dv +
         (size_t)ATT_BQ * (BK + 1);
}

// Stage the scaled q^T of rows [i0, i0 + 64) of kv head kh; q points at
// (t = 0, h = 0) of one sequence, q_t / q_h its element strides.
template <typename T>
__device__ __forceinline__ void att_stage_q(float* smem, const T* q,
                                            long long q_t, long long q_h,
                                            int i0, int rows, int G, int kh,
                                            int D, float scale) {
  for (int e = threadIdx.x; e < ATT_BQ * D; e += ATT_NT) {
    const int i = e / D, d = e % D;
    const int row = i0 + i;
    float val = 0.f;
    if (row < rows) {
      const int t = row / G, h = kh * G + row % G;
      val = to_f32(q[t * q_t + h * q_h + d]) * scale;
    }
    smem[d * (ATT_BQ + 1) + i] = val;
  }
}

// Fold the keys [0, nkeys) of one K/V run (k and v point at its key 0 of
// kv head kh; k_t / v_t are the key strides) into the carry.  Key j sits
// at global position kpos0 + j and is visible to a row at query position
// qpos when kpos0 + j < vlen and, if causal, kpos0 + j <= qpos or both lie
// in the prefix window [0, prefix_len).  Keys at or past nkeys are staged
// as zeros and never read.  Ends with every thread past its last read of
// the staged tiles except the probability/value tiles of the last key tile.
template <typename T, int DVT>
__device__ __forceinline__ void att_fold(
    float* smem, const T* k, long long k_t, const T* v, long long v_t, int D,
    int Dv, int BK, int nkeys, int kpos0, int vlen, int causal,
    int prefix_len, const int (&qpos)[4], const bool (&rvalid)[4],
    float (&m)[4], float (&l)[4], float (&acc)[4][DVT]) {
  float* qt = smem;                            // [D][BQ + 1]   q^T, scaled
  float* kt = qt + D * (ATT_BQ + 1);           // [D][BK + 1]   k^T
  float* vs = kt + D * (BK + 1);               // [BK][Dv]
  float* ps = vs + BK * Dv;                    // [BQ][BK + 1]  probabilities
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ncol = BK / 16;                    // score columns per thread

  for (int k0 = 0; k0 < nkeys; k0 += BK) {
    __syncthreads();                           // previous tile consumed
    for (int e = tid; e < BK * D; e += ATT_NT) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      kt[d * (BK + 1) + j] = kp < nkeys ? to_f32(k[kp * k_t + d]) : 0.f;
    }
    for (int e = tid; e < BK * Dv; e += ATT_NT) {
      const int j = e / Dv, c = e % Dv;
      const int kp = k0 + j;
      vs[j * Dv + c] = kp < nkeys ? to_f32(v[kp * v_t + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qt[d * (ATT_BQ + 1) + ty + 16 * a];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = j < ncol ? kt[d * (BK + 1) + tx + 16 * j] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qa[a], kb[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bool vis[4];
      float mx = ATT_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = k0 + tx + 16 * j;
        const int kp = kpos0 + kl;
        bool ok = j < ncol && rvalid[a] && kl < nkeys && kp < vlen;
        if (causal)
          ok = ok && (kp <= qpos[a] ||
                      (kp < prefix_len && qpos[a] < prefix_len));
        vis[j] = ok;
        if (!ok) s[a][j] = ATT_NEG_INF;
        mx = fmaxf(mx, s[a][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = vis[j] ? expf(s[a][j] - m_new) : 0.f;
        sum += pj;
        if (j < ncol) ps[(ty + 16 * a) * (BK + 1) + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DVT; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DVT; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < Dv ? vs[j * Dv + col] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }
}

// The last key any row of the tile [i0, i0 + 64) may see, plus one: the
// valid length, cut at the causal frontier (widened to the prefix window).
__device__ __forceinline__ int att_key_end(int i0, int rows, int G, int qoff,
                                           int vlen, int causal,
                                           int prefix_len) {
  if (!causal) return vlen;
  const int t_first = i0 / G, t_last = (min(i0 + ATT_BQ, rows) - 1) / G;
  int frontier = qoff + t_last + 1;
  if (qoff + t_first < prefix_len) frontier = max(frontier, prefix_len);
  return min(vlen, frontier);
}

// The rows a thread owns in the tile starting at i0: their validity and
// query positions (qoff + t).
__device__ __forceinline__ void att_rows(int i0, int rows, int G, int qoff,
                                         int (&qpos)[4], bool (&rvalid)[4]) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + ty + 16 * a;
    rvalid[a] = row < rows;
    qpos[a] = qoff + (rvalid[a] ? row / G : 0);
  }
}

// -- the tensor-core route (TMA + wgmma) ---------------------------------------
//
// Taken, by one rule decided before launch (repro_torch/kernels/plan.py
// attention_route, checked again by each C entry point), for f16/bf16
// operands with D a multiple of 16 in [16, 256] (a runtime value), Dv a
// multiple of 16 in [16, 128], or 256 (the widths att_wgmma_o
// instantiates), G dividing 64, and 16-byte-aligned base pointers and row
// strides (TMA's rule).  f32 keeps the CUDA-core routine above: TF32 would
// change its results.
//
// A block is ATT_TC_THREADS threads: one consumer warpgroup that owns the
// 64 query rows of a tile (row = t * G + g, as above), and one producer warp
// one of whose threads keeps TMA loads in flight.  The tile of q is loaded
// once, as att_nbox(D) = ceil(D / 64) boxes (64 columns, G heads, 64 / G
// positions) of a 5-D map over (D, H, Tq, B, depth), so the rows land in
// the tile's row order; K and V come in tiles of ATT_TC_BK = 64 keys,
// att_nbox(D) and att_nbox(Dv) boxes (64 columns, 64 keys) of maps over (D,
// KH, Tk, B, depth), into a ring of ATT_TC_STAGES stages with full / empty
// mbarriers.  Every box is 128-byte swizzled; positions past Tq or Tk and
// columns past D or Dv read as zero (TMA's fill, counted in the box's
// bytes), so a width off 64 (stablelm-3b's D = 80: two boxes, the second 16
// columns deep) needs nothing more: S stops after D / 16 k-steps, and P v
// runs wgmma's n = Dv across the partly filled last box.  D is only a count
// of boxes and k-steps, so deepseek-v3's MLA (D = 192: three boxes, twelve
// k-steps; Dv = 128) runs the Dv = 128 instance, in 107,568 bytes.  Registers
// (ptxas, sm_90a): flash's instances 95 (Dv = 16) to 167 (128) and 225
// (256), 127 at Dv = 80; ring attention's 167 to 255; none spills.
//
// Per key tile the warpgroup runs
//   S = q k^T    wgmma m64n64k16, both operands in shared memory; k is
//                row-major (key, d), i.e. K-major, so it needs no transpose;
//   the softmax on S's accumulator fragment: a thread holds rows
//                16 warp + lane / 4 and that + 8, columns 8 j + 2 (lane % 4)
//                + {0, 1}; a row's max and sum reduce over its 4 threads;
//                the masks of att_fold above at those coordinates;
//   O += P v     wgmma m64n{Dv}k16 with P in registers (the RS form): S's
//                accumulator fragment is already A's register fragment, so
//                P never touches shared memory; v (key, Dv) is N-major and
//                read through the transpose bit, its 64-column boxes stepped
//                by the descriptor's leading byte offset.
// Deviations from the CUDA-core routine, held by the same tolerances: the
// scale multiplies S in f32 (inside the exponent's fused multiply-add)
// instead of being folded into q, the exponentials are the SFU's 2^x, and
// P is rounded to the operand type before P v (l sums the unrounded P).
// Every row sees a prefix of the keys, so the masks are one compare a
// score against the row's limit.
//
// The rows of the last tile at or past its key end (a cache's rows past
// valid_len, which may hold NaN; a stripe's keys past what the tile sees)
// are zeroed in shared memory before the products read them, since 0 x NaN
// is NaN inside wgmma: generic stores, then fence.proxy.async.shared::cta
// and a barrier of the warpgroup.
#define ATT_TC_BK 64
#define ATT_TC_STAGES 2
#define ATT_TC_THREADS 160

constexpr int ATT_TC_CONSUMERS = 128;        // one warpgroup, 64 query rows
constexpr int ATT_TC_BOX_BYTES = 64 * 128;   // one box: 64 rows of 128 bytes
static_assert(ATT_TC_THREADS == ATT_TC_CONSUMERS + 32, "one producer warp");
static_assert(ATT_BQ == 64 && ATT_TC_BK == 64, "wgmma m64 / n64 tiles");

// The 64-column boxes a width of x columns takes
__host__ __device__ constexpr int att_nbox(int x) { return (x + 63) / 64; }

// Dynamic shared memory of the route: 1024 bytes of slack for the
// swizzle's alignment, the q tile, the stages (k then v), and the full /
// empty barriers of each stage and of the q tile; every operand a whole
// number of 8192-byte boxes ((x + 63) >> 6 is att_nbox(x), written out so
// that the planner's test can evaluate the expression).
__host__ __device__ inline int att_tc_smem_bytes(int D, int Dv) {
  return 1024 + ((D + 63) >> 6) * 8192
         + ATT_TC_STAGES * (((D + 63) >> 6) + ((Dv + 63) >> 6)) * 8192
         + 8 * (2 * ATT_TC_STAGES + 2);
}

struct AttTcSmem {
  uint32_t base;  // shared-window address of the q tile, 1024-byte aligned
  int D;
  int kb, vb;     // boxes of a q or k tile (att_nbox(D)) and of v's
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const {
    return base + (kb + s * (kb + vb)) * ATT_TC_BOX_BYTES;
  }
  __device__ uint32_t v(int s) const { return k(s) + kb * ATT_TC_BOX_BYTES; }
  __device__ uint32_t bar(int i) const {
    return base + (kb + ATT_TC_STAGES * (kb + vb)) * ATT_TC_BOX_BYTES + 8 * i;
  }
  __device__ uint32_t full(int s) const { return bar(s); }
  __device__ uint32_t empty(int s) const { return bar(ATT_TC_STAGES + s); }
  __device__ uint32_t qfull() const { return bar(2 * ATT_TC_STAGES); }
  __device__ uint32_t qempty() const { return bar(2 * ATT_TC_STAGES + 1); }
};

using AttPipe = StagePipe<ATT_TC_STAGES>;

// Every thread of the block calls it once (it syncs the block).  A full
// barrier waits on the producer's arrival and its bytes, an empty one on
// the 4 consumer warps.
__device__ inline AttTcSmem att_tc_smem_init(unsigned char* raw, int D,
                                             int Dv) {
  AttTcSmem sm;
  sm.base = (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023)
            & ~1023u;
  sm.D = D;
  sm.kb = att_nbox(D);
  sm.vb = att_nbox(Dv);
  if (threadIdx.x == 0) {
    for (int s = 0; s <= ATT_TC_STAGES; ++s) {  // the stages, then q's
      const bool q = s == ATT_TC_STAGES;
      mbar_init(q ? sm.qfull() : sm.full(s), 1);
      mbar_init(q ? sm.qempty() : sm.empty(s), ATT_TC_CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  return sm;
}

// Producer: the q tile whose first position is t0 (heads h0 .. h0 + G - 1
// of batch row b at depth `depth`), once the previous tile is released.
__device__ inline void att_tc_load_q(const AttTcSmem& sm, uint32_t& qphase,
                                     const CUtensorMap* qmap, int h0, int t0,
                                     int b, int depth) {
  mbar_wait(sm.qempty(), qphase ^ 1);
  mbar_expect_tx(sm.qfull(), sm.kb * ATT_TC_BOX_BYTES);
  for (int c = 0; c < sm.kb; ++c)
    tma_load_5d(sm.q() + c * ATT_TC_BOX_BYTES, qmap, sm.qfull(), c * 64, h0,
                t0, b, depth);
  qphase ^= 1;
}

// Producer: ntiles key tiles from key k0 of kv head kh, each into the next
// stage once its consumers have released it.
__device__ inline void att_tc_load_kv(const AttTcSmem& sm, AttPipe& pipe,
                                      const CUtensorMap* kmap,
                                      const CUtensorMap* vmap, int kh, int k0,
                                      int ntiles, int b, int depth) {
  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(sm.empty(pipe.stage), pipe.phase ^ 1);
    const uint32_t full = sm.full(pipe.stage);
    mbar_expect_tx(full, (sm.kb + sm.vb) * ATT_TC_BOX_BYTES);
    const int key = k0 + i * ATT_TC_BK;
    for (int c = 0; c < sm.kb; ++c)
      tma_load_5d(sm.k(pipe.stage) + c * ATT_TC_BOX_BYTES, kmap, full,
                  c * 64, kh, key, b, depth);
    for (int c = 0; c < sm.vb; ++c)
      tma_load_5d(sm.v(pipe.stage) + c * ATT_TC_BOX_BYTES, vmap, full,
                  c * 64, kh, key, b, depth);
    pipe.advance();
  }
}

// The first of the two rows a consumer thread owns in the tile:
// 16 warp + lane / 4 (the other is 8 below it).
__device__ __forceinline__ int att_tc_row0() {
  return 16 * (threadIdx.x / 32) + threadIdx.x % 32 / 4;
}

// The two rows a consumer thread owns in the tile starting at i0: their
// validity and query positions (qoff + t).
__device__ __forceinline__ void att_tc_rows(int i0, int rows, int G, int qoff,
                                            int (&qpos)[2],
                                            bool (&rvalid)[2]) {
  const int r0 = att_tc_row0();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = i0 + r0 + 8 * h;
    rvalid[h] = row < rows;
    qpos[h] = qoff + (rvalid[h] ? row / G : 0);
  }
}

// keeps the compiler from moving register reads or writes across wgmma
template <int N>
__device__ __forceinline__ void att_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ATT_LOG2E 1.4426950408889634f

// 2^x on the SFU (ex2.approx, flush to zero: 2^-huge is 0)
__device__ __forceinline__ float att_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t att_pack(float a, float b);
template <>
__device__ __forceinline__ uint32_t att_pack<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t att_pack<__half>(float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

#define ATT_WGMMA_SS64(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31 "                                                   \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                      \
      : "+f"(d[0]),                                                           \
        "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
        "+f"(d[31])                                                           \
      : "l"(da), "l"(db), "r"(scale_d))

#define ATT_WGMMA_RS16(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7 "                                       \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS32(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15 "                                                                  \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15])                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS48(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23 "                          \
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS64(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31 "                                                   \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS80(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39 "           \
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS96(TY)                                                    \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." #TY "." #TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47 "                                    \
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS112(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n112k16.f32." #TY "." #TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55 "                                                             \
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"                        \
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
        "+f"(d[55])                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS128(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "                     \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS192(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." #TY "." #TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "     \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "     \
      "%93, %94, %95 "                                                        \
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"                       \
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
        "+f"(d[95])                                                           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define ATT_WGMMA_RS256(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                           \
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
      "%127 "                                                                 \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                   \
      : "+f"(d[0]),                                                           \
        "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),      \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),      \
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),      \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),      \
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),      \
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),      \
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),      \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),     \
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),               \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),               \
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]),               \
        "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),               \
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),               \
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),               \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d (64 x 64, f32) (+)= q (64 x 16, K-major) k^T (16 x 64, K-major)
template <typename T>
__device__ __forceinline__ void att_wgmma_s(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    ATT_WGMMA_SS64(bf16);
  } else {
    ATT_WGMMA_SS64(f16);
  }
}

// d (64 x N, f32) += A (64 x 16, registers) B (16 x N, N-major in shared
// memory, read through the transpose bit): P v here, and the gradient's
// dv, dk and dq (flash_attention_bwd.cu); N a multiple of 16 up to 128,
// 192 (the gradient's MLA instance) or 256
#define ATT_RS_CASE(W)                                                        \
  if constexpr (N == W) {                                                     \
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {                    \
      ATT_WGMMA_RS##W(bf16);                                                  \
    } else {                                                                  \
      ATT_WGMMA_RS##W(f16);                                                   \
    }                                                                         \
  }

template <typename T, int N>
__device__ __forceinline__ void att_wgmma_o(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert((N % 16 == 0 && N >= 16 && N <= 128) || N == 192 ||
                    N == 256,
                "an instance width");
  ATT_RS_CASE(16) ATT_RS_CASE(32) ATT_RS_CASE(48) ATT_RS_CASE(64)
  ATT_RS_CASE(80) ATT_RS_CASE(96) ATT_RS_CASE(112) ATT_RS_CASE(128)
  ATT_RS_CASE(192) ATT_RS_CASE(256)
}

// Consumer warpgroup: fold ntiles key tiles, whose first key has local
// index k0, into the carry (m, l, o) of the thread's two rows.  Local key
// j sits at global position kpos0 + j and is visible under att_fold's
// rule; keys at or past nkeys are zeroed in shared memory and masked.
template <typename T, int DV>
__device__ inline void att_tc_fold(const AttTcSmem& sm, AttPipe& pipe, int k0,
                                   int ntiles, int nkeys, int kpos0, int vlen,
                                   int causal, int prefix_len,
                                   const int (&qpos)[2],
                                   const bool (&rvalid)[2], float scale,
                                   float (&m)[2], float (&l)[2],
                                   float (&o)[DV / 2]) {
  const int lane = threadIdx.x % 32;
  const int ksteps = sm.D / 16;
  // Every row sees a prefix of the keys: kpos0 + j < rend[h], the valid
  // length cut at the causal frontier (qpos + 1, widened to prefix_len
  // inside the prefix window); a row past the tile sees none.  So a
  // column's mask is one compare against the row's limit in the tile.
  int rend[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int e = vlen;
    if (causal)
      e = min(e, qpos[h] < prefix_len ? max(qpos[h] + 1, prefix_len)
                                      : qpos[h] + 1);
    rend[h] = rvalid[h] ? min(e - kpos0, nkeys) : 0;
  }
  const int c0 = 2 * (lane & 3);
  const float scale2 = scale * ATT_LOG2E;  // exp(x scale) = 2^(x scale2)
  for (int i = 0; i < ntiles; ++i) {
    const int kl0 = k0 + i * ATT_TC_BK;
    const int stage = pipe.stage;
    mbar_wait(sm.full(stage), pipe.phase);
    if (kl0 + ATT_TC_BK > nkeys) {
      // rows [j0, 64) of every k and v box (k's boxes, then v's, back to
      // back) to zero; whole 128-byte rows, so the swizzle does not matter
      const int j0 = max(nkeys - kl0, 0);
      const int per_box = (ATT_TC_BK - j0) * 8;   // 16-byte chunks
      const int chunks = (sm.kb + sm.vb) * per_box;
      for (int e = threadIdx.x; e < chunks; e += ATT_TC_CONSUMERS) {
        const uint32_t addr = sm.k(stage) + (e / per_box) * ATT_TC_BOX_BYTES
                              + (j0 + (e % per_box) / 8) * 128
                              + (e % 8) * 16;
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                     "r"(0), "r"(0), "r"(0), "r"(0) : "memory");
      }
      fence_proxy_async_shared();
      asm volatile("bar.sync 1, %0;" ::"n"(ATT_TC_CONSUMERS) : "memory");
    }

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    att_fence_regs(s);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t kt = sm.k(stage);
    for (int kk = 0; kk < ksteps; ++kk) {
      // 16 columns are 32 bytes of each 128-byte row; 64-column boxes
      // ATT_TC_BOX_BYTES apart; 8-row groups 1024 bytes apart
      const uint32_t off = (kk >> 2) * ATT_TC_BOX_BYTES + (kk & 3) * 32;
      att_wgmma_s<T>(s, tc_desc(sm.q() + off, 16, 1024),
                     tc_desc(kt + off, 16, 1024), kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    att_fence_regs(s);

    // s[j]: row h = (j / 2) % 2 of the thread's two, column
    // 8 (j / 4) + 2 (lane % 4) + j % 2; a masked score is -1e30
    const int lim[2] = {rend[0] - kl0, rend[1] - kl0};
    float mx[2] = {ATT_NEG_INF, ATT_NEG_INF};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = (j >> 1) & 1;
      s[j] = 8 * (j >> 2) + c0 + (j & 1) < lim[h] ? s[j] : ATT_NEG_INF;
      mx[h] = fmaxf(mx[h], s[j]);
    }
    float alpha[2], mo[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // the running max of the scaled scores (a row that has seen no key
      // keeps -1e30)
      const float m_new =
          fmaxf(m[h], mx[h] == ATT_NEG_INF ? ATT_NEG_INF : mx[h] * scale);
      alpha[h] = att_exp2((m[h] - m_new) * ATT_LOG2E);
      m[h] = m_new;
      mo[h] = m_new == ATT_NEG_INF ? 0.f : m_new * ATT_LOG2E;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      // p = exp(s scale - m), one fused multiply-add and one exp2; a
      // masked score gives 2^(-1e30 scale2) = 0, also in a row that has
      // seen no key (mo = 0)
      s[j] = att_exp2(fmaf(s[j], scale2, -mo[(j >> 1) & 1]));
      sum[(j >> 1) & 1] += s[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
    // P as wgmma's A fragment of each 16-key step: S's accumulator layout
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = att_pack<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    att_fence_regs(o);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint32_t vt = sm.v(stage);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      // 16 keys are 16 rows (2048 bytes) of each box; 64-column boxes
      // ATT_TC_BOX_BYTES apart (leading byte offset); 8-row groups 1024
      att_wgmma_o<T, DV>(o, pa[kk],
                         tc_desc(vt + kk * 16 * 128, ATT_TC_BOX_BYTES, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    att_fence_regs(o);
    if (lane == 0) mbar_arrive(sm.empty(stage));
    pipe.advance();
  }
}

// -- host side of the tensor-core route ----------------------------------------

// The route rule, checked again at launch: 16-bit operands, D a multiple
// of 16 in [16, 256], Dv a multiple of 16 in [16, 128], or 256, G dividing
// 64, the key tile 64, and 16-byte-aligned base pointers (att_tc_map
// refuses byte strides off 16).
static bool att_tc_route_ok(int dtype, int D, int Dv, int G, int BK,
                            std::initializer_list<const void*> ptrs) {
  if (dtype != kBF16 && dtype != kF16) return false;
  if (D < 16 || D > 256 || D % 16 != 0) return false;
  if (!((Dv >= 16 && Dv <= 128 && Dv % 16 == 0) || Dv == 256)) return false;
  if (G < 1 || 64 % G != 0 || BK != ATT_TC_BK) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// A 16-bit (cols, heads, positions, B, depth) operand as a 5-D TMA map:
// el[i] is the element stride of dim i + 1.  A dim of extent 1 is never
// stepped, so it takes the packed stride instead of its own (which may be
// anything, even 0); every other byte stride must be a multiple of 16
// (TMA's rule, part of the route's).  The box is (64 columns, box_heads,
// box_pos, 1, 1).
static int att_tc_map(CUtensorMap* map, const void* base, int dtype,
                      const long long (&dims)[5], const long long (&el)[4],
                      int box_heads, int box_pos) {
  long long strides[4];
  long long packed = dims[0] * 2;
  for (int i = 0; i < 4; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed : el[i] * 2;
    if (strides[i] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    packed = strides[i] * dims[i + 1];
  }
  const int box[5] = {64, box_heads, box_pos, 1, 1};
  return tc_map_nd(map, base, dtype, 5, dims, strides, box);
}
