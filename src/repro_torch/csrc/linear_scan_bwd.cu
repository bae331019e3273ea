// linear_scan_bwd: the gradient of the linear scan of csrc/linear_scan.cu,
//   S_t = S_{t-1} * diag(a_t) + p_t ⊗ q_t,      y_t = S_{t-1 or t} r_t,
// given dy (BH, T, M) and the cotangent ds_fin (BH, M, N) of the final state
// (or null for zeros): dp (BH, T, M), dq / dr (BH, T, N), ds0 (BH, M, N) and
// dla (BH, T, N), the gradient with respect to log a of the function the
// forward kernel computes (it takes log max(a, 1e-38)): a * da where
// a >= 1e-38, 0 below, so no da / a is ever formed.  All f32.
//
// Replaces no TPU kernel: the reference differentiates its sequential oracle
// linear_scan_ref (src/repro/kernels/linear_scan/ref.py:23) under AD, the
// gradient of linear_scan_pallas (src/repro/kernels/linear_scan/kernel.py:104).
// It is row 11 of the port's kernel table.
//
// With G the cotangent of the state after row t (ds_fin after the last row),
// going backward G <- G diag(a_t) + dy_t r_tᵀ (the readout term entering G
// before the decay under post-readout, after it under readout_pre); then
// dp_t = G q_t, dq_t = Gᵀ p_t, dr_t = S_{t-1 or t}ᵀ dy_t, ds0 the last G and
// dla_t = a_t Σ_m G ⊙ S_{t-1}.  dla is formed from that product's terms,
// each of which carries a_t's factor: never as the identity's suffix sum
// Σ_{u >= t} (r_u ⊙ dr_u − q_u ⊙ dq_u), whose terms cancel where the decays
// are strong (its error is then a share of dr and dq, not of dla: 4e-4 of
// dla at a = e^-8, every digit at a = 1e-13).
//
// One block of BWD_THREADS a sequence, in two passes over chunks of BWD_C
// rows.  Pass 1 walks the chunks forward and writes each chunk's starting
// state to the caller's scratch (BH, chunks, 64, 64).  Pass 2 walks them in
// reverse with the carried cotangent K (the G after the chunk's last row).
// With L the inclusive prefix of log max(a, 1e-38) over the chunk, Lr_u =
// L_{u-1} (0 at u = 0) under readout_pre or L_u, ρ(u) = u - 1 or u the row
// whose state row u reads, (u, s) visible when s <= ρ(u), and E[u, s] =
// exp(Lr_u − L_s) per channel:
//   P[u, s] = dy_u · p_s             A[u, s] = Σ_n r_u q_s E
//   dp_s    = Σ_u A[u, s] dy_u + K (q_s ⊙ exp(L_end − L_s))
//   dr_u    = exp(Lr_u) ⊙ (S_startᵀ dy_u) + Σ_s P[u, s] q_s ⊙ E[u, s]
//   dq_s    = exp(L_end − L_s) ⊙ (Kᵀ p_s) + Σ_u P[u, s] r_u ⊙ E[u, s]
//   dla_t   = exp(L_end) ⊙ Σ_m K ⊙ S_start + Σ_{s < t} q_s ⊙ dqK_s
//             + Σ_{ρ(u) >= t} r_u ⊙ drS_u + Σ_{s < t <= ρ(u)} P[u, s] r_u q_s E
//   K      <- K diag(exp(L_end)) + Σ_u dy_u ⊗ (r_u ⊙ exp(Lr_u))
// with dqK and drS the K and S_start terms of dq and dr.
//
// The chunk is factored as the forward's prefill route factors it (Yang et
// al., Gated Linear Attention, 2023): sub-chunks of BWD_SUB rows, per-pair
// exponentials only on the two diagonal sub-blocks; off them, for u in
// sub-chunk 1 and s in sub-chunk 0,
//   E[u, s] = exp(Lr_u − L_15) exp(L_15 − L_s),  R~_u = r_u exp(Lr_u − L_15),
//   Q~_s = q_s exp(L_15 − L_s)
// (the forward's D = exp(L_b − L_e) is 1 between neighbouring sub-chunks),
// so A's off block is R~ Q~ᵀ and the pair terms of dr and dq there are
// exp(Lr_u − L_15) ⊙ (P Q~) and exp(L_15 − L_s) ⊙ (Pᵀ R~).  dla's straddling
// sum splits the same way: the pairs of a diagonal block per pair (for each
// s a suffix over u, so every term is added, none subtracted); the pairs
// across the two blocks as a prefix, over sub-chunk 0's rows, of q ⊙ (dq's
// off-block term) and a suffix, over sub-chunk 1's rows, of r ⊙ (dr's).
// Every exponent is a difference of prefix log-decays that is <= 0.  Every
// sum runs in a fixed order and nothing is atomic, so two runs on equal
// inputs give equal bits.  f32 on the CUDA cores: TF32 would change the
// results.
//
// Layout.  Widths are padded to 64 (zero rows and columns, log a = 0, which
// add nothing), as is a ragged last chunk (p = q = r = dy = 0, a = 1).  One
// block of BWD_THREADS, four warp groups of 128 (WG0–WG3), takes a sequence.
// Each chunk's rows p, dy, q, a, r land in one of two buffer sets while the
// chunk before it computes (in pass 2 the chunk before in time, and the
// state that chunk starts from), issued in three parts after three of that
// chunk's barriers: with 16-byte-aligned operands and widths a multiple of
// 4 by TMA from one thread (a 68 x 32 box an array lands in the padded
// rows, zeros past T and past M or N; an mbarrier a set), else by 4-byte
// cp.async from every thread (16-byte cp.async in TMA's place measured
// 8-10 % slower on an H100: chip_split.py --scan-bwd).  L is a shuffle scan, a warp a channel (lane
// = row), a warp's four channels interleaved.  Every dense product is a
// register tile (tile_mm: 4 x 4, 4 x 2 or 2 x 4 accumulators a thread) fed
// by 16-byte shared loads, the operands read k-major or along k as each
// product's layout gives them, rows strided by 8 where read along k so that
// a warp's loads fall in distinct banks.  Pass 2's five barriers a chunk
// split it into steps:
//   1. L (and the rows with a < 1e-38, a ballot a channel);
//   2. q exp(L_end − L), r exp(Lr), Q~ and R~, a float4 a thread;
//   3. dp's K term (WG0), drS (WG1), dqK and Σ K ⊙ S_start (WG2), P (WG3);
//      then A's entries: the off block's R~ Q~ᵀ one a thread of WG1 and
//      WG2, the diagonal blocks' pairs, their exponentials per channel, one
//      a thread of WG0 and WG3;
//   4. dp's A term, dp written (WG0); K's update (WG0, WG1); dr's and dq's
//      off-block terms (WG1); the diagonal blocks' pair terms of dr, dq and
//      dla (WG2, WG3: a thread a sub-chunk, channel and half of the s rows,
//      its pair exponentials in registers, the halves summed in shared
//      memory behind a barrier of those two groups alone); the state the
//      next chunk starts from, by TMA;
//   5. dla (WG2), dr and dq (WG3) summed and written.
// Pass 1 runs the state's update on the same tiles (2 x 4, all 512 threads).
//
// Bound on this card: at the training shape (BH 256, T 1024, M = N = 64)
// the function reads p, q, a, r, dy (0.34 GB) and writes dp, dq, dla, dr
// (0.27 GB): 0.18 ms at HBM rate; its products, counted per visible pair of
// 16-row chunks (the least of the chunked forms; 13.8 GFLOP under
// readout_pre), take 0.21 ms at the f32 rate: operations.  This design's
// own count is 7–9 % above that (P and A over whole 32 x 32 blocks, the
// state pass, the pair terms at 64 channels), its exponentials run on the
// special-function units beside it, and the shared-memory loads of its
// dense products are at most one 128-byte wavefront per four warp FFMAs.
// What keeps it above that bound is not measured unit by unit; the
// working hypothesis is issue and latency at one block an SM (16 warps,
// four to a scheduler, the products' tiles waiting on their loads between
// barriers, the steps' warp groups finishing apart).
// Shared memory: scan_bwd_smem_bytes(), 204,048 bytes, so BWD_BLOCKS_PER_SM
// (one) block an SM; 256 sequences are two waves on 132 SMs.
#include <cstdint>

#include "hopper.cuh"

#define BWD_C 32              // rows of a chunk
#define BWD_SUB 16            // rows of a sub-chunk
#define BWD_DMAX 64           // largest M and N (and the padded width)
#define BWD_THREADS 512       // four warp groups of 128
#define BWD_BLOCKS_PER_SM 1
#define BWD_SPLIT 5           // the diagonal pass's s rows: [0, 5) and [5, 16)
#define BWD_TINY 1e-38f
#define BWD_RS (BWD_DMAX + 4) // row stride of a 64-wide array
#define BWD_PS (BWD_C + 4)    // row stride of a 32-wide array

struct ScanBwdParams {
  const float* p;
  const float* q;
  const float* a;
  const float* r;
  const float* s0;      // (BH, M, N) or null for zeros
  const float* dy;      // (BH, T, M)
  const float* ds_fin;  // (BH, M, N) or null for zeros
  float* dp;            // (BH, T, M)
  float* dq;            // (BH, T, N)
  float* dla;           // (BH, T, N)
  float* dr;            // (BH, T, N)
  float* ds0;           // (BH, M, N)
  float* states;        // scratch (BH, chunks, 64, 64)
  int T, M, N, vec;
};

// With vec, TMA maps of p, dy, q, a, r (3-D: width, T, BH; a box of BWD_RS x
// BWD_C x 1, so a chunk lands in its padded rows with zeros past T and past
// M or N) and of the chunk states (64, 64, BH x chunks; box BWD_RS x 64 x 1)
struct ScanBwdMaps {
  CUtensorMap op[5];
  CUtensorMap states;
};

// floats of dynamic shared memory: two buffer sets of five staged arrays,
// then q exp(L_end − L), r exp(Lr), Q~/R~ and dr's and dq's dense terms (a
// chunk's rows each, BWD_RS apart); the starting state and K (BWD_DMAX rows);
// P and A transposed (BWD_PS apart); the diagonal pass's exchanged dr, dla
// and dq (BWD_DMAX apart); Σ K ⊙ S_start's two halves, the sixteen partial
// column sums of r ⊙ drS and q ⊙ dqK, and the a < 1e-38 masks (BWD_DMAX
// each); the two buffer sets' mbarriers (4 floats)
__host__ __device__ inline int scan_bwd_smem_bytes() {
  return 4 * (15 * BWD_C * BWD_RS + 2 * BWD_DMAX * BWD_RS + 2 * BWD_C * BWD_PS
              + 3 * BWD_C * BWD_DMAX + 19 * BWD_DMAX + 4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// exp(a - b) lane by lane (every caller's a - b is <= 0)
__device__ __forceinline__ float4 expd4(float4 a, float4 b) {
  return make_float4(__expf(a.x - b.x), __expf(a.y - b.y), __expf(a.z - b.z),
                     __expf(a.w - b.w));
}

// acc += a * b lane by lane
__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

// mbar_wait with a bound: a phase that has not completed after 2^30 polls
// (seconds) traps, so a copy that never lands ends the launch with an error
// instead of holding the card
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar,
                                                  uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n >> 30) __trap();
  }
}

// The k-th pair of a lower triangle in row order: (t, s) with s < t
// (strict: (1,0), (2,0), (2,1), ...) or s <= t ((0,0), (1,0), (1,1), ...).
__device__ __forceinline__ void tri_pair(int k, bool strict, int& t, int& s) {
  int tt = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  while ((tt + 1) * (tt + 2) / 2 <= k) ++tt;
  while (tt * (tt + 1) / 2 > k) --tt;
  s = k - tt * (tt + 1) / 2;
  t = strict ? tt + 1 : tt;
}

// v[i][kk] = X(r0 + STEP i, k + kk) for i < TN, kk < 4: X k-major (X[k ld +
// r], one 16- or 8-byte load a k where the TN rows are adjacent) or read
// along k (X[r ld + k], one 16-byte load a row).
template <int TN, bool KMAJ, int STEP>
__device__ __forceinline__ void ld_frag(float (&v)[TN][4], const float* X,
                                        int ld, int r0, int k) {
  if constexpr (!KMAJ) {
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const float4 w = ld4(X + (r0 + STEP * i) * ld + k);
      v[i][0] = w.x;
      v[i][1] = w.y;
      v[i][2] = w.z;
      v[i][3] = w.w;
    }
  } else if constexpr (STEP == 1 && TN == 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = ld4(X + (k + kk) * ld + r0);
      v[0][kk] = w.x;
      v[1][kk] = w.y;
      v[2][kk] = w.z;
      v[3][kk] = w.w;
    }
  } else if constexpr (STEP == 1 && TN == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 w =
          *reinterpret_cast<const float2*>(X + (k + kk) * ld + r0);
      v[0][kk] = w.x;
      v[1][kk] = w.y;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < TN; ++i) v[i][kk] = X[(k + kk) * ld + r0 + STEP * i];
  }
}

// A register tile: acc[i][j] += Σ_{k0 <= k < k1} X(r0 + RSTEP i, k) Y(k, c0 +
// CSTEP j), k1 - k0 a multiple of 4; X read k-major when XK, else along k; Y
// k-major (Y[k ldy + c]) when YK, else along k (Y[c ldy + k]).  The sum over
// k runs in order, the same for every element.
template <int TR, int TC, bool XK, bool YK, int RSTEP, int CSTEP>
__device__ __forceinline__ void tile_mm(float (&acc)[TR][TC], const float* X,
                                        int ldx, const float* Y, int ldy,
                                        int r0, int c0, int k0, int k1) {
#pragma unroll 1
  for (int k = k0; k < k1; k += 4) {
    float x[TR][4], y[TC][4];
    ld_frag<TR, XK, RSTEP>(x, X, ldx, r0, k);
    ld_frag<TC, YK, CSTEP>(y, Y, ldy, c0, k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j)
          acc[i][j] = fmaf(x[i][kk], y[j][kk], acc[i][j]);
  }
}

// The pairs (u, s) of a diagonal sub-block with s in [S0, S1), for one
// channel: Lv[i] = L at the block's row i - 1 (Lv[0] the row before it), rr
// the block's r, Pb its P (BWD_PS apart), qcol its q (BWD_RS apart).  Adds
// the pair terms of dr, writes those of dq (dqcol, BWD_DMAX apart) and adds
// the straddling pairs of dla: for each s the suffix over u of P r q E,
// added at t = ρ(u) while t > s.
template <bool PRE, int S0, int S1>
__device__ __forceinline__ void diag_pairs(
    const float* Pb, const float* qcol, const float (&Lv)[BWD_SUB + 1],
    const float (&rr)[BWD_SUB], float (&dr)[BWD_SUB], float (&dla)[BWD_SUB],
    float* dqcol) {
#pragma unroll
  for (int s = S0; s < S1; ++s) {
    const float qs = qcol[s * BWD_RS], ls = Lv[s + 1];
    float col = 0.f, dqs = 0.f;
#pragma unroll
    for (int u = BWD_SUB - 1; u >= (PRE ? s + 1 : s); --u) {
      const float pe = Pb[u * BWD_PS + s] * __expf((PRE ? Lv[u] : Lv[u + 1]) - ls);
      dr[u] = fmaf(pe, qs, dr[u]);
      const float t1 = pe * rr[u];
      dqs += t1;
      const int t = PRE ? u - 1 : u;
      if (t > s) {
        col = fmaf(t1, qs, col);
        dla[t] += col;
      }
    }
    dqcol[s * BWD_DMAX] = dqs;
  }
}

template <bool PRE>
__global__ void __launch_bounds__(BWD_THREADS, BWD_BLOCKS_PER_SM)
scan_bwd_kernel(ScanBwdParams prm, const __grid_constant__ ScanBwdMaps maps) {
  constexpr int C = BWD_C, SUB = BWD_SUB, D = BWD_DMAX, RS = BWD_RS,
                PS = BWD_PS, NT = BWD_THREADS;
  constexpr int ARR = C * RS;   // one staged array
  constexpr int SET = 5 * ARR;  // p, dy, q, a (then L), r
  constexpr int ALL = 31, PQA = 13;  // stage()'s arrays: all five; p, q, a
  constexpr int PART1 = 3, PART2 = 20, PART3 = 8;  // p, dy; q, r; a
  extern __shared__ __align__(128) float smem[];
  float* Ss = smem + 2 * SET;   // [D][RS] the chunk's starting state
  float* Ks = Ss + D * RS;      // [D][RS] K
  float* Pm = Ks + D * RS;      // [C][PS] P[u][s], 0 where not visible
  float* At = Pm + C * PS;      // [C][PS] A transposed: At[s][u]
  float* QH = At + C * PS;      // [C][RS] q exp(L_end - L)
  float* RH = QH + ARR;         // r exp(Lr)
  float* Tt = RH + ARR;         // rows < SUB: Q~, rows >= SUB: R~
  float* DR = Tt + ARR;         // dr's S_start and off-block terms
  float* DQ = DR + ARR;         // dq's K and off-block terms
  float* Xdr = DQ + ARR;        // [C][D] the diagonal blocks' pair terms: dr
  float* Xdla = Xdr + C * D;    // dla
  float* Xdq = Xdla + C * D;    // dq
  float* KSp = Xdq + C * D;     // [2][D] Σ_m K ⊙ S_start over halves of m
  float* SGr = KSp + 2 * D;     // [8][D] Σ_{u >= SUB} r ⊙ drS by row group
  float* SGq = SGr + 8 * D;     // [8][D] Σ_{s < SUB} q ⊙ dqK by row group
  unsigned* tmask = reinterpret_cast<unsigned*>(SGq + 8 * D);  // [D]
  // the buffer sets' mbarriers (with vec), 8 bytes apart
  const uint32_t bars =
      static_cast<uint32_t>(__cvta_generic_to_shared(tmask + D));

  const int T = prm.T, M = prm.M, N = prm.N;
  const bool vec = prm.vec;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, j = tid & 127, rg = j >> 4, cg = j & 15;
  const long long bh = blockIdx.x;
  const int nc = (T + C - 1) / C;
  // this sequence's chunk states (the operands' bases are formed where they
  // are read, from the parameters, so that no register holds them)
  float* states = prm.states + bh * nc * D * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // the rows of chunk `c` into buffer set `set`, the arrays whose bits
  // `arrays` sets (p 1, dy 2, q 4, a 8, r 16); rows past T and columns past
  // M or N land as zeros.  With vec one thread issues a TMA box an array on
  // the set's mbarrier, the phase's whole byte count (`tx`, on the first
  // part) armed with its one arrival; else every thread issues 4-byte
  // cp.async copies.  A chunk is staged in three parts, each after a
  // barrier of the chunk before it, so that no step waits on all of it.
  auto stage = [&](int set, int c, int arrays, uint32_t tx) {
    float* B = smem + set * SET;
    if (vec) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * set;
        if (tx) mbar_expect_tx(bar, tx);
#pragma unroll
        for (int o = 0; o < 5; ++o)
          if (arrays >> o & 1)
            tma_load_3d(static_cast<uint32_t>(
                            __cvta_generic_to_shared(B + o * ARR)),
                        &maps.op[o], bar, 0, c * C, static_cast<int>(bh));
      }
      return;
    }
    const int c0 = c * C, rows = min(C, T - c0);
#pragma unroll
    for (int o = 0; o < 5; ++o) {
      if (!(arrays >> o & 1)) continue;
      const int W = o < 2 ? M : N;
      const float* src = (o == 0 ? prm.p : o == 1 ? prm.dy : o == 2 ? prm.q
                          : o == 3 ? prm.a : prm.r) + bh * T * W;
      float* dst = B + o * ARR;
      for (int i = tid; i < C * D; i += NT) {
        const int t = i >> 6, col = i & 63;
        const bool ok = t < rows && col < W;
        cp_async4(dst + t * RS + col,
                  ok ? src + (long long)(c0 + t) * W + col : src, ok);
      }
    }
    cp_async_commit();
  };
  // the bytes of a phase: the staged arrays' boxes, and the state's
  auto tx_of = [](int arrays, bool state) {
    return static_cast<uint32_t>(4 * (__popc(arrays) * ARR
                                      + (state ? D * RS : 0)));
  };
  // every copy into buffer set `set` landed (parity bit `set` of ph flips)
  uint32_t ph = 0;
  auto landed = [&](int set) {
    if (vec) {
      mbar_wait_bounded(bars + 8 * set, ph >> set & 1);
      ph ^= 1u << set;
    } else {
      cp_async_wait_all();
    }
  };
  // L in place of a: log max(a, 1e-38) summed down the chunk's rows, a warp
  // a channel (lane = row), a warp's four channels interleaved; padded rows
  // and columns read log 1 = 0.  With `mask`, the rows where a < 1e-38 (dla
  // is 0 there) as a bit mask.
  auto scan_log = [&](float* La, int rows, bool mask) {
    constexpr int NW = NT / 32, PER = D / NW;
    float v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = warp + NW * i;
      const float av = La[lane * RS + n];
      const bool live = lane < rows && n < N;
      v[i] = live ? logf(fmaxf(av, BWD_TINY)) : 0.f;
      if (mask) {
        const unsigned b = __ballot_sync(0xffffffffu, live && av < BWD_TINY);
        if (lane == 0) tmask[n] = b;
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float u = __shfl_up_sync(0xffffffffu, v[i], o);
        if (lane >= o) v[i] += u;
      }
#pragma unroll
    for (int i = 0; i < PER; ++i) La[lane * RS + warp + NW * i] = v[i];
  };

  if (vec && tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    fence_mbar_init();
  }
  for (int i = tid; i < C * PS; i += NT) At[i] = 0.f;  // 0 where not visible
  for (int i = tid; i < D * D; i += NT) {
    const int m = i >> 6, n = i & 63;
    Ks[m * RS + n] = (prm.ds_fin && m < M && n < N)
                         ? prm.ds_fin[(bh * M + m) * N + n] : 0.f;
  }

  // -- pass 1: each chunk's starting state, forward; thread (warp, lane)
  //    holds S[sm0 + i][sn0 + jj], i < 2, jj < 4 ------------------------------
  const int sm0 = 16 * (warp & 3) + 2 * (lane & 7);
  const int sn0 = 16 * (warp >> 2) + 4 * (lane >> 3);
  {
    float S1[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int m = sm0 + i, n = sn0 + jj;
        S1[i][jj] = (prm.s0 && m < M && n < N)
                        ? prm.s0[(bh * M + m) * N + n] : 0.f;
      }
    __syncthreads();  // the mbarriers initialised
    stage(0, 0, nc == 1 ? ALL : PQA, tx_of(nc == 1 ? ALL : PQA, false));
    for (int c = 0;; ++c) {
      // the next chunk's arrays: p, q and a, or all five for pass 2's first
      const int next = c + 1 == nc - 1 ? ALL : PQA;
      float* dst = c == nc - 1 ? Ss : states + (long long)c * D * D;
      const int ld = c == nc - 1 ? RS : D;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        st4(dst + (sm0 + i) * ld + sn0,
            make_float4(S1[i][0], S1[i][1], S1[i][2], S1[i][3]));
      if (c == nc - 1) {  // pass 2 starts from the last chunk's state
        fence_proxy_async_shared();  // before TMA writes over Ss
        break;
      }
      fence_proxy_async_global();  // before TMA reads the state back
      landed(c & 1);
      __syncthreads();  // chunk c landed
      stage((c + 1) & 1, c + 1, next & PART1, tx_of(next, false));
      float* B = smem + (c & 1) * SET;
      scan_log(B + 3 * ARR, C, false);
      fence_proxy_async_shared();  // L written where TMA writes later
      __syncthreads();
      stage((c + 1) & 1, c + 1, next & PART2, 0);
      {
        const int t = tid >> 4, n = 4 * (tid & 15);
        const float* L = B + 3 * ARR;
        st4(QH + t * RS + n, mul4(ld4(B + 2 * ARR + t * RS + n),
                                  expd4(ld4(L + (C - 1) * RS + n),
                                        ld4(L + t * RS + n))));
      }
      __syncthreads();
      stage((c + 1) & 1, c + 1, next & PART3, 0);
      // S <- S exp(L_end) + pᵀ (q exp(L_end - L))
      const float4 dec = expd4(ld4(B + 3 * ARR + (C - 1) * RS + sn0), zero4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        S1[i][0] *= dec.x;
        S1[i][1] *= dec.y;
        S1[i][2] *= dec.z;
        S1[i][3] *= dec.w;
      }
      tile_mm<2, 4, true, true, 1, 1>(S1, B, RS, QH, RS, sm0, sn0, 0, C);
    }
  }

  // -- pass 2: the chunks in reverse ------------------------------------------
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * C, rows = min(C, T - c0);
    float dpv[4][4];  // WG0: dp's tile, rows rg + 8 i, columns cg + 16 jj
    landed(c & 1);
    __syncthreads();  // (1) chunk c and its starting state landed
    if (c > 0) stage((c - 1) & 1, c - 1, PART1, tx_of(ALL, true));
    float* B = smem + (c & 1) * SET;
    const float* Pp = B;
    const float* Py = B + ARR;
    const float* Pq = B + 2 * ARR;
    float* L = B + 3 * ARR;
    const float* Pr = B + 4 * ARR;

    // -- 1. L -----------------------------------------------------------------
    scan_log(L, rows, true);
    fence_proxy_async_shared();
    __syncthreads();  // (2)
    if (c > 0) stage((c - 1) & 1, c - 1, PART2, 0);

    // -- 2. q exp(L_end - L), r exp(Lr), Q~ (rows < SUB), R~ (rows >= SUB) ----
    {
      const int t = tid >> 4, n = 4 * (tid & 15);
      const float4 lt = ld4(L + t * RS + n);
      const float4 lr = !PRE ? lt : t > 0 ? ld4(L + (t - 1) * RS + n) : zero4;
      const float4 l15 = ld4(L + (SUB - 1) * RS + n);
      const float4 qv = ld4(Pq + t * RS + n), rv = ld4(Pr + t * RS + n);
      st4(QH + t * RS + n, mul4(qv, expd4(ld4(L + (C - 1) * RS + n), lt)));
      st4(RH + t * RS + n, mul4(rv, expd4(lr, zero4)));
      st4(Tt + t * RS + n, t < SUB ? mul4(qv, expd4(l15, lt))
                                   : mul4(rv, expd4(lr, l15)));
    }
    __syncthreads();  // (3)
    if (c > 0) stage((c - 1) & 1, c - 1, PART3, 0);

    // -- 3. the products that read K and S_start, P, then A -------------------
    if (wg == 0) {  // dp's K term: (q exp(L_end - L)) Kᵀ
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dpv[i][jj] = 0.f;
      tile_mm<4, 4, false, false, 8, 16>(dpv, QH, RS, Ks, RS, rg, cg, 0, D);
    } else if (wg < 3) {  // drS = exp(Lr) ⊙ (dy S) (WG1), dqK (WG2)
      const bool is_dr = wg == 1;
      float acc[4][4] = {};
      tile_mm<4, 4, false, true, 8, 1>(acc, is_dr ? Py : Pp, RS,
                                       is_dr ? Ss : Ks, RS, rg, 4 * cg, 0, D);
      float4 part = zero4;  // this thread's rows of σr (rows >= SUB) or σq
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg + 8 * i;
        const float4 lt = ld4(L + t * RS + 4 * cg);
        const float4 ex =
            is_dr ? expd4(!PRE ? lt : t > 0 ? ld4(L + (t - 1) * RS + 4 * cg)
                                            : zero4, zero4)
                  : expd4(ld4(L + (C - 1) * RS + 4 * cg), lt);
        const float4 v =
            mul4(make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]), ex);
        st4((is_dr ? DR : DQ) + t * RS + 4 * cg, v);
        if (is_dr ? i >= 2 : i < 2)
          fma4(part, v, ld4((is_dr ? Pr : Pq) + t * RS + 4 * cg));
      }
      st4((is_dr ? SGr : SGq) + rg * D + 4 * cg, part);
      if (!is_dr) {  // Σ_m K ⊙ S_start, two halves of m, four sums each
        const int n = j & 63, h = j >> 6;
        float ks[4] = {};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int m = 32 * h + i;
          ks[i & 3] = fmaf(Ks[m * RS + n], Ss[m * RS + n], ks[i & 3]);
        }
        KSp[h * D + n] = (ks[0] + ks[1]) + (ks[2] + ks[3]);
      }
    } else {  // P = dy pᵀ over the visible pairs: rows rg + 8 i, cols cg + 16 jj
      float acc[4][2] = {};
      tile_mm<4, 2, false, false, 8, 16>(acc, Py, RS, Pp, RS, rg, cg, 0, D);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int u = rg + 8 * i, s = cg + 16 * jj;
          Pm[u * PS + s] = (PRE ? s < u : s <= u) ? acc[i][jj] : 0.f;
        }
    }
    {  // A, an entry a work item: the off block's (R~ Q~ᵀ) one a thread of
       // WG1 and WG2; the diagonal blocks' strict pairs (per-pair
       // exponentials) one a thread of WG0 and WG3, whose products are
       // shorter; post-readout's diagonal (exp 0 = 1) two a thread of the
       // 16 threads of WG3 left over
      constexpr int NSTR = SUB * (SUB - 1) / 2;  // s < u in one block
      int slot = (wg == 0 || wg == 1 ? 0 : 128) + j;
      // formed anew each chunk: hoisted out of the chunk loop, the entry's
      // indices would hold registers across all of it
      asm volatile("" : "+r"(slot));
      const bool off = wg == 1 || wg == 2;
      auto entry = [&](int u, int s, bool pair) {
        float4 acc = zero4;
        if (!pair) {
#pragma unroll 4
          for (int n = 0; n < D; n += 4)
            fma4(acc, ld4((off ? Tt : Pr) + u * RS + n),
                 ld4((off ? Tt : Pq) + s * RS + n));
        } else {
          const float* lr = L + (PRE ? u - 1 : u) * RS;
#pragma unroll 4
          for (int n = 0; n < D; n += 4)
            fma4(acc, mul4(ld4(Pr + u * RS + n), ld4(Pq + s * RS + n)),
                 expd4(ld4(lr + n), ld4(L + s * RS + n)));
        }
        At[s * PS + u] = (acc.x + acc.y) + (acc.z + acc.w);
      };
      if (off) {
        entry(SUB + (slot >> 4), slot & 15, false);
      } else if (slot < 2 * NSTR) {
        const int sb = slot >= NSTR;
        int u, s;
        tri_pair(slot - sb * NSTR, true, u, s);
        entry(u + SUB * sb, s + SUB * sb, true);
      } else if (!PRE) {
        const int d = 2 * (slot - 2 * NSTR);
        entry(d, d, false);
        entry(d + 1, d + 1, false);
      }
    }
    __syncthreads();  // (4) K and S_start read; P and A whole

    // -- 4. dp, K's update, the off-block and diagonal pair terms -------------
    if (c > 0 && vec) {  // the previous chunk's starting state
      if (tid == 0)
        tma_load_3d(static_cast<uint32_t>(__cvta_generic_to_shared(Ss)),
                    &maps.states, bars + 8 * ((c - 1) & 1), 0, 0,
                    static_cast<int>(bh * nc + c - 1));
    } else if (c > 0) {
      const float* st = states + (long long)(c - 1) * D * D;
      for (int i = tid; i < D * (D / 4); i += NT) {
        const int m = i >> 4, n = 4 * (i & 15);
        cp_async16(Ss + m * RS + n, st + m * D + n, true);
      }
      cp_async_commit();
    }
    if (wg < 2) {
      if (wg == 0) {  // dp += Aᵀ dy, then written
        tile_mm<4, 4, false, true, 8, 16>(dpv, At, PS, Py, RS, rg, cg, 0, C);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int s = rg + 8 * i, m = cg + 16 * jj;
            if (s < rows && m < M)
              prm.dp[(bh * T + c0 + s) * M + m] = dpv[i][jj];
          }
      } else {  // dr's and dq's off-block terms into DR (rows >= SUB), DQ
        float acc[2][4] = {};
        tile_mm<2, 4, false, true, 8, 1>(acc, Pm, PS, Tt, RS, SUB + rg,
                                         4 * cg, 0, SUB);
        const float4 l15 = ld4(L + (SUB - 1) * RS + 4 * cg);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int u = SUB + rg + 8 * i;
          float* d = DR + u * RS + 4 * cg;
          const float4 ex = expd4(ld4(L + (PRE ? u - 1 : u) * RS + 4 * cg), l15);
          st4(d, add4(ld4(d), mul4(make_float4(acc[i][0], acc[i][1],
                                               acc[i][2], acc[i][3]), ex)));
        }
        float acc2[2][4] = {};
        tile_mm<2, 4, true, true, 8, 1>(acc2, Pm, PS, Tt, RS, rg, 4 * cg, SUB,
                                        C);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = rg + 8 * i;
          float* d = DQ + s * RS + 4 * cg;
          const float4 ex = expd4(l15, ld4(L + s * RS + 4 * cg));
          st4(d, add4(ld4(d), mul4(make_float4(acc2[i][0], acc2[i][1],
                                               acc2[i][2], acc2[i][3]), ex)));
        }
      }
      // K <- K exp(L_end) + dyᵀ (r exp(Lr)): a 4 x 4 tile a thread of WG0-1
      const int kw = tid >> 5;
      const int m0 = 32 * (kw & 1) + 4 * (lane & 7);
      const int n0 = 16 * (kw >> 1) + 4 * (lane >> 3);
      const float4 dec = expd4(ld4(L + (C - 1) * RS + n0), zero4);
      float kacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv = mul4(ld4(Ks + (m0 + i) * RS + n0), dec);
        kacc[i][0] = kv.x;
        kacc[i][1] = kv.y;
        kacc[i][2] = kv.z;
        kacc[i][3] = kv.w;
      }
      tile_mm<4, 4, true, true, 1, 1>(kacc, Py, RS, RH, RS, m0, n0, 0, C);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st4(Ks + (m0 + i) * RS + n0,
            make_float4(kacc[i][0], kacc[i][1], kacc[i][2], kacc[i][3]));
        if (c == 0)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (m0 + i < M && n0 + jj < N)
              prm.ds0[(bh * M + m0 + i) * N + n0 + jj] = kacc[i][jj];
      }
    } else {  // the diagonal blocks' pairs: sub-chunk sb, channel n, a half
      const int half = wg - 2, sb = j >> 6, n = j & 63, base = SUB * sb;
      float Lv[SUB + 1], rr[SUB], dr[SUB], dla[SUB];
      Lv[0] = sb ? L[(SUB - 1) * RS + n] : 0.f;
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        Lv[i + 1] = L[(base + i) * RS + n];
        rr[i] = Pr[(base + i) * RS + n];
        dr[i] = 0.f;
        dla[i] = 0.f;
      }
      const float* Pb = Pm + base * PS + base;
      const float* qcol = Pq + base * RS + n;
      float* dqcol = Xdq + base * D + n;
      if (half == 0)
        diag_pairs<PRE, 0, BWD_SPLIT>(Pb, qcol, Lv, rr, dr, dla, dqcol);
      else
        diag_pairs<PRE, BWD_SPLIT, SUB>(Pb, qcol, Lv, rr, dr, dla, dqcol);
      // the two halves' sums, half 0's first (WG2 and WG3 alone wait)
      if (half == 0)
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          Xdr[(base + i) * D + n] = dr[i];
          Xdla[(base + i) * D + n] = dla[i];
        }
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (half == 1)
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          Xdr[(base + i) * D + n] += dr[i];
          Xdla[(base + i) * D + n] += dla[i];
        }
    }
    __syncthreads();  // (5) DR, DQ and the exchanged pairs whole

    // -- 5. dla (WG2), dr and dq (WG3) summed and written ---------------------
    if (wg >= 2) {
      const int sb = j >> 6, n = j & 63, base = SUB * sb;
      if (wg == 2) {
        float sq = 0.f, sr = 0.f;  // σq (sub-chunk 0's q ⊙ dqK), σr
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          sq += SGq[g * D + n];
          sr += SGr[g * D + n];
        }
        const float ks =
            __expf(L[(C - 1) * RS + n]) * (KSp[n] + KSp[D + n]);
        float pref[SUB];  // Σ_{s < t} q ⊙ (dqK + dq's off-block term)
        float run = sb ? sq : 0.f;
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          pref[t] = run;
          run = fmaf(Pq[(base + t) * RS + n], DQ[(base + t) * RS + n], run);
        }
        float suf = sb ? 0.f : sr;  // Σ_{ρ(u) >= t} r ⊙ (drS + off-block)
        const unsigned tm = tmask[n];
#pragma unroll
        for (int t = SUB - 1; t >= 0; --t) {
          const float w = Pr[(base + t) * RS + n] * DR[(base + t) * RS + n];
          if (!PRE) suf += w;
          const float v = ks + pref[t] + suf + Xdla[(base + t) * D + n];
          if (PRE) suf += w;
          const int row = base + t;
          if (row < rows && n < N)
            prm.dla[(bh * T + c0 + row) * N + n] = (tm >> row) & 1u ? 0.f : v;
        }
      } else {
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          const int row = base + t;
          const float vr = DR[row * RS + n] + Xdr[row * D + n];
          const float vq = DQ[row * RS + n] + Xdq[row * D + n];
          if (row < rows && n < N) {
            prm.dr[(bh * T + c0 + row) * N + n] = vr;
            prm.dq[(bh * T + c0 + row) * N + n] = vq;
          }
        }
      }
    }
  }
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

extern "C" int repro_linear_scan_bwd(const void* p, const void* q,
                                     const void* a, const void* r,
                                     const void* s0, const void* dy,
                                     const void* ds_fin, void* dp, void* dq,
                                     void* dla, void* dr, void* ds0,
                                     void* states, int BH, int T, int M, int N,
                                     int pre, void* stream) {
  if (BH < 1 || T < 1 || M < 1 || N < 1 || M > BWD_DMAX || N > BWD_DMAX ||
      !aligned16(states))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanBwdParams prm;
  prm.p = static_cast<const float*>(p);
  prm.q = static_cast<const float*>(q);
  prm.a = static_cast<const float*>(a);
  prm.r = static_cast<const float*>(r);
  prm.s0 = static_cast<const float*>(s0);
  prm.dy = static_cast<const float*>(dy);
  prm.ds_fin = static_cast<const float*>(ds_fin);
  prm.dp = static_cast<float*>(dp);
  prm.dq = static_cast<float*>(dq);
  prm.dla = static_cast<float*>(dla);
  prm.dr = static_cast<float*>(dr);
  prm.ds0 = static_cast<float*>(ds0);
  prm.states = static_cast<float*>(states);
  prm.T = T; prm.M = M; prm.N = N;
  prm.vec = M % 4 == 0 && N % 4 == 0 && aligned16(p) && aligned16(q) &&
            aligned16(a) && aligned16(r) && aligned16(dy);
  ScanBwdMaps maps = {};
  if (prm.vec) {
    const void* ops[5] = {p, dy, q, a, r};
    for (int o = 0; o < 5; ++o) {
      const long long W = o < 2 ? M : N;
      const long long dims[3] = {W, T, BH}, strides[2] = {4 * W, 4 * W * T};
      const int box[3] = {BWD_RS, BWD_C, 1};
      const int e = f32_map_nd(&maps.op[o], ops[o], 3, dims, strides, box);
      if (e) return e;
    }
    const long long nc = (T + BWD_C - 1) / BWD_C;
    const long long dims[3] = {BWD_DMAX, BWD_DMAX, BH * nc};
    const long long strides[2] = {4 * BWD_DMAX, 4 * BWD_DMAX * BWD_DMAX};
    const int box[3] = {BWD_RS, BWD_DMAX, 1};
    const int e = f32_map_nd(&maps.states, states, 3, dims, strides, box);
    if (e) return e;
  }
  const int smem = scan_bwd_smem_bytes();
  void (*kern)(ScanBwdParams, const ScanBwdMaps) =
      pre ? scan_bwd_kernel<true> : scan_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<BH, BWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(prm,
                                                                     maps);
  REPRO_RETURN_LAUNCH_STATUS();
}
