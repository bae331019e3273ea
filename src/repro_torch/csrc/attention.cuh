// The online-softmax tile routine shared by flash_attention.cu and
// ring_attention.cu.
//
// A block of ATT_NT = 256 threads owns a tile of ATT_BQ = 64 query rows of
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

#include "common.cuh"

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
