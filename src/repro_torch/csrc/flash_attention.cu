// flash_attention: GQA attention forward with an online softmax,
//   out[b, t, h] = softmax_k(scale * q[b, t, h] . k[b, k, h / G]) v[b, k, h / G]
// over the keys k visible to query position q_pos = q_offset[b] + t:
//   k < valid_len[b]  and, when causal,  k <= q_pos  or  (k < prefix_len and
//   q_pos < prefix_len)  (a bidirectional prefix window, then causal).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:80, pallas_call at :125, body _attn_kernel at :31).  Where the
// Pallas kernel bakes q_offset and valid_len into its masks as static ints,
// this kernel reads them per batch row from int32 device tensors, so a
// serving decode step (per-slot positions) never reads a position back to
// the host.  Semantics follow the reference model stack's blockwise oracle
// (flash_attention_ref, ref.py:62): the scale is folded into q in f32; the
// running max, denominator and accumulator are f32; masked scores count as
// -1e30 and contribute p = 0, so a row that sees no key gives 0 (the
// denominator is clamped at 1e-30); Dv may differ from D.
//
// Layout: q (R, B, Tq, H, D), k (R, B, Tk, KH, D), v (R, B, Tk, KH, Dv) and
// out (R, B, Tq, H, Dv), each with its own (r, b, t, h) element strides and
// a unit last stride.  R folds every rank dimension of a stacked tensor, so
// one launch serves every virtual rank, and a per-layer slice of a stacked
// KV cache (L between the ranks and the batch) needs no copy.
// q_offset / valid_len are (R * B,) int32.
//
// Keys at or past the tile's last visible key (see kend below) are staged
// as zeros and never read, so the rows of a cache past valid_len may hold
// anything, even NaN.
//
// Tiling: one block per (64-row query tile, kv head, r * B + b), running
// attention.cuh's tile routine over the keys in tiles of BK (16, 32 or 64,
// from OverlapPlanner.plan_attention_block).  Key tiles past the last key
// any row of the tile can see (valid_len, the causal frontier, the prefix
// window) are not read at all.
//
// Bound on this card: at decode (Tq = 1) bytes, the K/V rows read once
// (valid_len x KH x (D + Dv) x 2 B a batch row); for a prefill chunk,
// operations, 4 Tq Tk H D flops at the bf16 tensor-core rate.  This first
// version runs its products on the CUDA cores in f32 (no wgmma / TMA) and
// splits no key range across blocks, so a decode step launches only
// R * B * KH blocks; both are later work (PERF.md).
#include "attention.cuh"

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[4], ks[4], vs[4], os[4];  // (r, b, t, h) element strides
  const int* q_offset;
  const int* valid_len;
  int B, Tq, Tk, H, KH, D, Dv, G, BK, causal, prefix_len;
  float scale;
};

template <typename T, int DVT>
__global__ void __launch_bounds__(ATT_NT) flash_fwd_kernel(FlashParams p) {
  extern __shared__ float smem[];
  const int G = p.G;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kh = blockIdx.y;
  const int nb = blockIdx.z;             // r * B + b
  const int r = nb / p.B, b = nb % p.B;
  const int rows = p.Tq * G;
  const int i0 = blockIdx.x * ATT_BQ;
  const int qoff = p.q_offset[nb];
  const int vlen = min(p.valid_len[nb], p.Tk);

  const T* q = static_cast<const T*>(p.q) + r * p.qs[0] + b * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + r * p.ks[0] + b * p.ks[1] +
               kh * p.ks[3];
  const T* v = static_cast<const T*>(p.v) + r * p.vs[0] + b * p.vs[1] +
               kh * p.vs[3];
  T* o = static_cast<T*>(p.o) + r * p.os[0] + b * p.os[1];

  const int kend =
      att_key_end(i0, rows, G, qoff, vlen, p.causal, p.prefix_len);
  att_stage_q(smem, q, p.qs[2], p.qs[3], i0, rows, G, kh, p.D, p.scale);
  int qpos[4];
  bool rvalid[4];
  att_rows(i0, rows, G, qoff, qpos, rvalid);
  float m[4], l[4], acc[4][DVT];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = ATT_NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DVT; ++c) acc[a][c] = 0.f;
  }
  att_fold<T, DVT>(smem, k, p.ks[2], v, p.vs[2], p.D, p.Dv, p.BK, kend, 0,
                   vlen, p.causal, p.prefix_len, qpos, rvalid, m, l, acc);

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (!rvalid[a]) continue;
    const int row = i0 + ty + 16 * a;
    const int t = row / G, h = kh * G + row % G;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < DVT; ++c) {
      const int col = tx + 16 * c;
      if (col < p.Dv)
        o[t * p.os[2] + h * p.os[3] + col] = from_f32<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, int DVT>
static int launch(const FlashParams& p, int R, cudaStream_t stream) {
  const size_t smem = sizeof(float) * att_smem_floats(p.D, p.Dv, p.BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Tq * p.G + ATT_BQ - 1) / ATT_BQ, p.KH, R * p.B);
  flash_fwd_kernel<T, DVT><<<grid, ATT_NT, smem, stream>>>(p);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_dv(const FlashParams& p, int R, cudaStream_t stream) {
  if (p.Dv <= 16) return launch<T, 1>(p, R, stream);
  if (p.Dv <= 32) return launch<T, 2>(p, R, stream);
  if (p.Dv <= 64) return launch<T, 4>(p, R, stream);
  if (p.Dv <= 128) return launch<T, 8>(p, R, stream);
  return launch<T, 16>(p, R, stream);
}

extern "C" int repro_flash_attention(
    const void* q, long long q_r, long long q_b, long long q_t, long long q_h,
    const void* k, long long k_r, long long k_b, long long k_t, long long k_h,
    const void* v, long long v_r, long long v_b, long long v_t, long long v_h,
    void* o, long long o_r, long long o_b, long long o_t, long long o_h,
    const void* q_offset, const void* valid_len, int R, int B, int Tq, int Tk,
    int H, int KH, int D, int Dv, int BK, int causal, int prefix_len,
    float scale, int dtype, void* stream) {
  if (Dv > 256 || BK % 16 != 0 || BK < 16 || BK > 64 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  const long long qs[4] = {q_r, q_b, q_t, q_h}, ks[4] = {k_r, k_b, k_t, k_h},
                  vs[4] = {v_r, v_b, v_t, v_h}, os[4] = {o_r, o_b, o_t, o_h};
  for (int i = 0; i < 4; ++i) {
    p.qs[i] = qs[i]; p.ks[i] = ks[i]; p.vs[i] = vs[i]; p.os[i] = os[i];
  }
  p.q_offset = static_cast<const int*>(q_offset);
  p.valid_len = static_cast<const int*>(valid_len);
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.KH = KH; p.D = D; p.Dv = Dv;
  p.G = H / KH; p.BK = BK; p.causal = causal; p.prefix_len = prefix_len;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_dv<float>(p, R, s);
    case kF16: return dispatch_dv<__half>(p, R, s);
    case kBF16: return dispatch_dv<__nv_bfloat16>(p, R, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
