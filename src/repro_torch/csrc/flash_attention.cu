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
// (flash_attention_ref, ref.py:62): the running max, denominator and
// accumulator are f32 (the CUDA-core route folds the scale into q in f32;
// the tensor-core route scales S in f32 and rounds P to the operand type
// before P v, attention.cuh); masked scores count as
// -1e30 and contribute p = 0, so a row that sees no key gives 0 (the
// denominator is clamped at 1e-30); Dv may differ from D.  Asked for, both
// routes also write each row's log-sum-exp (lse below), for the gradient of
// flash_attention_bwd.cu; a launch that writes it takes no key split.
//
// Layout: q (R, B, Tq, H, D), k (R, B, Tk, KH, D), v (R, B, Tk, KH, Dv) and
// out (R, B, Tq, H, Dv), each with its own (r, b, t, h) element strides and
// a unit last stride.  R folds every rank dimension of a stacked tensor, so
// one launch serves every virtual rank, and a per-layer slice of a stacked
// KV cache (L between the ranks and the batch) needs no copy.
// q_offset / valid_len are (R * B,) int32.
//
// Keys at or past the tile's last visible key (see kend below) are never
// read as data (staged as zeros on the CUDA-core route, zeroed in shared
// memory on the tensor-core route), so the rows of a cache past valid_len
// may hold anything, even NaN.
//
// Two routes, by attention.cuh's rule (plan.attention_route), decided
// before launch; the entry point refuses a tensor-core launch off the rule:
//
// * tensor cores (flash_tc_kernel): f16/bf16 with D a multiple of 16 in
//   [16, 256], Dv a multiple of 16 in [16, 128], or 256, G dividing 64,
//   16-byte-aligned operands; one instance a Dv the rule admits, D a
//   runtime value (a width off 64, such as stablelm-3b's D = Dv = 80, is
//   whole 64-column boxes whose columns past the width TMA fills with
//   zeros; deepseek-v3's MLA, D = 192 and Dv = 128, is three boxes of q and
//   k on the Dv = 128 instance).  One block per (64-row
//   query tile, key split, kv head, r * B + b), running attention.cuh's
//   TMA + wgmma tile over its split of the tile's visible keys [0, kend),
//   in 64-key tiles.
//   A decode step has few tiles (8 blocks at glm4-9b's or paligemma-3b's
//   decode on 2 ranks x 4 slots), so the wrapper splits the keys
//   (plan.plan_key_splits: enough blocks to cover the SMs about twice, 1
//   where the grid already fills the card).  Split sp of S takes the whole
//   64-key tiles [sp T / S, (sp + 1) T / S) of the T tiles the tile's rows
//   see, so the work follows each slot's own length, read on the card.
//   With S > 1 each block writes its f32 partial (m, l, acc) for its valid
//   rows into scratch the wrapper allocates, and flash_combine_kernel
//   merges the S partials in split order (the merge monoid of
//   ring_attention/kernel.py, merge_states) and normalizes;
// * CUDA cores (flash_fwd_kernel): f32 and shapes off the rule (widths
//   off 16, Dv in (128, 256), G not dividing 64 such as command-r-plus's
//   12, unaligned operands); one block
//   per (64-row query tile, kv head, r * B + b), running att_fold over the
//   keys in tiles of BK (16, 32 or 64, from plan_attention_block).
//
// Key tiles past the last key any row of the tile can see (valid_len, the
// causal frontier, the prefix window) are not read at all.
//
// Bound on this card: at decode (Tq = 1) bytes, the K/V rows read once
// (valid_len x KH x (D + Dv) x 2 B a batch row); for a prefill chunk,
// operations, 4 Tq Tk H D flops at the bf16 tensor-core rate.
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
  // the tensor-core route's key splits and, with splits > 1, the f32
  // partials: pm, pl (R * B, splits, Tq, H) and pacc (..., Dv)
  int splits;
  float* pm;
  float* pl;
  float* pacc;
  // with splits == 1, where not null: each (r b, t, h) row's log-sum-exp
  // lse = m + log l of the scaled scores, (R * B, Tq, H) f32, +inf for a row
  // that sees no key; the backward (flash_attention_bwd.cu) recomputes P
  // from it
  float* lse;
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
    if (p.lse && tx == 0)
      p.lse[((long long)nb * p.Tq + t) * p.H + h] = row_lse(m[a], l[a]);
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

// -- the tensor-core route ---------------------------------------------------

template <typename T, int DV>
__global__ void __launch_bounds__(ATT_TC_THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, FlashParams p) {
  extern __shared__ unsigned char tc_smem[];
  const AttTcSmem sm = att_tc_smem_init(tc_smem, p.D, DV);
  const int G = p.G, S = p.splits;
  const int tile = blockIdx.x / S, sp = blockIdx.x % S;
  const int kh = blockIdx.y;
  const int nb = blockIdx.z;             // r * B + b
  const int r = nb / p.B, b = nb % p.B;
  const int rows = p.Tq * G;
  const int i0 = tile * ATT_BQ;
  const int qoff = p.q_offset[nb];
  const int vlen = min(p.valid_len[nb], p.Tk);
  // the keys any row of the tile sees; split sp folds its run of them
  const int kend =
      att_key_end(i0, rows, G, qoff, vlen, p.causal, p.prefix_len);
  const int tiles = kend > 0 ? (kend + ATT_TC_BK - 1) / ATT_TC_BK : 0;
  const int tb = (int)((long long)sp * tiles / S);
  const int te = (int)((long long)(sp + 1) * tiles / S);
  AttPipe pipe;
  if (threadIdx.x == ATT_TC_CONSUMERS) {
    uint32_t qphase = 0;
    att_tc_load_q(sm, qphase, &qmap, kh * G, i0 / G, b, r);
    att_tc_load_kv(sm, pipe, &kmap, &vmap, kh, tb * ATT_TC_BK, te - tb, b,
                   r);
  } else if (threadIdx.x < ATT_TC_CONSUMERS) {
    int qpos[2];
    bool rvalid[2];
    att_tc_rows(i0, rows, G, qoff, qpos, rvalid);
    float m[2] = {ATT_NEG_INF, ATT_NEG_INF}, l[2] = {0.f, 0.f}, o[DV / 2];
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
    mbar_wait(sm.qfull(), 0);
    att_tc_fold<T, DV>(sm, pipe, tb * ATT_TC_BK, te - tb, kend, 0, vlen,
                       p.causal, p.prefix_len, qpos, rvalid, p.scale, m, l,
                       o);
    const int lane = threadIdx.x % 32;
    const int r0 = i0 + att_tc_row0();
    T* out = static_cast<T*>(p.o) + r * p.os[0] + b * p.os[1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!rvalid[h]) continue;
      const int row = r0 + 8 * h;
      const int t = row / G, head = kh * G + row % G;
      if (S == 1) {
        T* dst = out + t * p.os[2] + head * p.os[3];
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
        if (p.lse && (lane & 3) == 0)
          p.lse[((long long)nb * p.Tq + t) * p.H + head] = row_lse(m[h], l[h]);
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          store2(dst + 8 * j + 2 * (lane & 3), o[4 * j + 2 * h] * inv,
                 o[4 * j + 2 * h + 1] * inv);
      } else {
        const long long prow =
            ((long long)(nb * S + sp) * p.Tq + t) * p.H + head;
        if ((lane & 3) == 0) {
          p.pm[prow] = m[h];
          p.pl[prow] = l[h];
        }
        float* acc = p.pacc + prow * DV;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<float2*>(acc + 8 * j + 2 * (lane & 3)) =
              make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <typename T, int DV>
static int launch_tc(const FlashParams& p, int R, int dtype,
                     cudaStream_t stream) {
  if (!att_tc_route_ok(dtype, p.D, p.Dv, p.G, p.BK, {p.q, p.k, p.v}) ||
      p.splits < 1 || (p.splits > 1 && (!p.pm || !p.pl || !p.pacc)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  const long long qd[5] = {p.D, p.H, p.Tq, p.B, R};
  const long long kd[5] = {p.D, p.KH, p.Tk, p.B, R};
  const long long vd[5] = {p.Dv, p.KH, p.Tk, p.B, R};
  const long long qs[4] = {p.qs[3], p.qs[2], p.qs[1], p.qs[0]};
  const long long ks[4] = {p.ks[3], p.ks[2], p.ks[1], p.ks[0]};
  const long long vs[4] = {p.vs[3], p.vs[2], p.vs[1], p.vs[0]};
  int err = att_tc_map(&qmap, p.q, dtype, qd, qs, p.G, ATT_BQ / p.G);
  if (err == 0) err = att_tc_map(&kmap, p.k, dtype, kd, ks, 1, ATT_TC_BK);
  if (err == 0) err = att_tc_map(&vmap, p.v, dtype, vd, vs, 1, ATT_TC_BK);
  if (err != 0) return err;
  const int smem = att_tc_smem_bytes(p.D, DV);
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.Tq * p.G + ATT_BQ - 1) / ATT_BQ * p.splits, p.KH, R * p.B);
  flash_tc_kernel<T, DV><<<grid, ATT_TC_THREADS, smem, stream>>>(qmap, kmap,
                                                                 vmap, p);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int dispatch_tc(const FlashParams& p, int R, int dtype,
                       cudaStream_t stream) {
  // one instance a width the rule admits (D stays a runtime value)
  switch (p.Dv) {
    case 16: return launch_tc<T, 16>(p, R, dtype, stream);
    case 32: return launch_tc<T, 32>(p, R, dtype, stream);
    case 48: return launch_tc<T, 48>(p, R, dtype, stream);
    case 64: return launch_tc<T, 64>(p, R, dtype, stream);
    case 80: return launch_tc<T, 80>(p, R, dtype, stream);
    case 96: return launch_tc<T, 96>(p, R, dtype, stream);
    case 112: return launch_tc<T, 112>(p, R, dtype, stream);
    case 128: return launch_tc<T, 128>(p, R, dtype, stream);
    case 256: return launch_tc<T, 256>(p, R, dtype, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- the split combine -------------------------------------------------------

struct CombineParams {
  const float* pm;
  const float* pl;
  const float* pacc;
  void* o;
  long long os[4];  // (r, b, t, h) element strides of out
  int B, Tq, H, Dv, splits;
  long long rows;   // R * B * Tq * H
};

constexpr int COMBINE_THREADS = 256;  // one (r, b, t, h) row a block

// One block a (r, b, t, h) row: fold the row's partials in split order
// with merge_states' rule (rescale both sides to the joint max; a side
// that saw no key has m = -1e30 and l = 0, so it adds nothing), then
// normalize with the 1e-30 clamp, so a row that saw no key comes out as 0.
// The splits' (m, l) land in shared memory together; one thread walks the
// scalar chain of running maxima and keeps each split's two rescale
// factors there; then thread c folds column c, its S loads independent of
// the chain so that they stay in flight together.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_combine_kernel(CombineParams c) {
  extern __shared__ float cs[];     // m[S], l[S], then (e1, e2)[S], 1 / l
  const int S = c.splits;
  const long long w = blockIdx.x;
  const int h = (int)(w % c.H), t = (int)(w / c.H % c.Tq);
  const long long nb = w / ((long long)c.H * c.Tq);
  // the row's partial of split s
  const long long row0 = (nb * S * c.Tq + t) * c.H + h;
  const long long step = (long long)c.Tq * c.H;
  float* ms = cs;
  float* ls = cs + S;
  float* fac = cs + 2 * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    ms[s] = c.pm[row0 + s * step];
    ls[s] = c.pl[row0 + s * step];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = ATT_NEG_INF, l = 0.f;
    for (int s = 0; s < S; ++s) {
      const float mn = s == 0 ? ms[s] : fmaxf(m, ms[s]);
      const float e1 = s == 0 ? 0.f : expf(m - mn), e2 = expf(ms[s] - mn);
      l = l * e1 + ls[s] * e2;
      m = mn;
      fac[2 * s] = e1;
      fac[2 * s + 1] = e2;
    }
    fac[2 * S] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col >= c.Dv) return;
  const float* a = c.pacc + row0 * c.Dv + col;
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s)
    acc = acc * fac[2 * s] + a[s * step * c.Dv] * fac[2 * s + 1];
  T* o = static_cast<T*>(c.o) + nb / c.B * c.os[0] + nb % c.B * c.os[1] +
         t * c.os[2] + h * c.os[3];
  o[col] = from_f32<T>(acc * fac[2 * S]);
}

template <typename T>
static int launch_combine(const CombineParams& c, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * (size_t)c.splits + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  flash_combine_kernel<T><<<(unsigned)c.rows, COMBINE_THREADS, smem,
                            stream>>>(c);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_flash_attention(
    const void* q, long long q_r, long long q_b, long long q_t, long long q_h,
    const void* k, long long k_r, long long k_b, long long k_t, long long k_h,
    const void* v, long long v_r, long long v_b, long long v_t, long long v_h,
    void* o, long long o_r, long long o_b, long long o_t, long long o_h,
    const void* q_offset, const void* valid_len, int R, int B, int Tq, int Tk,
    int H, int KH, int D, int Dv, int BK, int causal, int prefix_len,
    float scale, int dtype, int route, int splits, void* pm, void* pl,
    void* pacc, void* lse, void* stream) {
  if (Dv > 256 || BK % 16 != 0 || BK < 16 || BK > 64 || H % KH != 0 ||
      (lse && splits != 1))
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
  p.splits = splits;
  p.pm = static_cast<float*>(pm);
  p.pl = static_cast<float*>(pl);
  p.pacc = static_cast<float*>(pacc);
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) {
    switch (dtype) {
      case kF16: return dispatch_tc<__half>(p, R, dtype, s);
      case kBF16: return dispatch_tc<__nv_bfloat16>(p, R, dtype, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != kRouteSimt || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return dispatch_dv<float>(p, R, s);
    case kF16: return dispatch_dv<__half>(p, R, s);
    case kBF16: return dispatch_dv<__nv_bfloat16>(p, R, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[r, b, t, h] from the partials pm, pl (R * B, splits, Tq, H) and pacc
// (..., Dv), f32.
extern "C" int repro_flash_combine(const void* pm, const void* pl,
                                   const void* pacc, void* o, long long o_r,
                                   long long o_b, long long o_t,
                                   long long o_h, int R, int B, int Tq, int H,
                                   int Dv, int splits, int dtype,
                                   void* stream) {
  if (Dv < 1 || Dv > 256 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CombineParams c;
  c.pm = static_cast<const float*>(pm);
  c.pl = static_cast<const float*>(pl);
  c.pacc = static_cast<const float*>(pacc);
  c.o = o;
  c.os[0] = o_r; c.os[1] = o_b; c.os[2] = o_t; c.os[3] = o_h;
  c.B = B; c.Tq = Tq; c.H = H; c.Dv = Dv; c.splits = splits;
  c.rows = (long long)R * B * Tq * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_combine<float>(c, s);
    case kF16: return launch_combine<__half>(c, s);
    case kBF16: return launch_combine<__nv_bfloat16>(c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
