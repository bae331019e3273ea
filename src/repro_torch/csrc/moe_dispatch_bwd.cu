// fused_moe_dispatch_bwd: the gradient of moe_dispatch.cu's dropless
// expert-parallel ring, in ONE cooperative launch of every ring.
//
// No TPU kernel is replaced: it is the gradient of the kernel that replaces
// fused_moe_dispatch_tpu (src/repro/kernels/moe_dispatch/fused.py:263,
// pallas_call at :284), which has no backward on the TPU (the reference
// differentiates its emulation).  The forward maps wire blocks to results,
// out[r][j] = MLP_j(buf[r][j]) (rank j's experts on rank r's block for j);
// this kernel computes, for the cotangent dout,
//   dbuf[r][j] = J_j(buf[r][j])^T dout[r][j]    and    dW_j = sum_r ...
// with expert_bwd.cuh's passes, walking the same AllToAllPlan.schedule()
// table as the forward.  A weight set is rank r's expert e; its sources
// are the ring's offsets s = 0 .. ep - 1 (the block from rank r - s; s = 0
// the local block).
//
// On the tensor cores (dispatch_bwd_tc_kernel, the rule of
// plan.expert_bwd_route) the blocks land packed: one block first fills the
// packed layout's metadata from the counts (each weight set's live rows,
// offset by offset), the grid copies the local blocks' live rows of x and
// dout (and zeroes the padding rows), and each dispatch put of offset s
// carries only the live rows of rank r's x block and dout block for r + s,
// into that weight set's rows of offset s: the landing of every remote
// block is its own range of the packed layout (one slot a remote block,
// ep - 1 of them).  Fences are grid-wide barriers (cooperative launch, the
// grid sized from occupancy); pending puts are carried out before the phase
// that needs them, as in the forward.  The GEMM phases run as one, at the
// schedule's last "gemm" record, when every block has landed: passes A and
// B over every weight set's packed tiles (so each weight tile is read once
// a pass, not once a ring offset), and pass B stores each live row's dx
// straight into dbuf of its source (the return carries the live rows only;
// the "ret" records find nothing left to move), after the rows past the
// counts are written as zeros.  Pass C then sums each dW over the packed
// rows, offset by offset: written once, no atomics, the same bit for bit
// from run to run.  Every thread fences the async proxy after its generic
// stores and after each barrier (TMA reads the packed rows and the
// scratch).
//
// On the CUDA cores (dispatch_bwd_kernel) each put carries the padded x and
// dout blocks into rank (r + s)'s landing slot s % slots, each "gemm" phase
// runs passes A and B on one offset (the grid deals out every tile round
// robin, a scratch kept for every (rank, offset)), each return carries the
// padded dx block home, and pass C runs after the schedule; that needs one
// slot a remote block: the wrapper passes ep - 1, and the entry point
// refuses fewer.  Nothing is recorded on the host's put logs: the
// reference's AD transposes its puts without running their Python.
//
// Bound on this card: the grouped MLP gradient's (expert_bwd.cuh), plus the
// live rows' puts and dx.
//
// Layout: buf, dout, dbuf (G, ep_src, ep_dst, E_loc, C, d); wg, wu (G, ep,
// E_loc, d, f); wd (G, ep, E_loc, f, d), each rank's experts contiguous and
// the ranks sg, su, sd elements apart; dwg, dwu (G, ep, E_loc, d, f) and
// dwd (G, ep, E_loc, f, d) contiguous; counts (G, ep_src, ep_dst, E_loc)
// int32.  CUDA cores: xstage, dstage, ret_stage (G, ep, slots, E_loc, C, d);
// scratch three (G, ep, ep_offset, E_loc, C, f) planes (dg, du, h); work
// and tiles unused.  Tensor cores: xstage, dstage and ret_stage unused;
// tiles packed 64-row tiles at most (the caller's bound); scratch
// exb_planes(tiles) (packed x and dout, then dg, du, h); work
// exb_work_words(G ep E_loc, ep, tiles) int32.
#include <cooperative_groups.h>

#include <cstddef>
#include <type_traits>

#include "expert_bwd.cuh"

namespace cg = cooperative_groups;

// phase codes of a schedule record (repro_torch/kernels/moe_dispatch/fused.py)
enum { kPut = 0, kFence = 1, kGemm = 2, kRet = 3, kFenceRet = 4 };

struct DispatchBwdArgs {
  const void* buf;
  const void* dout;
  const void* wg;
  const void* wu;
  const void* wd;
  const int* counts;
  void* dbuf;
  void* dwg;
  void* dwu;
  void* dwd;
  void* xstage;
  void* dstage;
  void* ret_stage;
  void* scratch;
  const int* sched;
  void* work;
  long long sg, su, sd;
  int nrec, G, ep, slots, E_loc, C, d, f, tiles;
};

// The problems of the backward: weight set wp = (g ep + r) E_loc + e (rank
// r's expert e) and offset s: the block that landed from r - s (its local
// block at s = 0).
template <typename T>
struct RingBwdGet {
  DispatchBwdArgs a;

  // index of the (g, src, r, e) block of wp at offset s in buf's layout
  __device__ long long block(long long wp, int s) const {
    const int E = a.E_loc, ep = a.ep;
    const long long q = wp / E;
    const int r = (int)(q % ep), g = (int)(q / ep);
    const int src = (r - s + ep) % ep;
    return (((long long)g * ep + src) * ep + r) * E + wp % E;
  }
  __device__ int live(long long wp, int s) const {
    return min(max(a.counts[block(wp, s)], 0), a.C);
  }
  // element offset of that block's row r in buf's (and dout's, dbuf's)
  // layout
  __device__ long long row(long long wp, int s, int r) const {
    return (block(wp, s) * a.C + r) * (long long)a.d;
  }
  // the CUDA-core route's problem
  __device__ ExbProblem<T> operator()(long long wp, int s) const {
    const int E = a.E_loc, ep = a.ep, C = a.C, d = a.d, f = a.f;
    const long long q = wp / E;
    const int e = (int)(wp % E);
    const int r = (int)(q % ep), g = (int)(q / ep);
    const int src = (r - s + ep) % ep;
    const long long blk = (long long)E * C * d, eoff = (long long)e * C * d;
    ExbProblem<T> p;
    if (s == 0) {
      const long long off = (((long long)g * ep + r) * ep + r) * blk + eoff;
      p.x = static_cast<const T*>(a.buf) + off;
      p.dy = static_cast<const T*>(a.dout) + off;
      p.dx = static_cast<T*>(a.dbuf) + off;
    } else {
      const long long off = (q * a.slots + s % a.slots) * blk + eoff;
      p.x = static_cast<const T*>(a.xstage) + off;
      p.dy = static_cast<const T*>(a.dstage) + off;
      p.dx = static_cast<T*>(a.ret_stage) + off;
    }
    const long long plane = (long long)a.G * ep * ep * E * C * f;
    p.dg = static_cast<T*>(a.scratch) + ((q * ep + s) * E + e) * C * f;
    p.du = p.dg + plane;
    p.h = p.du + plane;
    p.wg = static_cast<const T*>(a.wg) + q * a.sg + (long long)e * d * f;
    p.wu = static_cast<const T*>(a.wu) + q * a.su + (long long)e * d * f;
    p.wd = static_cast<const T*>(a.wd) + q * a.sd + (long long)e * f * d;
    const int live = a.counts[(((long long)g * ep + src) * ep + r) * E + e];
    p.live = min(max(live, 0), C);
    return p;
  }
};

// dst(q) <- src(q) for every rank q = (g, r): G ep blocks of n elements, 16
// bytes at a time where the blocks allow it, COPY_UNROLL loads of each
// thread in flight before its stores.
constexpr int COPY_UNROLL = 8;

template <typename T, typename Src, typename Dst>
__device__ void pair_copy(int G, int ep, long long n, Src src, Dst dst) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const int ranks = G * ep;
  if ((n * sizeof(T)) % 16 == 0) {
    const long long nv = n * sizeof(T) / 16;
    for (int q = 0; q < ranks; ++q) {
      const uint4* s = reinterpret_cast<const uint4*>(src(q / ep, q % ep));
      uint4* d = reinterpret_cast<uint4*>(dst(q / ep, q % ep));
      for (long long i0 = gtid; i0 < nv; i0 += gstride * COPY_UNROLL) {
        uint4 v[COPY_UNROLL];
#pragma unroll
        for (int u = 0; u < COPY_UNROLL; ++u) {
          const long long i = i0 + u * gstride;
          if (i < nv) v[u] = s[i];
        }
#pragma unroll
        for (int u = 0; u < COPY_UNROLL; ++u) {
          const long long i = i0 + u * gstride;
          if (i < nv) d[i] = v[u];
        }
      }
    }
  } else {
    for (long long i = gtid; i < (long long)ranks * n; i += gstride) {
      const int q = (int)(i / n);
      dst(q / ep, q % ep)[i % n] = src(q / ep, q % ep)[i % n];
    }
  }
}

// The schedule, record by record, on every thread of the grid; gemm(s) runs
// GEMM phase s.  With pack null (the CUDA-core route) each put carries rank
// r's padded x and dout blocks for r + s into a landing slot and each
// return the padded dx block home; else pack(s) lands offset s's live rows
// and a return has nothing left to move (pass B stored the dx rows home).
// Every thread fences the async proxy after its puts and after each
// fence's barrier (TMA reads the landed rows).
template <typename T, typename Gemm, typename Pack>
__device__ void walk_bwd(const DispatchBwdArgs& a, cg::grid_group& grid,
                         Gemm gemm, Pack pack) {
  constexpr bool padded = std::is_same<Pack, std::nullptr_t>::value;
  const int ep = a.ep, slots = a.slots;
  const long long blk = (long long)a.E_loc * a.C * a.d;
  const T* buf = static_cast<const T*>(a.buf);
  const T* dout = static_cast<const T*>(a.dout);
  T* dbuf = static_cast<T*>(a.dbuf);
  T* xstage = static_cast<T*>(a.xstage);
  T* dstage = static_cast<T*>(a.dstage);
  const T* ret_stage = static_cast<const T*>(a.ret_stage);
  auto pair_off = [=](int g, int i, int j) {
    return (((long long)g * ep + i) * ep + j) * blk;
  };
  auto slot_off = [=](int g, int r, int sl) {
    return (((long long)g * ep + r) * slots + sl) * blk;
  };
  auto put = [&](int s) {  // rank r's x and dout blocks for r + s
    if constexpr (padded) {
      pair_copy<T>(a.G, ep, blk,
          [=](int g, int r) { return buf + pair_off(g, r, (r + s) % ep); },
          [=](int g, int r) { return xstage + slot_off(g, (r + s) % ep, s % slots); });
      pair_copy<T>(a.G, ep, blk,
          [=](int g, int r) { return dout + pair_off(g, r, (r + s) % ep); },
          [=](int g, int r) { return dstage + slot_off(g, (r + s) % ep, s % slots); });
    } else {
      pack(s);
    }
  };
  unsigned long long pending = 0;  // issued puts not yet carried out

  for (int i = 0; i < a.nrec; ++i) {
    const int phase = a.sched[2 * i], s = a.sched[2 * i + 1];
    if (phase == kPut) {
      pending |= 1ull << s;
    } else if (phase == kFence) {
      for (int o = 1; o <= s; ++o)
        if (pending >> o & 1ull) { put(o); pending &= ~(1ull << o); }
      fence_proxy_async_global();
      grid.sync();
      fence_proxy_async_global();
    } else if (phase == kGemm) {
      for (int o = 1; o < ep; ++o)
        if (pending >> o & 1ull) { put(o); pending &= ~(1ull << o); }
      fence_proxy_async_global();
      gemm(s);
    } else if (phase == kRet) {  // dx of the block from r - s, home to it
      if constexpr (padded)
        pair_copy<T>(a.G, ep, blk,
            [=](int g, int r) { return ret_stage + slot_off(g, r, s % slots); },
            [=](int g, int r) { return dbuf + pair_off(g, (r - s % ep + ep) % ep, r); });
    } else if (phase == kFenceRet) {
      grid.sync();
    }
  }
}

// CUDA-core route: every pass's tiles dealt round robin over the grid.
template <typename T>
__global__ void __launch_bounds__(EX_THREADS, 1)
dispatch_bwd_kernel(DispatchBwdArgs a) {
  __shared__ __align__(16) ExbSmem sm;
  cg::grid_group grid = cg::this_grid();
  const RingBwdGet<T> get{a};
  const long long NW = (long long)a.G * a.ep * a.E_loc;
  const int C = a.C, d = a.d, f = a.f;
  T* dwg = static_cast<T*>(a.dwg);
  T* dwu = static_cast<T*>(a.dwu);
  T* dwd = static_cast<T*>(a.dwd);
  walk_bwd<T>(a, grid, [&](int s) {
    auto one = [&](long long wp, int) { return get(wp, s); };
    for (int pass = 0; pass < 2; ++pass) {
      const long long n = exb_rows_items(NW, 1, C, pass == 0 ? f : d);
      for (long long it = blockIdx.x; it < n; it += gridDim.x)
        exb_simt_item<T>(pass, it, 1, C, d, f, one, dwg, dwu, dwd, sm);
      grid.sync();
    }
  }, nullptr);
  const long long n = exb_dw_items(NW, d, f);
  for (long long it = blockIdx.x; it < n; it += gridDim.x)
    exb_simt_item<T>(2, it, a.ep, C, d, f, get, dwg, dwu, dwd, sm);
}

// Tensor-core route: one block an SM (the stages take 217 KiB).
template <typename T>
__global__ void __launch_bounds__(EXB_THREADS, 1)
dispatch_bwd_tc_kernel(const __grid_constant__ CUtensorMap wgm,
                       const __grid_constant__ CUtensorMap wum,
                       const __grid_constant__ CUtensorMap wdm,
                       const __grid_constant__ CUtensorMap xm,
                       const __grid_constant__ CUtensorMap dym,
                       const __grid_constant__ CUtensorMap dgm,
                       const __grid_constant__ CUtensorMap dum,
                       const __grid_constant__ CUtensorMap hm,
                       const __grid_constant__ CUtensorMap dwgm,
                       const __grid_constant__ CUtensorMap dwum,
                       const __grid_constant__ CUtensorMap dwdm,
                       DispatchBwdArgs a) {
  extern __shared__ unsigned char smem[];
  const ExbTcSmem sm = exb_smem_init(smem);
  cg::grid_group grid = cg::this_grid();
  const RingBwdGet<T> get{a};
  const long long NW = (long long)a.G * a.ep * a.E_loc;
  const ExbPack pk = exb_pack_view(a.work, NW, a.ep, a.tiles);
  const ExbPlanes<T> pl = exb_planes<T>(a.scratch, a.tiles, a.d, a.f);
  const T* buf = static_cast<const T*>(a.buf);
  const T* dout = static_cast<const T*>(a.dout);
  T* dbuf = static_cast<T*>(a.dbuf);
  // -- the packed layout's metadata (the "// -- " lines mark the passes
  // for chip_split.py's clock64 split)
  if (blockIdx.x == 0)
    exb_build_pack(NW, a.ep, a.C, a.tiles,
                   [&](long long wp, int s) { return get.live(wp, s); },
                   static_cast<int*>(a.work));
  grid.sync();
  // offset s's live rows into the packed layout, a warp a row (s = 0: the
  // local blocks, every row's source offset and the padding rows)
  const long long warps = (long long)gridDim.x * (EXB_THREADS / 32);
  auto pack = [&](int s) {
    exb_pack_rows<T>(
        pk, a.d, s, s == 0, buf, dout, pl.xp, pl.dyp,
        const_cast<long long*>(pk.rowoff),
        [&](long long wp, int o, int r) { return get.row(wp, o, r); },
        (long long)blockIdx.x * (EXB_THREADS / 32) + threadIdx.x / 32, warps);
  };
  pack(0);
  ExbPipe pipe;
  int gemms = 0;
  walk_bwd<T>(a, grid, [&](int) {
    if (++gemms < a.ep) return;  // the last "gemm" record: all landed
    fence_proxy_async_global();
    grid.sync();
    fence_proxy_async_global();
    // -- pass A
    exb_tc_rows_pass<T>(sm, pipe, pk, a.E_loc, a.d, a.f, &wgm, &wum, &wdm,
                        &xm, &dym, pl);
    fence_proxy_async_global();  // the scratch, before TMA reads it
    grid.sync();
    fence_proxy_async_global();
    // -- pass B
    if (threadIdx.x < EXB_CONSUMERS)
      ex_zero_dead_rows<T>(
          (long long)a.G * a.ep * a.ep * a.E_loc, a.C, a.d,
          [&](long long p, int& live) {
            live = min(max(a.counts[p], 0), a.C);
            return dbuf + p * a.C * a.d;
          },
          (long long)blockIdx.x * (EXB_CONSUMERS / 32) + threadIdx.x / 32,
          (long long)gridDim.x * (EXB_CONSUMERS / 32));
    exb_tc_dx_pass<T>(sm, pipe, pk, a.E_loc, a.d, a.f, &wgm, &wum, &dgm, &dum,
                      dbuf);
  }, pack);
  __syncthreads();  // pass C's stages lie over pass B's: all released
  // -- pass C
  exb_tc_dw_pass<T>(sm, pipe, pk, a.d, a.f, &xm, &dym, &dgm, &dum, &hm,
                    &dwgm, &dwum, &dwdm);
  // -- end
}

template <typename T>
static int launch(DispatchBwdArgs a, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dispatch_bwd_kernel<T>, EX_THREADS, 0);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)dispatch_bwd_kernel<T>, dim3(per_sm * sms),
      dim3(EX_THREADS), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int launch_tc(DispatchBwdArgs a, int dtype, cudaStream_t stream) {
  const long long d = a.d, f = a.f, E = a.E_loc, ep = a.ep;
  const long long Q = (long long)a.G * ep, df = d * f;
  const ExbPlanes<T> pl = exb_planes<T>(a.scratch, a.tiles, a.d, a.f);
  if (a.tiles < 1 || (long long)a.tiles * EXB_BR > 0x7fffffffLL
      || !ex_tc_route_ok(dtype, a.d, a.f,
                         {a.buf, a.dout, a.wg, a.wu, a.wd, a.dbuf, a.dwg,
                          a.dwu, a.dwd, pl.xp, pl.dyp, pl.dg, pl.du, pl.h,
                          a.work}))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = (long long)a.tiles * EXB_BR;
  const long long wdims[5] = {f, d, E, Q, 1}, ddims[5] = {d, f, E, Q, 1};
  const long long wge[4] = {f, df, a.sg, a.sg * Q};
  const long long wue[4] = {f, df, a.su, a.su * Q};
  const long long wde[4] = {d, df, a.sd, a.sd * Q};
  const long long xdims[5] = {d, R, 1, 1, 1}, sdims[5] = {f, R, 1, 1, 1};
  const long long xe[4] = {d, R * d, R * d, R * d};
  const long long se[4] = {f, R * f, R * f, R * f};
  // each dW (Q E, d, f) or (Q E, f, d), stored by TMA
  const long long NW = Q * E;
  const long long gdims[5] = {f, d, NW, 1, 1}, vdims[5] = {d, f, NW, 1, 1};
  const long long ge[4] = {f, df, NW * df, NW * df};
  const long long ve[4] = {d, df, NW * df, NW * df};
  CUtensorMap wgm, wum, wdm, xm, dym, dgm, dum, hm, dwgm, dwum, dwdm;
  int err = ex_tc_map(&wgm, a.wg, dtype, wdims, wge, 64);
  if (err == 0) err = ex_tc_map(&wum, a.wu, dtype, wdims, wue, 64);
  if (err == 0) err = ex_tc_map(&wdm, a.wd, dtype, ddims, wde, 64);
  if (err == 0) err = ex_tc_map(&xm, pl.xp, dtype, xdims, xe, EXB_BR);
  if (err == 0) err = ex_tc_map(&dym, pl.dyp, dtype, xdims, xe, EXB_BR);
  if (err == 0) err = ex_tc_map(&dgm, pl.dg, dtype, sdims, se, EXB_BR);
  if (err == 0) err = ex_tc_map(&dum, pl.du, dtype, sdims, se, EXB_BR);
  if (err == 0) err = ex_tc_map(&hm, pl.h, dtype, sdims, se, EXB_BR);
  if (err == 0) err = ex_tc_map(&dwgm, a.dwg, dtype, gdims, ge, 64);
  if (err == 0) err = ex_tc_map(&dwum, a.dwu, dtype, gdims, ge, 64);
  if (err == 0) err = ex_tc_map(&dwdm, a.dwd, dtype, vdims, ve, 64);
  // the cooperative grid: as many blocks as fit the card at once, with the
  // route's dynamic shared memory set first
  const int smem = exb_smem_bytes();
  int blocks = 0;
  if (err == 0)
    err = ex_tc_grid(dispatch_bwd_tc_kernel<T>, smem, blocks, EXB_THREADS);
  if (err != 0) return err;
  void* args[] = {&wgm, &wum, &wdm, &xm, &dym,  &dgm, &dum,
                  &hm,  &dwgm, &dwum, &dwdm, &a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)dispatch_bwd_tc_kernel<T>, dim3(blocks), dim3(EXB_THREADS),
      args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_moe_dispatch_bwd(
    const void* buf, const void* dout, const void* wg, const void* wu,
    const void* wd, const void* counts, void* dbuf, void* dwg, void* dwu,
    void* dwd, void* xstage, void* dstage, void* ret_stage, void* scratch,
    const void* sched, void* work, long long sg, long long su, long long sd,
    int nrec, int G, int ep, int slots, int E_loc, int C, int d, int f,
    int tiles, int dtype, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // every remote block keeps its own slot until pass C has read it
  if (ep < 1 || ep > 64 || slots < ep - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DispatchBwdArgs a{buf, dout, wg, wu, wd,
                          static_cast<const int*>(counts), dbuf, dwg, dwu,
                          dwd, xstage, dstage, ret_stage, scratch,
                          static_cast<const int*>(sched), work, sg, su, sd,
                          nrec, G, ep, slots, E_loc, C, d, f, tiles};
  if (route == kRouteWgmma) {
    switch (dtype) {
      case kF16: return launch_tc<__half>(a, dtype, st);
      case kBF16: return launch_tc<__nv_bfloat16>(a, dtype, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return launch<float>(a, st);
    case kF16: return launch<__half>(a, st);
    case kBF16: return launch<__nv_bfloat16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
