// fused_moe_dispatch: the dropless expert-parallel dispatch ring of every
// virtual rank — one-sided puts of the routed blocks, the grouped expert
// MLP on each landed block, and the one-sided return of each result — in
// ONE cooperative launch.
//
// Replaces fused_moe_dispatch_tpu (src/repro/kernels/moe_dispatch/fused.py:
// 263, pallas_call at :284; body _fused_dispatch_kernel at :199).  On the
// TPU each device ran its own copy of the kernel, and a put was a remote
// DMA into the peer's VMEM slot.  Here all ranks live on one card:
//
// * a put is a store of rank r's wire block for rank r + s into rank
//   (r + s)'s landing slot s % slots of a device-memory slot buffer; the
//   return ("ret") is a store of rank r's result for the block from r - s
//   into out[r - s][r], the source's home-rank-major return layout;
// * a fence is a grid-wide barrier (cooperative launch, grid sized from
//   occupancy so every block is co-resident).  A put is issued where the
//   schedule puts it and carried out by the blocks before the next phase
//   that needs it: a fence for offset s completes every put of offset <= s
//   first, and the puts still pending at a GEMM (the overlapped schedule's
//   put of s + 1) are copied by the same blocks that then run the GEMM
//   tiles, so they overlap it;
// * each "gemm" phase runs expert_mlp.cuh's tile routines over every
//   rank's landed block, with each (source, expert) block's live-row count
//   read from the int32 count table the routing built, the gate/up pass, a
//   barrier, the down pass, a barrier.  On the tensor-core route
//   (dispatch_tc_kernel, the route of expert_mlp.cuh's rule) the grid first
//   builds each GEMM phase's list of row tiles with live rows (one block a
//   phase, then a barrier); a pass deals out only those items, all of one
//   cost, and the down pass first writes every row past its count as
//   zeros.  The weight maps (over the rank-strided views), the landed
//   blocks' maps (the local blocks of buf and the landing slots) and h's
//   map are built once a launch.  Landed blocks and h are written by
//   generic stores and read by TMA: every thread fences the async proxy
//   after those stores and after each barrier.  On the CUDA-core route
//   (dispatch_kernel, f32 and shapes off the rule) blocks claim the tiles
//   from a counter in device memory rather than being dealt them round
//   robin: at decode only a few experts hold rows, and a fixed deal leaves
//   some blocks several of their tiles while others idle.
//
// The schedule (AllToAllPlan.schedule()) reaches the kernel as an int32
// table of (phase, offset) records, so the kernel and the emulation run
// the same records.  The puts move whole padded blocks (E_loc x C x d), the
// bytes the communicator and the RMA tracker log.  Bound on this card: the
// grouped MLP's (see expert_mlp.cuh); the puts and returns add 2 (ep - 1)
// padded blocks a rank of reads and writes at memory speed.
//
// Layout: buf, out (G, ep_src, ep_dst, E_loc, C, d); wg, wu (G, ep, E_loc,
// d, f); wd (G, ep, E_loc, f, d), each rank's experts contiguous and the
// ranks sg, su, sd elements apart; counts (G, ep_src, ep_dst, E_loc) int32;
// stage, ret_stage (G, ep, slots, E_loc, C, d); h (G, ep, E_loc, C, f);
// work: on the CUDA-core route (2 ep) zeroed int64 tile counters, two a
// GEMM phase; on the tensor-core route ep lists of ex_tc_list_len(G ep
// E_loc, C) int32, one a GEMM phase.
#include <cooperative_groups.h>

#include "expert_mlp.cuh"

namespace cg = cooperative_groups;

// phase codes of a schedule record (repro_torch/kernels/moe_dispatch/fused.py)
enum { kPut = 0, kFence = 1, kGemm = 2, kRet = 3, kFenceRet = 4 };

template <typename T>
struct RingGet {
  const T* in;    // rank (g, r)'s input block: in + g * in_g + r * in_r
  long long in_g, in_r;
  T* out;         // its result block, same strides
  const T* wg;
  const T* wu;
  const T* wd;
  const int* counts;
  T* h;
  long long sg, su, sd;
  int ep, E_loc, C, d, f, s;

  // weight set wp = (g * ep + r) * E_loc + e: rank r's expert e
  __device__ ExProblem<T> operator()(long long wp, int) const {
    const long long q = wp / E_loc;
    const int e = (int)(wp % E_loc);
    const int r = (int)(q % ep), g = (int)(q / ep);
    const int src = (r - s % ep + ep) % ep;  // the block landed from r - s
    const long long blk = (long long)e * C * d;
    ExProblem<T> p;
    p.x = in + g * in_g + r * in_r + blk;
    p.y = out + g * in_g + r * in_r + blk;
    p.h = h + wp * C * f;
    p.wg = wg + q * sg + (long long)e * d * f;
    p.wu = wu + q * su + (long long)e * d * f;
    p.wd = wd + q * sd + (long long)e * f * d;
    const int live = counts[(((long long)g * ep + src) * ep + r) * E_loc + e];
    p.live = min(max(live, 0), C);
    return p;
  }
};

// dst[q] <- src[q] for every rank q = (g, r) of a phase: G * ep blocks of
// n elements each, 16 bytes at a time where the blocks allow it, with
// COPY_UNROLL loads of each thread in flight before its stores (a grid of
// one 160-thread block an SM needs them to keep HBM busy).
constexpr int COPY_UNROLL = 8;

template <typename T, typename Src, typename Dst>
__device__ void ring_copy(int G, int ep, long long n, Src src, Dst dst) {
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

// Runs items [0, total) claimed one at a time from *counter by every block
// until none is left.
template <typename Run>
__device__ void claim_items(unsigned long long* counter, long long total,
                            Run run) {
  __shared__ unsigned long long next;
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(counter, 1ull);
    __syncthreads();
    const long long it = (long long)next;
    __syncthreads();
    if (it >= total) return;
    run(it);
  }
}

struct DispatchArgs {
  const void* buf;
  const void* wg;
  const void* wu;
  const void* wd;
  const int* counts;
  void* out;
  void* stage;
  void* ret_stage;
  void* h;
  const int* sched;
  void* work;
  long long sg, su, sd;
  int nrec, G, ep, slots, E_loc, C, d, f;
};

// The problems of GEMM phase s: the local block buf[g][r][r] -> out[g][r][r]
// (s = 0) or the landed slot -> the return slot.
template <typename T>
__device__ RingGet<T> ring_get(const DispatchArgs& a, int s) {
  const long long blk = (long long)a.E_loc * a.C * a.d;
  RingGet<T> get;
  if (s == 0) {
    get.in = static_cast<const T*>(a.buf);
    get.out = static_cast<T*>(a.out);
    get.in_g = (long long)a.ep * a.ep * blk;
    get.in_r = (long long)(a.ep + 1) * blk;
  } else {
    const long long slot = (long long)(s % a.slots) * blk;
    get.in = static_cast<const T*>(a.stage) + slot;
    get.out = static_cast<T*>(a.ret_stage) + slot;
    get.in_g = (long long)a.ep * a.slots * blk;
    get.in_r = (long long)a.slots * blk;
  }
  get.wg = static_cast<const T*>(a.wg);
  get.wu = static_cast<const T*>(a.wu);
  get.wd = static_cast<const T*>(a.wd);
  get.counts = a.counts;
  get.h = static_cast<T*>(a.h);
  get.sg = a.sg; get.su = a.su; get.sd = a.sd;
  get.ep = a.ep; get.E_loc = a.E_loc; get.C = a.C; get.d = a.d; get.f = a.f;
  get.s = s;
  return get;
}

// The schedule, record by record, on every thread of the grid; gemm(s,
// get) runs GEMM phase s over the problems get describes.  The landed
// blocks are read by TMA on the tensor-core route, so every thread fences
// the async proxy after its puts and after each fence's barrier.
template <typename T, typename Gemm>
__device__ void walk_schedule(const DispatchArgs& a, cg::grid_group& grid,
                              Gemm gemm) {
  const int ep = a.ep, slots = a.slots;
  const long long blk = (long long)a.E_loc * a.C * a.d;
  const T* buf = static_cast<const T*>(a.buf);
  T* out = static_cast<T*>(a.out);
  T* stage = static_cast<T*>(a.stage);
  const T* ret_stage = static_cast<const T*>(a.ret_stage);
  // (g, i, j) of buf / out and (g, r, slot) of stage / ret_stage
  auto pair_off = [=](int g, int i, int j) {
    return (((long long)g * ep + i) * ep + j) * blk;
  };
  auto slot_off = [=](int g, int r, int sl) {
    return (((long long)g * ep + r) * slots + sl) * blk;
  };
  auto put = [&](int s) {  // rank r's block for r + s into its landing slot
    ring_copy<T>(a.G, ep, blk,
        [=](int g, int r) { return buf + pair_off(g, r, (r + s) % ep); },
        [=](int g, int r) { return stage + slot_off(g, (r + s) % ep, s % slots); });
  };
  unsigned long long pending = 0;  // issued puts not yet carried out, by offset

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
      gemm(s, ring_get<T>(a, s));
    } else if (phase == kRet) {  // result for the block from r - s, home to it
      ring_copy<T>(a.G, ep, blk,
          [=](int g, int r) { return ret_stage + slot_off(g, r, s % slots); },
          [=](int g, int r) { return out + pair_off(g, (r - s % ep + ep) % ep, r); });
    } else if (phase == kFenceRet) {
      grid.sync();
    }
  }
}

// CUDA-core route.  Two blocks an SM (at most 128 registers a thread): one
// block's loads wait while the other's FMAs run, and the cooperative grid
// is twice as wide.
template <typename T>
__global__ void __launch_bounds__(EX_THREADS, 2)
dispatch_kernel(DispatchArgs a) {
  __shared__ __align__(16) ExSmem sm;
  cg::grid_group grid = cg::this_grid();
  const long long NW = (long long)a.G * a.ep * a.E_loc;
  const int C = a.C, d = a.d, f = a.f;
  unsigned long long* work = static_cast<unsigned long long*>(a.work);
  int gemms = 0;  // GEMM phases run so far
  walk_schedule<T>(a, grid, [&](int, const RingGet<T>& get) {
    claim_items(work + 2 * gemms, ex_gate_up_items(NW, 1, C, f),
                [&](long long it) { gate_up_item<T>(it, 1, C, d, f, get, sm); });
    grid.sync();
    claim_items(work + 2 * gemms + 1, ex_down_items(NW, 1, C, d),
                [&](long long it) { down_item<T>(it, 1, C, d, f, get, sm); });
    grid.sync();
    ++gemms;
  });
}

// Item (entry, column tile) of a tensor-core pass of GEMM phase get.s:
// entry = wp * MT + row tile.  The weight maps are (cols, K, E_loc, G ep,
// 1); the gate/up pass reads x through the local map (d, C, E_loc, ep, G)
// at s = 0 or the landing slots' map (d, C, E_loc, slots, G ep), the down
// pass h through its map (f, C, E_loc, ep, G).
template <typename T>
struct RingTc {
  RingGet<T> get;
  int MT, slots;
  bool up;  // the gate/up pass (h out), else the down pass (y out)
  __device__ ExTcJob<T> operator()(int entry, int ntile) const {
    const long long wp = entry / MT;
    const ExProblem<T> pr = get(wp, 0);
    const int q = (int)(wp / get.E_loc);
    ExTcJob<T> j;
    j.e = (int)(wp % get.E_loc);
    j.wq = q;
    const bool slot = up && get.s != 0;
    j.c3 = slot ? get.s % slots : q % get.ep;
    j.c4 = slot ? q : q / get.ep;
    j.row0 = (entry % MT) * EX_TC_BR;
    j.rows = min(pr.live - j.row0, EX_TC_BR);
    j.n = ex_tc_n(j.rows);
    j.col0 = ntile * EX_TC_BM;
    j.ld = up ? get.f : get.d;
    j.out = (up ? pr.h : pr.y) + j.row0 * j.ld + j.col0;
    return j;
  }
};

// Tensor-core route: one block an SM (the stages take 193 KiB).
template <typename T>
__global__ void __launch_bounds__(EX_TC_THREADS, 1)
dispatch_tc_kernel(const __grid_constant__ CUtensorMap wgm,
                   const __grid_constant__ CUtensorMap wum,
                   const __grid_constant__ CUtensorMap wdm,
                   const __grid_constant__ CUtensorMap xlm,
                   const __grid_constant__ CUtensorMap xsm,
                   const __grid_constant__ CUtensorMap hm, DispatchArgs a) {
  extern __shared__ unsigned char smem[];
  const ExTcSmem sm = ex_tc_smem_init(smem, 2);
  cg::grid_group grid = cg::this_grid();
  const long long NW = (long long)a.G * a.ep * a.E_loc;
  const long long len = ex_tc_list_len(NW, a.C);
  const int MT = (a.C + EX_TC_BR - 1) / EX_TC_BR;
  int* lists = static_cast<int*>(a.work);
  for (int s = blockIdx.x; s < a.ep; s += gridDim.x) {  // a block a phase
    const RingGet<T> get = ring_get<T>(a, s);
    ex_tc_build_list(NW, a.C, [&](long long wp) { return get(wp, 0).live; },
                     lists + s * len);
  }
  grid.sync();
  ExTcPipe pipe;
  const long long warp = (long long)blockIdx.x * (EX_TC_CONSUMERS / 32)
                         + threadIdx.x / 32;
  const long long warps = (long long)gridDim.x * (EX_TC_CONSUMERS / 32);
  walk_schedule<T>(a, grid, [&](int s, const RingGet<T>& get) {
    const int* list = lists + s * len;
    ex_tc_pass<T, 2>(sm, pipe, list, a.f / EX_TC_BM, a.d / EX_TC_BK, &wgm,
                     &wum, s == 0 ? &xlm : &xsm,
                     RingTc<T>{get, MT, a.slots, true});
    fence_proxy_async_global();  // h, before the down pass reads it by TMA
    grid.sync();
    fence_proxy_async_global();
    if (threadIdx.x < EX_TC_CONSUMERS)
      ex_zero_dead_rows<T>(NW, a.C, a.d, [&](long long wp, int& live) {
        const ExProblem<T> p = get(wp, 0);
        live = p.live;
        return p.y;
      }, warp, warps);
    ex_tc_pass<T, 1>(sm, pipe, list, a.d / EX_TC_BM, a.f / EX_TC_BK, &wdm,
                     nullptr, &hm, RingTc<T>{get, MT, a.slots, false});
    grid.sync();
    fence_proxy_async_global();
  });
}

template <typename T>
static int launch(DispatchArgs a, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dispatch_kernel<T>,
                                                EX_THREADS, 0);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)dispatch_kernel<T>, dim3(per_sm * sms), dim3(EX_THREADS),
      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int launch_tc(DispatchArgs a, int dtype, cudaStream_t stream) {
  if (!ex_tc_route_ok(dtype, a.d, a.f, {a.buf, a.wg, a.wu, a.wd, a.out,
                                        a.stage, a.ret_stage, a.h, a.work}))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long C = a.C, d = a.d, f = a.f, E = a.E_loc, ep = a.ep;
  const long long Q = (long long)a.G * ep, blk = E * C * d, df = d * f;
  const long long wdims[5] = {f, d, E, Q, 1}, ddims[5] = {d, f, E, Q, 1};
  const long long wge[4] = {f, df, a.sg, a.sg * Q};
  const long long wue[4] = {f, df, a.su, a.su * Q};
  const long long wde[4] = {d, df, a.sd, a.sd * Q};
  const long long xldims[5] = {d, C, E, ep, a.G};
  const long long xle[4] = {d, C * d, (ep + 1) * blk, ep * ep * blk};
  const long long xsdims[5] = {d, C, E, a.slots, Q};
  const long long xse[4] = {d, C * d, blk, a.slots * blk};
  const long long hdims[5] = {f, C, E, ep, a.G};
  const long long he[4] = {f, C * f, E * C * f, ep * E * C * f};
  CUtensorMap wgm, wum, wdm, xlm, xsm, hm;
  int err = ex_tc_map(&wgm, a.wg, dtype, wdims, wge, EX_TC_BK);
  if (err == 0) err = ex_tc_map(&wum, a.wu, dtype, wdims, wue, EX_TC_BK);
  if (err == 0) err = ex_tc_map(&wdm, a.wd, dtype, ddims, wde, EX_TC_BK);
  if (err == 0) err = ex_tc_map(&xlm, a.buf, dtype, xldims, xle, 8);
  if (err == 0) err = ex_tc_map(&xsm, a.stage, dtype, xsdims, xse, 8);
  if (err == 0) err = ex_tc_map(&hm, a.h, dtype, hdims, he, 8);
  // the cooperative grid: as many blocks as fit the card at once, with the
  // route's dynamic shared memory set first
  const int smem = ex_tc_smem_bytes(2);
  int blocks = 0;
  if (err == 0) err = ex_tc_grid(dispatch_tc_kernel<T>, smem, blocks);
  if (err != 0) return err;
  void* args[] = {&wgm, &wum, &wdm, &xlm, &xsm, &hm, &a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)dispatch_tc_kernel<T>, dim3(blocks), dim3(EX_TC_THREADS),
      args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_moe_dispatch(const void* buf, const void* wg,
                                  const void* wu, const void* wd,
                                  const void* counts, void* out, void* stage,
                                  void* ret_stage, void* h, const void* sched,
                                  void* work, long long sg, long long su,
                                  long long sd, int nrec, int G, int ep,
                                  int slots, int E_loc, int C, int d, int f,
                                  int dtype, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DispatchArgs a{buf, wg, wu, wd, static_cast<const int*>(counts), out,
                       stage, ret_stage, h, static_cast<const int*>(sched),
                       work, sg, su, sd, nrec, G, ep, slots, E_loc, C, d, f};
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
