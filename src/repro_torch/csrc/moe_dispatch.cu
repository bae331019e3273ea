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
//   read from the int32 count table the routing built, then a barrier.
//   Blocks claim the tiles from a counter in device memory rather than
//   being dealt them round robin: at decode only a few experts hold rows,
//   and a fixed deal leaves some blocks several of their tiles while
//   others idle.
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
// work (2 ep) zeroed int64 tile counters, two a GEMM phase.
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
// n elements each, 16 bytes at a time where the blocks allow it.
template <typename T, typename Src, typename Dst>
__device__ void ring_copy(int G, int ep, long long n, Src src, Dst dst) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const long long ranks = (long long)G * ep;
  if ((n * sizeof(T)) % 16 == 0) {
    const long long nv = n * sizeof(T) / 16;
    for (long long i = gtid; i < ranks * nv; i += gstride) {
      const int q = (int)(i / nv);
      reinterpret_cast<uint4*>(dst(q / ep, q % ep))[i % nv] =
          reinterpret_cast<const uint4*>(src(q / ep, q % ep))[i % nv];
    }
  } else {
    for (long long i = gtid; i < ranks * n; i += gstride) {
      const int q = (int)(i / n);
      dst(q / ep, q % ep)[i % n] = src(q / ep, q % ep)[i % n];
    }
  }
}

// Two blocks an SM (at most 128 registers a thread): one block's loads
// wait while the other's FMAs run, and the cooperative grid is twice as
// wide.
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

template <typename T>
__global__ void __launch_bounds__(EX_THREADS, 2)
dispatch_kernel(const T* __restrict__ buf, const T* __restrict__ wg,
                const T* __restrict__ wu, const T* __restrict__ wd,
                const int* __restrict__ counts, T* __restrict__ out,
                T* __restrict__ stage, T* __restrict__ ret_stage,
                T* __restrict__ h, const int* __restrict__ sched,
                unsigned long long* __restrict__ work,
                long long sg, long long su, long long sd, int nrec, int G,
                int ep, int slots, int E_loc, int C, int d, int f) {
  __shared__ __align__(16) ExSmem sm;
  cg::grid_group grid = cg::this_grid();
  const long long blk = (long long)E_loc * C * d;
  // (g, i, j) of buf / out and (g, r, slot) of stage / ret_stage
  auto pair_off = [=](int g, int i, int j) {
    return (((long long)g * ep + i) * ep + j) * blk;
  };
  auto slot_off = [=](int g, int r, int sl) {
    return (((long long)g * ep + r) * slots + sl) * blk;
  };
  auto put = [&](int s) {  // rank r's block for r + s into its landing slot
    ring_copy<T>(G, ep, blk,
        [=](int g, int r) { return buf + pair_off(g, r, (r + s) % ep); },
        [=](int g, int r) { return stage + slot_off(g, (r + s) % ep, s % slots); });
  };
  const long long NW = (long long)G * ep * E_loc;
  unsigned long long pending = 0;  // issued puts not yet carried out, by offset
  int gemms = 0;                   // GEMM phases run so far

  for (int i = 0; i < nrec; ++i) {
    const int phase = sched[2 * i], s = sched[2 * i + 1];
    if (phase == kPut) {
      pending |= 1ull << s;
    } else if (phase == kFence) {
      for (int o = 1; o <= s; ++o)
        if (pending >> o & 1ull) { put(o); pending &= ~(1ull << o); }
      grid.sync();
    } else if (phase == kGemm) {
      for (int o = 1; o < ep; ++o)
        if (pending >> o & 1ull) { put(o); pending &= ~(1ull << o); }
      RingGet<T> get;
      if (s == 0) {  // the local block: buf[g][r][r] -> out[g][r][r]
        get.in = buf + pair_off(0, 0, 0);
        get.out = out;
        get.in_g = (long long)ep * ep * blk;
        get.in_r = (long long)(ep + 1) * blk;
      } else {       // the landed slot -> the return slot
        get.in = stage + slot_off(0, 0, s % slots);
        get.out = ret_stage + slot_off(0, 0, s % slots);
        get.in_g = (long long)ep * slots * blk;
        get.in_r = (long long)slots * blk;
      }
      get.wg = wg; get.wu = wu; get.wd = wd; get.counts = counts; get.h = h;
      get.sg = sg; get.su = su; get.sd = sd;
      get.ep = ep; get.E_loc = E_loc; get.C = C; get.d = d; get.f = f; get.s = s;
      claim_items(work + 2 * gemms, ex_gate_up_items(NW, 1, C, f),
                  [&](long long it) { gate_up_item<T>(it, 1, C, d, f, get, sm); });
      grid.sync();
      claim_items(work + 2 * gemms + 1, ex_down_items(NW, 1, C, d),
                  [&](long long it) { down_item<T>(it, 1, C, d, f, get, sm); });
      grid.sync();
      ++gemms;
    } else if (phase == kRet) {  // result for the block from r - s, home to it
      ring_copy<T>(G, ep, blk,
          [=](int g, int r) { return ret_stage + slot_off(g, r, s % slots); },
          [=](int g, int r) { return out + pair_off(g, (r - s % ep + ep) % ep, r); });
    } else if (phase == kFenceRet) {
      grid.sync();
    }
  }
}

template <typename T>
static int launch(const void* buf, const void* wg, const void* wu,
                  const void* wd, const int* counts, void* out, void* stage,
                  void* ret_stage, void* h, const int* sched, void* work,
                  long long sg,
                  long long su, long long sd, int nrec, int G, int ep,
                  int slots, int E_loc, int C, int d, int f,
                  cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dispatch_kernel<T>,
                                                EX_THREADS, 0);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const T* bp = static_cast<const T*>(buf);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  const T* dp = static_cast<const T*>(wd);
  T* op = static_cast<T*>(out);
  T* sp = static_cast<T*>(stage);
  T* rp = static_cast<T*>(ret_stage);
  T* hp = static_cast<T*>(h);
  unsigned long long* wp = static_cast<unsigned long long*>(work);
  void* args[] = {&bp, &gp, &up, &dp, &counts, &op, &sp, &rp, &hp, &sched,
                  &wp, &sg, &su, &sd, &nrec, &G, &ep, &slots, &E_loc, &C, &d,
                  &f};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)dispatch_kernel<T>, dim3(per_sm * sms), dim3(EX_THREADS),
      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_moe_dispatch(const void* buf, const void* wg,
                                  const void* wu, const void* wd,
                                  const void* counts, void* out, void* stage,
                                  void* ret_stage, void* h, const void* sched,
                                  void* work, long long sg, long long su,
                                  long long sd,
                                  int nrec, int G, int ep, int slots,
                                  int E_loc, int C, int d, int f, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  const int* sc = static_cast<const int*>(sched);
  switch (dtype) {
    case kF32: return launch<float>(buf, wg, wu, wd, c, out, stage, ret_stage, h, sc, work, sg, su, sd, nrec, G, ep, slots, E_loc, C, d, f, st);
    case kF16: return launch<__half>(buf, wg, wu, wd, c, out, stage, ret_stage, h, sc, work, sg, su, sd, nrec, G, ep, slots, E_loc, C, d, f, st);
    case kBF16: return launch<__nv_bfloat16>(buf, wg, wu, wd, c, out, stage, ret_stage, h, sc, work, sg, su, sd, nrec, G, ep, slots, E_loc, C, d, f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
