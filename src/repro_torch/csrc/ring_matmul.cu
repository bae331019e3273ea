// fused_ring_allgather_matmul: the whole bidirectional all-gather ring of
// every virtual rank in ONE cooperative launch.
//
// Replaces fused_ring_allgather_matmul_tpu (src/repro/kernels/ring_matmul/
// fused.py:145, pallas_call at :155; body _fused_ring_kernel at :79).  On
// the TPU each device ran its own copy of the kernel and a put was a remote
// DMA into the neighbour's VMEM slot.  Here all n ranks live on one card:
//
// * a put is a store of the stripe a rank holds into the peer rank's next
//   slot of a device-memory slot buffer (n, 2, slots, t_loc, K) — direction
//   0 (clockwise) goes to rank + 1, direction 1 to rank - 1.  At step 0 a
//   rank holds its own stripe of x, which it computes from and sends
//   directly: nothing is copied into slot 0 first;
// * the fence is a grid-wide barrier (cooperative launch, grid sized from
//   occupancy at the shared memory the route asks for, so every block is
//   co-resident; a grid barrier across blocks that are not co-resident
//   deadlocks);
// * each step's GEMMs (one per rank and live direction) share the grid as
//   a list of output tiles, computed by matmul.cuh's tile routines into
//   out[rank, src * t_loc : (src + 1) * t_loc].
//
// The schedule (RingPlan.schedule(): per step its compute/send flags) comes
// from the host as an int32 table, so kernel and emulation run the same
// records.  Bound on this card: operations, 2 T K N flops over all ranks
// (T = n t_loc, N = n n_loc) — 55.9 ms at 989 TFLOP/s for T = K = N = 30240
// in bf16.  The route follows matmul.cuh's rule (K and n_loc for the
// pitches; x, w and the slots for the pointers):
//
// * tensor cores: the tiles run through matmul.cuh's TMA + wgmma pipeline
//   in persistent 2-CTA clusters (cooperative cluster launch: every
//   cluster the card holds at once), a cluster's two CTAs on adjacent M
//   tiles of one job sharing its B tile; x, the slots and w are 3-D tensor
//   maps (depth = rank, or rank x direction x slot) whose boxes are one
//   stripe deep, so a tile's rows past t_loc read zeros, never the next
//   stripe.  The puts are generic stores and the next step reads those
//   slots through TMA, so every thread fences the async proxy after its
//   puts and before the grid barrier, and again after it.  The pipeline's
//   stage and phase carry from one step to the next;
// * CUDA cores: f32 and 16-bit shapes off the rule, matmul.cuh's mm_tile
//   per tile (its cp.async ring in the block's dynamic shared memory).
//
// The puts move up to 2 n t_loc K elements per step, before the step's
// GEMMs; they overlap them only across blocks.  Per-peer
// release/acquire flags in place of the grid barrier are later work.
#include <cooperative_groups.h>

#include "matmul.cuh"

namespace cg = cooperative_groups;

// columns of one schedule row (repro_torch/kernels/ring_matmul/fused.py)
enum { kStepIndex = 0, kComputeCw, kComputeCcw, kSendCw, kSendCcw, kStepCols };

// The ring's buffers: the stripe (rank, direction) holds at step s is its
// own x at step 0 and slot s % slots of the slot buffer after that.
template <typename T>
struct Ring {
  const T* x;
  T* bufs;
  int n, slots;
  long long stripe;  // t_loc * K elements
  __device__ T* slot(int r, int dir, int s) const {
    return bufs + ((long long)(r * 2 + dir) * slots + s) * stripe;
  }
  __device__ const T* held(int r, int dir, int s) const {
    return s == 0 ? x + r * stripe : slot(r, dir, s % slots);
  }
  // depth of (r, dir, slot) in the slot buffer's tensor map
  __device__ int slot_depth(int r, int dir, int s) const {
    return (r * 2 + dir) * slots + s % slots;
  }
};

// One GEMM of a step: rank r multiplies the stripe it holds in direction
// dir, which rank src owns.
struct RingJob {
  int r, dir, src;
};

__device__ __forceinline__ RingJob ring_job(const int* row, int job, int n) {
  const int s = row[kStepIndex];
  const int ndir = row[kComputeCw] + row[kComputeCcw];
  RingJob j;
  j.r = job / ndir;
  j.dir = (ndir == 2) ? job % 2 : (row[kComputeCw] ? 0 : 1);
  j.src = j.dir == 0 ? ((j.r - s) % n + n) % n : (j.r + s) % n;
  return j;
}

// put: every rank's held stripe -> the neighbour's next slot (cw to r + 1,
// ccw to r - 1), V-sized words at a time over the whole grid, kPutDepth
// words a thread in flight so that the copy keeps HBM busy.
constexpr int kPutDepth = 4;

template <typename V, typename T>
__device__ __forceinline__ void put_words(const Ring<T>& ring,
                                          const int* row) {
  const int s = row[kStepIndex], nxt = (s + 1) % ring.slots, n = ring.n;
  const long long words = ring.stripe * (long long)sizeof(T) / sizeof(V);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (int dir = 0; dir < 2; ++dir) {
    if (!row[dir == 0 ? kSendCw : kSendCcw]) continue;
    for (int r = 0; r < n; ++r) {
      const V* src = reinterpret_cast<const V*>(ring.held(r, dir, s));
      V* dst = reinterpret_cast<V*>(
          ring.slot((r + (dir == 0 ? 1 : n - 1)) % n, dir, nxt));
      for (long long i0 = tid; i0 < words; i0 += kPutDepth * nthreads) {
        V v[kPutDepth];
#pragma unroll
        for (int u = 0; u < kPutDepth; ++u)
          if (i0 + u * nthreads < words) v[u] = src[i0 + u * nthreads];
#pragma unroll
        for (int u = 0; u < kPutDepth; ++u)
          if (i0 + u * nthreads < words) dst[i0 + u * nthreads] = v[u];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void ring_puts(const Ring<T>& ring,
                                          const int* row) {
  if (!row[kSendCw] && !row[kSendCcw]) return;
  // 16-byte words where every stripe starts and ends on one
  if ((ring.stripe * sizeof(T)) % 16 == 0
      && reinterpret_cast<uintptr_t>(ring.x) % 16 == 0
      && reinterpret_cast<uintptr_t>(ring.bufs) % 16 == 0)
    put_words<int4>(ring, row);
  else
    put_words<T>(ring, row);
}

template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
ring_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, T* __restrict__ bufs,
            const int* __restrict__ sched, int nsteps, int n, int slots,
            int t_loc, int K, int n_loc) {
  extern __shared__ __align__(16) float mm_smem[];
  cg::grid_group grid = cg::this_grid();
  const Ring<T> ring{x, bufs, n, slots, (long long)t_loc * K};
  const int tiles_n = (n_loc + MM_BN - 1) / MM_BN;
  const int tiles = ((t_loc + MM_BM - 1) / MM_BM) * tiles_n;
  for (int st = 0; st < nsteps; ++st) {
    const int* row = sched + st * kStepCols;
    const int s = row[kStepIndex];
    ring_puts(ring, row);
    const long long work =
        (long long)n * (row[kComputeCw] + row[kComputeCcw]) * tiles;
    for (long long wi = blockIdx.x; wi < work; wi += gridDim.x) {
      const RingJob j = ring_job(row, (int)(wi / tiles), n);
      const int tile = (int)(wi % tiles);
      mm_tile<T>(ring.held(j.r, j.dir, s), K,
                 w + (long long)j.r * K * n_loc, n_loc,
                 out + ((long long)j.r * n + j.src) * t_loc * n_loc, n_loc,
                 t_loc, n_loc, K, (tile / tiles_n) * MM_BM,
                 (tile % tiles_n) * MM_BN, mm_smem);
    }
    grid.sync();  // fence: the next step's stripes have landed
  }
}

template <typename T>
__global__ void __launch_bounds__(TC_THREADS, 1)
ring_tc_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap slotmap,
               const __grid_constant__ CUtensorMap wmap,
               const T* __restrict__ x, T* __restrict__ out,
               T* __restrict__ bufs, const int* __restrict__ sched,
               int nsteps, int n, int slots, int t_loc, int K, int n_loc) {
  extern __shared__ unsigned char smem[];
  const TcSmem sm = tc_smem_init(smem);
  cg::grid_group grid = cg::this_grid();
  const Ring<T> ring{x, bufs, n, slots, (long long)t_loc * K};
  const int tiles_m = (t_loc + TC_BM - 1) / TC_BM;
  const int tiles_n = (n_loc + TC_BN - 1) / TC_BN;
  const int pairs = tc_pairs(tiles_m, tiles_n);
  const int nk = (K + TC_BK - 1) / TC_BK;
  const int first = blockIdx.x / TC_CLUSTER, step = gridDim.x / TC_CLUSTER;
  TcPipe pipe;
  for (int st = 0; st < nsteps; ++st) {
    const int* row = sched + st * kStepCols;
    const int s = row[kStepIndex];
    ring_puts(ring, row);
    fence_proxy_async_global();  // the puts, before TMA reads them
    // a cluster's two CTAs walk the same (job, tile pair) items
    const int work = n * (row[kComputeCw] + row[kComputeCcw]) * pairs;
    if (threadIdx.x == TC_CONSUMERS) {
      for (int wi = first; wi < work; wi += step) {
        const RingJob j = ring_job(row, wi / pairs, n);
        int m0, n0;
        tc_tile_origin(wi % pairs, tiles_m, tiles_n, m0, n0);
        if (s == 0)
          tc_load_tile(sm, pipe, &xmap, j.r, &wmap, j.r, m0, n0, nk);
        else
          tc_load_tile(sm, pipe, &slotmap, ring.slot_depth(j.r, j.dir, s),
                       &wmap, j.r, m0, n0, nk);
      }
    } else if (threadIdx.x < TC_CONSUMERS) {
      for (int wi = first; wi < work; wi += step) {
        const RingJob j = ring_job(row, wi / pairs, n);
        int m0, n0;
        tc_tile_origin(wi % pairs, tiles_m, tiles_n, m0, n0);
        tc_mma_tile<T>(sm, pipe, nk,
                       out + (((long long)j.r * n + j.src) * t_loc + m0)
                                 * n_loc + n0,
                       n_loc, t_loc - m0, n_loc - n0);
      }
    }
    grid.sync();  // fence: the next step's stripes have landed
    fence_proxy_async_global();
  }
  cluster_sync();  // the peer's last arrivals have landed before either exits
}

template <typename T>
static int launch_simt(const void* x, const void* w, void* out, void* bufs,
                       const int* sched, int nsteps, int n, int slots,
                       int t_loc, int K, int n_loc, cudaStream_t stream) {
  // the cooperative grid: as many blocks as fit the card at once
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int smem = mm_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<T>,
                                                    MM_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  T* bp = static_cast<T*>(bufs);
  void* args[] = {&xp, &wp, &op, &bp, &sched, &nsteps, &n, &slots, &t_loc,
                  &K, &n_loc};
  e = cudaLaunchCooperativeKernel((const void*)ring_kernel<T>,
                                  dim3(per_sm * sms), dim3(MM_THREADS), args,
                                  smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int launch_tc(const void* x, const void* w, void* out, void* bufs,
                     const int* sched, int nsteps, int n, int slots,
                     int t_loc, int K, int n_loc, int dtype,
                     cudaStream_t stream) {
  if (!tc_route_ok(dtype, K, n_loc, {x, w, bufs}))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, slotmap, wmap;
  int err = tc_map(&xmap, x, dtype, n, t_loc, K, TC_BM);
  if (err == 0)
    err = tc_map(&slotmap, bufs, dtype, (long long)n * 2 * slots, t_loc, K,
                 TC_BM);
  if (err == 0) err = tc_map(&wmap, w, dtype, n, K, n_loc, TC_BK);
  if (err != 0) return err;
  // every cluster the card holds at once: they sync as one grid
  TcLaunch launch(ring_tc_kernel<T>, stream, true);
  err = launch.size();
  if (err != 0) return err;
  cudaError_t e = cudaLaunchKernelEx(
      &launch.cfg, ring_tc_kernel<T>, xmap, slotmap, wmap,
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<T*>(bufs),
      sched, nsteps, n, slots, t_loc, K, n_loc);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_ring_matmul(const void* x, const void* w, void* out,
                                 void* bufs, const void* sched, int nsteps,
                                 int n, int slots, int t_loc, int K,
                                 int n_loc, int dtype, int route,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(sched);
  if (route == kRouteWgmma) {
    switch (dtype) {
      case kF16: return launch_tc<__half>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, dtype, s);
      case kBF16: return launch_tc<__nv_bfloat16>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, dtype, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return launch_simt<float>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, s);
    case kF16: return launch_simt<__half>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, s);
    case kBF16: return launch_simt<__nv_bfloat16>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
