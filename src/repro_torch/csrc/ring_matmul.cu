// fused_ring_allgather_matmul: the whole bidirectional all-gather ring of
// every virtual rank in ONE cooperative launch.
//
// Replaces fused_ring_allgather_matmul_tpu (src/repro/kernels/ring_matmul/
// fused.py:145, pallas_call at :155; body _fused_ring_kernel at :79).  On
// the TPU each device ran its own copy of the kernel and a put was a remote
// DMA into the neighbour's VMEM slot.  Here all n ranks live on one card:
//
// * a put is a store of the rank's current stripe into the peer rank's next
//   slot of a device-memory slot buffer (n, 2, slots, t_loc, K) — direction
//   0 (clockwise) goes to rank + 1, direction 1 to rank - 1;
// * the fence is a grid-wide barrier (cooperative launch, grid sized from
//   occupancy so every block is co-resident; a grid barrier across blocks
//   that are not co-resident deadlocks);
// * each step's GEMMs (one per rank and live direction) share the grid as
//   a list of 64 x 64 output tiles, computed by matmul.cuh's tile routine
//   into out[rank, src * t_loc : (src + 1) * t_loc].
//
// The schedule (RingPlan.schedule(): per step its compute/send flags) comes
// from the host as an int32 table, so kernel and emulation run the same
// records.  Bound on this card: operations, 2 T K N flops over all ranks
// (T = n t_loc, N = n n_loc) — 55.9 ms at 989 TFLOP/s for T = K = N = 30240
// in bf16.  The GEMM tiles run on the CUDA cores (see matmul.cuh), so this
// version is GEMM-bound far above that; the puts move 2 n t_loc K elements
// per step at memory speed and do not overlap the GEMMs of the same step
// except across blocks.  Per-peer release/acquire flags in place of the
// grid barrier are later work.
#include <cooperative_groups.h>

#include "matmul.cuh"

namespace cg = cooperative_groups;

// columns of one schedule row (repro_torch/kernels/ring_matmul/fused.py)
enum { kStepIndex = 0, kComputeCw, kComputeCcw, kSendCw, kSendCcw, kStepCols };

template <typename T>
__global__ void __launch_bounds__(MM_THREADS)
ring_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, T* __restrict__ bufs,
            const int* __restrict__ sched, int nsteps, int n, int slots,
            int t_loc, int K, int n_loc) {
  __shared__ __align__(16) MmSmem sm;
  cg::grid_group grid = cg::this_grid();
  const long long stripe = (long long)t_loc * K;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  // slot (rank, dir, slot) of the slot buffer
  auto slot_ptr = [&](int r, int dir, int s) {
    return bufs + ((long long)(r * 2 + dir) * slots + s) * stripe;
  };

  // seed both streams' slot 0 with the local stripe
  for (long long e = gtid; e < (long long)n * stripe; e += gstride) {
    int r = (int)(e / stripe);
    long long i = e % stripe;
    T v = x[e];
    slot_ptr(r, 0, 0)[i] = v;
    slot_ptr(r, 1, 0)[i] = v;
  }
  grid.sync();

  const int tiles_m = (t_loc + MM_BM - 1) / MM_BM;
  const int tiles_n = (n_loc + MM_BN - 1) / MM_BN;
  const int tiles = tiles_m * tiles_n;
  for (int st = 0; st < nsteps; ++st) {
    const int* row = sched + st * kStepCols;
    const int s = row[kStepIndex];
    const int slot = s % slots, nxt = (s + 1) % slots;
    const bool send_cw = row[kSendCw], send_ccw = row[kSendCcw];
    // put: my stripe -> the neighbour's next slot (cw to r+1, ccw to r-1)
    if (send_cw || send_ccw) {
      for (long long e = gtid; e < (long long)n * stripe; e += gstride) {
        int r = (int)(e / stripe);
        long long i = e % stripe;
        if (send_cw) slot_ptr((r + 1) % n, 0, nxt)[i] = slot_ptr(r, 0, slot)[i];
        if (send_ccw) slot_ptr((r + n - 1) % n, 1, nxt)[i] = slot_ptr(r, 1, slot)[i];
      }
    }
    // GEMMs on the current slot: job = (rank, direction)
    const int ndir = row[kComputeCw] + row[kComputeCcw];
    const long long work = (long long)n * ndir * tiles;
    for (long long wi = blockIdx.x; wi < work; wi += gridDim.x) {
      int job = (int)(wi / tiles), tile = (int)(wi % tiles);
      int r = job / ndir;
      int dir = (ndir == 2) ? job % 2 : (row[kComputeCw] ? 0 : 1);
      int src = dir == 0 ? ((r - s) % n + n) % n : (r + s) % n;
      mm_tile<T>(slot_ptr(r, dir, slot), K,
                 w + (long long)r * K * n_loc, n_loc,
                 out + ((long long)r * n * t_loc + (long long)src * t_loc) * n_loc,
                 n_loc, t_loc, n_loc, K, (tile / tiles_n) * MM_BM,
                 (tile % tiles_n) * MM_BN, sm);
    }
    grid.sync();  // fence: the next step's stripes have landed
  }
}

template <typename T>
static int launch(const void* x, const void* w, void* out, void* bufs,
                  const int* sched, int nsteps, int n, int slots, int t_loc,
                  int K, int n_loc, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<T>,
                                                MM_THREADS, 0);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  T* bp = static_cast<T*>(bufs);
  void* args[] = {&xp, &wp, &op, &bp, &sched, &nsteps, &n, &slots, &t_loc,
                  &K, &n_loc};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)ring_kernel<T>, dim3(per_sm * sms), dim3(MM_THREADS), args,
      0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_ring_matmul(const void* x, const void* w, void* out,
                                 void* bufs, const void* sched, int nsteps,
                                 int n, int slots, int t_loc, int K,
                                 int n_loc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(sched);
  switch (dtype) {
    case kF32: return launch<float>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, s);
    case kF16: return launch<__half>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, s);
    case kBF16: return launch<__nv_bfloat16>(x, w, out, bufs, sc, nsteps, n, slots, t_loc, K, n_loc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
