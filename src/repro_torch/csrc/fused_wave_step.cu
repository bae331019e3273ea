// fused_wave_step: one Minimod wave step over every rank of a 1-D symmetric
// Z ring, in ONE cooperative launch.
//
// Replaces fused_wave_step_tpu (src/repro/kernels/stencil/fused.py:446,
// pallas_call at :461, body _fused_stencil_kernel at :371).  On the TPU each
// device staged its whole shard in VMEM and put its R boundary planes into
// the neighbours' VMEM landing windows by remote DMA.  Here all nz ranks
// live on one card, and the step runs the plan's single-step phases:
//
//   put       every rank stores its hi planes into rank + 1's landing window
//             0 and its lo planes into rank - 1's window 1, windows
//             (nz, 2, R, Y, X) in device memory;
//   interior  rows R .. Z - R, which need no halo, computed meanwhile;
//   fence     a grid-wide barrier (cooperative launch, grid sized from
//             occupancy so every block is co-resident);
//   boundary  rows 0 .. R and Z - R .. Z from the landed windows; rank 0's
//             lo window and rank nz - 1's hi window read as zeros (Dirichlet
//             edges; the put wraps around the ring like the reference's).
//
// With overlap == 0 (a shard with no interior) every row is boundary and
// is computed after the fence.  Bound on this card: bytes, as leap's
// (u, prev, c2 read once, out written once, plus 2 * 2R planes a rank
// through the windows).  This first version reads every star point through
// L1/L2 (25 loads a point, grid-stride over points) — simple, and slower
// than wave_step.cu's staged tiles; the arithmetic order is the same.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define R 4
#define THREADS 256

__constant__ float kCoeffs[R + 1] = {-205.f / 72.f, 8.f / 5.f, -1.f / 5.f,
                                     8.f / 315.f, -1.f / 560.f};

struct Field {
  const float* u;
  const float* win;
  int nz, Z, Y, X;
  // value of rank r's halo-extended field at (z, y, x), z in [-R, Z + R)
  __device__ __forceinline__ float at(int r, int z, int y, int x) const {
    if (y < 0 || y >= Y || x < 0 || x >= X) return 0.f;
    const long long plane = (long long)Y * X;
    const long long yx = (long long)y * X + x;
    if (z < 0) {  // my lo halo: the down-neighbour's hi planes, window 0
      return r == 0 ? 0.f : win[((long long)(r * 2 + 0) * R + (z + R)) * plane + yx];
    }
    if (z >= Z) {  // my hi halo: the up-neighbour's lo planes, window 1
      return r == nz - 1 ? 0.f : win[((long long)(r * 2 + 1) * R + (z - Z)) * plane + yx];
    }
    return u[((long long)r * Z + z) * plane + yx];
  }
};

__device__ __forceinline__ void point(const Field& f, const float* prev,
                                      const float* c2, float c2s, float* out,
                                      float dx2, int r, int z, int y, int x) {
  const float center = f.at(r, z, y, x);
  float lap = 3.f * kCoeffs[0] * center;
#pragma unroll
  for (int k = 1; k <= R; ++k) {
    const float c = kCoeffs[k];
    lap = lap + c * (f.at(r, z - k, y, x) + f.at(r, z + k, y, x));
    lap = lap + c * (f.at(r, z, y - k, x) + f.at(r, z, y + k, x));
    lap = lap + c * (f.at(r, z, y, x - k) + f.at(r, z, y, x + k));
  }
  lap = lap / dx2;
  const long long i = (((long long)r * f.Z + z) * f.Y + y) * f.X + x;
  out[i] = 2.f * center - prev[i] + (c2 ? c2[i] : c2s) * lap;
}

__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const float* __restrict__ u, const float* __restrict__ prev,
                  const float* __restrict__ c2, float c2s,
                  float* __restrict__ out, float* __restrict__ win, int nz,
                  int Z, int Y, int X, int overlap, float dx2) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const long long plane = (long long)Y * X;
  const Field f{u, win, nz, Z, Y, X};

  // put: my hi planes -> up's window 0, my lo planes -> down's window 1
  for (long long e = gtid; e < (long long)nz * R * plane; e += gstride) {
    int r = (int)(e / (R * plane));
    long long rem = e % (R * plane);
    int i = (int)(rem / plane);
    long long yx = rem % plane;
    int up = (r + 1) % nz, down = (r + nz - 1) % nz;
    win[((long long)(up * 2 + 0) * R + i) * plane + yx] =
        u[((long long)r * Z + (Z - R + i)) * plane + yx];
    win[((long long)(down * 2 + 1) * R + i) * plane + yx] =
        u[((long long)r * Z + i) * plane + yx];
  }

  // interior: rows R .. Z - R from the local field alone
  if (overlap) {
    const int zi = Z - 2 * R;
    for (long long e = gtid; e < (long long)nz * zi * plane; e += gstride) {
      int r = (int)(e / (zi * plane));
      long long rem = e % (zi * plane);
      int z = R + (int)(rem / plane);
      int y = (int)((rem % plane) / X), x = (int)(rem % X);
      point(f, prev, c2, c2s, out, dx2, r, z, y, x);
    }
  }

  grid.sync();  // fence: every landing window is complete

  // boundary: the 2R edge rows (every row when there is no interior)
  const int zb = overlap ? 2 * R : Z;
  for (long long e = gtid; e < (long long)nz * zb * plane; e += gstride) {
    int r = (int)(e / (zb * plane));
    long long rem = e % (zb * plane);
    int j = (int)(rem / plane);
    int z = (overlap && j >= R) ? Z - 2 * R + j : j;
    int y = (int)((rem % plane) / X), x = (int)(rem % X);
    point(f, prev, c2, c2s, out, dx2, r, z, y, x);
  }
}

extern "C" int repro_fused_wave_step(const void* u, const void* prev,
                                     const void* c2, float c2s, void* out,
                                     void* win, int nz, int Z, int Y, int X,
                                     int overlap, float dx2, void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_step_kernel,
                                                THREADS, 0);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const float* up = static_cast<const float*>(u);
  const float* pp = static_cast<const float*>(prev);
  const float* cp = static_cast<const float*>(c2);
  float* op = static_cast<float*>(out);
  float* wp = static_cast<float*>(win);
  void* args[] = {&up, &pp, &cp, &c2s, &op, &wp, &nz, &Z, &Y, &X, &overlap,
                  &dx2};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)fused_step_kernel, dim3(per_sm * sms), dim3(THREADS), args,
      0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  REPRO_RETURN_LAUNCH_STATUS();
}
