// leap: one leapfrog update of the core of halo-extended slabs,
//   out = 2 u - prev + c2 * lap(u) / dx^2,
// lap = the 25-point radius-4 star (8th-order second differences per axis).
//
// Replaces wave_step_pallas (src/repro/kernels/stencil/kernel.py:65,
// pallas_call at :80, body _stencil_kernel at :30) and serves as the
// counterpart of the fused step's _leap (src/repro/kernels/stencil/
// fused.py:101): wave_step = leap(pad(u)), and the port's fused emulation
// calls leap for its interior and boundary passes.
//
// Layout: uext (B, Z + 2R, Y + 2R, X + 2R), prev / c2 / out (B, Z, Y, X),
// each with its own (batch, z, y) element strides and unit x stride, so the
// emulation hands over slices of larger tensors without copies and writes
// straight into the output's slices.  c2 is a scalar or a per-point tensor;
// no broadcast is materialized.
//
// Bound on this card: bytes.  Each point reads u, prev (and c2) once and
// writes out once: 12 B a point with a scalar c2, 12.9 GB at 1024^3, 3.85 ms
// at 3.35 TB/s.  Design: X on the 32 threads of a warp, a Y tile of 8 rows
// per block, and a Z loop inside the block.  The block stages one
// (8 + 2R) x (32 + 2R) plane tile in shared memory for the X and Y
// neighbours (STENCIL_TILE in repro_torch/kernels/plan.py), and each thread
// carries its column's 2R + 1 Z neighbours in a register queue, so every
// input value is read from device memory about (1 + 2R/8)(1 + 2R/32) times
// rather than 25 times.
#include "common.cuh"

#define R 4
#define TX 32
#define TY 8

__constant__ float kCoeffs[R + 1] = {-205.f / 72.f, 8.f / 5.f, -1.f / 5.f,
                                     8.f / 315.f, -1.f / 560.f};

__global__ void __launch_bounds__(TX* TY)
leap_kernel(const float* __restrict__ uext, long long ub, long long uz,
            long long uy, const float* __restrict__ prev, long long pb,
            long long pz, long long py, const float* __restrict__ c2,
            long long cb, long long cz, long long cy, float c2s,
            float* __restrict__ out, long long ob, long long oz,
            long long oy, int Z, int Y, int X, int bz, int zchunks,
            float dx2) {
  __shared__ float tile[TY + 2 * R][TX + 2 * R];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int b = blockIdx.z / zchunks;
  const int k0 = (blockIdx.z % zchunks) * bz;
  const int k1 = min(k0 + bz, Z);
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < X && y < Y;
  const int YE = Y + 2 * R, XE = X + 2 * R;
  const float* ub_ = uext + b * ub;
  // this thread's column of uext, at the core point (y, x)
  const float* col = ub_ + (long long)(y + R) * uy + (x + R);

  float q[2 * R + 1];  // uext planes k .. k + 2R of this column
#pragma unroll
  for (int i = 0; i < 2 * R; ++i)
    q[i] = (inside && k0 < k1) ? col[(long long)(k0 + i) * uz] : 0.f;

  for (int k = k0; k < k1; ++k) {
    q[2 * R] = inside ? col[(long long)(k + 2 * R) * uz] : 0.f;
    // stage plane k + R (the center plane) with its Y/X rim
    const float* plane = ub_ + (long long)(k + R) * uz;
    for (int i = ty * TX + tx; i < (TY + 2 * R) * (TX + 2 * R); i += TX * TY) {
      int r = i / (TX + 2 * R), c = i % (TX + 2 * R);
      int gy = y0 + r, gx = x0 + c;
      tile[r][c] = (gy < YE && gx < XE) ? plane[(long long)gy * uy + gx] : 0.f;
    }
    __syncthreads();
    if (inside) {
      const float center = tile[ty + R][tx + R];
      float lap = 3.f * kCoeffs[0] * center;
#pragma unroll
      for (int r = 1; r <= R; ++r) {
        const float c = kCoeffs[r];
        lap = lap + c * (q[R - r] + q[R + r]);
        lap = lap + c * (tile[ty + R - r][tx + R] + tile[ty + R + r][tx + R]);
        lap = lap + c * (tile[ty + R][tx + R - r] + tile[ty + R][tx + R + r]);
      }
      lap = lap / dx2;
      const float pv = prev[b * pb + (long long)k * pz + (long long)y * py + x];
      const float cv =
          c2 ? c2[b * cb + (long long)k * cz + (long long)y * cy + x] : c2s;
      out[b * ob + (long long)k * oz + (long long)y * oy + x] =
          2.f * center - pv + cv * lap;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) q[i] = q[i + 1];
  }
}

extern "C" int repro_leap(const void* uext, long long ub, long long uz,
                          long long uy, const void* prev, long long pb,
                          long long pz, long long py, const void* c2,
                          long long cb, long long cz, long long cy, float c2s,
                          void* out, long long ob, long long oz, long long oy,
                          int B, int Z, int Y, int X, int bz, float dx2,
                          void* stream) {
  const int zchunks = (Z + bz - 1) / bz;
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, B * zchunks);
  leap_kernel<<<grid, dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uext), ub, uz, uy,
      static_cast<const float*>(prev), pb, pz, py,
      static_cast<const float*>(c2), cb, cz, cy, c2s, static_cast<float*>(out),
      ob, oz, oy, Z, Y, X, bz, zchunks, dx2);
  REPRO_RETURN_LAUNCH_STATUS();
}
