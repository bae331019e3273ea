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
// at 3.35 TB/s.  Two routes, picked on the host by plan.stencil_route:
//
// * "tma" (f32 operands whose base pointers are 16-byte aligned, whose
//   batch / z / y strides are multiples of 4 elements and whose X is a
//   multiple of 4).  A block owns a LEAP_TY x LEAP_TX output tile and walks
//   a Z chunk on the plane ring of stencil_ring.cuh, its plane source one
//   4-D TMA map over uext; TMA's zero fill past the slab's edges stands in
//   for edge tests.  uext is read (1 + 2R / bz) times from device memory;
//   the tile's rim, (LEAP_TX + 2R)(LEAP_TY + 2R) / (LEAP_TX LEAP_TY) =
//   1.41 x its outputs, mostly from L2.
// * "simt" (every other shape): X on the 32 threads of a warp, a Y tile of
//   TY rows per block and a Z loop inside the block; the block stages one
//   (TY + 2R) x (TX + 2R) plane tile (STENCIL_TILE in plan.py) and each
//   thread carries its column's 2R + 1 Z neighbours in registers.
//
// The C entry refuses a "tma" launch off its rule.
#include "stencil_ring.cuh"

#define TX 32
#define TY 8

// route codes (plan.STENCIL_ROUTES)
enum LeapRoute { kLeapSimt = 0, kLeapTma = 1 };

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

// -- the "tma" route ------------------------------------------------------------

struct LeapArgs {
  const float* prev;
  long long pb, pz, py;
  const float* c2;  // null: the scalar c2s
  long long cb, cz, cy;
  float c2s;
  float* out;
  long long ob, oz, oy;
  int Z, Y, X, bz, zchunks;
  float dx2;
};

// leap's plane source: plane p of the chunk from k0 is uext's row k0 + p
// (uext carries the halo, so the box starts at the tile's own corner)
struct LeapSrc {
  const CUtensorMap* umap;
  int b, k0, x0, y0;
  __device__ __forceinline__ void operator()(int p, uint32_t dst,
                                             uint32_t bar) const {
    tma_load_4d(dst, umap, bar, x0, y0, k0 + p, b);
  }
};

__global__ void __launch_bounds__(LEAP_THREADS, 2)
leap_tma_kernel(const __grid_constant__ CUtensorMap umap, LeapArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const PlaneRing ring = ring_setup(smem_raw);
  const int b = blockIdx.z / a.zchunks;
  const int k0 = (blockIdx.z % a.zchunks) * a.bz;
  const int nk = min(a.bz, a.Z - k0);
  const int x0 = blockIdx.x * LEAP_TX, y0 = blockIdx.y * LEAP_TY;
  const RingOut o{a.prev + b * a.pb, a.pz, a.py,
                  a.c2 ? a.c2 + b * a.cb : nullptr, a.cz, a.cy, a.c2s,
                  a.out + b * a.ob, a.oz, a.oy, a.Y, a.X, a.dx2};
  ring_item(ring, LeapSrc{&umap, b, k0, x0, y0}, o, k0, nk, y0, x0);
}

static bool leap_attr_set[16];

static int launch_tma(const float* uext, long long ub, long long uz,
                      long long uy, const LeapArgs& a, int B,
                      cudaStream_t stream) {
  const long long strides[] = {ub, uz, uy, a.pb, a.pz, a.py, a.ob, a.oz, a.oy};
  bool ok = a.X % 4 == 0 && aligned16(uext) && aligned16(a.prev) &&
            aligned16(a.out) && (a.c2 == nullptr ||
            (aligned16(a.c2) && a.cb % 4 == 0 && a.cz % 4 == 0 && a.cy % 4 == 0));
  for (long long s : strides) ok = ok && s % 4 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const long long XE = a.X + 2 * R, YE = a.Y + 2 * R, ZE = a.Z + 2 * R;
  const long long dims[] = {XE, YE, ZE, B};
  // a lone batch's stride is never stepped; any 16-byte multiple will do
  const long long st[] = {4 * uy, 4 * uz, 4 * (B > 1 ? ub : ZE * uz)};
  const int box[] = {kW, kH, 1, 1};
  CUtensorMap umap;
  int err = f32_map_nd(&umap, uext, 4, dims, st, box);
  if (err != 0) return err;
  err = ring_smem_once(leap_tma_kernel, leap_attr_set);
  if (err != 0) return err;
  dim3 grid((a.X + LEAP_TX - 1) / LEAP_TX, (a.Y + LEAP_TY - 1) / LEAP_TY,
            B * a.zchunks);
  leap_tma_kernel<<<grid, LEAP_THREADS, leap_tma_smem_bytes(), stream>>>(umap,
                                                                         a);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_leap(const void* uext, long long ub, long long uz,
                          long long uy, const void* prev, long long pb,
                          long long pz, long long py, const void* c2,
                          long long cb, long long cz, long long cy, float c2s,
                          void* out, long long ob, long long oz, long long oy,
                          int B, int Z, int Y, int X, int bz, float dx2,
                          int route, void* stream) {
  const int zchunks = (Z + bz - 1) / bz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kLeapTma) {
    LeapArgs a{static_cast<const float*>(prev), pb, pz, py,
               static_cast<const float*>(c2), cb, cz, cy, c2s,
               static_cast<float*>(out), ob, oz, oy, Z, Y, X, bz, zchunks,
               dx2};
    return launch_tma(static_cast<const float*>(uext), ub, uz, uy, a, B, s);
  }
  if (route != kLeapSimt) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, B * zchunks);
  leap_kernel<<<grid, dim3(TX, TY), 0, s>>>(
      static_cast<const float*>(uext), ub, uz, uy,
      static_cast<const float*>(prev), pb, pz, py,
      static_cast<const float*>(c2), cb, cz, cy, c2s, static_cast<float*>(out),
      ob, oz, oy, Z, Y, X, bz, zchunks, dx2);
  REPRO_RETURN_LAUNCH_STATUS();
}
