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
//   multiple of 4: Minimod's every launch).  A block owns a LEAP_TY x
//   LEAP_TX output tile and walks a Z chunk.  One producer thread keeps a
//   ring of LEAP_STAGES plane tiles of (LEAP_TY + 2R) x (LEAP_TX + 2R)
//   fed by TMA 4-D box loads of uext, one mbarrier a stage for the landing
//   and one for the release; TMA's zero fill past the slab's edges stands
//   in for edge tests.  A plane staged as the newest stays resident until
//   it is the centre plane (R + 1 planes), and the producer refills a stage
//   as soon as every warp has released it, so two to three planes are in
//   flight ahead of the one being computed.  Each thread owns 2 (Y) x 4 (X)
//   outputs and carries their 2R + 1 Z neighbours in a register queue fed
//   from the newest staged plane (the Z loop is unrolled by 2R + 1 so the
//   queue rotates by renaming, not by moves); X and Y neighbours are
//   16-byte shared-memory loads from the centre plane.  prev, c2 and out
//   move as 16-byte vectors.  uext is read (1 + 2R / bz) times from device
//   memory; the tile's rim, (LEAP_TX + 2R)(LEAP_TY + 2R) / (LEAP_TX
//   LEAP_TY) = 1.41 x its outputs, mostly from L2.
// * "simt" (every other shape): X on the 32 threads of a warp, a Y tile of
//   TY rows per block and a Z loop inside the block; the block stages one
//   (TY + 2R) x (TX + 2R) plane tile (STENCIL_TILE in plan.py) and each
//   thread carries its column's 2R + 1 Z neighbours in registers.
//
// The C entry refuses a "tma" launch off its rule.
#include "hopper.cuh"

#define R 4
#define TX 32
#define TY 8
#define LEAP_TX 64
#define LEAP_TY 32
#define LEAP_STAGES 8
#define LEAP_THREADS 256

// route codes (plan.STENCIL_ROUTES)
enum LeapRoute { kLeapSimt = 0, kLeapTma = 1 };

constexpr int kW = LEAP_TX + 2 * R;     // a staged plane tile's row (floats)
constexpr int kH = LEAP_TY + 2 * R;     // its rows
constexpr int kPlane = kW * kH;         // floats
constexpr int kQ = 2 * R + 1;           // the Z queue's planes

// Dynamic shared memory of a "tma"-route block: the alignment slack, the
// plane ring and its full and empty mbarriers.
__host__ __device__ inline int leap_tma_smem_bytes() {
  return 128 + LEAP_STAGES * (LEAP_TY + 2 * R) * (LEAP_TX + 2 * R) * 4
         + 16 * LEAP_STAGES;
}

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

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void put4(float (&d)[4], float4 v) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// adds c * v into the four lanes of acc
__device__ __forceinline__ void axpy4(float (&acc)[4], float c, float4 v) {
  acc[0] = fmaf(c, v.x, acc[0]);
  acc[1] = fmaf(c, v.y, acc[1]);
  acc[2] = fmaf(c, v.z, acc[2]);
  acc[3] = fmaf(c, v.w, acc[3]);
}

__global__ void __launch_bounds__(LEAP_THREADS, 2)
leap_tma_kernel(const __grid_constant__ CUtensorMap umap, LeapArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 127) & ~127u) - raw;
  float* planes = reinterpret_cast<float*>(smem_raw + pad);
  const uint32_t planes_s = raw + pad;
  const uint32_t full0 = planes_s + LEAP_STAGES * kPlane * 4;
  const uint32_t empty0 = full0 + 8 * LEAP_STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z / a.zchunks;
  const int k0 = (blockIdx.z % a.zchunks) * a.bz;
  const int nk = min(a.bz, a.Z - k0);
  const int np = nk + 2 * R;  // uext planes this chunk reads
  const int x0 = blockIdx.x * LEAP_TX, y0 = blockIdx.y * LEAP_TY;

  if (tid == 0) {
    for (int s = 0; s < LEAP_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, LEAP_THREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // producer (thread 0): plane p of the chunk into stage p % LEAP_STAGES,
  // once every warp has released the plane that held it before
  auto issue = [&](int p) {
    const int s = p % LEAP_STAGES;
    if (p >= LEAP_STAGES) mbar_wait(empty0 + 8 * s, (p / LEAP_STAGES - 1) & 1);
    mbar_expect_tx(full0 + 8 * s, kPlane * 4);
    tma_load_4d(planes_s + s * kPlane * 4, &umap, full0 + 8 * s, x0, y0,
                k0 + p, b);
  };
  auto wait_full = [&](int p) {
    mbar_wait(full0 + 8 * (p % LEAP_STAGES), (p / LEAP_STAGES) & 1);
  };
  auto release = [&](int p) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (p % LEAP_STAGES));
  };
  auto plane = [&](int p) -> const float* {
    return planes + (p % LEAP_STAGES) * kPlane;
  };

  if (tid == 0)
    for (int p = 0; p < min(np, LEAP_STAGES); ++p) issue(p);

  // this thread's outputs: rows 2ty, 2ty + 1 and columns 4tx .. 4tx + 3 of
  // the tile, at (rr + j, cc) in a staged plane
  const int rr = 2 * ty + R, cc = 4 * tx + R;
  const int x = x0 + 4 * tx;
  float q[kQ][2][4];  // the Z queue: slot p % kQ holds plane p
#pragma unroll
  for (int p = 0; p < 2 * R; ++p) {
    wait_full(p);
#pragma unroll
    for (int j = 0; j < 2; ++j) put4(q[p][j], lds4(plane(p) + (rr + j) * kW + cc));
    if (p < R) release(p);  // a plane before the first centre
  }
  if (tid == 0)
    for (int p = LEAP_STAGES; p < min(np, LEAP_STAGES + R); ++p) issue(p);

  const float* prev = a.prev + b * a.pb;
  const float* c2 = a.c2 ? a.c2 + b * a.cb : nullptr;
  float* out = a.out + b * a.ob;
  for (int kk = 0; kk < nk; kk += kQ) {
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int k = kk + u;
      if (k < nk) {
        const long long gk = k0 + k;
        // prev of this plane's outputs, in flight under the star
        float4 pv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int y = y0 + 2 * ty + j;
          pv[j] = (y < a.Y && x < a.X)
                      ? *reinterpret_cast<const float4*>(
                            prev + gk * a.pz + (long long)y * a.py + x)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        // the newest plane, k + 2R, into the queue
        const int sn = (u + 2 * R) % kQ;  // slot of plane k + 2R
        const int sc = (u + R) % kQ;      // slot of the centre, k + R
        wait_full(k + 2 * R);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          put4(q[sn][j], lds4(plane(k + 2 * R) + (rr + j) * kW + cc));
        const float* pc = plane(k + R);
        float lap[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // Z neighbours from the queue
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float l = 3.f * kCoeffs[0] * q[sc][j][i];
#pragma unroll
            for (int r = 1; r <= R; ++r)
              l = fmaf(kCoeffs[r],
                       q[(u + R - r) % kQ][j][i] + q[(u + R + r) % kQ][j][i],
                       l);
            lap[j][i] = l;
          }
          // X neighbours: the 12 values around the four centres
          const float4 lo = lds4(pc + (rr + j) * kW + cc - 4);
          const float4 hi = lds4(pc + (rr + j) * kW + cc + 4);
          const float e[12] = {lo.x, lo.y, lo.z, lo.w,
                               q[sc][j][0], q[sc][j][1], q[sc][j][2], q[sc][j][3],
                               hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 1; r <= R; ++r)
              lap[j][i] = fmaf(kCoeffs[r], e[4 + i - r] + e[4 + i + r],
                               lap[j][i]);
        }
        // Y neighbours: rows rr - R .. rr + 1 + R other than the two own
        // rows, whose centres are in the queue
#pragma unroll
        for (int d = -R; d <= R + 1; ++d) {
          if (d == 0 || d == 1) continue;
          const float4 v = lds4(pc + (rr + d) * kW + cc);
          if (d <= R) axpy4(lap[0], kCoeffs[d < 0 ? -d : d], v);
          if (d - 1 >= -R) axpy4(lap[1], kCoeffs[d - 1 < 0 ? 1 - d : d - 1], v);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // own rows: each the other's neighbour
          lap[0][i] = fmaf(kCoeffs[1], q[sc][1][i], lap[0][i]);
          lap[1][i] = fmaf(kCoeffs[1], q[sc][0][i], lap[1][i]);
        }
        release(k + R);
        if (tid == 0 && k >= 1 && k + R - 1 + LEAP_STAGES < np)
          issue(k + R - 1 + LEAP_STAGES);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int y = y0 + 2 * ty + j;
          if (y < a.Y && x < a.X) {
            const long long row = gk * a.oz + (long long)y * a.oy + x;
            const float4 cv =
                c2 ? *reinterpret_cast<const float4*>(
                         c2 + gk * a.cz + (long long)y * a.cy + x)
                   : make_float4(a.c2s, a.c2s, a.c2s, a.c2s);
            const float* ctr = q[sc][j];
            float4 o;
            o.x = 2.f * ctr[0] - pv[j].x + cv.x * (lap[j][0] / a.dx2);
            o.y = 2.f * ctr[1] - pv[j].y + cv.y * (lap[j][1] / a.dx2);
            o.z = 2.f * ctr[2] - pv[j].z + cv.z * (lap[j][2] / a.dx2);
            o.w = 2.f * ctr[3] - pv[j].w + cv.w * (lap[j][3] / a.dx2);
            *reinterpret_cast<float4*>(out + row) = o;
          }
        }
      }
    }
  }
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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
  const int smem = leap_tma_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      leap_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.X + LEAP_TX - 1) / LEAP_TX, (a.Y + LEAP_TY - 1) / LEAP_TY,
            B * a.zchunks);
  leap_tma_kernel<<<grid, LEAP_THREADS, smem, stream>>>(umap, a);
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
