// The TMA plane ring of the wave-step kernels: the 25-point radius-4 star
//   out = 2 u - prev + c2 * lap(u) / dx^2
// over one item, a (LEAP_TY x LEAP_TX) output tile of one batch (or rank)
// and a chunk of its Z rows.  wave_step.cu's leap and fused_wave_step.cu's
// "tma" route both walk their items with ring_item; they differ only in
// where each plane comes from (the caller's plane source).
//
// A block keeps a ring of LEAP_STAGES plane tiles of (LEAP_TY + 2R) x
// (LEAP_TX + 2R) floats, each fed by one 4-D TMA box load that one producer
// thread (thread 0) issues; a full mbarrier a stage reports the landing, an
// empty one (one arrival a warp) the release.  A plane staged as the newest
// stays resident until it is the centre plane (R + 1 planes), and the
// producer refills a stage as soon as every warp has released it, so two
// to three planes are in flight ahead of the one being computed.  Each
// thread owns 2 (Y) x 4 (X) outputs and carries their 2R + 1 Z neighbours
// in a register queue fed from the newest staged plane (the Z loop is
// unrolled by 2R + 1 so the queue rotates by renaming, not by moves); X and
// Y neighbours are 16-byte shared-memory loads from the centre plane.
// prev, c2 and out move as 16-byte vectors.  A block walks one item.
#pragma once

#include "hopper.cuh"

#define R 4
#define LEAP_TX 64
#define LEAP_TY 32
#define LEAP_STAGES 8
#define LEAP_THREADS 256

constexpr int kW = LEAP_TX + 2 * R;     // a staged plane tile's row (floats)
constexpr int kH = LEAP_TY + 2 * R;     // its rows
constexpr int kPlane = kW * kH;         // floats
constexpr int kQ = 2 * R + 1;           // the Z queue's planes

// Dynamic shared memory of a ring block: the alignment slack, the plane
// ring and its full and empty mbarriers.
__host__ __device__ inline int leap_tma_smem_bytes() {
  return 128 + LEAP_STAGES * (LEAP_TY + 2 * R) * (LEAP_TX + 2 * R) * 4
         + 16 * LEAP_STAGES;
}

__constant__ float kCoeffs[R + 1] = {-205.f / 72.f, 8.f / 5.f, -1.f / 5.f,
                                     8.f / 315.f, -1.f / 560.f};

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

// The ring in a block's dynamic shared memory: the plane stages, then the
// full and the empty mbarrier of each.
struct PlaneRing {
  float* planes;
  uint32_t planes_s, full0, empty0;
};

// Lays the ring out and initialises its barriers (every thread calls it).
__device__ __forceinline__ PlaneRing ring_setup(unsigned char* smem_raw) {
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 127) & ~127u) - raw;
  PlaneRing ring;
  ring.planes = reinterpret_cast<float*>(smem_raw + pad);
  ring.planes_s = raw + pad;
  ring.full0 = ring.planes_s + LEAP_STAGES * kPlane * 4;
  ring.empty0 = ring.full0 + 8 * LEAP_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < LEAP_STAGES; ++s) {
      mbar_init(ring.full0 + 8 * s, 1);
      mbar_init(ring.empty0 + 8 * s, LEAP_THREADS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  return ring;
}

// One item's operands, at its batch or rank: prev, c2 (null: the scalar
// c2s) and out with their z and y element strides (unit x stride).
struct RingOut {
  const float* prev;
  long long pz, py;
  const float* c2;
  long long cz, cy;
  float c2s;
  float* out;
  long long oz, oy;
  int Y, X;
  float dx2;
};

// Walks one item: output rows k0 .. k0 + nk of the tile at (y0, x0).  Plane
// p (0 <= p < nk + 2R) of the item is the field's row k0 - R + p;
// src(p, dst, bar) loads its (LEAP_TY + 2R) x (LEAP_TX + 2R) box, rows from
// y0 - R and columns from x0 - R, by TMA into the stage at shared address
// dst, completing on the mbarrier bar.  Thread (tx, ty) stores rows
// y0 + 2 ty + {0, 1}, columns x0 + 4 tx .. + 3 of every output row.
template <class Src>
__device__ __forceinline__ void ring_item(const PlaneRing& ring,
                                          const Src& src, const RingOut& a,
                                          int k0, int nk, int y0, int x0) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int np = nk + 2 * R;  // planes this item reads

  // producer (thread 0): plane p into stage p % LEAP_STAGES, once every
  // warp has released the plane that held it before
  auto issue = [&](int p) {
    const int s = p % LEAP_STAGES;
    if (p >= LEAP_STAGES)
      mbar_wait(ring.empty0 + 8 * s, (p / LEAP_STAGES - 1) & 1);
    mbar_expect_tx(ring.full0 + 8 * s, kPlane * 4);
    src(p, ring.planes_s + s * kPlane * 4, ring.full0 + 8 * s);
  };
  auto wait_full = [&](int p) {
    mbar_wait(ring.full0 + 8 * (p % LEAP_STAGES), (p / LEAP_STAGES) & 1);
  };
  auto release = [&](int p) {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty0 + 8 * (p % LEAP_STAGES));
  };
  auto plane = [&](int p) -> const float* {
    return ring.planes + (p % LEAP_STAGES) * kPlane;
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
                            a.prev + gk * a.pz + (long long)y * a.py + x)
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
                a.c2 ? *reinterpret_cast<const float4*>(
                           a.c2 + gk * a.cz + (long long)y * a.cy + x)
                     : make_float4(a.c2s, a.c2s, a.c2s, a.c2s);
            const float* ctr = q[sc][j];
            float4 o;
            o.x = 2.f * ctr[0] - pv[j].x + cv.x * (lap[j][0] / a.dx2);
            o.y = 2.f * ctr[1] - pv[j].y + cv.y * (lap[j][1] / a.dx2);
            o.z = 2.f * ctr[2] - pv[j].z + cv.z * (lap[j][2] / a.dx2);
            o.w = 2.f * ctr[3] - pv[j].w + cv.w * (lap[j][3] / a.dx2);
            *reinterpret_cast<float4*>(a.out + row) = o;
          }
        }
      }
    }
  }
}

// -- host side ------------------------------------------------------------------

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Sets a ring kernel's dynamic shared memory, once a process and device.
template <typename Kernel>
static int ring_smem_once(Kernel kern, bool (&done)[16]) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[device]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             leap_tma_smem_bytes());
    if (e != cudaSuccess) return static_cast<int>(e);
    done[device] = true;
  }
  return 0;
}
