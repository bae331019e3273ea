// fused_wave_step: one Minimod wave step over every rank of a 1-D symmetric
// Z ring, in ONE launch.
//
// Replaces fused_wave_step_tpu (src/repro/kernels/stencil/fused.py:446,
// pallas_call at :461, body _fused_stencil_kernel at :371).  On the TPU each
// device staged its whole shard in VMEM and put its R boundary planes into
// the neighbours' VMEM landing windows by remote DMA; shards that do not fit
// VMEM, and the time loop's carried halos, took the emulation.  Here all nz
// ranks live on one card, fields are stacked (nz, 1, Z, Y, X) f32, and the
// launch runs one of the halo plan's two overlapped schedules:
//
// * single step (put, interior, fence, boundary), repro_fused_wave_step:
//   every rank stores its hi planes into rank + 1's landing window 0 and
//   its lo planes into rank - 1's window 1 (windows (nz, 2, R, Y, X) in
//   device memory; the ring's wrap gets zeros, as the reference zeroes it:
//   Dirichlet edges); rows R .. Z - R, which need no halo, are computed
//   meanwhile; the fence; then rows 0 .. R and Z - R .. Z read their halo
//   planes from the windows.  A plan without overlap (no interior, or one
//   rank) computes every row after the fence.
// * carried (boundary, put, interior, fence), repro_fused_wave_step_carried:
//   the halos of the current field landed in the previous step (z_lo,
//   z_hi, each (nz, 1, R, Y, X)).  Items whose Z chunk holds output rows
//   0 .. R or Z - R .. Z are dealt first; each store of those rows also
//   lands in the neighbour's NEW halo tensor (rows Z - R .. Z of rank r in
//   z_lo[r + 1], rows 0 .. R in z_hi[r - 1]; the two edge halos get zeros).
//   That store is the put.  Nothing in the launch reads what it puts, so
//   the launch's end on the stream is the fence: no grid barrier.  The
//   input halos must not alias the new ones.
//
// Bound on this card: bytes.  u and prev (and c2) read once, out written
// once, plus 2 * 2R planes a rank into and out of the windows or halos:
// 13.15 GB at (4, 1, 256, 1024, 1024) with a scalar c2, 3.93 ms at
// 3.35 TB/s.  Two routes, picked on the host by plan.stencil_route:
//
// * "tma" (f32, X a multiple of 4, every pointer 16-byte aligned: every
//   Minimod launch).  One block an item, as leap: a 32 x 64 output tile of
//   one rank and a chunk of its Z rows, walked on the plane ring of
//   stencil_ring.cuh (two blocks an SM).  The plane source reads the
//   UN-padded stacked u through one 4-D TMA map (X, Y, Z, nz), boxes
//   starting at x0 - R, y0 - R, so TMA's zero fill is the Y and X
//   Dirichlet edge; planes z < 0 and z >= Z come from maps over the
//   windows (single step) or the landed halos (carried).  No padded copy,
//   no zero-filled output.  The single step's put items move 16-byte
//   vectors; its fence is per rank, not a grid barrier: each put item
//   releases its receiving rank's count of landed items, and a boundary
//   item's producer acquires its rank's count before its first load.
//   Blocks take the single step's items by a ticket in the order they
//   start (put items first, boundary items last), so a waiting item waits
//   only on items that running blocks hold.  (Persistent blocks on a
//   cooperative grid with a barrier held more registers than the ring's
//   128, spilled, and left each item's first plane without loads behind
//   it: 1.7x slower.)
// * "simt" (every other shape): a grid-stride loop over points that reads
//   all 25 star points through L1/L2 — the port's first version, kept for
//   shapes off the rule, with its cooperative grid and barrier; the
//   carried entry runs the same points in a plain loop, boundary rows
//   first.
//
// The C entries refuse a "tma" launch off its rule.
#include <cooperative_groups.h>

#include <initializer_list>

#include "stencil_ring.cuh"

namespace cg = cooperative_groups;

// route codes (plan.STENCIL_ROUTES)
enum FusedRoute { kFusedSimt = 0, kFusedTma = 1 };

#define SIMT_THREADS 256
#define PUT_VECS (LEAP_THREADS * 8)  // float4s a put item moves

// -- the "simt" route -----------------------------------------------------------

struct Field {
  const float* u;
  const float* lo;  // rank r's lo halo planes at lo + r * hs
  const float* hi;  // its hi halo planes at hi + r * hs
  long long hs;
  int Z, Y, X;
  // value of rank r's halo-extended field at (z, y, x), z in [-R, Z + R)
  __device__ __forceinline__ float at(int r, int z, int y, int x) const {
    if (y < 0 || y >= Y || x < 0 || x >= X) return 0.f;
    const long long plane = (long long)Y * X;
    const long long yx = (long long)y * X + x;
    if (z < 0) return lo[r * hs + (z + R) * plane + yx];
    if (z >= Z) return hi[r * hs + (z - Z) * plane + yx];
    return u[((long long)r * Z + z) * plane + yx];
  }
};

__device__ __forceinline__ float point(const Field& f, const float* prev,
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
  const float v = 2.f * center - prev[i] + (c2 ? c2[i] : c2s) * lap;
  out[i] = v;
  return v;
}

__global__ void __launch_bounds__(SIMT_THREADS)
fused_step_kernel(const float* __restrict__ u, const float* __restrict__ prev,
                  const float* __restrict__ c2, float c2s,
                  float* __restrict__ out, float* __restrict__ win, int nz,
                  int Z, int Y, int X, int overlap, float dx2) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const long long plane = (long long)Y * X;
  const Field f{u, win, win + R * plane, 2 * R * plane, Z, Y, X};

  // put: my hi planes -> up's window 0, my lo planes -> down's window 1;
  // the ring's wrap gets zeros
  for (long long e = gtid; e < (long long)nz * R * plane; e += gstride) {
    int r = (int)(e / (R * plane));
    long long rem = e % (R * plane);
    int i = (int)(rem / plane);
    long long yx = rem % plane;
    int up = (r + 1) % nz, down = (r + nz - 1) % nz;
    win[((long long)(up * 2 + 0) * R + i) * plane + yx] =
        r == nz - 1 ? 0.f : u[((long long)r * Z + (Z - R + i)) * plane + yx];
    win[((long long)(down * 2 + 1) * R + i) * plane + yx] =
        r == 0 ? 0.f : u[((long long)r * Z + i) * plane + yx];
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

// The carried step on the CUDA cores: every point of every rank, the 2R
// boundary rows first, each boundary value also put into the neighbour's
// new halo.
__global__ void __launch_bounds__(SIMT_THREADS)
fused_carried_kernel(const float* __restrict__ u,
                     const float* __restrict__ prev,
                     const float* __restrict__ c2, float c2s,
                     float* __restrict__ out, const float* __restrict__ lo_in,
                     const float* __restrict__ hi_in,
                     float* __restrict__ lo_out, float* __restrict__ hi_out,
                     int nz, int Z, int Y, int X, float dx2) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const long long plane = (long long)Y * X;
  const Field f{u, lo_in, hi_in, R * plane, Z, Y, X};
  const bool split = Z > 2 * R;  // boundary rows first
  for (long long e = gtid; e < (long long)nz * Z * plane; e += gstride) {
    int r = (int)(e / (Z * plane));
    long long rem = e % (Z * plane);
    int j = (int)(rem / plane);
    int z = !split ? j : j < R ? j : j < 2 * R ? Z - 2 * R + j : j - R;
    long long yx = rem % plane;
    int y = (int)(yx / X), x = (int)(yx % X);
    const float v = point(f, prev, c2, c2s, out, dx2, r, z, y, x);
    if (z < R)
      hi_out[((long long)((r + nz - 1) % nz) * R + z) * plane + yx] =
          r == 0 ? 0.f : v;
    if (z >= Z - R)
      lo_out[((long long)((r + 1) % nz) * R + (z - (Z - R))) * plane + yx] =
          r == nz - 1 ? 0.f : v;
  }
}

// -- the "tma" route ------------------------------------------------------------

// Every launch-wide value a block reads, precomputed on the host so the
// kernel reads it from the parameter bank.
struct FusedArgs {
  const float* u;
  const float* prev;
  const float* c2;  // null: the scalar c2s
  float c2s;
  float* out;
  float* win;     // single step: the landing windows (nz, 2, R, Y, X)
  int* sync;      // single step: windows' landed put items a rank, ticket
  float* lo_out;  // carried: the new halos (nz, 1, R, Y, X); null on the
  float* hi_out;  // single step
  long long plane, field, xs, slab4;  // Y X, Z Y X, X; float4s of R planes
  int nz, Z, Y, X, bz, tiles_x, tiles;
  int hoff;       // the hi halo's first plane in its map
  float dx2;
  // the items: carried (nc chunks a rank, ne of them edge chunks) and the
  // single step's put (pc chunks a slab), interior (nci chunks a rank) and
  // boundary (nb items a rank's tile) items
  int pc, n_put, n_int, nc, ne, nci, nb, overlap;
};

// The fused step's plane source: rank r's row z = k0 - R + p from u, from
// the lo halo map (z < 0) or from the hi halo map (z >= Z); boxes start
// R columns and rows before the tile, so the zero fill is the X/Y edge.
struct FusedSrc {
  const CUtensorMap* umap;
  const CUtensorMap* lomap;
  const CUtensorMap* himap;
  int Z, hoff, r, k0, x0, y0;
  __device__ __forceinline__ void operator()(int p, uint32_t dst,
                                             uint32_t bar) const {
    const int z = k0 - R + p;
    if (z < 0)
      tma_load_4d(dst, lomap, bar, x0 - R, y0 - R, z + R, r);
    else if (z >= Z)
      tma_load_4d(dst, himap, bar, x0 - R, y0 - R, z - Z + hoff, r);
    else
      tma_load_4d(dst, umap, bar, x0 - R, y0 - R, z, r);
  }
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// One put item of the single step: float4s c * PUT_VECS .. of a slab.
// Side 0: my hi planes -> rank r + 1's window 0; side 1: my lo planes ->
// rank r - 1's window 1; the ring's wrap gets zeros.  Then the receiving
// rank's count of landed items is released.
__device__ __forceinline__ void put_chunk(const FusedArgs& a, int i) {
  const int r = i / (2 * a.pc), side = i / a.pc % 2;
  const long long c = i % a.pc;
  const float4* src = reinterpret_cast<const float4*>(
      a.u + r * a.field + (side == 0 ? (a.Z - R) * a.plane : 0));
  const int to = side == 0 ? (r + 1) % a.nz : (r + a.nz - 1) % a.nz;
  float4* dst = reinterpret_cast<float4*>(
      a.win + ((long long)to * 2 + side) * R * a.plane);
  const bool zero = side == 0 ? r == a.nz - 1 : r == 0;
  const long long e1 = min(a.slab4, (c + 1) * PUT_VECS);
  for (long long e = c * PUT_VECS + threadIdx.x; e < e1; e += LEAP_THREADS)
    dst[e] = zero ? make_float4(0.f, 0.f, 0.f, 0.f) : src[e];
  fence_proxy_async_global();  // these stores, before TMA reads them
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(a.sync + to, 1);
  }
}

// The carried schedule's put: this thread's stored outputs of rank r's
// rows k0 .. k0 + nk that are boundary rows, into the neighbour's new halo
// (zeros where the ring wraps).  The thread reads back its own stores.
__device__ __forceinline__ void halo_put(const FusedArgs& a, int r, int k0,
                                         int nk, int y0, int x0) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int x = x0 + 4 * tx;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* out = a.out + r * a.field;
  for (int z = k0; z < k0 + nk; ++z) {
    if (z >= R && z < a.Z - R) z = a.Z - R;  // skip the interior rows
    if (z >= k0 + nk) break;
    float* dst = z < R
        ? a.hi_out + ((long long)((r + a.nz - 1) % a.nz) * R + z) * a.plane
        : a.lo_out + ((long long)((r + 1) % a.nz) * R + z - (a.Z - R))
          * a.plane;
    const bool wrap = z < R ? r == 0 : r == a.nz - 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int y = y0 + 2 * ty + j;
      if (y < a.Y && x < a.X) {
        const long long yx = (long long)y * a.xs + x;
        *reinterpret_cast<float4*>(dst + yx) =
            wrap ? zero
                 : *reinterpret_cast<const float4*>(out + z * a.plane + yx);
      }
    }
  }
}

// One block an item.  Carried: blockIdx.x; the chunks holding boundary
// rows come first.  Single step: a ticket taken when the block starts, the
// put items first, then the interior's chunks, then the boundary items,
// each of which waits until its rank's windows have landed (so it waits
// only on items that blocks already hold).
__global__ void __launch_bounds__(LEAP_THREADS, 2)
fused_tma_kernel(const __grid_constant__ CUtensorMap umap,
                 const __grid_constant__ CUtensorMap lomap,
                 const __grid_constant__ CUtensorMap himap,
                 const __grid_constant__ FusedArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int ticket;
  const bool carried = a.lo_out != nullptr;
  if (!carried && threadIdx.x == 0) ticket = atomicAdd(a.sync + a.nz, 1);
  const PlaneRing ring = ring_setup(smem_raw);  // its sync publishes ticket
  int i = carried ? (int)blockIdx.x : ticket;
  if (!carried && i < a.n_put) {
    put_chunk(a, i);
    return;
  }
  if (!carried) i -= a.n_put;
  const bool boundary = !carried && i >= a.n_int;
  if (boundary) i -= a.n_int;
  const int q = i / a.tiles, t = i % a.tiles;
  int r, k0, nk;
  if (carried) {
    int e = q, c;
    if (e < a.nz * a.ne) {
      r = e / a.ne;
      c = e % a.ne ? a.nc - 1 : 0;
    } else {
      e -= a.nz * a.ne;
      r = e / (a.nc - 2);
      c = 1 + e % (a.nc - 2);
    }
    k0 = c * a.bz;
    nk = min(a.bz, a.Z - k0);
  } else if (!boundary) {     // an interior chunk, rows R .. Z - R
    r = q / a.nci;
    k0 = R + q % a.nci * a.bz;
    nk = min(a.bz, a.Z - R - k0);
  } else {                    // a boundary item, after its windows' fence
    if (a.overlap) {
      r = q / 2;
      k0 = q % 2 ? a.Z - R : 0;
      nk = R;
    } else {                  // without overlap, every row, chunked
      r = q / a.nb;
      k0 = q % a.nb * a.bz;
      nk = min(a.bz, a.Z - k0);
    }
    if (threadIdx.x == 0) {
      while (ld_acquire(a.sync + r) < 2 * a.pc) __nanosleep(256);
      fence_proxy_async_global();
    }
  }
  const int x0 = t % a.tiles_x * LEAP_TX, y0 = t / a.tiles_x * LEAP_TY;
  const long long off = r * a.field;
  const RingOut o{a.prev + off, a.plane, a.xs,
                  a.c2 ? a.c2 + off : nullptr, a.plane, a.xs, a.c2s,
                  a.out + off, a.plane, a.xs, a.Y, a.X, a.dx2};
  ring_item(ring, FusedSrc{&umap, &lomap, &himap, a.Z, a.hoff, r, k0, x0, y0},
            o, k0, nk, y0, x0);
  if (carried && (k0 < R || k0 + nk > a.Z - R))
    halo_put(a, r, k0, nk, y0, x0);
}

// -- host side ------------------------------------------------------------------

static bool tma_attr_set[16];

// rank-stacked f32 planes (X, Y, planes, nz) as a 4-D TMA map of
// (LEAP_TX + 2R) x (LEAP_TY + 2R) boxes
static int planes_map(CUtensorMap* map, const float* base, int nz, int planes,
                      int Y, int X) {
  const long long dims[] = {X, Y, planes, nz};
  const long long st[] = {4LL * X, 4LL * X * Y, 4LL * X * Y * planes};
  const int box[] = {kW, kH, 1, 1};
  return f32_map_nd(map, base, 4, dims, st, box);
}

static bool tma_rule(int X, std::initializer_list<const void*> ptrs) {
  bool ok = X % 4 == 0;
  for (const void* p : ptrs) ok = ok && (p == nullptr || aligned16(p));
  return ok;
}

// halo_planes: the planes a rank's lo and hi maps hold (2R in the windows,
// R in the carried halos)
static int launch_tma(FusedArgs a, const float* lo, const float* hi,
                      int halo_planes, cudaStream_t stream) {
  CUtensorMap umap, lomap, himap;
  int err = planes_map(&umap, a.u, a.nz, a.Z, a.Y, a.X);
  if (err == 0) err = planes_map(&lomap, lo, a.nz, halo_planes, a.Y, a.X);
  if (err == 0) err = planes_map(&himap, hi, a.nz, halo_planes, a.Y, a.X);
  if (err == 0) err = ring_smem_once(fused_tma_kernel, tma_attr_set);
  if (err != 0) return err;
  a.plane = (long long)a.Y * a.X;
  a.field = a.Z * a.plane;
  a.xs = a.X;
  a.slab4 = R * a.plane / 4;
  a.tiles_x = (a.X + LEAP_TX - 1) / LEAP_TX;
  a.tiles = a.tiles_x * ((a.Y + LEAP_TY - 1) / LEAP_TY);
  a.nc = (a.Z + a.bz - 1) / a.bz;
  a.ne = a.nc < 2 ? a.nc : 2;
  a.nci = a.overlap ? (a.Z - 2 * R + a.bz - 1) / a.bz : 0;
  a.nb = a.overlap ? 2 : a.nc;
  const long long pc = (a.slab4 + PUT_VECS - 1) / PUT_VECS;
  const long long items =
      a.lo_out ? (long long)a.nz * a.nc * a.tiles
               : a.nz * 2 * pc + (long long)a.nz * (a.nci + a.nb) * a.tiles;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  a.pc = (int)pc;
  a.n_put = a.lo_out ? 0 : a.nz * 2 * a.pc;
  a.n_int = a.nz * a.nci * a.tiles;
  void* args[] = {&umap, &lomap, &himap, &a};
  cudaError_t e = cudaLaunchKernel((const void*)fused_tma_kernel,
                                   dim3((unsigned)items), dim3(LEAP_THREADS),
                                   args, leap_tma_smem_bytes(), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

static int simt_blocks(const void* kern, int (&cached)[16][2], int& blocks) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  int* c = cached[device];
  if (c[1] == 0) {
    e = cudaDeviceGetAttribute(&c[0], cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c[1], kern,
                                                        SIMT_THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (c[1] < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  blocks = c[0] * c[1];
  return 0;
}

extern "C" int repro_fused_wave_step(const void* u, const void* prev,
                                     const void* c2, float c2s, void* out,
                                     void* win, void* sync, int nz, int Z,
                                     int Y, int X, int overlap, int bz,
                                     float dx2, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  overlap = overlap && Z > 2 * R;
  const float* up = static_cast<const float*>(u);
  const float* pp = static_cast<const float*>(prev);
  const float* cp = static_cast<const float*>(c2);
  float* op = static_cast<float*>(out);
  float* wp = static_cast<float*>(win);
  if (route == kFusedTma) {
    if (sync == nullptr || !tma_rule(X, {u, prev, c2, out, win}))
      return static_cast<int>(cudaErrorInvalidValue);
    FusedArgs a{};
    a.u = up, a.prev = pp, a.c2 = cp, a.c2s = c2s, a.out = op, a.win = wp;
    a.sync = static_cast<int*>(sync);
    a.nz = nz, a.Z = Z, a.Y = Y, a.X = X, a.bz = bz, a.hoff = R;
    a.overlap = overlap, a.dx2 = dx2;
    return launch_tma(a, wp, wp, 2 * R, s);
  }
  if (route != kFusedSimt) return static_cast<int>(cudaErrorInvalidValue);
  static int cached[16][2];
  int blocks = 0;
  int err = simt_blocks((const void*)fused_step_kernel, cached, blocks);
  if (err != 0) return err;
  void* args[] = {&up, &pp, &cp, &c2s, &op, &wp, &nz, &Z, &Y, &X, &overlap,
                  &dx2};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)fused_step_kernel, dim3(blocks), dim3(SIMT_THREADS), args,
      0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_fused_wave_step_carried(
    const void* u, const void* prev, const void* c2, float c2s, void* out,
    const void* lo_in, const void* hi_in, void* lo_out, void* hi_out, int nz,
    int Z, int Y, int X, int bz, float dx2, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* up = static_cast<const float*>(u);
  const float* pp = static_cast<const float*>(prev);
  const float* cp = static_cast<const float*>(c2);
  const float* li = static_cast<const float*>(lo_in);
  const float* hi = static_cast<const float*>(hi_in);
  float* op = static_cast<float*>(out);
  float* lo = static_cast<float*>(lo_out);
  float* ho = static_cast<float*>(hi_out);
  // Z <= 2R has no interior: the carried schedule needs an overlapping plan
  if (lo == nullptr || ho == nullptr || li == lo || li == ho || hi == lo ||
      hi == ho || Z <= 2 * R)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kFusedTma) {
    if (!tma_rule(X, {u, prev, c2, out, lo_in, hi_in, lo_out, hi_out}))
      return static_cast<int>(cudaErrorInvalidValue);
    FusedArgs a{};
    a.u = up, a.prev = pp, a.c2 = cp, a.c2s = c2s, a.out = op;
    a.lo_out = lo, a.hi_out = ho;
    a.nz = nz, a.Z = Z, a.Y = Y, a.X = X, a.bz = bz, a.hoff = 0;
    a.overlap = 1, a.dx2 = dx2;
    return launch_tma(a, li, hi, R, s);
  }
  if (route != kFusedSimt) return static_cast<int>(cudaErrorInvalidValue);
  static int cached[16][2];
  int blocks = 0;
  int err = simt_blocks((const void*)fused_carried_kernel, cached, blocks);
  if (err != 0) return err;
  fused_carried_kernel<<<blocks, SIMT_THREADS, 0, s>>>(
      up, pp, cp, c2s, op, li, hi, lo, ho, nz, Z, Y, X, dx2);
  REPRO_RETURN_LAUNCH_STATUS();
}
