// expert_mlp_bwd: the gradient of expert_mlp.cu's grouped silu-gated expert
// MLP, (dx, dwg, dwu, dwd) for the cotangent dy of y = (silu(x wg) * (x wu))
// .astype(x) @ wd.
//
// No TPU kernel is replaced: it is the gradient of the kernel that replaces
// expert_mlp_pallas (src/repro/kernels/moe_dispatch/kernel.py:35,
// pallas_call at :44), which has no backward on the TPU (the reference
// trains through jnp.einsum under AD, src/repro/models/layers.py:831-881).
// The passes, the routes and what bounds them on this card are in
// expert_bwd.cuh.  Bound at qwen3-moe's training call (x of 2 x 2 ranks, 2
// sources, 64 experts, 80 rows, d = 4096, f = 1536, bf16): bytes, the
// weights read and the dW written once, 5.8 ms at 3.35 TB/s, against the
// operations' 3.3 ms at 989 TFLOP/s.
//
// CUDA-core route: three launches on one stream, one block an item: every
// pass-A tile (h, dg, du into the scratch), every pass-B tile (dx, zeros
// past the counts), every pass-C tile (the three dW).  Tensor-core route:
// five launches on one stream: one block packs each rank's experts' live
// rows over its S sources (the metadata, into `work`), a grid copies
// those rows of x and dy into the packed layout of `scratch` (padding rows
// zero), then persistent grids run pass A, pass B (after writing the rows
// past the counts as zeros) and pass C over the packed tiles; the maps are
// built here once a call.
//
// Layout: x, dy, dx (G, S, E, C, d); wg, wu (G, E, d, f); wd (G, E, f, d),
// each rank's experts contiguous and the ranks sg, su, sd elements apart;
// dwg, dwu (G, E, d, f) and dwd (G, E, f, d) contiguous; counts (G, S, E)
// int32 live rows, or null for all C rows.  G are ranks (each with its own
// weights), S sources that share a rank's weights; dW sums over the S
// sources.  CUDA-core route: scratch three (G, S, E, C, f) planes (dg, du,
// h); work unused.  Tensor-core route: tiles packed 64-row tiles at most
// (the caller's bound on sum over the weight sets of ceil(live rows / 64));
// scratch exb_planes(tiles) (packed x and dy, then dg, du, h), work
// exb_work_words(G E, S, tiles) int32.
#include "expert_bwd.cuh"

template <typename T>
struct GroupedBwdGet {
  const T* x;
  const T* dy;
  T* dx;
  T* scratch;
  const T* wg;
  const T* wu;
  const T* wd;
  const int* counts;
  long long sg, su, sd;
  int S, E, C, d, f, G;

  // live rows of weight set wp = g * E + e from source sp
  __device__ int live(long long wp, int sp) const {
    const long long p = (wp / E * S + sp) * E + wp % E;
    return counts ? min(max(counts[p], 0), C) : C;
  }
  // element offset of row r of that (g, sp, e) block in x's layout
  __device__ long long row(long long wp, int sp, int r) const {
    return (((wp / E * S + sp) * E + wp % E) * C + r) * (long long)d;
  }
  // weight set wp, source sp (the CUDA-core route)
  __device__ ExbProblem<T> operator()(long long wp, int sp) const {
    const long long g = wp / E, e = wp % E;
    const long long p = (g * S + sp) * E + e;  // index of the (g, s, e) block
    const long long plane = (long long)G * S * E * C * f;
    ExbProblem<T> r;
    r.x = x + p * C * d;
    r.dy = dy + p * C * d;
    r.dx = dx + p * C * d;
    r.dg = scratch + p * C * f;
    r.du = r.dg + plane;
    r.h = r.du + plane;
    r.wg = wg + g * sg + e * d * f;
    r.wu = wu + g * su + e * d * f;
    r.wd = wd + g * sd + e * f * d;
    r.live = live(wp, sp);
    return r;
  }
};

template <typename T>
__global__ void __launch_bounds__(EX_THREADS, 1)
exb_simt_kernel(GroupedBwdGet<T> get, int pass, T* dwg, T* dwu, T* dwd) {
  __shared__ __align__(16) ExbSmem sm;
  exb_simt_item<T>(pass, blockIdx.x, get.S, get.C, get.d, get.f, get, dwg,
                   dwu, dwd, sm);
}

template <typename T>
static int launch(GroupedBwdGet<T> get, T* dwg, T* dwu, T* dwd,
                  cudaStream_t stream) {
  const long long NW = (long long)get.G * get.E;
  const long long items[3] = {exb_rows_items(NW, get.S, get.C, get.f),
                              exb_rows_items(NW, get.S, get.C, get.d),
                              exb_dw_items(NW, get.d, get.f)};
  for (int pass = 0; pass < 3; ++pass) {
    if (items[pass] > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    exb_simt_kernel<T><<<(unsigned)items[pass], EX_THREADS, 0, stream>>>(
        get, pass, dwg, dwu, dwd);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// -- the tensor-core route ----------------------------------------------------

template <typename T>
__global__ void exb_list_kernel(GroupedBwdGet<T> get, int tiles, int* work) {
  exb_build_pack(
      (long long)get.G * get.E, get.S, get.C, tiles,
      [&](long long wp, int sp) { return get.live(wp, sp); }, work);
}

template <typename T>
__global__ void exb_pack_kernel(GroupedBwdGet<T> get, ExbPack pk,
                                ExbPlanes<T> pl) {
  exb_pack_rows<T>(
      pk, get.d, -1, true, get.x, get.dy, pl.xp, pl.dyp,
      const_cast<long long*>(pk.rowoff),
      [&](long long wp, int sp, int r) { return get.row(wp, sp, r); },
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32,
      (long long)gridDim.x * blockDim.x / 32);
}

template <typename T>
__global__ void __launch_bounds__(EXB_THREADS, 1)
exb_rows_tc_kernel(const __grid_constant__ CUtensorMap wgm,
                   const __grid_constant__ CUtensorMap wum,
                   const __grid_constant__ CUtensorMap wdm,
                   const __grid_constant__ CUtensorMap xm,
                   const __grid_constant__ CUtensorMap dym, ExbPack pk,
                   ExbPlanes<T> pl, int E, int d, int f) {
  extern __shared__ unsigned char smem[];
  const ExbTcSmem sm = exb_smem_init(smem);
  ExbPipe pipe;
  exb_tc_rows_pass<T>(sm, pipe, pk, E, d, f, &wgm, &wum, &wdm, &xm, &dym, pl);
}

template <typename T>
__global__ void __launch_bounds__(EXB_THREADS, 1)
exb_dx_tc_kernel(const __grid_constant__ CUtensorMap wgm,
                 const __grid_constant__ CUtensorMap wum,
                 const __grid_constant__ CUtensorMap dgm,
                 const __grid_constant__ CUtensorMap dum,
                 GroupedBwdGet<T> get, ExbPack pk) {
  extern __shared__ unsigned char smem[];
  const ExbTcSmem sm = exb_smem_init(smem);
  ExbPipe pipe;
  if (threadIdx.x < EXB_CONSUMERS)  // the producer starts loading meanwhile
    ex_zero_dead_rows<T>(
        (long long)get.G * get.S * get.E, get.C, get.d,
        [&](long long p, int& live) {
          live = get.counts ? min(max(get.counts[p], 0), get.C) : get.C;
          return get.dx + p * get.C * get.d;
        },
        (long long)blockIdx.x * (EXB_CONSUMERS / 32) + threadIdx.x / 32,
        (long long)gridDim.x * (EXB_CONSUMERS / 32));
  exb_tc_dx_pass<T>(sm, pipe, pk, get.E, get.d, get.f, &wgm, &wum, &dgm, &dum,
                    get.dx);
}

template <typename T>
__global__ void __launch_bounds__(EXB_THREADS, 1)
exb_dw_tc_kernel(const __grid_constant__ CUtensorMap xm,
                 const __grid_constant__ CUtensorMap dym,
                 const __grid_constant__ CUtensorMap dgm,
                 const __grid_constant__ CUtensorMap dum,
                 const __grid_constant__ CUtensorMap hm,
                 const __grid_constant__ CUtensorMap dwgm,
                 const __grid_constant__ CUtensorMap dwum,
                 const __grid_constant__ CUtensorMap dwdm, ExbPack pk, int d,
                 int f) {
  extern __shared__ unsigned char smem[];
  const ExbTcSmem sm = exb_smem_init(smem);
  ExbPipe pipe;
  exb_tc_dw_pass<T>(sm, pipe, pk, d, f, &xm, &dym, &dgm, &dum, &hm, &dwgm,
                    &dwum, &dwdm);
}

template <typename T>
static int launch_tc(GroupedBwdGet<T> get, T* dwg, T* dwu, T* dwd, void* work,
                     int tiles, int dtype, cudaStream_t stream) {
  const long long NW = (long long)get.G * get.E;
  const ExbPlanes<T> pl = exb_planes<T>(get.scratch, tiles, get.d, get.f);
  if (tiles < 1 || (long long)tiles * EXB_BR > 0x7fffffffLL
      || !ex_tc_route_ok(dtype, get.d, get.f,
                         {get.x, get.dy, get.dx, get.wg, get.wu, get.wd,
                          pl.xp, pl.dyp, pl.dg, pl.du, pl.h, dwg, dwu, dwd,
                          work}))
    return static_cast<int>(cudaErrorInvalidValue);
  const ExbPack pk = exb_pack_view(work, NW, get.S, tiles);
  const long long d = get.d, f = get.f, E = get.E, G = get.G, df = d * f;
  const long long R = (long long)tiles * EXB_BR;
  const long long wdims[5] = {f, d, E, G, 1}, ddims[5] = {d, f, E, G, 1};
  const long long wge[4] = {f, df, get.sg, get.sg * G};
  const long long wue[4] = {f, df, get.su, get.su * G};
  const long long wde[4] = {d, df, get.sd, get.sd * G};
  const long long xdims[5] = {d, R, 1, 1, 1}, sdims[5] = {f, R, 1, 1, 1};
  const long long xe[4] = {d, R * d, R * d, R * d};
  const long long se[4] = {f, R * f, R * f, R * f};
  // each dW (NW, d, f) or (NW, f, d), stored by TMA
  const long long gdims[5] = {f, d, NW, 1, 1}, vdims[5] = {d, f, NW, 1, 1};
  const long long ge[4] = {f, df, NW * df, NW * df};
  const long long ve[4] = {d, df, NW * df, NW * df};
  CUtensorMap wgm, wum, wdm, xm, dym, dgm, dum, hm, dwgm, dwum, dwdm;
  int err = ex_tc_map(&wgm, get.wg, dtype, wdims, wge, 64);
  if (err == 0) err = ex_tc_map(&wum, get.wu, dtype, wdims, wue, 64);
  if (err == 0) err = ex_tc_map(&wdm, get.wd, dtype, ddims, wde, 64);
  if (err == 0) err = ex_tc_map(&xm, pl.xp, dtype, xdims, xe, EXB_BR);
  if (err == 0) err = ex_tc_map(&dym, pl.dyp, dtype, xdims, xe, EXB_BR);
  if (err == 0) err = ex_tc_map(&dgm, pl.dg, dtype, sdims, se, EXB_BR);
  if (err == 0) err = ex_tc_map(&dum, pl.du, dtype, sdims, se, EXB_BR);
  if (err == 0) err = ex_tc_map(&hm, pl.h, dtype, sdims, se, EXB_BR);
  if (err == 0) err = ex_tc_map(&dwgm, dwg, dtype, gdims, ge, 64);
  if (err == 0) err = ex_tc_map(&dwum, dwu, dtype, gdims, ge, 64);
  if (err == 0) err = ex_tc_map(&dwdm, dwd, dtype, vdims, ve, 64);
  const int smem = exb_smem_bytes();
  int rows_blocks = 0, dx_blocks = 0, dw_blocks = 0, sms = 0, device = 0;
  if (err == 0)
    err = ex_tc_grid(exb_rows_tc_kernel<T>, smem, rows_blocks, EXB_THREADS);
  if (err == 0)
    err = ex_tc_grid(exb_dx_tc_kernel<T>, smem, dx_blocks, EXB_THREADS);
  if (err == 0)
    err = ex_tc_grid(exb_dw_tc_kernel<T>, smem, dw_blocks, EXB_THREADS);
  if (err == 0) err = static_cast<int>(cudaGetDevice(&device));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device));
  if (err != 0) return err;
  exb_list_kernel<T><<<1, 1024, 0, stream>>>(get, tiles,
                                             static_cast<int*>(work));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exb_pack_kernel<T><<<8 * sms, 256, 0, stream>>>(get, pk, pl);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exb_rows_tc_kernel<T><<<rows_blocks, EXB_THREADS, smem, stream>>>(
      wgm, wum, wdm, xm, dym, pk, pl, get.E, get.d, get.f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exb_dx_tc_kernel<T><<<dx_blocks, EXB_THREADS, smem, stream>>>(
      wgm, wum, dgm, dum, get, pk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exb_dw_tc_kernel<T><<<dw_blocks, EXB_THREADS, smem, stream>>>(
      xm, dym, dgm, dum, hm, dwgm, dwum, dwdm, pk, get.d, get.f);
  REPRO_RETURN_LAUNCH_STATUS();
}

template <typename T>
static int run(const void* x, const void* wg, const void* wu, const void* wd,
               const void* dy, const int* counts, void* dx, void* dwg,
               void* dwu, void* dwd, void* scratch, void* work, long long sg,
               long long su, long long sd, int G, int S, int E, int C, int d,
               int f, int tiles, int dtype, int route, cudaStream_t stream) {
  GroupedBwdGet<T> get{static_cast<const T*>(x), static_cast<const T*>(dy),
                       static_cast<T*>(dx), static_cast<T*>(scratch),
                       static_cast<const T*>(wg), static_cast<const T*>(wu),
                       static_cast<const T*>(wd), counts, sg, su, sd, S, E,
                       C, d, f, G};
  T* gw = static_cast<T*>(dwg);
  T* uw = static_cast<T*>(dwu);
  T* dw = static_cast<T*>(dwd);
  if constexpr (!std::is_same<T, float>::value) {  // wgmma takes 16-bit only
    if (route == kRouteWgmma)
      return launch_tc<T>(get, gw, uw, dw, work, tiles, dtype, stream);
  }
  return launch<T>(get, gw, uw, dw, stream);
}

extern "C" int repro_expert_mlp_bwd(const void* x, const void* wg,
                                    const void* wu, const void* wd,
                                    const void* dy, const void* counts,
                                    void* dx, void* dwg, void* dwu, void* dwd,
                                    void* scratch, void* work, long long sg,
                                    long long su, long long sd, int G, int S,
                                    int E, int C, int d, int f, int tiles,
                                    int dtype, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  if (route == kRouteWgmma) {
    switch (dtype) {
      case kF16: return run<__half>(x, wg, wu, wd, dy, c, dx, dwg, dwu, dwd, scratch, work, sg, su, sd, G, S, E, C, d, f, tiles, dtype, route, s);
      case kBF16: return run<__nv_bfloat16>(x, wg, wu, wd, dy, c, dx, dwg, dwu, dwd, scratch, work, sg, su, sd, G, S, E, C, d, f, tiles, dtype, route, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return run<float>(x, wg, wu, wd, dy, c, dx, dwg, dwu, dwd, scratch, work, sg, su, sd, G, S, E, C, d, f, tiles, dtype, route, s);
    case kF16: return run<__half>(x, wg, wu, wd, dy, c, dx, dwg, dwu, dwd, scratch, work, sg, su, sd, G, S, E, C, d, f, tiles, dtype, route, s);
    case kBF16: return run<__nv_bfloat16>(x, wg, wu, wd, dy, c, dx, dwg, dwu, dwd, scratch, work, sg, su, sd, G, S, E, C, d, f, tiles, dtype, route, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
