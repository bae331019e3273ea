// expert_mlp: the grouped silu-gated expert MLP, y = (silu(x wg) * (x wu))
// .astype(x) @ wd with f32 accumulation, one weight set an expert.
// Replaces expert_mlp_pallas (src/repro/kernels/moe_dispatch/kernel.py:35,
// pallas_call at :44); the tile routines, the route rule and their design
// note are in expert_mlp.cuh.  The TPU kernel ran one grid step an expert.
// CUDA-core route: one block computes one output tile of one expert's rows,
// two launches on one stream: every gate/up tile (h into a scratch
// buffer), then every down tile.  Tensor-core route: three launches on one
// stream: one block builds the list of row tiles with live rows from the
// counts (into `work`), then a persistent grid runs every gate/up item of
// the list, then another its zero pass and every down item; the weight, x
// and h maps are built here once a call.
//
// Layout: x, y (G, S, E, C, d); wg, wu (G, E, d, f); wd (G, E, f, d), each
// rank's experts contiguous and the ranks sg, su, sd elements apart (a
// layer of a stacked weight is a view); h (G, S, E, C, f) scratch; counts
// (G, S, E) int32 live rows, or null for all C rows; work (ex_tc_list_len(
// G S E, C) int32) the tensor-core route's list.  G are ranks (each
// with its own weights), S sources that share a rank's weights.
#include "expert_mlp.cuh"

template <typename T>
struct GroupedGet {
  const T* x;
  const T* wg;
  const T* wu;
  const T* wd;
  const int* counts;
  T* h;
  T* y;
  long long sg, su, sd;
  int S, E, C, d, f, G;

  // weight set wp = g * E + e, source sp
  __device__ ExProblem<T> operator()(long long wp, int sp) const {
    const long long g = wp / E, e = wp % E;
    const long long p = (g * S + sp) * E + e;  // index of the (g, s, e) block
    ExProblem<T> r;
    r.x = x + p * C * d;
    r.y = y + p * C * d;
    r.h = h + p * C * f;
    r.wg = wg + g * sg + e * d * f;
    r.wu = wu + g * su + e * d * f;
    r.wd = wd + g * sd + e * f * d;
    r.live = counts ? min(max(counts[p], 0), C) : C;
    return r;
  }
};

// two blocks an SM for both passes (at most 128 registers a thread)
template <typename T>
__global__ void __launch_bounds__(EX_THREADS, 2)
gate_up_kernel(GroupedGet<T> get) {
  __shared__ __align__(16) ExSmem sm;
  gate_up_item<T>(blockIdx.x, get.S, get.C, get.d, get.f, get, sm);
}

template <typename T>
__global__ void __launch_bounds__(EX_THREADS, 2)
down_kernel(GroupedGet<T> get) {
  __shared__ __align__(16) ExSmem sm;
  down_item<T>(blockIdx.x, get.S, get.C, get.d, get.f, get, sm);
}

template <typename T>
static int launch(const void* x, const void* wg, const void* wu,
                  const void* wd, const int* counts, void* y, void* h,
                  long long sg, long long su, long long sd, int G, int S,
                  int E, int C, int d, int f, cudaStream_t stream) {
  GroupedGet<T> get{static_cast<const T*>(x), static_cast<const T*>(wg),
                    static_cast<const T*>(wu), static_cast<const T*>(wd),
                    counts, static_cast<T*>(h), static_cast<T*>(y),
                    sg, su, sd, S, E, C, d, f, G};
  const long long NW = (long long)G * E;
  const long long up = ex_gate_up_items(NW, S, C, f);
  const long long down = ex_down_items(NW, S, C, d);
  if (up > 0x7fffffffLL || down > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  gate_up_kernel<T><<<(unsigned)up, EX_THREADS, 0, stream>>>(get);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_kernel<T><<<(unsigned)down, EX_THREADS, 0, stream>>>(get);
  REPRO_RETURN_LAUNCH_STATUS();
}

// -- the tensor-core route ----------------------------------------------------

// Item (entry, column tile) of a pass: entry = p * MT + row tile, p = wp *
// S + sp the problem, wp = g * E + e.  The weight maps are (cols, K, E, G,
// 1), the x and h maps (cols, C, E, S, G).
template <typename T>
struct GroupedTc {
  GroupedGet<T> get;
  int MT;
  bool up;  // the gate/up pass (h out), else the down pass (y out)
  __device__ ExTcJob<T> operator()(int entry, int ntile) const {
    const long long p = entry / MT;
    const long long wp = p / get.S;
    const int sp = (int)(p % get.S);
    const ExProblem<T> pr = get(wp, sp);
    ExTcJob<T> j;
    j.e = (int)(wp % get.E);
    j.wq = (int)(wp / get.E);
    j.c3 = sp;
    j.c4 = j.wq;
    j.row0 = (entry % MT) * EX_TC_BR;
    j.rows = min(pr.live - j.row0, EX_TC_BR);
    j.n = ex_tc_n(j.rows);
    j.col0 = ntile * EX_TC_BM;
    j.ld = up ? get.f : get.d;
    j.out = (up ? pr.h : pr.y) + j.row0 * j.ld + j.col0;
    return j;
  }
};

template <typename T>
__global__ void ex_list_kernel(GroupedGet<T> get, int* list) {
  ex_tc_build_list(
      (long long)get.S * get.E * get.G, get.C,
      [&](long long p) { return get(p / get.S, (int)(p % get.S)).live; },
      list);
}

template <typename T>
__global__ void __launch_bounds__(EX_TC_THREADS, 1)
gate_up_tc_kernel(const __grid_constant__ CUtensorMap wgm,
                  const __grid_constant__ CUtensorMap wum,
                  const __grid_constant__ CUtensorMap xm, GroupedGet<T> get,
                  const int* list) {
  extern __shared__ unsigned char smem[];
  const ExTcSmem sm = ex_tc_smem_init(smem, 2);
  ExTcPipe pipe;
  const int MT = (get.C + EX_TC_BR - 1) / EX_TC_BR;
  ex_tc_pass<T, 2>(sm, pipe, list, get.f / EX_TC_BM, get.d / EX_TC_BK, &wgm,
                   &wum, &xm, GroupedTc<T>{get, MT, true});
}

template <typename T>
__global__ void __launch_bounds__(EX_TC_THREADS, 1)
down_tc_kernel(const __grid_constant__ CUtensorMap wdm,
               const __grid_constant__ CUtensorMap hm, GroupedGet<T> get,
               const int* list) {
  extern __shared__ unsigned char smem[];
  const ExTcSmem sm = ex_tc_smem_init(smem, 1);
  ExTcPipe pipe;
  const int MT = (get.C + EX_TC_BR - 1) / EX_TC_BR;
  if (threadIdx.x < EX_TC_CONSUMERS)  // the producer starts loading meanwhile
    ex_zero_dead_rows<T>(
        (long long)get.G * get.E * get.S, get.C, get.d,
        [&](long long p, int& live) {
          const ExProblem<T> pr = get(p / get.S, (int)(p % get.S));
          live = pr.live;
          return pr.y;
        },
        (long long)blockIdx.x * (EX_TC_CONSUMERS / 32) + threadIdx.x / 32,
        (long long)gridDim.x * (EX_TC_CONSUMERS / 32));
  ex_tc_pass<T, 1>(sm, pipe, list, get.d / EX_TC_BM, get.f / EX_TC_BK, &wdm,
                   nullptr, &hm, GroupedTc<T>{get, MT, false});
}

template <typename T>
static int launch_tc(const void* x, const void* wg, const void* wu,
                     const void* wd, const int* counts, void* y, void* h,
                     void* work, long long sg, long long su, long long sd,
                     int G, int S, int E, int C, int d, int f, int dtype,
                     cudaStream_t stream) {
  if (!ex_tc_route_ok(dtype, d, f, {x, wg, wu, wd, y, h, work}))
    return static_cast<int>(cudaErrorInvalidValue);
  GroupedGet<T> get{static_cast<const T*>(x), static_cast<const T*>(wg),
                    static_cast<const T*>(wu), static_cast<const T*>(wd),
                    counts, static_cast<T*>(h), static_cast<T*>(y),
                    sg, su, sd, S, E, C, d, f, G};
  const long long df = (long long)d * f;
  const long long wdims[5] = {f, d, E, G, 1}, ddims[5] = {d, f, E, G, 1};
  const long long wge[4] = {f, df, sg, sg * G}, wue[4] = {f, df, su, su * G};
  const long long wde[4] = {d, df, sd, sd * G};
  const long long xdims[5] = {d, C, E, S, G}, hdims[5] = {f, C, E, S, G};
  const long long xe[4] = {d, (long long)C * d, (long long)E * C * d,
                           (long long)S * E * C * d};
  const long long he[4] = {f, (long long)C * f, (long long)E * C * f,
                           (long long)S * E * C * f};
  CUtensorMap wgm, wum, wdm, xm, hm;
  int err = ex_tc_map(&wgm, wg, dtype, wdims, wge, EX_TC_BK);
  if (err == 0) err = ex_tc_map(&wum, wu, dtype, wdims, wue, EX_TC_BK);
  if (err == 0) err = ex_tc_map(&wdm, wd, dtype, ddims, wde, EX_TC_BK);
  if (err == 0) err = ex_tc_map(&xm, x, dtype, xdims, xe, 8);
  if (err == 0) err = ex_tc_map(&hm, h, dtype, hdims, he, 8);
  int up_blocks = 0, down_blocks = 0;
  if (err == 0)
    err = ex_tc_grid(gate_up_tc_kernel<T>, ex_tc_smem_bytes(2), up_blocks);
  if (err == 0)
    err = ex_tc_grid(down_tc_kernel<T>, ex_tc_smem_bytes(1), down_blocks);
  if (err != 0) return err;
  int* list = static_cast<int*>(work);
  ex_list_kernel<T><<<1, 1024, 0, stream>>>(get, list);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gate_up_tc_kernel<T><<<up_blocks, EX_TC_THREADS, ex_tc_smem_bytes(2),
                         stream>>>(wgm, wum, xm, get, list);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  down_tc_kernel<T><<<down_blocks, EX_TC_THREADS, ex_tc_smem_bytes(1),
                      stream>>>(wdm, hm, get, list);
  REPRO_RETURN_LAUNCH_STATUS();
}

extern "C" int repro_expert_mlp(const void* x, const void* wg, const void* wu,
                                const void* wd, const void* counts, void* y,
                                void* h, void* work, long long sg,
                                long long su, long long sd, int G, int S,
                                int E, int C, int d, int f, int dtype,
                                int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  if (route == kRouteWgmma) {
    switch (dtype) {
      case kF16: return launch_tc<__half>(x, wg, wu, wd, c, y, h, work, sg, su, sd, G, S, E, C, d, f, dtype, s);
      case kBF16: return launch_tc<__nv_bfloat16>(x, wg, wu, wd, c, y, h, work, sg, su, sd, G, S, E, C, d, f, dtype, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != kRouteSimt) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return launch<float>(x, wg, wu, wd, c, y, h, sg, su, sd, G, S, E, C, d, f, s);
    case kF16: return launch<__half>(x, wg, wu, wd, c, y, h, sg, su, sd, G, S, E, C, d, f, s);
    case kBF16: return launch<__nv_bfloat16>(x, wg, wu, wd, c, y, h, sg, su, sd, G, S, E, C, d, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
