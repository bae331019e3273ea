// expert_mlp: the grouped silu-gated expert MLP, y = (silu(x wg) * (x wu))
// .astype(x) @ wd with f32 accumulation, one weight set an expert.
// Replaces expert_mlp_pallas (src/repro/kernels/moe_dispatch/kernel.py:35,
// pallas_call at :44); the tile routines and their design note are in
// expert_mlp.cuh.  The TPU kernel ran one grid step an expert; here one
// block computes one output tile of one expert's rows, and the call is two
// launches on one stream: every gate/up tile (h into a scratch buffer),
// then every down tile.
//
// Layout: x, y (G, S, E, C, d); wg, wu (G, E, d, f); wd (G, E, f, d), each
// rank's experts contiguous and the ranks sg, su, sd elements apart (a
// layer of a stacked weight is a view); h (G, S, E, C, f) scratch; counts
// (G, S, E) int32 live rows, or null for all C rows.  G are ranks (each
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
  int S, E, C, d, f;

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
                    sg, su, sd, S, E, C, d, f};
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

extern "C" int repro_expert_mlp(const void* x, const void* wg, const void* wu,
                                const void* wd, const void* counts, void* y,
                                void* h, long long sg, long long su,
                                long long sd, int G, int S, int E, int C,
                                int d, int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  switch (dtype) {
    case kF32: return launch<float>(x, wg, wu, wd, c, y, h, sg, su, sd, G, S, E, C, d, f, s);
    case kF16: return launch<__half>(x, wg, wu, wd, c, y, h, sg, su, sd, G, S, E, C, d, f, s);
    case kBF16: return launch<__nv_bfloat16>(x, wg, wu, wd, c, y, h, sg, su, sd, G, S, E, C, d, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
