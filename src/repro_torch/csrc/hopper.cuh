// Hopper's asynchronous machinery, shared by the tensor-core routes of
// matmul.cuh (matmul.cu, ring_matmul.cu), attention.cuh
// (flash_attention.cu, ring_attention.cu, flash_attention_bwd.cu) and
// expert_mlp.cuh (expert_mlp.cu, moe_dispatch.cu), and by the stencils'
// plane ring (stencil_ring.cuh): mbarriers, TMA loads (and expert_bwd.cuh's
// TMA stores) and their tensor maps, proxy fences, and the wgmma
// shared-memory descriptor.
#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types (no libcuda link)

#include <cstdint>

#include "common.cuh"

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// arrive on the barrier at offset bar of this CTA
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// arrive on the barrier at offset bar of CTA cta of this cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// the barriers' initialization, visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// box (c0 innermost, c1, c2) of a 3-D tensor map -> shared memory at dst
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// box (c0 innermost, ..., c3) of a 4-D tensor map -> shared memory at dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// box (c0 innermost, ..., c4) of a 5-D tensor map -> shared memory at dst
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4) : "memory");
}

// shared memory at src -> box (c0 innermost, ..., c4) of a 5-D tensor map,
// in this thread's bulk group; src must stay unchanged until the group's
// reads are done (bulk_wait_read)
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ... and written their global memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// the same box into shared memory at dst of every CTA in mask, each
// completing on its own barrier at offset bar
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int c0,
                                                      int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "h"(mask) : "memory");
}

// Orders this thread's generic stores to global memory before later reads
// of the same bytes through the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Orders this thread's generic stores to shared memory before later reads
// of the same bytes by wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// two f32 values, rounded, into two adjacent 16-bit elements
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The ring of shared-memory stages a producer and its consumers walk in
// step: (stage, phase) advance together on both sides.
template <int STAGES>
struct StagePipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// -- host side ------------------------------------------------------------------

typedef CUresult (*TcEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the CUDA library the runtime loaded
static TcEncodeTiled tc_encoder() {
  static TcEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TcEncodeTiled>(p);
  }
  return fn;
}

static int map_nd(CUtensorMap* map, const void* base,
                  CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
                  int rank, const long long* dims, const long long* strides,
                  const int* box) {
  TcEncodeTiled encode = tc_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    unit[i] = 1;
    if (i > 0) s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]);
  }
  CUresult r = encode(map, type, rank, const_cast<void*>(base), d, s, b, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 16-bit tensor of `rank` dims (dims[0] innermost, unit stride; strides
// in bytes for dims 1..rank-1) as a TMA map with box `box`, 128-byte
// swizzled; elements past any edge read as zero.
static int tc_map_nd(CUtensorMap* map, const void* base, int dtype, int rank,
                     const long long* dims, const long long* strides,
                     const int* box) {
  return map_nd(map, base,
                dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                CU_TENSOR_MAP_SWIZZLE_128B, rank, dims, strides, box);
}

// The same for a float32 tensor, unswizzled: a box lands in shared memory
// row after row, densely.
static int f32_map_nd(CUtensorMap* map, const void* base, int rank,
                      const long long* dims, const long long* strides,
                      const int* box) {
  return map_nd(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                CU_TENSOR_MAP_SWIZZLE_NONE, rank, dims, strides, box);
}

// route codes passed from Python (repro_torch/kernels/_build.py ROUTE_CODES,
// picked by plan.gemm_route, plan.attention_route, plan.attention_bwd_route
// and plan.expert_route)
enum ReproRoute { kRouteSimt = 0, kRouteWgmma = 1 };
