// The stripes of ring attention's schedule, shared by ring_attention.cu
// (row 9) and its gradient, ring_attention_bwd.cu (row 14): the schedule
// table's columns, and the puts.  A put is a store of a rank's current
// stripe into the neighbour's next slot of a device-memory slot buffer
// (ring, rank, direction, slot, B, tk, KH, D) — direction 0 (clockwise)
// goes to rank + 1, direction 1 to rank - 1 — and the fence the caller's
// grid-wide barrier (a cooperative launch).
#pragma once

#include "common.cuh"

// columns of one schedule row (repro_torch/kernels/ring_attention/fused.py)
enum { kStepIndex = 0, kComputeCw, kComputeCcw, kSendCw, kSendCcw, kStepCols };

struct RingSlots {
  void* bufk;
  void* bufv;
  int rings, n, slots, B, tk, KH, D, Dv;
};

// The rank whose stripe direction dir holds on rank r at step s.
__device__ __forceinline__ int ring_src(int r, int s, int dir, int n) {
  return dir == 0 ? ((r - s) % n + n) % n : (r + s) % n;
}

template <typename T>
__device__ __forceinline__ void ring_copy_stripes(const RingSlots& p,
                                                  const T* k, const T* v,
                                                  int slot_from, int slot_to,
                                                  bool seed, bool send_cw,
                                                  bool send_ccw) {
  // seed: my stripe -> both of my directions' slot 0;
  // else: my direction-d slot -> the neighbour's next slot
  const long long sk = (long long)p.B * p.tk * p.KH * p.D;
  const long long sv = (long long)p.B * p.tk * p.KH * p.Dv;
  const long long per = sk + sv;
  const long long total = (long long)p.rings * p.n * per;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  T* bk = static_cast<T*>(p.bufk);
  T* bv = static_cast<T*>(p.bufv);
  auto slot_k = [&](long long gr, int dir, int s) {
    return bk + ((gr * 2 + dir) * p.slots + s) * sk;
  };
  auto slot_v = [&](long long gr, int dir, int s) {
    return bv + ((gr * 2 + dir) * p.slots + s) * sv;
  };
  for (long long e = gtid; e < total; e += gstride) {
    const long long gr = e / per;          // ring * n + rank
    const long long i = e % per;
    const int g = (int)(gr / p.n), r = (int)(gr % p.n);
    const long long right = (long long)g * p.n + (r + 1) % p.n;
    const long long left = (long long)g * p.n + (r + p.n - 1) % p.n;
    if (i < sk) {
      if (seed) {
        const T x = k[gr * sk + i];
        slot_k(gr, 0, 0)[i] = x;
        slot_k(gr, 1, 0)[i] = x;
      } else {
        if (send_cw) slot_k(right, 0, slot_to)[i] = slot_k(gr, 0, slot_from)[i];
        if (send_ccw) slot_k(left, 1, slot_to)[i] = slot_k(gr, 1, slot_from)[i];
      }
    } else {
      const long long j = i - sk;
      if (seed) {
        const T x = v[gr * sv + j];
        slot_v(gr, 0, 0)[j] = x;
        slot_v(gr, 1, 0)[j] = x;
      } else {
        if (send_cw) slot_v(right, 0, slot_to)[j] = slot_v(gr, 0, slot_from)[j];
        if (send_ccw) slot_v(left, 1, slot_to)[j] = slot_v(gr, 1, slot_from)[j];
      }
    }
  }
}

