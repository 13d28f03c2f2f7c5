// Whole-warp fused FTS lookup for Hopper (sm_90a): tag compare + victim
// argmin over one bank row of the FIGCache tag store.  Shared by the
// standalone lookup kernel (fts_lookup.cu) and the whole-trace replay
// kernel (sim_scan.cu), which inlines it into every cached step.  The
// FIGCache-KV transaction kernel (figkv_tx.cu) takes the argmin alone,
// masked_argmin_warp(), which reads only the entries the mask keeps and
// ends in sim::masked_pick (sim_step.cuh), as the host builds' scalar
// sim::masked_argmin does.
//
// Device code only: include from a .cu file.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_step.cuh"

namespace fts {

constexpr int kBig = 1 << 30;
constexpr int kIntMax = 0x7fffffff;
constexpr int kWarp = 32;

struct Best {
  int hit_slot;  // smallest matching index (S when none)
  int val;       // masked score of the current candidate
  int idx;       // index of the current candidate
};

__device__ __forceinline__ void visit(Best& b, int i, int tag, int score,
                                      int seg, int limit) {
  if (tag == seg && i < b.hit_slot) b.hit_slot = i;
  const int v = i < limit ? score : kBig;
  if (v < b.val || (v == b.val && i < b.idx)) {
    b.val = v;
    b.idx = i;
  }
}

// A row that the kernel never writes may go through the read-only data
// cache (__ldg); one that the same launch writes (the replay kernel's
// store) must not, or a later step could read a stale line.
template <bool kReadOnly>
__device__ __forceinline__ int4 load4(const int4* p) {
  if constexpr (kReadOnly) return __ldg(p);
  return *p;
}

template <bool kReadOnly>
__device__ __forceinline__ int load1(const int32_t* p) {
  if constexpr (kReadOnly) return __ldg(p);
  return *p;
}

// Whole-warp lookup over one row of S entries: the first s with
// tags[s] == seg (S if none), and the lexicographic minimum of
// (s < limit ? score[s] : BIG, s) over all S entries, so limit <= 0 gives
// 0 and ties go to the first index (the semantics of jnp.argmin).  Every
// thread of the warp returns the same result.  Threads walk the row with
// coalesced 16-byte loads over the aligned prefix and scalar loads over
// the tail, keep running minima in registers and reduce them with warp
// shuffles.
template <bool kReadOnly>
__device__ __forceinline__ Best fts_lookup_warp(const int32_t* tags,
                                                const int32_t* score, int S,
                                                int seg, int limit) {
  const int t = threadIdx.x & (kWarp - 1);
  Best b{S, kIntMax, kIntMax};
  int n4 = 0;
  if ((reinterpret_cast<uintptr_t>(tags) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(score) & 15) == 0) {
    n4 = S >> 2;
    const int4* t4 = reinterpret_cast<const int4*>(tags);
    const int4* s4 = reinterpret_cast<const int4*>(score);
    for (int k = t; k < n4; k += kWarp) {
      const int4 tv = load4<kReadOnly>(t4 + k);
      const int4 sv = load4<kReadOnly>(s4 + k);
      const int i = k << 2;
      visit(b, i + 0, tv.x, sv.x, seg, limit);
      visit(b, i + 1, tv.y, sv.y, seg, limit);
      visit(b, i + 2, tv.z, sv.z, seg, limit);
      visit(b, i + 3, tv.w, sv.w, seg, limit);
    }
  }
  for (int i = (n4 << 2) + t; i < S; i += kWarp) {
    visit(b, i, load1<kReadOnly>(tags + i), load1<kReadOnly>(score + i), seg,
          limit);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const int hs = __shfl_xor_sync(0xffffffffu, b.hit_slot, off);
    const int v = __shfl_xor_sync(0xffffffffu, b.val, off);
    const int ix = __shfl_xor_sync(0xffffffffu, b.idx, off);
    if (hs < b.hit_slot) b.hit_slot = hs;
    if (v < b.val || (v == b.val && ix < b.idx)) {
      b.val = v;
      b.idx = ix;
    }
  }
  return b;
}

// sim::masked_argmin over a row with the whole warp: the first index of
// the minimum of (i < limit ? score[i] : BIG) over the n > 0 entries,
// reading only the kept ones (16-byte loads over the aligned prefix,
// scalar loads over the tail); every thread of the warp returns it.
template <bool kReadOnly>
__device__ __forceinline__ int masked_argmin_warp(const int32_t* score,
                                                  int n, int limit) {
  const int t = threadIdx.x & (kWarp - 1);
  const int kept = sim::kept_count(n, limit);
  int val = kIntMax, idx = kIntMax;
  auto take = [&](int i, int v) {
    if (v < val || (v == val && i < idx)) {
      val = v;
      idx = i;
    }
  };
  int n4 = 0;
  if ((reinterpret_cast<uintptr_t>(score) & 15) == 0) {
    n4 = kept >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(score);
    for (int k = t; k < n4; k += kWarp) {
      const int4 v = load4<kReadOnly>(s4 + k);
      const int i = k << 2;
      take(i + 0, v.x);
      take(i + 1, v.y);
      take(i + 2, v.z);
      take(i + 3, v.w);
    }
  }
  for (int i = (n4 << 2) + t; i < kept; i += kWarp)
    take(i, load1<kReadOnly>(score + i));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const int v = __shfl_xor_sync(0xffffffffu, val, off);
    const int i = __shfl_xor_sync(0xffffffffu, idx, off);
    take(i, v);
  }
  return sim::masked_pick(n, kept, val, idx);
}

}  // namespace fts
