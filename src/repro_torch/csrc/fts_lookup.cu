// Fused FTS lookup for Hopper (sm_90a): tag compare + victim argmin over
// one bank row of the FIGCache tag store, for every simulator lane at once.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fts_lookup/fts_lookup.py
// (`fts_lookup`, body `_kernel`).  The TPU kernel answers for ONE lane and
// is vmapped; here lanes are a tensor dimension, so one launch answers all
// N lanes of a simulator step:
//
//   inputs   tags, score (N, n_banks, S) int32, contiguous;
//            bank, seg, limit (N,) int32
//   output   out (N, 3) int32 = [hit, hit_slot, victim_cand]
//   hit_slot    first s with tags[n, bank[n], s] == seg[n], or S if none
//   victim_cand lexicographic minimum of (idx < limit ? score : BIG, idx)
//               over ALL S entries: limit <= 0 gives 0, ties go to the
//               first index (the semantics of jnp.argmin).
//
// Bound on this card: bytes.  One launch must read the two selected rows,
// 2 * N * S * 4 bytes (131 KB at the fig-8 shape N = 32, S = 512), which
// takes ~0.04 us at 3.35 TB/s; the work is ~2 * N * S integer compares.
// Both are far below the few microseconds of launch latency, which sets
// the kernel's time.  Design: one warp per lane, 8 lanes per 256-thread
// block; each warp walks its two S-wide rows with coalesced 16-byte loads
// (int4) over the aligned prefix and scalar loads over the tail, keeps
// per-thread running minima in registers, and reduces them with warp
// shuffles; thread 0 of the warp writes the three ints.  Removing the
// launch latency is the job of the later fused whole-step scan kernel,
// which will inline fts_lookup_warp() below.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfts_lookup.so fts_lookup.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kIntMax = 0x7fffffff;
constexpr int kWarp = 32;
constexpr int kLanesPerBlock = 8;  // warps per block, one simulator lane each

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

// Whole-warp lookup over one row of S entries.  Every thread of the warp
// returns the same result.
__device__ __forceinline__ Best fts_lookup_warp(const int32_t* __restrict__ tags,
                                                const int32_t* __restrict__ score,
                                                int S, int seg, int limit) {
  const int t = threadIdx.x & (kWarp - 1);
  Best b{S, kIntMax, kIntMax};
  int n4 = 0;
  if ((reinterpret_cast<uintptr_t>(tags) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(score) & 15) == 0) {
    n4 = S >> 2;
    const int4* t4 = reinterpret_cast<const int4*>(tags);
    const int4* s4 = reinterpret_cast<const int4*>(score);
    for (int k = t; k < n4; k += kWarp) {
      const int4 tv = __ldg(t4 + k);
      const int4 sv = __ldg(s4 + k);
      const int i = k << 2;
      visit(b, i + 0, tv.x, sv.x, seg, limit);
      visit(b, i + 1, tv.y, sv.y, seg, limit);
      visit(b, i + 2, tv.z, sv.z, seg, limit);
      visit(b, i + 3, tv.w, sv.w, seg, limit);
    }
  }
  for (int i = (n4 << 2) + t; i < S; i += kWarp) {
    visit(b, i, __ldg(tags + i), __ldg(score + i), seg, limit);
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

__global__ void __launch_bounds__(kWarp * kLanesPerBlock)
fts_lookup_kernel(const int32_t* __restrict__ tags,
                  const int32_t* __restrict__ score,
                  const int32_t* __restrict__ bank,
                  const int32_t* __restrict__ seg,
                  const int32_t* __restrict__ limit,
                  int32_t* __restrict__ out, int n_lanes, int n_banks,
                  int S) {
  const int lane = blockIdx.x * kLanesPerBlock + (threadIdx.x / kWarp);
  if (lane >= n_lanes) return;  // whole warps exit together
  int b = bank[lane];
  // clamp like the JAX reference's gather: an out-of-range bank reads the
  // nearest row instead of faulting
  b = b < 0 ? 0 : (b >= n_banks ? n_banks - 1 : b);
  const size_t row = (static_cast<size_t>(lane) * n_banks + b) * S;
  const Best r = fts_lookup_warp(tags + row, score + row, S, seg[lane],
                                 limit[lane]);
  if ((threadIdx.x & (kWarp - 1)) == 0) {
    out[3 * lane + 0] = r.hit_slot < S ? 1 : 0;
    out[3 * lane + 1] = r.hit_slot;
    out[3 * lane + 2] = r.idx;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Returns
// cudaGetLastError(): non-zero means the launch was refused.
extern "C" int fts_lookup_launch(const void* tags, const void* score,
                                 const void* bank, const void* seg,
                                 const void* limit, void* out, int n_lanes,
                                 int n_banks, int S, void* stream) {
  if (n_lanes <= 0) return 0;
  const dim3 block(kWarp * kLanesPerBlock);
  const dim3 grid((n_lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  fts_lookup_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(score),
      static_cast<const int32_t*>(bank), static_cast<const int32_t*>(seg),
      static_cast<const int32_t*>(limit), static_cast<int32_t*>(out),
      n_lanes, n_banks, S);
  return static_cast<int>(cudaGetLastError());
}
