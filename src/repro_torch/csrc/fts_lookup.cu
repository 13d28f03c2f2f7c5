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
// shuffles (fts_lookup_warp() in fts_lookup.cuh); thread 0 of the warp
// writes the three ints.  On the simulator's main path the replay kernel
// (sim_scan.cu) inlines the same fts_lookup_warp() into every step and
// this launch is gone; this kernel stays for the eager step loop.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfts_lookup.so fts_lookup.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "fts_lookup.cuh"

namespace {

constexpr int kWarp = fts::kWarp;
constexpr int kLanesPerBlock = 8;  // warps per block, one simulator lane each

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
  const fts::Best r = fts::fts_lookup_warp<true>(tags + row, score + row, S,
                                                 seg[lane], limit[lane]);
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
