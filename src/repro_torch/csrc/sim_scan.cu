// Whole-trace replay of the FIGCache DRAM simulator for Hopper (sm_90a):
// every step of a (T, N) lane trace in one launch, with the fused FTS
// lookup inlined.
//
// Replaces, on the card, the eager step loop of core/dram.py (_advance:
// ~217 device ops a cached step, each launched from the host), which ports
// the JAX package's fused lax.scan (src/repro/core/dram.py: the body is
// make_decision_fn + make_step, scanned by _scan_segment).  It also takes
// in the Pallas TPU kernel
// src/repro/kernels/fts_lookup/fts_lookup.py (`fts_lookup`): its tag
// compare and victim argmin run here as fts_lookup_warp() (fts_lookup.cuh),
// so the simulator's main path launches no separate lookup.
//
//   trace   t_issue, bank, row, col, core (T, N) int32, is_write (T, N)
//           bool, lane n in column n (dram._lane_trace)
//   params  the 15 MechParams leaves, (N,) int32
//   state   every BankState / FTS / Counters leaf with a leading lane axis,
//           updated IN PLACE (dram._advance hands over fresh clones)
//
// Design (a first version: right and simple, state in device memory):
//   * one warp per lane and one lane per block, so each lane's state
//     (~200 KB at 512 slots x 16 banks) has its SM's L1 to itself; lane n
//     loops over t = 0 .. T-1;
//   * a cached step scans the lane's bank row of tags and of the policy's
//     score with the whole warp (fts_lookup_warp: 16-byte loads, shuffle
//     reduction; no read-only cache, since the same launch writes them);
//   * the scalar rest of the step (sim_step.cuh: victim row and in-row
//     pick, free list, miss tracker, slot write-back, row_sum delta, open
//     row, busy time, MSHR ring, bus, counters) runs redundantly in every
//     thread of the warp from the pre-step state; after a __syncwarp()
//     thread 0 stores it, and a second __syncwarp() orders the stores
//     before the next step's loads.
// Static choices (mechanism, policy) are launch arguments; any max_slots,
// max_segs_per_row and miss-tracker size work.
//
// Telemetry windows (StaticConfig.telemetry > 0, DESIGN.md §15/§16) are a
// template parameter, so the telemetry-off instantiation is the replay
// without them, instruction for instruction.  With them, thread 0 folds
// each request into the open window after commit() (sim::tel_step): the
// 12 scalar lanes stay in its registers for the whole launch, the
// window's bank and histogram planes and the cumulative histogram and
// SLO counts in shared memory (500 ints at 16 banks and 8 cores); a ring
// row goes to device memory only when a window closes, and the live row,
// the open window and the planes once at the end.  No step reads back
// what telemetry stores, so it adds no round trip to the chain below,
// only thread 0's instructions and, once per window, 56 stores.
//
// Bound on this card.  Bytes: the trace read once and the FTS, bank and
// counter state read (and, but for the free list, written) once, ~17 MB
// at the fig-8 group (32 lanes, 6144 steps, 512 slots), a few
// microseconds at 3.35 TB/s.  But a lane's steps form one chain: each
// step's loads depend on the last one's stores.  A cached step is at
// least one L2 and four L1 round trips, five shuffles and fourteen
// read-modify-writes that commit() must keep in order (the pointers may
// alias), so T times that bounds the time, far above the bytes;
// chip_smoke.py counts it (CHAIN) and measures the latencies.  Only 32 of
// the 132 SMs have a lane.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsim_scan.so sim_scan.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "fts_lookup.cuh"
#include "sim_step.cuh"

namespace {

constexpr int kWarp = fts::kWarp;

template <bool kTel>
__global__ void __launch_bounds__(kWarp) sim_scan_kernel(sim::Args a) {
  extern __shared__ int32_t planes[];   // telemetry planes (kTel only)
  const int n = blockIdx.x;
  if (n >= a.d.N) return;
  const bool cache = sim::has_cache(a.d);
  const bool leader = (threadIdx.x & (kWarp - 1)) == 0;
  sim::Tel tel;
  if (kTel && leader) sim::tel_load(a, n, tel, planes);
  for (int t = 0; t < a.d.T; ++t) {
    const sim::Req r = sim::request(a, n, t);
    sim::Lookup lk{a.d.S, 0};
    if (cache) {
      const fts::Best best = fts::fts_lookup_warp<false>(
          r.tags_row, r.score_row, a.d.S, r.seg, r.limit);
      lk.hit_slot = best.hit_slot;
      lk.cand = best.idx;
    }
    sim::Step s;
    sim::decide(a, n, r, lk, s);
    __syncwarp();
    if (leader) {
      sim::commit(a, n, r, s, t == 0);
      if (kTel) sim::tel_step(a, n, r, s, tel, planes);
    }
    __syncwarp();
  }
  if (kTel && leader) sim::tel_store(a, n, tel, planes);
}

}  // namespace

// Replay `dims[0]` steps of `dims[1]` lanes on `stream` (a cudaStream_t
// passed as a pointer).  `ptrs` holds the 50 leaf pointers (59 with a
// telemetry period, dims[12]) and `dims` the 14 sizes, in the order of
// sim_step.cuh's make_args.
// Returns cudaGetLastError(): non-zero means the launch was refused.
extern "C" int sim_scan_launch(void* const* ptrs, const int* dims,
                               void* stream) {
  const sim::Args a = sim::make_args(ptrs, dims);
  if (a.d.N <= 0 || a.d.T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.d.period > 0) {
    const size_t smem = sim::tel_plane_ints(a.d) * sizeof(int32_t);
    sim_scan_kernel<true><<<a.d.N, kWarp, smem, st>>>(a);
  } else {
    sim_scan_kernel<false><<<a.d.N, kWarp, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
