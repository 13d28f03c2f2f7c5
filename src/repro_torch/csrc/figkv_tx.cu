// One FIGCache-KV decode step's tag-store transaction and relocation for
// Hopper (sm_90a): for every sequence, the lookups and touches of the
// selected segments, the insert of the first live miss and the move of its
// K and V rows from the slow pools into the fast pools, in one launch.
//
// Replaces on the FIGCache-KV path the Pallas TPU kernel
// src/repro/kernels/figaro_reloc/figaro_reloc.py (`reloc`), which the
// step launched twice (K and V), together with the tag-store transaction
// around it (the JAX package's _fts_step in src/repro/figkv/kv_cache.py,
// ~195 host-launched ops a step in the port's eager form).  The
// transaction's logic is figkv_tx.cuh, shared with the host build
// (figkv_tx_host.cpp); the plain version is kernels/figkv_tx/ref.py.
//
//   sel       (B, n_sel) int32, the step's selection (distinct ids a row)
//   FTS       tags, valid, dirty, benefit, last_use, evict_row, evict_mask,
//             row_sum, free_list, n_valid, leading axis B, updated IN PLACE
//   pools     slow K/V rows (B, n_segs, seg_bytes) and fast K/V rows
//             (B, S, seg_bytes) at byte strides; the fast pools are written
//             in place
//   out       slots (B, n_sel): where each selected id is read from (-1:
//             the slow pool); ins_seg, ins_slot (B,) (-1: no insert)
//
// Design: one 256-thread block per sequence.
//   1. Warps take the selected ids in turn; a warp scans the row of tags
//      and valid bits with 16-byte loads and a ballot and takes the first
//      matching slot; its lane 0 touches a hit at once (the ids are
//      distinct, so are their slots; row_sum takes atomic adds).
//   2. __syncthreads(): the victim search reads the touched values.
//   3. Every thread finds the insert candidate from shared memory; thread 0
//      starts the bulk copies (cp.async.bulk, an mbarrier per buffer) of
//      its K and V rows into shared memory at once.
//   4. Warp 0 finds the victim while they are in flight (free-stack top,
//      else the policy's first argmin, masked_argmin_warp() of
//      fts_lookup.cuh), and its lane 0 writes the slot's leaves.
//   5. Each thread writes slot map entries; thread 0 waits for the loads and
//      bulk-stores the rows into the chosen slot; the block leaves once the
//      stores have read shared memory.
// A row longer than one 16 KiB buffer goes through a ring of two buffers.
// A launch whose rows are not all 16-byte aligned (address, strides or
// length) copies global to global with the whole block: 16-byte vectors
// where both ends allow, bytes else (as figaro_reloc.cu).
//
// Bound on this card.  Bytes: the two rows read and written (at the figkv
// shape 8 x 2 x 16 KiB, twice) plus the rows of tags and valid bits and
// the few entries the touches and the victim search read and write, ~0.52
// MiB, ~0.16 us at 3.35 TB/s (chip_smoke.py's tx_bytes counts them for the
// branch each sequence takes).  The transaction itself
// is one chain of dependent round trips per sequence (the selection and
// its row scan, the touched benefit, the store's fill count, the victim
// row, the victim's benefit), which with the launch sets the time; adds
// whose result nobody reads are atomics (no round trip), and the block
// does not wait for its bulk stores to land.  chip_smoke.py counts the
// chain (FIGKV_CHAIN) and times it at measured latencies.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfigkv_tx.so figkv_tx.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "figkv_tx.cuh"
#include "fts_lookup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / fts::kWarp;
constexpr int kMaxSel = 256;     // selected ids a row (the wrapper checks)
constexpr int kChunk = 16384;    // bytes of one staging buffer
constexpr int kRing = 2;         // staging buffers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed.  A copy
// that never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, in the calling thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The first slot whose tag is seg and whose valid bit is set, S if none;
// every lane of the warp returns it.  Lanes take 16 slots at a time (four
// 16-byte loads of tags, one of valid bits) over the 16-byte-aligned part
// of the row, one slot at a time over the rest, and the first lane with a
// match (ballot) holds the first slot.
__device__ __forceinline__ int find_slot_warp(const int32_t* tags,
                                              const uint8_t* valid, int S,
                                              int32_t seg) {
  const int lane = threadIdx.x & (fts::kWarp - 1);
  int n16 = 0;
  if (((reinterpret_cast<uintptr_t>(tags) |
        reinterpret_cast<uintptr_t>(valid)) & 15) == 0)
    n16 = S >> 4;
  for (int base = 0; base < n16; base += fts::kWarp) {
    const int g = base + lane;
    int found = S;
    if (g < n16) {
      const int4 v = reinterpret_cast<const int4*>(valid)[g];
      const int4* t4 = reinterpret_cast<const int4*>(tags) + 4 * g;
      const int vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        const int4 t = t4[q];
        const int tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int e = 3; e >= 0; --e)
          if (tv[e] == seg && ((vw[q] >> (8 * e)) & 0xff) != 0)
            found = 16 * g + 4 * q + e;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, found < S);
    if (m) return __shfl_sync(0xffffffffu, found, __ffs(m) - 1);
  }
  for (int base = n16 << 4; base < S; base += fts::kWarp) {
    const int s = base + lane;
    const bool f = s < S && tags[s] == seg && valid[s] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (m) return base + __ffs(m) - 1;
  }
  return S;
}

__global__ void __launch_bounds__(kThreads)
figkv_tx_kernel(const figkv::Args a) {
  __shared__ alignas(128) uint8_t stage[kRing][kChunk];
  __shared__ alignas(8) uint64_t bars[kRing];
  __shared__ int32_t hit[kMaxSel];
  __shared__ int32_t s_slot;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / fts::kWarp;
  const int lane = threadIdx.x & (fts::kWarp - 1);
  const figkv::Row r = figkv::row_of(a, b);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kRing; ++k) mbar_init(smem_u32(&bars[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_shared();
  }

  // 1. lookups, each hit touched by the warp that found it
  for (int i = warp; i < a.n_sel; i += kWarps) {
    const int s = find_slot_warp(r.tags, r.valid, a.S, r.sel[i]);
    if (lane == 0) {
      hit[i] = s;
      if (s < a.S) figkv::touch(a, r, s);
    }
  }
  __syncthreads();

  // 3. the insert candidate; its rows start moving into shared memory
  const int32_t ins = figkv::insert_candidate(a, r, hit);
  const bool moves = ins >= 0 && ins < a.n_segs;
  const bool bulk = moves && figkv::bulk_ok(a);
  const long long per = (a.seg_bytes + kChunk - 1) / kChunk;  // chunks a row
  const long long total = 2 * per;
  auto chunk_off = [&](long long c) { return (c % per) * kChunk; };
  auto chunk_len = [&](long long c) {
    const long long left = a.seg_bytes - chunk_off(c);
    return static_cast<uint32_t>(left < kChunk ? left : kChunk);
  };
  auto issue = [&](long long c) {
    const int k = static_cast<int>(c % kRing);
    const uint32_t bar = smem_u32(&bars[k]);
    mbar_expect_tx(bar, chunk_len(c));
    bulk_load(smem_u32(stage[k]),
              figkv::move_src(a, static_cast<int>(c / per), b, ins) +
                  chunk_off(c),
              chunk_len(c), bar);
  };
  if (bulk && threadIdx.x == 0)
    for (long long c = 0; c < total && c < kRing; ++c) issue(c);

  // 4. the victim, while the rows are in flight
  if (warp == 0) {
    int32_t slot = -1;
    if (ins >= 0) {
      const figkv::Scan sc = figkv::victim_scan(a, r);
      // the policy's first argmin, reading only the entries its mask keeps
      // (RowBenefit: the live rows, 64 of row_sum's 512 at the figkv shape)
      const int32_t cand =
          sc.n > 0 ? fts::masked_argmin_warp<false>(sc.score, sc.n, sc.limit)
                   : 0;
      if (lane == 0) slot = figkv::insert(a, r, ins, cand);
    }
    if (lane == 0) {
      s_slot = slot;
      a.ins_seg[b] = ins;
      a.ins_slot[b] = slot;
    }
  }
  __syncthreads();

  // 5. the slot map, and the rows into their slot
  const int32_t slot = s_slot;
  for (int i = threadIdx.x; i < a.n_sel; i += kThreads)
    a.slots[static_cast<size_t>(b) * a.n_sel + i] =
        figkv::slot_of(a, r.sel[i], hit[i], ins, slot);
  if (!moves) return;
  const bool to_slot = slot >= 0 && slot < a.S;
  if (bulk) {
    if (threadIdx.x != 0) return;
    if (!to_slot) {  // no move after all: let the loads land, then leave
      for (long long c = 0; c < total && c < kRing; ++c)
        mbar_wait(smem_u32(&bars[c]), 0);
      return;
    }
    for (long long c = 0; c < total; ++c) {
      const int k = static_cast<int>(c % kRing);
      mbar_wait(smem_u32(&bars[k]), static_cast<uint32_t>((c / kRing) & 1));
      fence_async_shared();
      bulk_store(figkv::move_dst(a, static_cast<int>(c / per), b, slot) +
                     chunk_off(c),
                 smem_u32(stage[k]), chunk_len(c));
      bulk_commit();
      if (c + kRing < total) {
        bulk_wait_read();  // buffer k is free again
        issue(c + kRing);
      }
    }
    // the block may leave once the stores have read shared memory: their
    // writes land before the grid completes
    bulk_wait_read();
    return;
  }
  if (!to_slot) return;
  for (int t = 0; t < 2; ++t) {
    const uint8_t* from = figkv::move_src(a, t, b, ins);
    uint8_t* to = figkv::move_dst(a, t, b, slot);
    long long n16 = 0;
    if (((reinterpret_cast<uintptr_t>(from) |
          reinterpret_cast<uintptr_t>(to)) & 15) == 0) {
      n16 = a.seg_bytes >> 4;
      const int4* f4 = reinterpret_cast<const int4*>(from);
      int4* t4 = reinterpret_cast<int4*>(to);
      for (long long i = threadIdx.x; i < n16; i += kThreads) t4[i] = f4[i];
    }
    for (long long i = (n16 << 4) + threadIdx.x; i < a.seg_bytes;
         i += kThreads)
      to[i] = from[i];
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer): one block per
// sequence.  `ptrs` and `dims` as figkv::make_args reads them.  Returns
// cudaGetLastError(): non-zero means the launch was refused.
extern "C" int figkv_tx_launch(void* const* ptrs, const long long* dims,
                               void* stream) {
  const figkv::Args a = figkv::make_args(ptrs, dims);
  if (a.B <= 0) return 0;
  if (a.n_sel > kMaxSel) return static_cast<int>(cudaErrorInvalidValue);
  figkv_tx_kernel<<<a.B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
