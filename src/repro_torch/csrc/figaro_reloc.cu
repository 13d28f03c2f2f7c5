// FIGARO RELOC for Hopper (sm_90a): move whole segments from a slow pool
// into a fast pool, in place, one thread block per move.
//
// Replaces the Pallas TPU kernel src/repro/kernels/figaro_reloc/
// figaro_reloc.py (`reloc`, body `_kernel`), which copies one (1, E)
// segment per grid step through VMEM with both ids scalar-prefetched.
// Here the moves are batched over groups (FIGCache-KV: one group per
// sequence, each with its own slow and fast pool), and the kernel is a
// plain byte mover, so f32, bf16 and int8 run the same code:
//
//   pool   G groups of n_segs segments, seg_bytes each, at byte strides
//          pool_gstride (group) and pool_sstride (segment)
//   fast   G groups of n_slots slots, at fast_gstride / fast_sstride
//   src, dst (G, M) int32, contiguous: move (g, m) copies segment
//          src[g, m] of group g to slot dst[g, m] of group g
//   a move with src or dst negative (or out of range) writes nothing
//
// The destinations of one launch must be distinct; the sources may repeat.
// The segment stride of the pool is free, so a pool whose length is not a
// multiple of the segment length (FIGCache-KV's s_max) is moved in place
// without a copy.
//
// Bound on this card: bytes.  A move reads and writes seg_bytes once;
// there is no arithmetic.  At the FIGCache-KV shape (8 moves of a 16-token
// Qwen2-7B segment, 16 KiB each) one launch moves 256 KiB, ~0.08 us at
// 3.35 TB/s, far below the few microseconds of a launch, which sets the
// time.  Design: 256 threads per block, 16-byte vector loads and stores
// (int4) over the 16-byte-aligned prefix of a segment, bytes for the tail
// and for a segment whose source or destination is not 16-byte aligned.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfigaro_reloc.so figaro_reloc.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
figaro_reloc_kernel(const uint8_t* pool, uint8_t* fast,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ dst, int n_moves,
                    int n_segs, int n_slots, long long pool_gstride,
                    long long pool_sstride, long long fast_gstride,
                    long long fast_sstride, long long seg_bytes) {
  const long long move = blockIdx.x;
  const long long g = move / n_moves;
  const int s = src[move];
  const int d = dst[move];
  if (s < 0 || d < 0 || s >= n_segs || d >= n_slots) return;  // masked
  const uint8_t* from = pool + g * pool_gstride + s * pool_sstride;
  uint8_t* to = fast + g * fast_gstride + d * fast_sstride;
  long long n16 = 0;
  if (((reinterpret_cast<uintptr_t>(from) |
        reinterpret_cast<uintptr_t>(to)) & 15) == 0) {
    n16 = seg_bytes >> 4;
    const int4* f4 = reinterpret_cast<const int4*>(from);
    int4* t4 = reinterpret_cast<int4*>(to);
    for (long long i = threadIdx.x; i < n16; i += kThreads) t4[i] = f4[i];
  }
  for (long long i = (n16 << 4) + threadIdx.x; i < seg_bytes; i += kThreads) {
    to[i] = from[i];
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Returns
// cudaGetLastError(): non-zero means the launch was refused.
extern "C" int figaro_reloc_launch(const void* pool, void* fast,
                                   const void* src, const void* dst,
                                   int n_groups, int n_moves, int n_segs,
                                   int n_slots, long long pool_gstride,
                                   long long pool_sstride,
                                   long long fast_gstride,
                                   long long fast_sstride,
                                   long long seg_bytes, void* stream) {
  const long long blocks = static_cast<long long>(n_groups) * n_moves;
  if (blocks <= 0 || seg_bytes <= 0) return 0;
  figaro_reloc_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<uint8_t*>(fast),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      n_moves, n_segs, n_slots, pool_gstride, pool_sstride, fast_gstride,
      fast_sstride, seg_bytes);
  return static_cast<int>(cudaGetLastError());
}
