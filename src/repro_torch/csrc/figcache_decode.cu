// FIGCache-KV decode attention for Hopper (sm_90a): one query token per
// (sequence, query head) against the gathered (hot segments + recent
// window) KV buffer, with a per-sequence validity mask.
//
// Replaces the Pallas TPU kernel src/repro/kernels/figcache_decode/
// figcache_decode.py (`figcache_decode`, body `_kernel`), whose grid walks
// L in blocks with the online-softmax state in VMEM scratch.  Here one
// thread block owns one (sequence b, query head h) and loops over L in
// tiles itself, so any L works (the TPU kernel needs L % block_l == 0).
//
//   q      (B, H, D)          f32 or bf16, contiguous
//   k, v   (B, L, Hkv, D)     the layout the FIGCache-KV step gathers;
//                             query head h reads KV head h / (H / Hkv), so
//                             grouped-query attention never repeats K/V
//   valid  (B, L)             bool (one byte), shared by a sequence's heads
//   out    (B, H, D)          the input type
//
// Semantics of the reference (figcache_decode_ref / _masked_attend):
// scores in f32, s = (q . k) * scale with scale = D^-0.5, a masked score is
// the finite -1e30, softmax over L, output (p @ v) in f32 then rounded.  The
// running max starts at -1e30 as in the TPU kernel, so a fully masked row
// returns the uniform mean of v, as the reference does.
//
// Bound on this card: bytes.  At the FIGCache-KV shape of Qwen2-7B (B = 8,
// H = 28, Hkv = 4, D = 128, L = 160, bf16) K and V are 2.6 MB read once
// (~0.8 us at 3.35 TB/s) against 18 MFLOP (~0.02 us on the bf16 tensor
// cores, ~0.3 us even on the f32 pipes).  With one short row per key the
// kernel is bound by memory latency in practice, so the design keeps many
// independent loads in flight, simple first (no tensor cores, no TMA):
// 256 threads (8 warps) per block; tiles of 64 keys; each warp reduces 4
// key rows at once (a warp-per-row dot product, lanes over D, 4 rows'
// loads issued together, warp-shuffle sums); every warp then derives the
// tile max and the sum of exp from the shared scores (the same arithmetic
// in each warp, so they agree bit for bit); warp 0 publishes the
// probabilities; for p @ v the block splits into 2 halves of 128 threads,
// each thread owning up to 4 D-columns and every other key of the tile,
// with the key loop unrolled by 8, and the two halves add up at the end.
// The H / Hkv query heads that share a KV head read the same rows, which
// the 50 MB L2 serves.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfigcache_decode.so figcache_decode.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kTile = 64;                     // keys per tile (2 per lane)
constexpr int kRows = 4;                      // key rows a warp reduces at once
constexpr int kCols = 128;                    // threads of one half of p @ v
constexpr int kParts = kThreads / kCols;      // halves splitting a tile's keys
constexpr int kMaxD = 512;
constexpr int kAcc = kMaxD / kCols;           // D-columns per thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
figcache_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ valid, T* __restrict__ out,
                       int H, int Hkv, int L, int D, float scale) {
  __shared__ float q_sh[kMaxD];
  __shared__ float s_sh[kTile];
  __shared__ float p_sh[kTile];
  __shared__ float red_sh[kMaxD];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / Hkv);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int col = threadIdx.x % kCols;
  const int half = threadIdx.x / kCols;
  for (int d = threadIdx.x; d < D; d += kThreads)
    q_sh[d] = to_f32(q[static_cast<size_t>(bh) * D + d]);
  __syncthreads();

  const size_t row = static_cast<size_t>(Hkv) * D;  // stride between keys
  const T* kb = k + (static_cast<size_t>(b) * L * Hkv + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * L * Hkv + kvh) * D;
  const uint8_t* ok = valid + static_cast<size_t>(b) * L;
  float m = kNeg;   // running max, -1e30 like the TPU kernel's init
  float l = 0.f;    // running denominator
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);
    // scores: each warp reduces kRows whole key rows at a time
    for (int j0 = warp * kRows; j0 < n; j0 += kWarps * kRows) {
      const T* kr = kb + static_cast<size_t>(t0 + j0) * row;
      const int rows = min(kRows, n - j0);
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
#pragma unroll 4
      for (int d = lane; d < D; d += kWarp) {
        const float qd = q_sh[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows) part[r] += qd * to_f32(kr[r * row + d]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = warp_sum(part[r]);
      if (lane < rows) {
        float sc = part[0];
#pragma unroll
        for (int r = 1; r < kRows; ++r)
          if (lane == r) sc = part[r];
        s_sh[j0 + lane] = ok[t0 + j0 + lane] ? sc * scale : kNeg;
      }
    }
    __syncthreads();
    // tile max and exp-sum: identical arithmetic in every warp
    const float s0 = lane < n ? s_sh[lane] : kNeg;
    const float s1 = lane + kWarp < n ? s_sh[lane + kWarp] : kNeg;
    const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
    const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
    const float p1 = lane + kWarp < n ? expf(s1 - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p0 + p1);
    m = m_new;
    if (warp == 0) {
      p_sh[lane] = p0;
      p_sh[lane + kWarp] = p1;
    }
    __syncthreads();
    // acc = acc * corr + p @ v over this thread's columns and every
    // kParts-th key of the tile
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int d = col + i * kCols;
      if (d < D) {
        float a = 0.f;
#pragma unroll 8
        for (int j = half; j < n; j += kParts)
          a += p_sh[j] * to_f32(vb[static_cast<size_t>(t0 + j) * row + d]);
        acc[i] = acc[i] * corr + a;
      }
    }
  }
  // the two halves add up; the first writes the output
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) red_sh[col + i * kCols] = acc[i];
  }
  __syncthreads();
  if (half == 0) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int d = col + i * kCols;
      if (d < D)
        out[static_cast<size_t>(bh) * D + d] =
            from_f32<T>((acc[i] + red_sh[col + i * kCols]) * inv);
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `dtype` is 0
// for f32 and 1 for bf16.  Returns cudaGetLastError(): non-zero means the
// launch was refused; 22 (cudaErrorInvalidValue) for a shape it does not
// take.
extern "C" int figcache_decode_launch(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* out, int B, int H, int Hkv,
                                      int L, int D, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || L <= 0 || D <= 0 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(B) * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    figcache_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(valid),
        static_cast<float*>(out), H, Hkv, L, D, scale);
  } else if (dtype == 1) {
    figcache_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const uint8_t*>(valid),
        static_cast<__nv_bfloat16*>(out), H, Hkv, L, D, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
