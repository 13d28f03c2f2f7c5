// FIGCache-KV decode attention for Hopper (sm_90a): one query token per
// (sequence, query head) against the gathered (hot segments + recent
// window) KV buffer, with a per-sequence validity mask.
//
// Replaces the Pallas TPU kernel src/repro/kernels/figcache_decode/
// figcache_decode.py (`figcache_decode`, body `_kernel`), whose grid walks
// L in blocks with the online-softmax state in VMEM scratch.
//
//   q      (B, H, D)          f32 or bf16, contiguous
//   k, v   (B, L, Hkv, D)     the layout the FIGCache-KV step gathers;
//                             query head h reads KV head h / (H / Hkv)
//   valid  (B, L)             bool (one byte), shared by a sequence's heads
//   out    (B, H, D)          the input type
//
// Semantics of the reference (figcache_decode_ref / _masked_attend):
// scores in f32, s = (q . k) * scale with scale = D^-0.5, a masked score is
// the finite -1e30, softmax over L, output (p @ v) in f32 then rounded.  The
// running max starts at -1e30 as in the TPU kernel, so a fully masked row
// returns the uniform mean of v, as the reference does.
//
// Bound on this card: bytes, and in practice latency.  At the FIGCache-KV
// shape of Qwen2-7B (B = 8, H = 28, Hkv = 4, D = 128, L = 160, bf16) K and
// V are 2.6 MB read once (~0.8 us at 3.35 TB/s) against 18 MFLOP, so the
// design reads each K/V row once and keeps the chain of dependent steps
// short:
//
// - Grid (S, Hkv * tiles, B): one block of 256 threads per (L-split s, KV
//   head g, sequence b) for up to 8 query heads of g's group (a larger
//   group takes several head tiles).  The S splits of one (b, g, tile) are
//   a thread block cluster.  The wrapper picks S from (B, Hkv, L): 3 at the
//   shape above (96 blocks); split s holds keys [s L / S, (s + 1) L / S).
// - All of a split's K and V are in flight at once: every thread issues
//   16-byte cp.async copies (q with the first K), rows padded so that 8
//   consecutive rows lie in 8 bank groups.  Per-row cp.async.bulk copies
//   took longer to issue, and TMA boxes (which would need a tensor map per
//   call and a 128-byte swizzle) ran no faster at this shape.  A split that
//   does not fit its share of shared memory is walked in chunks through a
//   2-stage ring.  Rows that are not whole 16-byte vectors, or q/K/V not
//   16-byte aligned, are copied with plain loads instead.
// - bf16 on the tensor cores (mma.sync m16n8k16, f32 sums): S = Q K^T with
//   the heads as 16 rows (8 used), warp w taking key tiles w, w + 8, ...;
//   the scaled, masked scores go through shared memory; then every warp
//   runs the split's online softmax in registers (a score row lives in a
//   lane quad; the max and sum are quad shuffles, exp is ex2.approx) on
//   the same scores, so all warps agree bit for bit, and computes O += P V
//   for its own 16-column pairs, with P in two bf16 parts (high and
//   remainder), which keeps P to ~2^-16 as the f32 plain version has it.
// - f32 on the CUDA cores: one thread per (head, key) score, warp r the
//   softmax of head r, p @ v by (head, 4-column) jobs with key parts.
// - The combine, inside the launch: a reduce-scatter over the cluster.
//   Rank t owns a range of 4-column blocks.  Every block stores its m and
//   l per head into every rank and its unnormalised output into the ranks
//   owning its columns, with st.async counted on the owner's mbarrier; no
//   global workspace and no counter to reset between CUDA-graph replays.
//   The owner weighs split s by exp(m_s - m), sums the splits in rank
//   order (deterministic) and divides by max(l, 1e-30).  The cluster
//   barriers are relaxed (a release barrier costs a GPU-wide fence).
// - Edge semantics: keys past the end of a split (the ragged last chunk)
//   and empty splits (L < S) contribute nothing (p = 0, l = 0); a fully
//   masked split contributes p = 1 per key against its own max of -1e30,
//   which the combine weighs by exp(-1e30 - m): 1 when every key of the row
//   is masked, 0 when any key is valid.
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
constexpr int kMaxD = 512;
constexpr int kMaxG = kWarps;       // query heads per block: one warp each
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kMaxChunk = 256;      // keys per ring stage
constexpr int kMaxParts = 8;        // key parts of the f32 p @ v
constexpr int kSmemLimit = 232448;  // 227 KB a block
constexpr float kNeg = -1e30f;

struct Problem {
  int B, H, Hkv, L, D;
  int G;        // H / Hkv
  int tiles;    // head tiles per KV head: ceil(G / kMaxG)
  int splits;   // cluster size
  int chunk;    // keys per ring stage
  int stages;   // 1 or 2
  int item;     // bytes of an element
  int dp;       // D padded: to 16 (bf16, the mma's k) or 4 (f32) elements
  int rows;     // rows of a ring tile: chunk, to 16 for bf16
  int rs;       // bytes between rows in the ring (and of q, bf16)
  int async;    // 1: cp.async copies; 0: plain loads (rows not 16-byte)
  int per;      // rows a pass of cp.async covers: kThreads / vectors
  int nv_shift; // log2 of the 16-byte vectors of a row, or -1
  int kb[kMaxSplits + 1];   // split s holds keys [kb[s], kb[s + 1])
  int cb[kMaxSplits + 1];   // rank t combines 4-column blocks [cb[t], ..)
  float scale;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// bytes between rows of `n` bytes in shared memory: n rounded to 16, plus
// 16 where that is an even number of 16-byte units, so that 8 consecutive
// rows start in 8 distinct bank groups (ldmatrix, 16-byte loads)
__host__ __device__ inline int row_stride(int n) {
  const int r = ceil_div(n, 16) * 16;
  return (r / 16) % 2 == 0 ? r + 16 : r;
}

// f32 p @ v: (head, 4-column) jobs, and key parts sharing them where there
// are fewer jobs than threads
__host__ __device__ inline int pv_parts(int jobs) {
  return jobs >= kThreads ? 1
                          : (kThreads / jobs < kMaxParts ? kThreads / jobs
                                                         : kMaxParts);
}

// Shared memory, in bytes from the 16-byte aligned base: the K/V ring (K
// and V tiles of each stage); q (f32, or bf16 in 16 rows for the mma);
// the scores (and f32 probabilities); the f32 key parts' partial sums; the
// f32 block output (`ow`); the mask bytes of a chunk; the combine's
// receive buffer (this rank's columns of every split's output) and every
// split's m and l; the f32 per-head corr; the receive mbarrier.
struct Layout {
  int tile, ring, q, sp, red, ow, ok, recv, dsl, rm, rl, corr, bar, bytes;
  __host__ __device__ explicit Layout(const Problem& p) {
    const bool mma = p.item == 2;
    tile = p.rows * p.rs;
    ring = 0;
    q = ring + p.stages * 2 * tile;
    sp = q + (mma ? 16 * p.rs : kMaxG * p.dp * 4);
    red = sp + kMaxG * p.chunk * 4;
    ow = red + (mma ? 0 : kThreads * 4 * 4);   // red, ow: f32 only
    ok = ow + (mma ? 0 : kMaxG * p.dp * 4);
    recv = ok + ceil_div(p.chunk, 16) * 16;
    dsl = ceil_div(p.dp / 4, p.splits) * 4;   // floats of a rank's share
    rm = recv + p.splits * kMaxG * dsl * 4;
    rl = rm + kMaxSplits * kMaxG * 4;
    corr = rl + kMaxSplits * kMaxG * 4;
    bar = corr + kMaxG * 4;                    // 8-byte aligned
    bytes = bar + 8;
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive outputs (8 or 16 bytes, aligned where D % 4 == 0)
__device__ __forceinline__ void store4(float* o, const float* a) {
  *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* a) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  *reinterpret_cast<uint2*>(o) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// Wait until the phase of `bar` with this parity has completed.  A store
// that never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

// the address of this block's shared `addr` in cluster rank `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// stores into another block's shared memory, counted in bytes on that
// block's mbarrier `bar` (both cluster addresses from mapa)
__device__ __forceinline__ void st_async(uint32_t addr, float x,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(x)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float2 x,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "r"(__float_as_uint(x.x)), "r"(__float_as_uint(x.y)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float4 x,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(x.x)), "r"(__float_as_uint(x.y)),
      "r"(__float_as_uint(x.z)), "r"(__float_as_uint(x.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start the copies of chunk `c` of keys [lo, hi) into its stage: 16-byte
// cp.async by every thread, one commit group for K and one for V; or
// plain loads, zero past D.
template <typename T>
__device__ void issue_chunk(const Problem& p, const T* __restrict__ k,
                            const T* __restrict__ v, unsigned char* ring,
                            int tile_bytes, int c, int lo, int hi, int b,
                            int g, int x, int j0, int per) {
  constexpr int E = 16 / sizeof(T);
  const int st = c % p.stages;
  const int c0 = lo + c * p.chunk;
  const int n = min(p.chunk, hi - c0);
  unsigned char* dst[2] = {ring + (2 * st) * tile_bytes,
                           ring + (2 * st + 1) * tile_bytes};
  const T* src[2] = {k, v};
  // element offset of key c0's row of KV head g, and between keys
  const size_t row0 = ((static_cast<size_t>(b) * p.L + c0) * p.Hkv + g) *
                      static_cast<size_t>(p.D);
  const size_t step = static_cast<size_t>(p.Hkv) * p.D;
  if (p.async) {
    // this thread's 16-byte column x of rows j0, j0 + per, ...
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      for (int j = j0; j < n; j += per)
        cp_async16(smem_u32(dst[t] + j * p.rs + x * 16),
                   src[t] + row0 + j * step + x * E);
      cp_commit();
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
    for (int i = threadIdx.x; i < n * p.dp; i += kThreads) {
      const int j = i / p.dp, d = i % p.dp;
      reinterpret_cast<T*>(dst[t] + j * p.rs)[d] =
          d < p.D ? src[t][row0 + j * step + d] : from_f32<T>(0.f);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
figcache_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ valid, T* __restrict__ out,
                       Problem p) {
  constexpr bool kMma = sizeof(T) == 2;  // bf16 on the tensor cores
  constexpr int E = 16 / sizeof(T);      // elements of a 16-byte vector
  constexpr int kJobs = kMaxD / 4 * kMaxG / kThreads;  // f32 jobs a thread
  constexpr int kPairs = kMaxD / 16 / kWarps;  // bf16 column pairs a warp
  constexpr int kTiles = 8;                    // bf16 key tiles a softmax step
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(p);
  unsigned char* ring = smem + lay.ring;
  float* sp = reinterpret_cast<float*>(smem + lay.sp);
  float* ow = reinterpret_cast<float*>(smem + lay.ow);
  uint8_t* ok_sh = smem + lay.ok;
  float* recv = reinterpret_cast<float*>(smem + lay.recv);
  float* rm = reinterpret_cast<float*>(smem + lay.rm);
  float* rl = reinterpret_cast<float*>(smem + lay.rl);
  float* corr_sh = reinterpret_cast<float*>(smem + lay.corr);

  const int split = blockIdx.x;                // the block's cluster rank
  const int tile = p.tiles == 1 ? 0 : blockIdx.y % p.tiles;
  const int g = p.tiles == 1 ? blockIdx.y : blockIdx.y / p.tiles;
  const int b = blockIdx.z;
  const int h0 = g * p.G + tile * kMaxG;          // first query head
  const int gb = min(kMaxG, p.G - tile * kMaxG);  // query heads here
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int lo = p.kb[split], hi = p.kb[split + 1];
  const int n_chunks = p.stages == 1 ? (hi > lo) : ceil_div(hi - lo, p.chunk);
  const int S = p.splits;
  const int nb4 = p.dp / 4;                     // 4-column blocks of a row
  const uint32_t bar = smem_u32(smem + lay.bar);

  // q of this block's heads (f32, or bf16 in 16 rows for the mma), zero
  // past D; with cp.async it lands with the first K
  const T* qb = q + (static_cast<size_t>(b) * p.H + h0) * p.D;
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  const int qrow = kMma ? p.rs / 2 : p.dp;      // elements between q rows
  // copies: thread tid moves 16-byte column x of rows j0, j0 + per, ...
  const int nv = p.D / E;
  const int per = p.per;
  const int x = !p.async ? 0 : p.nv_shift >= 0 ? tid & (nv - 1) : tid % nv;
  const int row = !p.async ? 0 : p.nv_shift >= 0 ? tid >> p.nv_shift
                                                 : tid / nv;
  const int j0 = p.async && row < per ? row : kThreads;
  if (p.async && n_chunks > 0)
    for (int r = j0; r < gb; r += per)
      cp_async16(smem_u32(qs + r * qrow + x * E), qb + r * p.D + x * E);
  for (int c = 0; c < min(p.stages, n_chunks); ++c)
    issue_chunk(p, k, v, ring, lay.tile, c, lo, hi, b, g, x, j0, per);
  // the combine's receive barrier counts the bytes the other splits will
  // store here: m and l of every head, and this rank's 4-column blocks
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, S * gb * (8 + 16 * (p.cb[split + 1] - p.cb[split])));
  }
  // every block of the cluster has started, its barrier initialised,
  // before any store into another's shared memory (waited for just before
  // the first)
  cluster_arrive_relaxed();
  if constexpr (kMma) {
    // (q rows gb..15 are left as they are: they only give score rows that
    // are never read)
    // K columns past D are read by the mma: zero them in every ring row
    // (the copies write [0, D) only)
    if (p.async && p.dp > p.D)
      for (int i = tid; i < p.stages * 2 * p.rows * (p.dp - p.D);
           i += kThreads) {
        const int row = i / (p.dp - p.D), d = p.D + i % (p.dp - p.D);
        reinterpret_cast<T*>(ring + row * p.rs)[d] = from_f32<T>(0.f);
      }
  }
  if (!p.async || p.dp > p.D)
    for (int i = tid; i < gb * p.dp; i += kThreads) {
      const int r = i / p.dp, d = i % p.dp;
      if (!p.async || d >= p.D)
        qs[r * qrow + d] = d < p.D ? qb[r * p.D + d] : from_f32<T>(0.f);
    }

  // f32: p @ v jobs (head, 4 columns) and key parts
  const int jobs = gb * (p.dp / 4);
  const int parts = pv_parts(jobs);
  const int part = parts > 1 ? tid / jobs : 0;
  float acc[kJobs][4];   // f32
#pragma unroll
  for (int i = 0; i < kJobs; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // bf16: the warp's column pairs of O (16 head rows x 16 columns each)
  float pacc[kMma ? kPairs : 1][8];
#pragma unroll
  for (int i = 0; i < (kMma ? kPairs : 1); ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) pacc[i][e] = 0.f;
  // f32: warp r < gb holds head r's split-local max and sum; bf16: every
  // warp holds them in row g = lane / 4
  float m_r = kNeg;
  float l_r = 0.f;
  const uint8_t* ok_row = valid + static_cast<size_t>(b) * p.L;

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % p.stages;
    const bool next = p.stages == 2 && c + 1 < n_chunks;
    const int c0 = lo + c * p.chunk;
    const int n = min(p.chunk, hi - c0);
    const unsigned char* ks = ring + (2 * st) * lay.tile;
    const unsigned char* vs = ks + lay.tile;
    if (tid < n) ok_sh[tid] = ok_row[c0 + tid];
    if (p.async) {   // this chunk's K and V (and q) have landed
      if (next) cp_wait<2>(); else cp_wait<0>();
    }
    __syncthreads();
    if constexpr (kMma) {
      // S = Q K^T (16 head rows x 8 keys a tile) on the tensor cores, warp
      // w taking key tiles w, w + 8, ...; rows gb and up are not needed
      const int tg = lane % 4;
      const uint32_t qa = smem_u32(smem + lay.q);
      for (int t0 = warp * 8; t0 < n; t0 += kWarps * 8) {
        // two chains of products (even and odd 16-column steps)
        float s4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const uint32_t kb = smem_u32(ks) + (t0 + lane % 8) * p.rs +
                            ((lane / 8) % 2) * 16;
        for (int k0 = 0; k0 < p.dp; k0 += 32) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kc = k0 + 16 * h;
            if (kc >= p.dp) break;
            uint32_t a[4], bk[2];
            ldsm_x4(qa + (lane % 16) * p.rs + (kc + (lane / 16) * 8) * 2, a);
            ldsm_x2(kb + kc * 2, bk);
            mma_bf16(s4[h], a, bk);
          }
        }
        const int r = lane / 4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t0 + 2 * tg + e;
          if (r < gb && j < n)
            sp[r * p.chunk + j] =
                ok_sh[j] ? (s4[0][e] + s4[1][e]) * p.scale : kNeg;
        }
      }
      __syncthreads();
      // Every warp then walks the chunk in blocks of 64 keys with the
      // softmax in registers (row g = lane / 4 of a tile lives in the
      // lane's quad), P as two bf16 parts in A fragments, and O += P V for
      // its own column pairs.  The warps run the same softmax on the same
      // scores, so their m and l agree bit for bit.
      const int g = lane / 4;
      for (int t0 = 0; t0 < n; t0 += 8 * kTiles) {
        // keys past n get -inf, so p = 0 for them whatever the max (a
        // masked key's -1e30 counts, as in the reference)
        float sc[kTiles][2];
        float mx = kNeg;
#pragma unroll
        for (int kt = 0; kt < kTiles; ++kt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = t0 + 8 * kt + 2 * tg + e;
            sc[kt][e] = j < n ? sp[g * p.chunk + j]
                              : -__int_as_float(0x7f800000);
            mx = fmaxf(mx, sc[kt][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r, mx);
        const float corr = __expf(m_r - m_new);
        float sum = 0.f;
        uint32_t ph[kTiles / 2][4], pl[kTiles / 2][4];   // keys t0 + 16 kk
#pragma unroll
        for (int kt = 0; kt < kTiles; ++kt) {
          const float e0 = __expf(sc[kt][0] - m_new);
          const float e1 = __expf(sc[kt][1] - m_new);
          sum += e0 + e1;
          const __nv_bfloat162 hv = __floats2bfloat162_rn(e0, e1);
          const float2 hf = __bfloat1622float2(hv);
          const __nv_bfloat162 lv =
              __floats2bfloat162_rn(e0 - hf.x, e1 - hf.y);
          ph[kt / 2][2 * (kt % 2)] = *reinterpret_cast<const uint32_t*>(&hv);
          pl[kt / 2][2 * (kt % 2)] = *reinterpret_cast<const uint32_t*>(&lv);
          ph[kt / 2][2 * (kt % 2) + 1] = 0u;   // rows g + 8: no heads
          pl[kt / 2][2 * (kt % 2) + 1] = 0u;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_r = l_r * corr + sum;
        m_r = m_new;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          if ((warp + i * kWarps) * 16 >= p.dp) break;
#pragma unroll
          for (int e = 0; e < 8; ++e) pacc[i][e] *= corr;
        }
#pragma unroll
        for (int kk = 0; kk < kTiles / 2; ++kk) {
          const int k0 = t0 + 16 * kk;
          if (k0 >= n) break;
          // V rows past n may hold anything: zero their halves of B
          const int key = k0 + 2 * tg;
          uint32_t keep[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            keep[h] = (key + 8 * h < n ? 0xffffu : 0u) |
                      (key + 8 * h + 1 < n ? 0xffff0000u : 0u);
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            const int n0 = (warp + i * kWarps) * 16;
            if (n0 >= p.dp) break;
            uint32_t bv[4];
            ldsm_x4_t(smem_u32(vs) + (k0 + lane % 16) * p.rs +
                          (n0 + (lane / 16) * 8) * 2,
                      bv);
#pragma unroll
            for (int h = 0; h < 4; ++h) bv[h] &= keep[h % 2];
            mma_bf16(pacc[i], ph[kk], bv);
            mma_bf16(pacc[i], pl[kk], bv);
            mma_bf16(pacc[i] + 4, ph[kk], bv + 2);
            mma_bf16(pacc[i] + 4, pl[kk], bv + 2);
          }
        }
      }
    } else {
      // f32 on the CUDA cores: one thread per (head, key) score, warp r
      // the softmax of head r, then p @ v by (head, 4-column) jobs
      const float* qp = reinterpret_cast<const float*>(qs);
      const int nq = p.dp / 4;
      for (int pr = tid; pr < gb * n; pr += kThreads) {
        const int r = pr / n, j = pr % n;
        const float* qr = qp + r * p.dp;
        const float* kr = reinterpret_cast<const float*>(ks + j * p.rs);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
        for (int xq = 0; xq < nq; ++xq) {
          const float4 kx = *reinterpret_cast<const float4*>(kr + 4 * xq);
          const float4 qx = *reinterpret_cast<const float4*>(qr + 4 * xq);
          s0 = fmaf(qx.x, kx.x, s0);
          s1 = fmaf(qx.y, kx.y, s1);
          s0 = fmaf(qx.z, kx.z, s0);
          s1 = fmaf(qx.w, kx.w, s1);
        }
        sp[r * p.chunk + j] = ok_sh[j] ? (s0 + s1) * p.scale : kNeg;
      }
      __syncthreads();
      if (warp < gb) {
        float* sr = sp + warp * p.chunk;
        float cm = kNeg;
        for (int j = lane; j < n; j += kWarp) cm = fmaxf(cm, sr[j]);
        const float m_new = fmaxf(m_r, warp_max(cm));
        float sum = 0.f;
        for (int j = lane; j < n; j += kWarp) {
          const float e = expf(sr[j] - m_new);
          sr[j] = e;
          sum += e;
        }
        const float corr = expf(m_r - m_new);
        l_r = l_r * corr + warp_sum(sum);
        m_r = m_new;
        if (lane == 0) corr_sh[warp] = corr;
      }
      __syncthreads();
      const int j0p = part * n / parts, j1p = (part + 1) * n / parts;
#pragma unroll
      for (int i = 0; i < kJobs; ++i) {
        const int job = parts > 1 ? tid % jobs : tid + i * kThreads;
        if ((parts > 1 && (i > 0 || part >= parts)) || job >= jobs) continue;
        const int r = job / nq, d0 = (job % nq) * 4;
        const float corr = corr_sh[r];
        const float* pr = sp + r * p.chunk;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
#pragma unroll 4
        for (int j = j0p; j < j1p; ++j) {
          const float4 vx =
              *reinterpret_cast<const float4*>(vs + j * p.rs + d0 * 4);
          const float pj = pr[j];
          acc[i][0] = fmaf(pj, vx.x, acc[i][0]);
          acc[i][1] = fmaf(pj, vx.y, acc[i][1]);
          acc[i][2] = fmaf(pj, vx.z, acc[i][2]);
          acc[i][3] = fmaf(pj, vx.w, acc[i][3]);
        }
      }
    }
    if (c + 1 < n_chunks) {
      __syncthreads();   // the stage and the probabilities are free again
      if (c + p.stages < n_chunks)
        issue_chunk(p, k, v, ring, lay.tile, c + p.stages, lo, hi, b, g, x,
                    j0, per);
    }
  }

  // f32: the block's (unnormalised) output, summed over the key parts,
  // into `ow` (gb x dp)
  if constexpr (!kMma) {
    float* red = reinterpret_cast<float*>(smem + lay.red);
    if (parts > 1) {   // key parts add up in part order
      if (part < parts)
        *reinterpret_cast<float4*>(red + (part * jobs + tid % jobs) * 4) =
            make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      __syncthreads();
      for (int job = tid; job < jobs; job += kThreads) {
        float4 a = *reinterpret_cast<const float4*>(red + job * 4);
        for (int s = 1; s < parts; ++s) {
          const float4 x =
              *reinterpret_cast<const float4*>(red + (s * jobs + job) * 4);
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        }
        *reinterpret_cast<float4*>(ow + job * 4) = a;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kJobs; ++i) {
        const int job = tid + i * kThreads;
        if (job < jobs)
          *reinterpret_cast<float4*>(ow + job * 4) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();
  }

  // combine, as a reduce-scatter over the cluster: rank t owns the
  // 4-column blocks [cb[t], cb[t + 1]); every block stores its m and l per
  // head into every rank and each 4-column block of its output into the
  // rank owning it, counted on that rank's barrier
  cluster_wait();
  // the rank owning 4-column block `cb`, and the block's float offset there
  auto owner = [&](int cb, int r, int* t) {
    int u = 0;
    while (cb >= p.cb[u + 1]) ++u;
    *t = u;
    return (split * kMaxG + r) * lay.dsl + (cb - p.cb[u]) * 4;
  };
  if constexpr (kMma) {
    // every warp holds row g = lane / 4's m and l: warp 0 sends them to
    // ranks lane % 4 and 4 + lane % 4; each lane sends the two columns of
    // each of its accumulator tiles (half a 4-column block)
    const int r = lane / 4, tg = lane % 4;
    if (warp == 0 && r < gb)
      for (int t = tg; t < S; t += 4) {
        const uint32_t rb = mapa(bar, t);
        st_async(mapa(smem_u32(rm + split * kMaxG + r), t), m_r, rb);
        st_async(mapa(smem_u32(rl + split * kMaxG + r), t), l_r, rb);
      }
    if (r < gb)
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int n0 = (warp + i * kWarps) * 16;
        if (n0 >= p.dp) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * h + 2 * tg;
          int t;
          const int off = owner(col / 4, r, &t) + col % 4;
          st_async(mapa(smem_u32(recv + off), t),
                   make_float2(pacc[i][4 * h], pacc[i][4 * h + 1]),
                   mapa(bar, t));
        }
      }
  } else if (warp < gb) {
    // warp r holds head r's m and l and sends them; its lanes send the
    // 4-column blocks of row r
    const int r = warp;
    if (lane < S) {
      const uint32_t rb = mapa(bar, lane);
      st_async(mapa(smem_u32(rm + split * kMaxG + r), lane), m_r, rb);
      st_async(mapa(smem_u32(rl + split * kMaxG + r), lane), l_r, rb);
    }
    for (int cb = lane; cb < nb4; cb += kWarp) {
      int t;
      const int off = owner(cb, r, &t);
      st_async(mapa(smem_u32(recv + off), t),
               *reinterpret_cast<const float4*>(ow + r * p.dp + cb * 4),
               mapa(bar, t));
    }
  }
  mbar_wait(bar, 0);
  // every store into this block has landed; once all blocks are here
  // (waited for at the end) none is in flight and any may exit
  cluster_arrive_relaxed();
  // this rank's columns: weights exp(m_s - m) of every split, the
  // denominator and the sums over the splits in rank order
  T* ob = out + (static_cast<size_t>(b) * p.H + h0) * p.D;
  const int mine = p.cb[split + 1] - p.cb[split];   // 4-column blocks here
  const int r = warp;                                // head r: warp r
  for (int lb = lane; r < gb && lb < mine; lb += kWarp) {
    const int d0 = (p.cb[split] + lb) * 4;
    float ms[kMaxSplits], ls[kMaxSplits];
    float4 xs[kMaxSplits];
    float m = kNeg;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < S) {
        ms[s] = rm[s * kMaxG + r];
        ls[s] = rl[s * kMaxG + r];
        xs[s] = *reinterpret_cast<const float4*>(
            recv + (s * kMaxG + r) * lay.dsl + lb * 4);
        m = fmaxf(m, ms[s]);
      }
    float den = 0.f;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < S) {
        const float w = expf(ms[s] - m);
        den += w * ls[s];
        a[0] += w * xs[s].x;
        a[1] += w * xs[s].y;
        a[2] += w * xs[s].z;
        a[3] += w * xs[s].w;
      }
    const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] *= inv;
    T* o = ob + r * p.D + d0;
    if (p.D % 4 == 0 && d0 + 4 <= p.D) {
      store4(o, a);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < p.D) o[e] = from_f32<T>(a[e]);
    }
  }
  cluster_wait();
}

bool make_problem(int B, int H, int Hkv, int L, int D, float scale,
                  int item, int splits, int chunk, int stages, Problem* p) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || L <= 0 ||
      D <= 0 || D > kMaxD || splits < 1 || splits > kMaxSplits || chunk < 1 ||
      chunk > kMaxChunk || (stages != 1 && stages != 2) ||
      (stages == 1 && chunk < ceil_div(L, splits)))
    return false;
  p->B = B;
  p->H = H;
  p->Hkv = Hkv;
  p->L = L;
  p->D = D;
  p->G = H / Hkv;
  p->tiles = ceil_div(p->G, kMaxG);
  p->splits = splits;
  p->chunk = chunk;
  p->stages = stages;
  p->item = item;
  const int unit = item == 2 ? 16 : 4;
  p->dp = ceil_div(D, unit) * unit;
  p->rows = item == 2 ? ceil_div(chunk, 16) * 16 : chunk;
  p->rs = row_stride(p->dp * item);
  p->async = 0;
  const int nv = D * item / 16;
  p->per = nv > 0 ? kThreads / nv : 0;
  p->nv_shift = -1;
  for (int sh = 0; (1 << sh) <= nv; ++sh)
    if ((1 << sh) == nv) p->nv_shift = sh;
  // split s: keys [s L / S, (s + 1) L / S); rank t: 4-column blocks
  // [t n / S, (t + 1) n / S) of the n = dp / 4 of a row
  for (int s = 0; s <= kMaxSplits; ++s) {
    const int t = s < splits ? s : splits;
    p->kb[s] = static_cast<int>(static_cast<int64_t>(t) * L / splits);
    p->cb[s] = t * (p->dp / 4) / splits;
  }
  p->scale = scale;
  return B <= 65535 && Hkv * p->tiles <= 65535 &&
         Layout(*p).bytes <= kSmemLimit;
}

// The load path: 16-byte cp.async where rows are whole 16-byte vectors and
// q, K, V are 16-byte aligned, else plain loads.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, Problem p, cudaStream_t s) {
  p.async = (p.D * sizeof(T)) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int bytes = Layout(p).bytes;
  if (bytes > 48 * 1024) {
    // the attribute belongs to the current device's context, so it is set
    // on every launch that needs it
    const cudaError_t err = cudaFuncSetAttribute(
        figcache_decode_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.Hkv * p.tiles, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, figcache_decode_kernel<T>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `dtype` is 0
// for f32 and 1 for bf16.  `splits` (1..8, the cluster size), `chunk`
// (keys per ring stage, 1..256) and `stages` (1 or 2) are the wrapper's
// plan.  Returns cudaGetLastError(): non-zero means the launch was
// refused; 22 (cudaErrorInvalidValue) for a shape or plan it does not
// take.
extern "C" int figcache_decode_launch(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* out, int B, int H, int Hkv,
                                      int L, int D, float scale, int dtype,
                                      int splits, int chunk, int stages,
                                      void* stream) {
  if (B <= 0 || H <= 0) return 0;
  Problem p;
  if ((dtype != 0 && dtype != 1) ||
      !make_problem(B, H, Hkv, L, D, scale, dtype == 0 ? 4 : 2, splits,
                    chunk, stages, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(q, k, v, valid, out, p, s)
                 : launch<__nv_bfloat16>(q, k, v, valid, out, p, s);
  return static_cast<int>(err);
}

// Dynamic shared memory a block of that plan takes (bytes), or -1 where
// the launch would refuse the plan.
extern "C" int figcache_decode_smem_bytes(int H, int Hkv, int L, int D,
                                          int dtype, int splits, int chunk,
                                          int stages) {
  Problem p;
  if ((dtype != 0 && dtype != 1) ||
      !make_problem(1, H, Hkv, L, D, 1.f, dtype == 0 ? 4 : 2, splits, chunk,
                    stages, &p))
    return -1;
  return Layout(p).bytes;
}
