// Prefill flash attention for Hopper (sm_90a): causal and sliding-window
// masks, grouped-query heads, any sequence length.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`, body `_kernel`), whose grid walks
// (batch*heads, q blocks, kv blocks) with the kv axis sequential and the
// running max / denominator / accumulator in VMEM scratch.  Here one thread
// block owns one (sequence b, query head h, query tile) and loops over the
// key tiles itself, so the online-softmax state stays in registers.
//
//   q      (B, S, H, D)      f32 or bf16, contiguous (the model's layout)
//   k, v   (B, S, Hkv, D)    query head h reads KV head h / (H / Hkv), so
//                            grouped-query attention never repeats K/V
//   out    (B, S, H, D)      the input type
//
// Semantics of the TPU kernel: scores in f32, s = (q . k) * scale with the
// scale applied to the f32 product, a masked score is the finite -1e30
// (causal: key <= query; window w > 0: key > query - w), the running max
// starts at -1e30, the output is acc / max(l, 1e-30) rounded to q's type.
// A key tile that the masks exclude for every query of the tile is never
// visited.  Any S works: rows and keys past S are zero-filled and masked
// (the TPU wrapper's S % block == 0 is not needed).
//
// Bound on this card: operations.  At Qwen2-7B's prefill (B = 4, S = 4096,
// H = 28, Hkv = 4, D = 128, bf16, causal) the two products are ~4.8e11
// FLOP (~0.49 ms at 989 TFLOP/s) against ~0.27 GB of q, k, v and out
// (~0.08 ms at 3.35 TB/s).  The bf16 path therefore runs on the tensor
// cores, simple first (no TMA, no wgmma, no warp specialisation):
//   * 4 warps per block, a 64-query tile (16 rows per warp), 64-key tiles;
//   * Q, K and V tiles staged in shared memory by cp.async (rows padded by
//     16 bytes so ldmatrix is free of bank conflicts); V's copy overlaps
//     the score product;
//   * S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulate), the
//     warp's Q fragments held in registers for the whole key loop;
//   * the online softmax on the f32 accumulator fragments (row max and sum
//     over the 4 threads of a quad by shuffles);
//   * P V with the score fragments reused as A operands.  P is split into
//     a bf16 high part and a bf16 remainder, two products each, so the
//     probabilities keep ~16 bits (the plain version keeps P in f32; one
//     bf16 rounding of P alone would put bf16 outputs of magnitude 4..8
//     one output ulp (2^-5) away from it, past the 2e-2 tolerance).
// The f32 path keeps f32 throughout on the CUDA cores (tensor-core TF32
// would miss the 2e-5 tolerance): 4 warps, a 32-query tile (8 rows per
// warp), 32-key tiles, one key per lane for the scores and D/32 columns
// per lane for P V.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;   // 4 warps, both paths
constexpr float kNeg = -1e30f;

struct Problem {
  int B, S, H, Hkv;
  int causal, window;
  float scale;
};

// Key tiles [lo, hi) that query rows [q0, q1] must visit: the causal mask
// ends at the last row, the window starts after q0 - window.
__device__ __forceinline__ void key_tiles(const Problem& p, int q0, int q1,
                                          int tile, int* lo, int* hi) {
  int last = p.S - 1;
  if (p.causal) last = min(last, q1);
  const int first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  *lo = first / tile;
  *hi = last / tile + 1;
}

__device__ __forceinline__ bool masked(const Problem& p, int row, int key) {
  return key >= p.S || (p.causal && key > row) ||
         (p.window > 0 && key <= row - p.window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// ---------------------------------------------------------------------------
// bf16 path: tensor cores

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two probabilities (column order) -> their bf16 high parts and remainders
__device__ __forceinline__ void split2(float x0, float x1, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  *hi = pack_bf16(h0, h1);
  *lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                  __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

constexpr int kMmaBQ = 64;   // queries per block (16 per warp)
constexpr int kMmaBK = 64;   // keys per tile

// padded shared-memory row, in elements
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (kMmaBQ + 2 * kMmaBK) * mma_ld<D>() * 2;
}

// rows [row0, row0 + ROWS) of a (S, row_stride) bf16 matrix into a padded
// smem tile; rows past S are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int row0, int S) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int s = row0 + r;
    const __nv_bfloat16* g =
        s < S ? src + static_cast<size_t>(s) * row_stride + col : src;
    cp_async16(dst + r * mma_ld<D>() + col, g, s < S ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, Problem p) {
  constexpr int LD = mma_ld<D>();
  constexpr int KS = D / 16;        // k-steps of the score product
  constexpr int NT = kMmaBK / 8;    // score n-tiles per warp
  constexpr int DT = D / 8;         // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_sh = q_sh + kMmaBQ * LD;
  __nv_bfloat16* v_sh = k_sh + kMmaBK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = qt * kMmaBQ;
  const int q1 = min(q0 + kMmaBQ, p.S) - 1;
  const size_t q_stride = static_cast<size_t>(p.H) * D;
  const size_t kv_stride = static_cast<size_t>(p.Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * p.S * p.H + h) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<size_t>(b) * p.S * p.Hkv + kvh) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<size_t>(b) * p.S * p.Hkv + kvh) * D;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2;          // row within the 8-row half of a tile
  const int tig = lane & 3;         // column pair within an 8-column tile

  load_tile<D, kMmaBQ>(q_sh, qb, q_stride, q0, p.S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];   // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], q_sh + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNeg, kNeg};   // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};     // this thread's share of the denominators
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int lo, hi;
  key_tiles(p, q0, q1, kMmaBK, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kMmaBK;
    __syncthreads();                  // the previous tile is consumed
    load_tile<D, kMmaBK>(k_sh, kb, kv_stride, k0, p.S);
    cp_async_commit();
    load_tile<D, kMmaBK>(v_sh, vb, kv_stride, k0, p.S);
    cp_async_commit();
    cp_async_wait<1>();               // K has landed; V may be in flight
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_sh + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[nt], qf[kk], bk[0], bk[1]);
        mma_bf16(s[nt + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax; element e of an n-tile is row
    // g + 8 * (e >> 1), key 2 * tig + (e & 1)
    const bool edge = k0 + kMmaBK > p.S ||
                      (p.causal && k0 + kMmaBK - 1 > q0) ||
                      (p.window > 0 && k0 <= q1 - p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (edge && masked(p, row[e >> 1], k0 + nt * 8 + 2 * tig + (e & 1)))
          x = kNeg;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = quad_max(mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    cp_async_wait<0>();               // V has landed
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      // the score fragments of keys 16j..16j+15 are the A fragment of P
      uint32_t ph[4], pl[4];
      split2(s[2 * j][0], s[2 * j][1], &ph[0], &pl[0]);
      split2(s[2 * j][2], s[2 * j][3], &ph[1], &pl[1]);
      split2(s[2 * j + 1][0], s[2 * j + 1][1], &ph[2], &pl[2]);
      split2(s[2 * j + 1][2], s[2 * j + 1][3], &ph[3], &pl[3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_sh + (j * 16 + (lane & 15)) * LD + dt * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(o[dt], ph, bv[0], bv[1]);
        mma_bf16(o[dt], pl, bv[0], bv[1]);
        mma_bf16(o[dt + 1], ph, bv[2], bv[3]);
        mma_bf16(o[dt + 1], pl, bv[2], bv[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * p.S * p.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.S) continue;
    __nv_bfloat16* orow = ob + static_cast<size_t>(row[r]) * q_stride;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          o[dt][2 * r] * inv[r], o[dt][2 * r + 1] * inv[r]);
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * tig) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 path: CUDA cores

constexpr int kSimtBQ = 32;   // queries per block (8 per warp)
constexpr int kSimtBK = 32;   // keys per tile (one per lane)
constexpr int kRowsPerWarp = kSimtBQ / (kThreads / kWarp);
constexpr int kMaxCols = 4;   // D / 32 columns per lane, D <= 128

int simt_smem_bytes(int D) {
  return 4 * (kSimtBQ * D + kSimtBK * (D + 1) + kSimtBK * D +
              kSimtBQ * kSimtBK);
}

__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  Problem p, int D) {
  extern __shared__ float fsm[];
  float* q_sh = fsm;                          // [BQ][D]
  float* k_sh = q_sh + kSimtBQ * D;           // [BK][D + 1]
  float* v_sh = k_sh + kSimtBK * (D + 1);     // [BK][D]
  float* p_sh = v_sh + kSimtBK * D;           // [BQ][BK]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = qt * kSimtBQ;
  const int q1 = min(q0 + kSimtBQ, p.S) - 1;
  const size_t q_stride = static_cast<size_t>(p.H) * D;
  const size_t kv_stride = static_cast<size_t>(p.Hkv) * D;
  const float* qb = q + (static_cast<size_t>(b) * p.S * p.H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * p.S * p.Hkv + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * p.S * p.Hkv + kvh) * D;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int r0 = warp * kRowsPerWarp;         // this warp's first tile row

  for (int i = threadIdx.x; i < kSimtBQ * D; i += kThreads) {
    const int s = q0 + i / D;
    q_sh[i] = s < p.S ? qb[static_cast<size_t>(s) * q_stride + i % D] : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  int lo, hi;
  key_tiles(p, q0, q1, kSimtBK, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kSimtBK;
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtBK * D; i += kThreads) {
      const int j = i / D, d = i % D, s = k0 + j;
      const size_t off = static_cast<size_t>(s) * kv_stride + d;
      k_sh[j * (D + 1) + d] = s < p.S ? kb[off] : 0.f;
      v_sh[i] = s < p.S ? vb[off] : 0.f;
    }
    __syncthreads();
    // scores: lane = key, the warp's rows at once
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = k_sh[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        sc[r] += q_sh[(r0 + r) * D + d] * kd;
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float x = sc[r] * p.scale;
      if (masked(p, q0 + r0 + r, key)) x = kNeg;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float pe = expf(x - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pe);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[r][c] *= corr;
      p_sh[(r0 + r) * kSimtBK + lane] = pe;
    }
    __syncwarp();
    // P V: lane owns columns lane + 32 c
    for (int j = 0; j < kSimtBK; ++j) {
      float vj[kMaxCols];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int d = lane + c * kWarp;
        vj[c] = d < D ? v_sh[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = p_sh[(r0 + r) * kSimtBK + j];
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) acc[r][c] += pj * vj[c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = q0 + r0 + r;
    if (s >= p.S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(b) * p.S * p.H + h) * D +
                  static_cast<size_t>(s) * q_stride;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = lane + c * kWarp;
      if (d < D) orow[d] = acc[r][c] * inv;
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, const Problem& p, cudaStream_t s) {
  // above 48 KB of shared memory; the attribute belongs to the current
  // device's context, so it is set on every launch (it costs ~1 us)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kMmaBQ - 1) / kMmaBQ, p.H, p.B);
  flash_mma_kernel<D><<<grid, kThreads, mma_smem_bytes<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      p);
  return cudaGetLastError();
}

cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, const Problem& p, int D, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(   // per device, as above
      flash_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      simt_smem_bytes(128));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kSimtBQ - 1) / kSimtBQ, p.H, p.B);
  flash_simt_kernel<<<grid, kThreads, simt_smem_bytes(D), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), p, D);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `dtype` is 0
// for f32 and 1 for bf16; D must be 16, 32, 64 or 128; `causal` is 0 or 1,
// `window` 0 (none) or the window length.  Returns the launch's
// cudaGetLastError(): non-zero means the launch was refused; 22
// (cudaErrorInvalidValue) for a shape it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int Hkv, int D, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || window < 0 || B > 65535 || H > 65535 ||
      (D != 16 && D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{B, S, H, Hkv, causal ? 1 : 0, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_simt(q, k, v, out, p, D, s);
  } else if (dtype == 1) {
    switch (D) {
      case 16: err = launch_mma<16>(q, k, v, out, p, s); break;
      case 32: err = launch_mma<32>(q, k, v, out, p, s); break;
      case 64: err = launch_mma<64>(q, k, v, out, p, s); break;
      case 128: err = launch_mma<128>(q, k, v, out, p, s); break;
    }
  }
  return static_cast<int>(err);
}
