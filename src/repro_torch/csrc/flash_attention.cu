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
// visited.  Any S works: rows and keys past S are zero-filled and masked,
// and rows past S are never stored.
//
// Bound on this card: operations.  At Qwen2-7B's prefill (B = 4, S = 4096,
// H = 28, Hkv = 4, D = 128, bf16, causal) the two products are 4.81e11
// FLOP (0.4865 ms at 989 TFLOP/s) against 0.27 GB of q, k, v and out
// (0.080 ms at 3.35 TB/s), so the bf16 path is built to keep the tensor
// cores fed:
//   * 3 warpgroups per block over 128 queries.  Warpgroup 2 is the
//     producer (setmaxnreg leaves it 40 registers and the consumers 232):
//     one thread issues TMA copies (cp.async.bulk.tensor over 4-D maps of
//     the model's layouts, no transpose, no repeated K/V) of the Q tile
//     once, then of 128-key K and V tiles into a ring of 2 stages.  Each
//     stage has mbarriers "K full", "V full", "K empty" and "V empty", so
//     a stage's K is refilled as soon as both consumers have its scores.
//     TMA writes each tile with the 128-byte swizzle (D*2 bytes for D < 64)
//     that the wgmma descriptors name; a row of D = 128 is two 64-column
//     swizzle atoms, one copy each.  Boxes past S are zero-filled.
//   * Warpgroups 0 and 1 are consumers, 64 query rows each.  S = Q K^T is
//     wgmma with Q and K from shared memory (both K-major).  P V is wgmma in
//     its register form: the f32 fragments of S, after the online softmax,
//     convert in place into the A fragments of P, and V is read from shared
//     memory as an MN-major (transposed) B operand, one column atom per
//     instruction.
//   * The two consumers take turns on the tensor cores (two named
//     barriers): a turn runs P V of the previous tile, then S of the next,
//     and one warpgroup's softmax runs while the other has its turn.
//     Inside a warpgroup the products run one after the other: overlapping
//     them needs S, P and the accumulator live at once (~200 registers),
//     and that version spilled (PERF.md).
//   * The online softmax runs on the accumulator fragments: ex2.approx
//     with log2(e) folded into the scale, one FMA for scale and subtract
//     on tiles without masked elements, row max and sum over the 4 threads
//     of a quad by shuffles; masks only on edge tiles.  The softmax and
//     the turns overlap the tensor work poorly: at Qwen2-7B's prefill the
//     products alone would take 0.73 ms at the peak of the kernel's
//     1.28 ms (PERF.md).
//   * P keeps ~16 bits: it is split into a bf16 high part and a bf16
//     remainder and P V runs for both (1.5x the tensor work of one bf16 P).
//     The TPU kernel keeps P in f32; one bf16 rounding of P misses the
//     per-layer hold at the LM's activations (PERF.md).
//   * Blocks run the longest causal rows first.
// The f32 path keeps f32 throughout on the CUDA cores (tensor-core TF32
// would miss the 2e-5 tolerance): 4 warps, a 32-query tile (8 rows per
// warp), 32-key tiles, one key per lane for the scores and D/32 columns
// per lane for P V.
// Head dims: 16, 32, 64, 128 and 192 are instantiated; the wrapper
// zero-pads q, k and v to the next of them and passes the true D^-0.5,
// which is exact (zero columns add nothing to q . k, and the output's
// padded columns are sliced off).  D = 192 (three 64-column atoms) runs
// 64-key tiles, so that Q and the K/V ring fit in shared memory.
//
// Build (plain C interface, loaded with ctypes; the tensor-map encoder is
// fetched from the driver at run time, so libcuda is not linked):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;   // f32 path: 4 warps
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
// bf16 path: TMA, mbarriers, wgmma

constexpr int kBQ = 128;             // queries per block (64 per consumer)
constexpr int kStages = 2;           // K/V tiles in flight
constexpr int kConsumers = 2;        // consumer warpgroups
constexpr int kTmaThreads = 128 * (kConsumers + 1);   // + the producer's

// Shared memory of one block for head dim D.  A tile of R rows is stored
// as D / kCols column blocks ("atoms") of R rows x kSpan bytes, each written
// by one TMA copy with the kSpan-byte swizzle (128 B for D >= 64, else D*2
// bytes) that the wgmma descriptors read back.  Key tiles hold 128 keys up
// to D = 128 and 64 at D = 192: there the Q tile (48 KB) and a 2-stage
// ring of 128-key K/V tiles (192 KB) would pass the 227 KB a block may
// have, and 64-key tiles (96 KB) leave the consumers 96 f32 of O and 32
// of S a thread.
template <int D>
struct Smem {
  static constexpr int kBK = D <= 128 ? 128 : 64;   // keys per tile
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kSpan = 2 * kCols;
  static constexpr int kAtoms = D / kCols;
  static constexpr int kQ = kBQ * D * 2;         // bytes of the Q tile
  static constexpr int kKV = kBK * D * 2;        // bytes of a K or V tile
  static constexpr int kK = kQ;                  // offset of K stage 0
  static constexpr int kV = kK + kStages * kKV;  // offset of V stage 0
  static constexpr int kBar = kV + kStages * kKV;
  // Q full, then K full, V full, K empty, V empty per stage; + 1 KB to
  // align the base
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile whose rows are `span`
// bytes apart: start address, the 8-row stride in both offset fields, and
// the swizzle mode (1 = 128 B, 2 = 64 B, 3 = 32 B).  A K-major operand
// reads only the stride field.  For an MN-major one the leading field is
// the stride between column atoms along N and the stride field the 8-row
// stride along K (on the card the swapped pair gives wrong sums at
// N = 128); each P V instruction here spans one atom, so only the 8-row
// stride is read.
template <int span>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kStride = (8 * span) >> 4;
  constexpr uint64_t kMode = span == 128 ? 1 : span == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kStride << 16) |
         (kStride << 32) | (kMode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void reg_fence(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d (64 x 128, f32) += a (64 x 16) * b (128 x 16)^T, both K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, f32) = a (64 x 16) * b (128 x 16)^T: the first k-step, which
// writes d without reading it
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64, f32) (+)= a (64 x 16) * b (64 x 16)^T, both K-major in shared
// memory; `accumulate` 0 writes d without reading it (the first k-step)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += a (64 x 16, registers) * b (16 x 64, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, f32) += a (64 x 16, registers) * b (16 x 32, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16, f32) += a (64 x 16, registers) * b (16 x 16, shared
// memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else {
    wgmma_rs_n16(d, a, db);
  }
}

// two probabilities (column order) -> their bf16 high parts and remainders,
// packed as A-fragment registers
__device__ __forceinline__ void split2(float x0, float x1, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Named barrier `id` over both consumer warpgroups: wait, or only arrive.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * kConsumers)
               : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * kConsumers)
               : "memory");
}

// 2^x by the special-function unit (2 ulp; results below 2^-126 flush to
// 0): one instruction, where exp2f adds range handling around it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wait until this warpgroup's committed wgmma groups have completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Register fragments of one consumer warpgroup (64 query rows).  Element e
// of an accumulator's 8-column block j is row g + 8 * (e >> 1), column
// 8 j + 2 tig + (e & 1), with 16 rows per warp.
template <int D>
struct Frags {
  static constexpr int kCols = Smem<D>::kCols;
  static constexpr int kBK = Smem<D>::kBK;
  float o[D / kCols][kCols / 2];   // output accumulator, column atoms
  float s[kBK / 2];                // scores, then exp2(s - max)
  uint32_t ph[kBK / 16][4];        // P, high bf16 parts, per 16-key step
  uint32_t pl[kBK / 16][4];        // P, bf16 remainders
};

template <int D>
__device__ __forceinline__ void fence_pv(Frags<D>& f) {
  constexpr int kBK = Smem<D>::kBK;
#pragma unroll
  for (int a = 0; a < D / Frags<D>::kCols; ++a)
#pragma unroll
    for (int e = 0; e < Frags<D>::kCols / 2; ++e) reg_fence(f.o[a][e]);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(f.ph[kk][j]);
      reg_fence(f.pl[kk][j]);
    }
}

// Issue S = Q K^T of one key tile over D in 16-column steps: this
// warpgroup's Q rows at q_c, the K tile at k_t.
template <int D>
__device__ __forceinline__ void issue_qk(Frags<D>& f, uint32_t q_c,
                                         uint32_t k_t) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk * 16 / L::kCols;
    const uint32_t off = (kk * 16 % L::kCols) * 2;
    const uint64_t dq = smem_desc<L::kSpan>(q_c + a * kBQ * L::kSpan + off);
    const uint64_t dk =
        smem_desc<L::kSpan>(k_t + a * L::kBK * L::kSpan + off);
    if constexpr (L::kBK == 128) {
      if (kk == 0) {
        wgmma_ss_n128_first(f.s, dq, dk);
      } else {
        wgmma_ss_n128(f.s, dq, dk);
      }
    } else {
      wgmma_ss_n64(f.s, dq, dk, kk != 0);
    }
  }
}

// Issue O += P V of one key tile (P = high parts + remainders), the V tile
// at v_t read as an MN-major B operand one column atom at a time.
template <int D>
__device__ __forceinline__ void issue_pv(Frags<D>& f, uint32_t v_t) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
      const uint64_t dv =
          smem_desc<L::kSpan>(v_t + a * kBK * L::kSpan + kk * 16 * L::kSpan);
      wgmma_rs<L::kCols>(f.o[a], f.ph[kk], dv);
      wgmma_rs<L::kCols>(f.o[a], f.pl[kk], dv);
    }
  }
}

// The online softmax of one key tile (keys k0 ..) in log2 units: scale and
// (on an edge tile) mask the scores, update the running max m and the
// denominators l, leave exp2(s - m) in f.s and the accumulator's factor in
// corr.  A tile without masked elements takes its max on the raw scores
// and scales and subtracts in one FMA (one rounding instead of two).
template <int D>
__device__ __forceinline__ void softmax_tile(Frags<D>& f, float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Problem& p,
                                             const int (&row)[2], int tig,
                                             int k0, bool edge,
                                             float scale2) {
  constexpr int kBK = Smem<D>::kBK;
  float mx[2];
  if (edge) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int r = (e >> 1) & 1;
      float x = f.s[e] * scale2;
      if (masked(p, row[r], k0 + 8 * (e >> 2) + 2 * tig + (e & 1))) x = kNeg;
      f.s[e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  } else {
    // no masked element: max(s * c) = max(s) * c for c > 0
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], f.s[e]);
    mx[0] = fmaxf(m[0], mx[0] * scale2);
    mx[1] = fmaxf(m[1], mx[1] * scale2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = quad_max(mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
  if (edge) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int r = (e >> 1) & 1;
      f.s[e] = ex2(f.s[e] - m[r]);
      l[r] += f.s[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int r = (e >> 1) & 1;
      f.s[e] = ex2(fmaf(f.s[e], scale2, -m[r]));
      l[r] += f.s[e];
    }
  }
}

// P as A fragments: keys 16 kk .. 16 kk + 15 are 8-column blocks 2 kk and
// 2 kk + 1 of S, in the register order of the A operand
template <int D>
__device__ __forceinline__ void to_fragments(Frags<D>& f) {
  constexpr int kBK = Smem<D>::kBK;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = (2 * kk + half) * 4 + 2 * r;
        split2(f.s[e], f.s[e + 1], &f.ph[kk][2 * half + r],
               &f.pl[kk][2 * half + r]);
      }
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_tma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, Problem p) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK;
  constexpr int kCols = L::kCols;
  constexpr int kSpan = L::kSpan;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  // barriers: Q full, then per stage K full, V full, K empty, V empty
  const uint32_t bar = base + L::kBar;
  auto k_s = [&](int s) { return base + L::kK + s * L::kKV; };
  auto v_s = [&](int s) { return base + L::kV + s * L::kKV; };
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = qt * kBQ;
  int lo, hi;
  key_tiles(p, q0, min(q0 + kBQ, p.S) - 1, kBK, &lo, &hi);
  const int n_tiles = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup index, warp-uniform for the compiler: the consumers are
  // 0 .. kConsumers - 1, the producer kConsumers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full.  A stage's K is refilled
    // once both consumers have its scores, its V once both have used it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar, L::kQ);
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load(q_s + a * kBQ * kSpan, &tq, a * kCols, h, q0, b, bar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (lo + i) * kBK;
        if (i >= kStages) mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::kKV);
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load(k_s(s) + a * kBK * kSpan, &tk, a * kCols, kvh, k0, b,
                   k_full(s));
        if (i >= kStages) mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::kKV);
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load(v_s(s) + a * kBK * kSpan, &tv, a * kCols, kvh, k0, b,
                   v_full(s));
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows q0 + 64 c .. q0 + 64 c + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg;
  const int t = threadIdx.x % 128;
  const int warp = t / kWarp;
  const int lane = t % kWarp;
  const int g = lane >> 2;          // row within an 8-row half
  const int tig = lane & 3;         // column pair within 8 columns
  const int r0 = q0 + 64 * c;
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const uint32_t q_c = q_s + 64 * c * kSpan;   // this warpgroup's Q rows
  const float scale2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
  // a key tile with masked elements for some row of this warpgroup
  auto edge = [&](int k0) {
    return k0 + kBK > p.S || (p.causal && k0 + kBK - 1 > r0) ||
           (p.window > 0 && k0 <= r0 + 63 - p.window);
  };

  Frags<D> f;
#pragma unroll
  for (int a = 0; a < L::kAtoms; ++a)
#pragma unroll
    for (int e = 0; e < kCols / 2; ++e) f.o[a][e] = 0.f;
  float m[2] = {kNeg, kNeg};   // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};     // this thread's share of the denominators
  float corr[2];

  // The two warpgroups take turns on the tensor cores (named barriers 1
  // and 2, one per warpgroup): turn i runs P V of tile i - 1, then S of
  // tile i, and the softmax of tile i overlaps the other's turn.
  if (c == 1) named_arrive(1);   // warpgroup 0 takes the first turn
  mbar_wait(bar, 0);
  for (int i = 0; i <= n_tiles; ++i) {
    named_sync(1 + c);
    if (i > 0) {
      const int s = (i - 1) % kStages;
      mbar_wait(v_full(s), ((i - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv<D>(f, v_s(s));
      wgmma_commit();
      wgmma_wait();
      fence_pv<D>(f);
      if (t == 0) mbar_arrive(v_empty(s));
    }
    if (i < n_tiles) {
      const int s = i % kStages;
      mbar_wait(k_full(s), (i / kStages) & 1);
      wgmma_fence();
      issue_qk<D>(f, q_c, k_s(s));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) reg_fence(f.s[e]);
      if (t == 0) mbar_arrive(k_empty(s));
    }
    // hand the turn over (after warpgroup 1's last turn none is left)
    if (c == 0 || i < n_tiles) named_arrive(2 - c);
    if (i < n_tiles) {
      const int k0 = (lo + i) * kBK;
      softmax_tile<D>(f, m, l, corr, p, row, tig, k0, edge(k0), scale2);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a)
#pragma unroll
        for (int e = 0; e < kCols / 2; ++e) f.o[a][e] *= corr[(e >> 1) & 1];
      to_fragments<D>(f);
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
  const size_t q_stride = static_cast<size_t>(p.H) * D;
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * p.S * p.H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.S) continue;
    __nv_bfloat16* orow = ob + static_cast<size_t>(row[r]) * q_stride;
#pragma unroll
    for (int a = 0; a < L::kAtoms; ++a) {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const __nv_bfloat162 val =
            __floats2bfloat162_rn(f.o[a][4 * j + 2 * r] * inv[r],
                                  f.o[a][4 * j + 2 * r + 1] * inv[r]);
        *reinterpret_cast<__nv_bfloat162*>(orow + a * kCols + 8 * j +
                                           2 * tig) = val;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 path: CUDA cores

constexpr int kSimtBQ = 32;   // queries per block (8 per warp)
constexpr int kSimtBK = 32;   // keys per tile (one per lane)
constexpr int kRowsPerWarp = kSimtBQ / (kThreads / kWarp);
constexpr int kSimtMaxD = 192;

int simt_smem_bytes(int D) {
  return 4 * (kSimtBQ * D + kSimtBK * (D + 1) + kSimtBK * D +
              kSimtBQ * kSimtBK);
}

// kMaxCols: columns of the output per lane, D <= 32 * kMaxCols
template <int kMaxCols>
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

// cuTensorMapEncodeTiled, fetched from the driver once per process.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// 4-D map of a (B, S, heads, D) bf16 tensor, innermost first, whose box is
// one column atom (`cols` of D) of `rows` consecutive positions of one head.
// Boxes reaching past S are zero-filled.
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B,
              int S, int heads, int rows) {
  constexpr int cols = Smem<D>::kCols;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {cols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tma(const void* q, const void* k, const void* v,
                       void* out, const Problem& p, cudaStream_t s) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // built on the host per launch and passed by value, so a CUDA graph
  // captures them with the launch
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(encode, &tq, q, p.B, p.S, p.H, kBQ) ||
      !make_map<D>(encode, &tk, k, p.B, p.S, p.Hkv, Smem<D>::kBK) ||
      !make_map<D>(encode, &tv, v, p.B, p.S, p.Hkv, Smem<D>::kBK))
    return cudaErrorInvalidValue;
  // above 48 KB of shared memory; the attribute belongs to the current
  // device's context, so it is set on every launch (it costs ~1 us)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.H, p.B);
  flash_tma_kernel<D><<<grid, kTmaThreads, Smem<D>::kBytes, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), p);
  return cudaGetLastError();
}


template <int kMaxCols>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, const Problem& p, int D, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(   // per device, as above
      flash_simt_kernel<kMaxCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      simt_smem_bytes(32 * kMaxCols));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kSimtBQ - 1) / kSimtBQ, p.H, p.B);
  flash_simt_kernel<kMaxCols><<<grid, kThreads, simt_smem_bytes(D), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), p, D);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  `dtype` is 0
// for f32 and 1 for bf16; D must be 16, 32, 64, 128 or 192 (the wrapper
// zero-pads any other D up to one of these); `causal` is 0 or 1,
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
      (D != 16 && D != 32 && D != 64 && D != 128 && D != 192))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{B, S, H, Hkv, causal ? 1 : 0, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = D <= 128 ? launch_simt<4>(q, k, v, out, p, D, s)
                   : launch_simt<kSimtMaxD / kWarp>(q, k, v, out, p, D, s);
  } else if (dtype == 1) {
    switch (D) {
      case 16: err = launch_tma<16>(q, k, v, out, p, s); break;
      case 32: err = launch_tma<32>(q, k, v, out, p, s); break;
      case 64: err = launch_tma<64>(q, k, v, out, p, s); break;
      case 128: err = launch_tma<128>(q, k, v, out, p, s); break;
      case 192: err = launch_tma<192>(q, k, v, out, p, s); break;
    }
  }
  return static_cast<int>(err);
}
