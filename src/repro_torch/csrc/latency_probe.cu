// Latency probe for Hopper (sm_90a).  Not a port of a TPU kernel and not
// on any path of the port: chip_smoke.py times with it the dependent round
// trips that one step of the replay kernel (sim_scan.cu) is made of, and
// multiplies them by a step's count of each (chip_smoke.py, CHAIN) into
// the replay's chain bound.
//
//   mode 0  one thread follows `steps` links of the cycle in `buf`
//           (j = buf[j]) with plain global loads, as the replay loads its
//           state: an L1 hit when the cycle's lines fit in L1, an L2 hit
//           when they do not;
//   mode 1  one thread runs `steps` iterations of buf[0] += 1;
//           buf[32] += 1 (two lines) through two pointers that may alias,
//           so each load waits for the other word's store, as commit()'s
//           read-modify-writes do: two round trips an iteration, each a
//           load of a line this thread stored the iteration before;
//   mode 2  one warp runs `steps` dependent __shfl_xor_sync + add, the
//           step of fts_lookup_warp()'s reduction.
// out[0] takes the result, so that nothing is optimised away.  The caller
// times two step counts and takes the difference, which leaves the launch
// out.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o liblatency_probe.so latency_probe.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chase(const int32_t* buf, int32_t* out, int steps) {
  int32_t j = 0;
  for (int k = 0; k < steps; ++k) j = buf[j];
  out[0] = j;
}

__global__ void reload(int32_t* a, int32_t* b, int32_t* out, int steps) {
  for (int k = 0; k < steps; ++k) {
    a[0] = a[0] + 1;
    b[0] = b[0] + 1;
  }
  out[0] = a[0] + b[0];
}

__global__ void shuffle(int32_t* out, int steps) {
  int32_t v = threadIdx.x;
  for (int k = 0; k < steps; ++k) v = __shfl_xor_sync(0xffffffffu, v, 1) + 1;
  if (threadIdx.x == 0) out[0] = v;
}

}  // namespace

// Run probe `mode` for `steps` steps on `stream` (a cudaStream_t passed as
// a pointer).  `buf` is the cycle (mode 0) or at least 33 words (mode 1).
// Returns cudaGetLastError(): non-zero means the launch was refused.
extern "C" int latency_probe_launch(int32_t* buf, int32_t* out, int steps,
                                    int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    chase<<<1, 1, 0, s>>>(buf, out, steps);
  } else if (mode == 1) {
    reload<<<1, 1, 0, s>>>(buf, buf + 32, out, steps);
  } else {
    shuffle<<<1, 32, 0, s>>>(out, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
