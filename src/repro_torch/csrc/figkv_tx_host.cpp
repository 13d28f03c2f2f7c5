// Host build of the FIGCache-KV decode-step transaction (figkv_tx.cuh) with
// scalar row scans: the same per-sequence code as the kernel
// (figkv_tx.cu), compiled by a host C++ compiler so that the CPU tests can
// run it bitwise against the plain version.  Not used by the port itself.
//
// Build (plain C interface, loaded with ctypes):
//   g++ -std=c++17 -O2 -shared -fPIC -o libfigkv_tx_host.so figkv_tx_host.cpp

#include <stdint.h>
#include <string.h>

#include <vector>

#include "figkv_tx.cuh"

namespace {

// The first slot whose tag is seg and whose valid bit is set, S if none.
int32_t scalar_find(const int32_t* tags, const uint8_t* valid, int S,
                    int32_t seg) {
  for (int s = 0; s < S; ++s)
    if (tags[s] == seg && valid[s] != 0) return s;
  return S;
}

}  // namespace

// The transaction and both moves of every sequence, in place, on the host:
// the contract of figkv_tx_launch without a stream.
extern "C" int figkv_tx_host(void* const* ptrs, const long long* dims) {
  const figkv::Args a = figkv::make_args(ptrs, dims);
  std::vector<int32_t> hit(a.n_sel > 0 ? a.n_sel : 1);
  for (int b = 0; b < a.B; ++b) {
    const figkv::Row r = figkv::row_of(a, b);
    for (int i = 0; i < a.n_sel; ++i) {
      hit[i] = scalar_find(r.tags, r.valid, a.S, r.sel[i]);
      if (hit[i] < a.S) figkv::touch(a, r, hit[i]);
    }
    const int32_t ins = figkv::insert_candidate(a, r, hit.data());
    int32_t slot = -1;
    if (ins >= 0) {
      const figkv::Scan sc = figkv::victim_scan(a, r);
      const int32_t cand =
          sc.n > 0 ? sim::masked_argmin(sc.score, sc.n, sc.limit) : 0;
      slot = figkv::insert(a, r, ins, cand);
    }
    a.ins_seg[b] = ins;
    a.ins_slot[b] = slot;
    for (int i = 0; i < a.n_sel; ++i)
      a.slots[static_cast<size_t>(b) * a.n_sel + i] =
          figkv::slot_of(a, r.sel[i], hit[i], ins, slot);
    if (ins >= 0 && ins < a.n_segs && slot >= 0 && slot < a.S) {
      for (int t = 0; t < 2; ++t)
        memcpy(figkv::move_dst(a, t, b, slot), figkv::move_src(a, t, b, ins),
               static_cast<size_t>(a.seg_bytes));
    }
  }
  return 0;
}
