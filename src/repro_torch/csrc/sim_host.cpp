// Host build of the simulator step (sim_step.cuh) with a scalar FTS
// lookup: the same per-request code as the replay kernel (sim_scan.cu),
// compiled by a host C++ compiler so that the CPU tests can replay it
// bitwise against the eager loop.  Not used by the port itself.
//
// Build (plain C interface, loaded with ctypes):
//   g++ -std=c++17 -O2 -shared -fPIC -o libsim_host.so sim_host.cpp

#include <stdint.h>

#include <vector>

#include "sim_step.cuh"

namespace {

// fts_lookup_warp() one entry at a time: the first slot whose tag is seg
// (S if none) and sim::masked_argmin's victim candidate.
sim::Lookup scalar_lookup(const int32_t* tags, const int32_t* score, int S,
                          int32_t seg, int32_t limit) {
  sim::Lookup lk{S, sim::masked_argmin(score, S, limit)};
  for (int s = 0; s < S; ++s) {
    if (tags[s] == seg) {
      lk.hit_slot = s;
      break;
    }
  }
  return lk;
}

}  // namespace

// Replay every step of every lane, in place, on the host: the contract of
// sim_scan_launch without a stream.
extern "C" int sim_replay_host(void* const* ptrs, const int* dims) {
  const sim::Args a = sim::make_args(ptrs, dims);
  const bool tel_on = a.d.period > 0;
  std::vector<int32_t> planes(tel_on ? sim::tel_plane_ints(a.d) : 0);
  for (int n = 0; n < a.d.N; ++n) {
    sim::Tel tel;
    if (tel_on && a.d.T > 0) sim::tel_load(a, n, tel, planes.data());
    for (int t = 0; t < a.d.T; ++t) {
      const sim::Req r = sim::request(a, n, t);
      sim::Lookup lk{a.d.S, 0};
      if (sim::has_cache(a.d))
        lk = scalar_lookup(r.tags_row, r.score_row, a.d.S, r.seg, r.limit);
      sim::Step s;
      sim::decide(a, n, r, lk, s);
      sim::commit(a, n, r, s, t == 0);
      if (tel_on) sim::tel_step(a, n, r, s, tel, planes.data());
    }
    if (tel_on && a.d.T > 0) sim::tel_store(a, n, tel, planes.data());
  }
  return 0;
}
