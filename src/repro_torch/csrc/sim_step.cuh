// One request of the FIGCache DRAM simulator's fused step, for one lane:
// the per-request body of core/dram.py (make_decision_fn + make_step),
// which ports the JAX package's lax.scan body (src/repro/core/dram.py).
//
// Everything here but the warp-wide tag lookup, written once for two
// builds: nvcc compiles it into the replay kernel (sim_scan.cu, where
// every function is __host__ __device__ and the lookup is
// fts_lookup_warp()), and a host C++ compiler into the small host library
// (sim_host.cpp, a scalar lookup) that the CPU tests replay bitwise
// against the eager loop.
//
// A step is three calls, so that a warp whose threads all compute it can
// let one thread store:
//   request()  reads the request and picks the bank row the lookup scans;
//   decide()   reads the pre-step state and computes every value the step
//              writes (a Step), touching nothing;
//   commit()   stores the Step (one thread; read-modify-writes read the
//              pre-step value, which nothing else has written).
//
// Semantics kept bit for bit with the eager loop (and the JAX package):
//   * int32 arithmetic wraps (added and multiplied as uint32: signed
//     overflow is undefined in C++);
//   * floor division and Python's remainder (a tag of -1 reaches the LISA
//     hop count), never C's truncation;
//   * the Random victim hash in int64, masked to 31 bits;
//   * the eager loop's index clamps (free-list top, RowBenefit gather);
//   * LAT_SUM_CAP saturation after every add (the eager loop clamps every
//     core's sum each step; after the first step only the added one can
//     exceed the cap, so commit() clamps all of them on the first step
//     and the added one after);
//   * ties to the first index, as jnp.argmin;
//   * a no-op request (t_issue >= NOOP_ISSUE) stores back old values.
//
// Telemetry windows (dram._telemetry_step, DESIGN.md §15/§16), when the
// period is set: tel_step() after commit() folds the request into the
// open window, which a Tel holds in registers for the whole replay (the
// 12 scalar lanes) and in a small planes buffer (the window's bank issues
// and latency histogram, the cumulative read/write histogram and the
// over-SLO counts: shared memory in the kernel).  A ring row is written
// only when a window closes (its values just before the reset) and, by
// tel_store(), for the live window at the end: the same rows as the eager
// loop's "write row n every step", filler rows included.

#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define SIM_FN __host__ __device__ __forceinline__
#else
#define SIM_FN inline
#endif

namespace sim {

constexpr int32_t kNoopIssue = 1 << 30;          // dram.NOOP_ISSUE
constexpr int32_t kLatSumCap = (1 << 30) - 1;    // dram.LAT_SUM_CAP
constexpr int32_t kMshr = 8;                     // dram.N_MSHR
constexpr int32_t kBig = 1 << 30;                // fts.BIG
constexpr int kHistBuckets = 28;                 // dram.HIST_BUCKETS
constexpr int kTelLanes = 12;                    // dram._TEL_SCALARS

// timing.MECHANISMS and the replacement policies, in that order
enum Mechanism { kBase, kLisaVilla, kFigSlow, kFigFast, kFigIdeal, kLldram };
enum Policy { kRowBenefit, kSegmentBenefit, kLru, kRandom };

SIM_FN int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
SIM_FN int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
SIM_FN int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
// floor division and Python's remainder, for b > 0
SIM_FN int32_t floordiv(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
SIM_FN int32_t pymod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return r < 0 ? r + b : r;
}
SIM_FN int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
SIM_FN int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
SIM_FN int32_t clampi(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The FTS victim argmin (fts.masked_argmin): the first index of the
// minimum of (i < limit ? score[i] : BIG) over the n > 0 entries i < n,
// ties to the first index, as jnp.argmin.  Only the kept entries,
// i < kept_count(n, limit), need reading: every other one reads BIG, so
// the first of them (index kept) wins only when none is kept or every
// kept entry is above BIG.  masked_pick() takes the first minimum
// (val, idx) over the kept entries (any val when none is kept); the warp
// scan of fts_lookup.cuh and masked_argmin() below both end in it.
SIM_FN int kept_count(int n, int32_t limit) {
  return limit < n ? (limit > 0 ? limit : 0) : n;
}
SIM_FN int32_t masked_pick(int n, int kept, int32_t val, int32_t idx) {
  return (kept < n && (kept == 0 || val > kBig)) ? kept : idx;
}
// The same, one entry at a time (the host builds).
SIM_FN int32_t masked_argmin(const int32_t* score, int n, int32_t limit) {
  const int kept = kept_count(n, limit);
  int32_t val = 0, idx = 0;
  for (int i = 0; i < kept; ++i) {
    if (i == 0 || score[i] < val) {
      val = score[i];
      idx = i;
    }
  }
  return masked_pick(n, kept, val, idx);
}

// The §16 bucket of a latency: its bit length (32 - clz), clipped into
// the last bucket.  clz(0) is 32 on the card; the host builtin is
// undefined at 0, so zero is taken apart there.
SIM_FN int32_t hist_bucket(int32_t lat) {
  const int32_t v = lat > 0 ? lat : 0;
#if defined(__CUDA_ARCH__)
  const int32_t bits = 32 - __clz(v);
#else
  const int32_t bits =
      v == 0 ? 0 : 32 - __builtin_clz(static_cast<uint32_t>(v));
#endif
  return imin(bits, kHistBuckets - 1);
}

// Sizes and static choices of one replay (the dims array, in this order).
struct Dims {
  int T, N;                 // steps, lanes
  int n_banks, S, MS, NT;   // FTS: max_slots, max_segs_per_row, tracker
  int n_cores;
  int n_rows, rows_per_subarray, n_subarrays;
  int mech, policy;
  int period, W;            // telemetry window period (0: off), ring rows
};

// Every leaf, as device (or host) pointers in the order of the Python
// NamedTuples: Trace, MechParams, BankState (FTS flattened), Counters (50
// pointers), then with a telemetry period the 9 leaves of dram.TelScan.
// bool leaves are one byte, 0 or 1.
struct Args {
  Dims d;
  // trace, (T, N)
  const int32_t *t_issue, *bank, *row, *col;
  const uint8_t* is_write;
  const int32_t* core;
  // params, (N,)
  const int32_t *rcd, *rp, *cas, *bl, *ccd, *rcd_fast, *rp_fast, *reloc,
      *lisa_hop, *seg_blocks, *insert_threshold, *benefit_max, *n_slots,
      *segs_per_row, *slo_ns;
  // bank state
  int32_t *open_row, *busy;                 // (N, n_banks)
  int32_t* tags;                            // (N, n_banks, S)
  uint8_t *valid, *dirty;                   // (N, n_banks, S)
  int32_t *benefit, *last_use;              // (N, n_banks, S)
  int32_t* evict_row;                       // (N, n_banks)
  uint8_t* evict_mask;                      // (N, n_banks, MS)
  int32_t *miss_tags, *miss_cnt;            // (N, n_banks, NT)
  int32_t *row_sum, *free_list;             // (N, n_banks, S)
  int32_t* n_valid;                         // (N, n_banks)
  int32_t* mshr_ring;                       // (N, n_cores, kMshr)
  int32_t* mshr_idx;                        // (N, n_cores)
  int32_t* bus_free;                        // (N,)
  // counters, (N,) except lat_sum_ns and req_cnt (N, n_cores)
  int32_t *acts_slow, *acts_fast, *reads, *writes, *reloc_blocks,
      *wb_blocks, *row_hits, *cache_hits, *insertions, *lat_sum_ns,
      *req_cnt, *t_end;
  // telemetry (dram.TelScan): the open window (N, 12), (N, n_banks),
  // (N, kHistBuckets); the cumulative planes (N, 2, n_cores,
  // kHistBuckets) and (N, n_cores); the ring (N, W, 12), (N, W, n_banks),
  // (N, W, kHistBuckets); the closed-window count (N,)
  int32_t *tel_scalars, *tel_banks, *tel_hist_win, *tel_hist, *tel_slo,
      *buf_scalars, *buf_banks, *buf_hist, *tel_n;
};

SIM_FN Args make_args(void* const* p, const int* dims) {
  Args a;
  a.d = Dims{dims[0], dims[1], dims[2],  dims[3],  dims[4],
             dims[5], dims[6], dims[7],  dims[8],  dims[9],
             dims[10], dims[11], dims[12], dims[13]};
  int i = 0;
  auto i32 = [&]() { return static_cast<int32_t*>(p[i++]); };
  auto u8 = [&]() { return static_cast<uint8_t*>(p[i++]); };
  a.t_issue = i32(); a.bank = i32(); a.row = i32(); a.col = i32();
  a.is_write = u8(); a.core = i32();
  a.rcd = i32(); a.rp = i32(); a.cas = i32(); a.bl = i32(); a.ccd = i32();
  a.rcd_fast = i32(); a.rp_fast = i32(); a.reloc = i32();
  a.lisa_hop = i32(); a.seg_blocks = i32(); a.insert_threshold = i32();
  a.benefit_max = i32(); a.n_slots = i32(); a.segs_per_row = i32();
  a.slo_ns = i32();
  a.open_row = i32(); a.busy = i32();
  a.tags = i32(); a.valid = u8(); a.dirty = u8(); a.benefit = i32();
  a.last_use = i32(); a.evict_row = i32(); a.evict_mask = u8();
  a.miss_tags = i32(); a.miss_cnt = i32(); a.row_sum = i32();
  a.free_list = i32(); a.n_valid = i32();
  a.mshr_ring = i32(); a.mshr_idx = i32(); a.bus_free = i32();
  a.acts_slow = i32(); a.acts_fast = i32(); a.reads = i32();
  a.writes = i32(); a.reloc_blocks = i32(); a.wb_blocks = i32();
  a.row_hits = i32(); a.cache_hits = i32(); a.insertions = i32();
  a.lat_sum_ns = i32(); a.req_cnt = i32(); a.t_end = i32();
  a.tel_scalars = a.tel_banks = a.tel_hist_win = a.tel_hist = a.tel_slo =
      a.buf_scalars = a.buf_banks = a.buf_hist = a.tel_n = nullptr;
  if (a.d.period > 0) {
    a.tel_scalars = i32(); a.tel_banks = i32(); a.tel_hist_win = i32();
    a.tel_hist = i32(); a.tel_slo = i32(); a.buf_scalars = i32();
    a.buf_banks = i32(); a.buf_hist = i32(); a.tel_n = i32();
  }
  return a;
}

SIM_FN bool has_cache(const Dims& d) {
  return d.mech == kLisaVilla || d.mech == kFigSlow || d.mech == kFigFast ||
         d.mech == kFigIdeal;
}

// One request of lane n at step t, and the bank row its lookup scans.
struct Req {
  bool real, is_write;
  int32_t t_issue, b, c, row, col, seg;
  size_t bank_row;         // offset of the lane's bank row in (N, NB, S)
  const int32_t* tags_row;
  const int32_t* score_row;
  int32_t limit;           // the lookup's active prefix (0: no argmin)
};

// What the lookup returns: the first slot whose tag is seg (S if none) and
// the policy's victim candidate.
struct Lookup {
  int32_t hit_slot, cand;
};

SIM_FN Req request(const Args& a, int n, int t) {
  const Dims& d = a.d;
  const size_t i = static_cast<size_t>(t) * d.N + n;
  Req r;
  r.t_issue = a.t_issue[i];
  r.real = r.t_issue < kNoopIssue;
  // the eager loop indexes with these; clamped so that a bad trace cannot
  // reach outside the lane's state
  r.b = clampi(a.bank[i], 0, d.n_banks - 1);
  r.c = clampi(a.core[i], 0, d.n_cores - 1);
  r.row = a.row[i];
  r.col = a.col[i];
  r.is_write = a.is_write[i] != 0;
  r.seg = 0;
  r.bank_row = (static_cast<size_t>(n) * d.n_banks + r.b) * d.S;
  r.tags_row = a.tags + r.bank_row;
  r.score_row = r.tags_row;
  r.limit = 0;
  if (has_cache(d)) {
    const int32_t spr = a.segs_per_row[n];
    const int32_t n_slots = a.n_slots[n];
    r.seg = wadd(wmul(r.row, spr), floordiv(r.col, a.seg_blocks[n]));
    if (d.policy == kRowBenefit) {
      r.score_row = a.row_sum + r.bank_row;
      r.limit = floordiv(wsub(wadd(n_slots, spr), 1), spr);
    } else if (d.policy == kSegmentBenefit) {
      r.score_row = a.benefit + r.bank_row;
      r.limit = n_slots;
    } else if (d.policy == kLru) {
      r.score_row = a.last_use + r.bank_row;
      r.limit = n_slots;
    }
  }
  return r;
}

// Everything one step stores, computed from the pre-step state.
struct Step {
  // FTS write-back of slot w (cached mechanisms only)
  int32_t w, tag, benefit, last_use, row_delta, evict_row, tr_idx, miss_tag,
      miss_cnt, n_valid_inc;
  bool valid, dirty;
  bool use_victim, need_new;  // RowBenefit: refresh the eviction bitvector
  int32_t jj;                 // ... and clear bit jj of it
  // bank and channel
  int32_t open_row, busy, mshr_slot, mshr_done, mshr_next, bus_free;
  // counter increments
  int32_t acts_slow, acts_fast, reads, writes, reloc_blocks, wb_blocks,
      row_hits, cache_hits, insertions, lat_ns, req, t_end;
  // what telemetry adds (real requests; 0 for a no-op): the request's
  // ordinal (the pre-step reads + writes), its ticks waiting on the busy
  // bus and on a full MSHR, its latency bucket and whether it is over the
  // SLO (exact latency)
  int32_t step_id, bus_wait, mshr_wait, bucket;
  bool over;
};

// Distance (in subarrays) to the nearest interleaved fast subarray.
SIM_FN int32_t lisa_hops(int32_t row, int32_t rows_per_subarray) {
  const int32_t m = pymod(floordiv(row, rows_per_subarray), 4);
  return imin(m, 4 - m);
}

SIM_FN void decide(const Args& a, int n, const Req& r, const Lookup& lk,
                   Step& s) {
  const Dims& d = a.d;
  const bool cache = has_cache(d);
  const bool fast_cache =
      d.mech == kLisaVilla || d.mech == kFigFast || d.mech == kFigIdeal;
  const int32_t cache_base = d.n_rows;
  const size_t bi = static_cast<size_t>(n) * d.n_banks + r.b;
  const int32_t open_b = a.open_row[bi];
  const int32_t step_id = wadd(a.reads[n], a.writes[n]);
  const int32_t spr = a.segs_per_row[n];
  const int32_t seg_blocks = a.seg_blocks[n];
  const int32_t p_rcd = a.rcd[n];

  bool hit = false, served_fast, do_ins = false, ev_dirty = false;
  int32_t target_row = r.row, ins_slot = 0, old_tag = 0;
  s.use_victim = false;
  s.need_new = false;
  s.jj = 0;
  if (cache) {
    const int32_t S = d.S, MS = d.MS;
    const int32_t n_slots = a.n_slots[n];
    const bool cacheable =
        d.mech != kFigSlow ||
        floordiv(r.row, d.rows_per_subarray) != d.n_subarrays - 1;
    const bool hit_raw = lk.hit_slot < S;
    const int32_t slot = lk.hit_slot;
    hit = hit_raw && cacheable && r.real;

    // ---- replacement decision from the carried aggregates
    const int32_t evict_row_b = a.evict_row[bi];
    const uint8_t* em = a.evict_mask + bi * MS;
    int32_t victim_slot, row_sel = 0;
    if (d.policy == kRowBenefit) {
      bool any = false;
      for (int j = 0; j < MS; ++j) any = any || em[j] != 0;
      s.need_new = evict_row_b < 0 || !any;
      row_sel = s.need_new ? lk.cand : evict_row_b;
      // lowest-benefit marked slot of the victim row (gather clamped to
      // the store, as the eager loop's bidx.clamp)
      int32_t best = 0;
      for (int j = 0; j < MS; ++j) {
        const int32_t bj = clampi(wadd(wmul(row_sel, spr), j), 0, S - 1);
        const bool marked = s.need_new ? j < spr : em[j] != 0;
        const int32_t v =
            (j < spr && marked) ? a.benefit[bi * S + bj] : kBig;
        if (j == 0 || v < best) {
          best = v;
          s.jj = j;
        }
      }
      victim_slot = wadd(wmul(row_sel, spr), s.jj);
    } else if (d.policy == kRandom) {
      const int64_t h =
          (static_cast<int64_t>(step_id) * 1103515245LL + 12345LL) &
          0x7FFFFFFFLL;
      const int64_t m = static_cast<int64_t>(n_slots);
      victim_slot = static_cast<int32_t>(((h % m) + m) % m);
    } else {
      victim_slot = lk.cand;
    }
    const int32_t n_valid_b = a.n_valid[bi];
    const bool has_free = n_valid_b < n_slots;
    const int32_t free_slot =
        a.free_list[bi * S + clampi(n_valid_b, 0, S - 1)];

    // ---- insertion policy (consecutive-miss tracker)
    const int32_t tr_idx = pymod(r.seg, d.NT);
    const size_t ti = bi * d.NT + tr_idx;
    const int32_t miss_tag_old = a.miss_tags[ti];
    const int32_t miss_cnt_old = a.miss_cnt[ti];
    const int32_t cnt_new =
        miss_tag_old == r.seg ? wadd(miss_cnt_old, 1) : 1;
    const int32_t thr = a.insert_threshold[n];
    const bool want = thr <= 1 || cnt_new >= thr;
    const bool advance = r.real && cacheable && !hit_raw;
    do_ins = !hit && cacheable && want && r.real;

    // ---- the one slot written: hit slot or landing slot
    ins_slot = has_free ? free_slot : victim_slot;
    const int32_t w = hit ? slot : ins_slot;
    const size_t wi = bi * S + w;
    old_tag = a.tags[wi];
    const bool old_valid = a.valid[wi] != 0;
    const bool old_dirty = a.dirty[wi] != 0;
    const int32_t old_benefit = a.benefit[wi];
    ev_dirty = do_ins && !has_free && old_valid && old_dirty;
    const int32_t b_touch = imin(wadd(old_benefit, 1), a.benefit_max[n]);
    const int32_t new_benefit =
        do_ins ? 1 : (hit ? b_touch : old_benefit);
    s.use_victim = d.policy == kRowBenefit && do_ins && !has_free;
    s.w = w;
    s.tag = do_ins ? r.seg : old_tag;
    s.valid = old_valid || do_ins;
    s.dirty = do_ins ? r.is_write : (old_dirty || (hit && r.is_write));
    s.benefit = new_benefit;
    s.last_use = (hit || do_ins) ? step_id : a.last_use[wi];
    s.row_delta = wsub(new_benefit, old_benefit);
    s.evict_row = s.use_victim ? row_sel : evict_row_b;
    s.tr_idx = tr_idx;
    s.miss_tag = advance ? r.seg : miss_tag_old;
    s.miss_cnt = advance ? cnt_new : miss_cnt_old;
    s.n_valid_inc = (do_ins && has_free) ? 1 : 0;
    if (hit) target_row = wadd(cache_base, floordiv(slot, spr));
    served_fast = hit && fast_cache;
  } else {
    served_fast = d.mech == kLldram;
  }

  // ---- service latency (bank-local half)
  const int32_t rcd = served_fast ? a.rcd_fast[n] : p_rcd;
  const int32_t rp = served_fast ? a.rp_fast[n] : a.rp[n];
  const bool row_hit = open_b == target_row;
  const bool closed = open_b < 0;
  const int32_t pre_act = row_hit ? 0 : wadd(rcd, closed ? 0 : rp);

  // ---- relocation cost (miss-path insertion)
  int32_t reloc_cost = 0, new_open = target_row, moved = 0, wb = 0;
  if (cache) {
    int32_t rc;
    if (d.mech == kFigIdeal) {
      rc = 0;
    } else if (d.mech == kLisaVilla) {
      // whole-row relocation, distance-dependent (the source row is open)
      rc = wadd(wmul(lisa_hops(r.row, d.rows_per_subarray), a.lisa_hop[n]),
                a.rcd_fast[n]);
      if (ev_dirty)
        rc = wadd(rc, wadd(wmul(lisa_hops(old_tag, d.rows_per_subarray),
                                a.lisa_hop[n]),
                           p_rcd));
    } else {
      // FIGARO: seg_blocks RELOCs; a dirty victim's home row is opened
      rc = wmul(seg_blocks, a.reloc[n]);
      if (ev_dirty) rc = wadd(rc, wadd(wmul(seg_blocks, a.reloc[n]), p_rcd));
    }
    if (do_ins) {
      reloc_cost = rc;
      new_open = wadd(cache_base, floordiv(ins_slot, spr));
      moved = seg_blocks;
      wb = ev_dirty ? seg_blocks : 0;
    }
  }

  // ---- channel-shared timing: MSHR closed loop + data bus
  const size_t ci = static_cast<size_t>(n) * d.n_cores + r.c;
  const int32_t mshr_slot = a.mshr_idx[ci];
  s.mshr_slot = mshr_slot;
  const int32_t mshr_free = a.mshr_ring[ci * kMshr + mshr_slot];
  const int32_t t_ready = imax(r.t_issue, mshr_free);
  const int32_t busy_b = a.busy[bi];
  const int32_t t0 = imax(t_ready, busy_b);
  const int32_t bus = a.bus_free[n];
  const int32_t done =
      wadd(imax(wadd(wadd(t0, pre_act), a.cas[n]), bus), a.bl[n]);
  const int32_t serv_end = wadd(wadd(t0, pre_act), a.ccd[n]);
  const int32_t busy_end = wadd(serv_end, reloc_cost);

  s.open_row = r.real ? new_open : open_b;
  s.busy = r.real ? busy_end : busy_b;
  s.mshr_done = r.real ? done : mshr_free;
  s.mshr_next = r.real ? pymod(wadd(mshr_slot, 1), kMshr) : mshr_slot;
  s.bus_free = r.real ? done : bus;

  // ---- counters
  const bool act = !row_hit && r.real;
  s.acts_slow = act && !served_fast;
  s.acts_fast = act && served_fast;
  s.reads = !r.is_write && r.real;
  s.writes = r.is_write && r.real;
  s.reloc_blocks = moved;
  s.wb_blocks = wb;
  s.row_hits = row_hit && r.real;
  s.cache_hits = hit;
  s.insertions = do_ins;
  s.lat_ns = r.real ? floordiv(wsub(done, t_ready), 8) : 0;
  s.req = r.real;
  s.t_end = r.real ? imax(done, busy_end) : 0;

  // ---- telemetry (dead code unless the caller runs tel_step)
  s.step_id = step_id;
  s.bus_wait = r.real ? wsub(done, wadd(wadd(wadd(t0, pre_act), a.cas[n]),
                                        a.bl[n]))
                      : 0;
  s.mshr_wait = r.real ? wsub(t_ready, r.t_issue) : 0;
  s.bucket = hist_bucket(s.lat_ns);
  const int32_t slo = a.slo_ns[n];
  s.over = r.real && slo > 0 && s.lat_ns > slo;
}

SIM_FN void commit(const Args& a, int n, const Req& r, const Step& s,
                   bool first) {
  const Dims& d = a.d;
  const size_t bi = static_cast<size_t>(n) * d.n_banks + r.b;
  if (has_cache(d)) {
    const size_t wi = bi * d.S + s.w;
    a.tags[wi] = s.tag;
    a.valid[wi] = s.valid;
    a.dirty[wi] = s.dirty;
    a.benefit[wi] = s.benefit;
    a.last_use[wi] = s.last_use;
    const size_t ri = bi * d.S + floordiv(s.w, a.segs_per_row[n]);
    a.row_sum[ri] = wadd(a.row_sum[ri], s.row_delta);
    a.evict_row[bi] = s.evict_row;
    if (s.use_victim) {
      uint8_t* em = a.evict_mask + bi * d.MS;
      const int32_t spr = a.segs_per_row[n];
      for (int j = 0; j < d.MS; ++j)
        em[j] = (s.need_new ? j < spr : em[j] != 0) && j != s.jj;
    }
    const size_t ti = bi * d.NT + s.tr_idx;
    a.miss_tags[ti] = s.miss_tag;
    a.miss_cnt[ti] = s.miss_cnt;
    a.n_valid[bi] = wadd(a.n_valid[bi], s.n_valid_inc);
  }
  a.open_row[bi] = s.open_row;
  a.busy[bi] = s.busy;
  const size_t ci = static_cast<size_t>(n) * d.n_cores + r.c;
  a.mshr_ring[ci * kMshr + s.mshr_slot] = s.mshr_done;
  a.mshr_idx[ci] = s.mshr_next;
  a.bus_free[n] = s.bus_free;

  a.lat_sum_ns[ci] = imin(wadd(a.lat_sum_ns[ci], s.lat_ns), kLatSumCap);
  if (first) {
    for (int k = 0; k < d.n_cores; ++k) {
      int32_t* x = a.lat_sum_ns + static_cast<size_t>(n) * d.n_cores + k;
      *x = imin(*x, kLatSumCap);
    }
  }
  a.req_cnt[ci] = wadd(a.req_cnt[ci], s.req);
  a.acts_slow[n] = wadd(a.acts_slow[n], s.acts_slow);
  a.acts_fast[n] = wadd(a.acts_fast[n], s.acts_fast);
  a.reads[n] = wadd(a.reads[n], s.reads);
  a.writes[n] = wadd(a.writes[n], s.writes);
  a.reloc_blocks[n] = wadd(a.reloc_blocks[n], s.reloc_blocks);
  a.wb_blocks[n] = wadd(a.wb_blocks[n], s.wb_blocks);
  a.row_hits[n] = wadd(a.row_hits[n], s.row_hits);
  a.cache_hits[n] = wadd(a.cache_hits[n], s.cache_hits);
  a.insertions[n] = wadd(a.insertions[n], s.insertions);
  a.t_end[n] = imax(a.t_end[n], s.t_end);
}

// ---- telemetry windows -------------------------------------------------

// The open window's 12 scalar lanes (registers) and the closed count.
struct Tel {
  int32_t v[kTelLanes];
  int32_t n;
};

// The planes buffer of one lane: the open window's bank issues and
// histogram, then the cumulative (2, n_cores, kHistBuckets) histogram and
// the n_cores over-SLO counts.
SIM_FN int tel_plane_ints(const Dims& d) {
  return d.n_banks + kHistBuckets + 2 * d.n_cores * kHistBuckets + d.n_cores;
}

SIM_FN void tel_load(const Args& a, int n, Tel& tel, int32_t* planes) {
  const Dims& d = a.d;
  for (int i = 0; i < kTelLanes; ++i)
    tel.v[i] = a.tel_scalars[static_cast<size_t>(n) * kTelLanes + i];
  tel.n = a.tel_n[n];
  int32_t* p = planes;
  for (int j = 0; j < d.n_banks; ++j)
    *p++ = a.tel_banks[static_cast<size_t>(n) * d.n_banks + j];
  for (int j = 0; j < kHistBuckets; ++j)
    *p++ = a.tel_hist_win[static_cast<size_t>(n) * kHistBuckets + j];
  const int nh = 2 * d.n_cores * kHistBuckets;
  for (int j = 0; j < nh; ++j)
    *p++ = a.tel_hist[static_cast<size_t>(n) * nh + j];
  for (int j = 0; j < d.n_cores; ++j)
    *p++ = a.tel_slo[static_cast<size_t>(n) * d.n_cores + j];
}

// Ring row `row` of lane n := the open window as it stands.
SIM_FN void tel_write_row(const Args& a, int n, int32_t row, const Tel& tel,
                          const int32_t* planes) {
  const Dims& d = a.d;
  const size_t r = static_cast<size_t>(n) * d.W + clampi(row, 0, d.W - 1);
  for (int i = 0; i < kTelLanes; ++i)
    a.buf_scalars[r * kTelLanes + i] = tel.v[i];
  for (int j = 0; j < d.n_banks; ++j)
    a.buf_banks[r * d.n_banks + j] = planes[j];
  for (int j = 0; j < kHistBuckets; ++j)
    a.buf_hist[r * kHistBuckets + j] = planes[d.n_banks + j];
}

// Fold one request (its Step) into the open window, after commit().
SIM_FN void tel_step(const Args& a, int n, const Req& r, const Step& s,
                     Tel& tel, int32_t* planes) {
  const Dims& d = a.d;
  // windows never skip, so the boundary test is a multiply against the
  // next window's start
  const int32_t next = wadd(tel.v[0], 1);
  if (r.real && s.step_id >= wmul(next, d.period)) {
    tel_write_row(a, n, tel.n, tel, planes);
    tel.n = wadd(tel.n, 1);
    tel.v[0] = next;
    for (int i = 1; i < kTelLanes; ++i) tel.v[i] = 0;
    for (int j = 0; j < d.n_banks + kHistBuckets; ++j) planes[j] = 0;
  }
  const int32_t delta[kTelLanes] = {
      0,           s.req,        s.reads,      s.writes,
      s.row_hits,  s.cache_hits, s.insertions, s.reloc_blocks,
      s.lat_ns,    s.bus_wait,   s.mshr_wait,  s.over};
  for (int i = 0; i < kTelLanes; ++i)
    tel.v[i] = imin(wadd(tel.v[i], delta[i]), kLatSumCap);
  if (r.real) {
    // the four planes are disjoint: every load issues before any store,
    // so their latencies overlap
    int32_t* banks = planes;
    int32_t* hist_w = banks + d.n_banks;
    int32_t* hist = hist_w + kHistBuckets;
    int32_t* slo = hist + 2 * d.n_cores * kHistBuckets;
    const int hi = ((r.is_write ? 1 : 0) * d.n_cores + r.c) * kHistBuckets +
                   s.bucket;
    const int32_t b0 = banks[r.b], h0 = hist_w[s.bucket], c0 = hist[hi],
                  o0 = slo[r.c];
    banks[r.b] = wadd(b0, 1);
    hist_w[s.bucket] = wadd(h0, 1);
    hist[hi] = wadd(c0, 1);
    slo[r.c] = wadd(o0, s.over);
  }
}

// End of the replay: the live ring row, the open window, the planes and
// the closed count back to the lane's leaves.
SIM_FN void tel_store(const Args& a, int n, const Tel& tel,
                      const int32_t* planes) {
  const Dims& d = a.d;
  tel_write_row(a, n, tel.n, tel, planes);
  for (int i = 0; i < kTelLanes; ++i)
    a.tel_scalars[static_cast<size_t>(n) * kTelLanes + i] = tel.v[i];
  a.tel_n[n] = tel.n;
  const int32_t* p = planes;
  for (int j = 0; j < d.n_banks; ++j)
    a.tel_banks[static_cast<size_t>(n) * d.n_banks + j] = *p++;
  for (int j = 0; j < kHistBuckets; ++j)
    a.tel_hist_win[static_cast<size_t>(n) * kHistBuckets + j] = *p++;
  const int nh = 2 * d.n_cores * kHistBuckets;
  for (int j = 0; j < nh; ++j)
    a.tel_hist[static_cast<size_t>(n) * nh + j] = *p++;
  for (int j = 0; j < d.n_cores; ++j)
    a.tel_slo[static_cast<size_t>(n) * d.n_cores + j] = *p++;
}

}  // namespace sim
