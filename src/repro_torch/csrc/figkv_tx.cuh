// One FIGCache-KV decode step's tag-store transaction for one sequence:
// the per-sequence body of kernels/figkv_tx/ref.py (fts_step, then the
// slot map's repair), which ports the JAX package's _fts_step
// (src/repro/figkv/kv_cache.py) with the port's two differences: only live
// (complete) segments are inserted, and a selected segment whose hit slot
// the same step's insert takes is read from the slow pool (slot -1).
//
// Everything here but the warp-wide row scans, written once for two
// builds: nvcc compiles it into the decode-step kernel (figkv_tx.cu, where
// the scans are whole-warp loads and ballots), and a host C++ compiler into
// the small host library (figkv_tx_host.cpp, scalar scans) that the CPU
// tests replay bitwise against the plain version.
//
// A sequence's transaction, in order:
//   lookup      the first valid slot holding each selected id (S if none);
//   touch()     each hit: saturating benefit, LRU stamp, row_sum delta (the
//               selected ids are distinct, so are their hit slots);
//   insert_candidate()  the first selected id, in selection order, that
//               missed and is live (< n_live), or -1;
//   victim_scan()       which score row the policy's first argmin scans
//               when the store is full (the touched values);
//   insert()    the free-stack top, else the policy's victim; writes the
//               slot's leaves (and the RowBenefit bitvector when no slot
//               was free);
//   slot_of()   the slot each selected id is read from, -1 for the slow
//               pool.
// Semantics kept bit for bit with the plain version: first-index ties, the
// free-list top clamped into the store, the RowBenefit gather clamped into
// the store, the Random hash in int64 masked to 31 bits, int32 sums that
// wrap.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "sim_step.cuh"

namespace figkv {

constexpr int kPtrs = 18;  // pointers make_args() reads
constexpr int kDims = 20;  // sizes and arguments make_args() reads

// Every argument of one launch.  The slow pools are rows of seg_bytes at a
// byte stride per sequence (gs) and per segment (ss); the fast pools at gs
// per sequence and ss per slot.  Index 0 is K, 1 is V.  bool leaves are one
// byte, 0 or 1.
struct Args {
  int B, n_sel, S, MS, R, n_segs, policy;
  int32_t step, n_live, bmax, spr;
  long long seg_bytes;
  long long pool_gs[2], pool_ss[2], fast_gs[2], fast_ss[2];
  const int32_t* sel;                       // (B, n_sel)
  int32_t* tags;                            // (B, S)
  uint8_t *valid, *dirty;                   // (B, S)
  int32_t *benefit, *last_use;              // (B, S)
  int32_t* evict_row;                       // (B,)
  uint8_t* evict_mask;                      // (B, MS)
  int32_t* row_sum;                         // (B, R)
  int32_t* free_list;                       // (B, S)
  int32_t* n_valid;                         // (B,)
  const uint8_t* pool[2];
  uint8_t* fast[2];
  int32_t *slots, *ins_seg, *ins_slot;      // out: (B, n_sel), (B,), (B,)
};

// Pointers in the order of kernels/figkv_tx/figkv_tx.py's pack(): sel, the
// ten FTS leaves the transaction reads or writes, pool K, pool V, fast K,
// fast V, slots, ins_seg, ins_slot.  dims: B, n_sel, S, MS, R, n_segs,
// policy, step, n_live, benefit_max, segs_per_row, seg_bytes, then (gs, ss)
// of pool K, pool V, fast K, fast V.
SIM_FN Args make_args(void* const* p, const long long* d) {
  Args a;
  a.B = static_cast<int>(d[0]);
  a.n_sel = static_cast<int>(d[1]);
  a.S = static_cast<int>(d[2]);
  a.MS = static_cast<int>(d[3]);
  a.R = static_cast<int>(d[4]);
  a.n_segs = static_cast<int>(d[5]);
  a.policy = static_cast<int>(d[6]);
  a.step = static_cast<int32_t>(d[7]);
  a.n_live = static_cast<int32_t>(d[8]);
  a.bmax = static_cast<int32_t>(d[9]);
  a.spr = static_cast<int32_t>(d[10]);
  a.seg_bytes = d[11];
  for (int t = 0; t < 2; ++t) {
    a.pool_gs[t] = d[12 + 2 * t];
    a.pool_ss[t] = d[13 + 2 * t];
    a.fast_gs[t] = d[16 + 2 * t];
    a.fast_ss[t] = d[17 + 2 * t];
  }
  a.sel = static_cast<const int32_t*>(p[0]);
  a.tags = static_cast<int32_t*>(p[1]);
  a.valid = static_cast<uint8_t*>(p[2]);
  a.dirty = static_cast<uint8_t*>(p[3]);
  a.benefit = static_cast<int32_t*>(p[4]);
  a.last_use = static_cast<int32_t*>(p[5]);
  a.evict_row = static_cast<int32_t*>(p[6]);
  a.evict_mask = static_cast<uint8_t*>(p[7]);
  a.row_sum = static_cast<int32_t*>(p[8]);
  a.free_list = static_cast<int32_t*>(p[9]);
  a.n_valid = static_cast<int32_t*>(p[10]);
  a.pool[0] = static_cast<const uint8_t*>(p[11]);
  a.pool[1] = static_cast<const uint8_t*>(p[12]);
  a.fast[0] = static_cast<uint8_t*>(p[13]);
  a.fast[1] = static_cast<uint8_t*>(p[14]);
  a.slots = static_cast<int32_t*>(p[15]);
  a.ins_seg = static_cast<int32_t*>(p[16]);
  a.ins_slot = static_cast<int32_t*>(p[17]);
  return a;
}

// One sequence's rows of every leaf.
struct Row {
  const int32_t* sel;
  int32_t* tags;
  uint8_t *valid, *dirty;
  int32_t *benefit, *last_use, *evict_row;
  uint8_t* evict_mask;
  int32_t *row_sum, *free_list, *n_valid;
};

SIM_FN Row row_of(const Args& a, int b) {
  const size_t s = static_cast<size_t>(b) * a.S;
  return Row{a.sel + static_cast<size_t>(b) * a.n_sel,
             a.tags + s,
             a.valid + s,
             a.dirty + s,
             a.benefit + s,
             a.last_use + s,
             a.evict_row + b,
             a.evict_mask + static_cast<size_t>(b) * a.MS,
             a.row_sum + static_cast<size_t>(b) * a.R,
             a.free_list + s,
             a.n_valid + b};
}

// *p += v, wrapping; atomic on the card, where the hits of several warps
// may share a row (and where an add whose result nobody reads costs no
// round trip).
SIM_FN void add_wrap(int32_t* p, int32_t v) {
#if defined(__CUDA_ARCH__)
  atomicAdd(p, v);
#else
  *p = sim::wadd(*p, v);
#endif
}

// A hit at `slot` (fts.touch with count 1, is_write False).
SIM_FN void touch(const Args& a, const Row& r, int32_t slot) {
  const int32_t b0 = r.benefit[slot];
  const int32_t b1 = sim::imin(sim::wadd(b0, 1), a.bmax);
  r.benefit[slot] = b1;
  r.last_use[slot] = a.step;
  add_wrap(r.row_sum + sim::floordiv(slot, a.spr), sim::wsub(b1, b0));
}

// The first selected id that missed (hit_slot[i] == S) and is live, in
// selection order; -1 if none.
SIM_FN int32_t insert_candidate(const Args& a, const Row& r,
                                const int32_t* hit_slot) {
  for (int i = 0; i < a.n_sel; ++i)
    if (hit_slot[i] >= a.S && r.sel[i] < a.n_live) return r.sel[i];
  return -1;
}

SIM_FN bool has_free(const Args& a, const Row& r) {
  return *r.n_valid < a.S;
}

// RowBenefit: the bitvector is exhausted (or no row is marked), so a new
// victim row is chosen by the argmin over row_sum.
SIM_FN bool need_new_row(const Args& a, const Row& r) {
  bool any = false;
  for (int j = 0; j < a.MS; ++j) any = any || r.evict_mask[j] != 0;
  return *r.evict_row < 0 || !any;
}

// The first argmin an insert into a full store needs: the lexicographic
// minimum of (i < limit ? score[i] : BIG, i) over the n entries of score
// (the semantics of fts.masked_argmin).  n == 0: none is needed (a free
// slot, Random, or RowBenefit with a marked row left).
struct Scan {
  const int32_t* score;
  int n;
  int32_t limit;
};

SIM_FN Scan victim_scan(const Args& a, const Row& r) {
  if (has_free(a, r)) return Scan{r.benefit, 0, 0};
  if (a.policy == sim::kRowBenefit) {
    if (!need_new_row(a, r)) return Scan{r.row_sum, 0, 0};
    // rows r with r * spr < S, as fts.pick_victim_row's mask
    return Scan{r.row_sum, a.R,
                sim::floordiv(sim::wsub(sim::wadd(a.S, a.spr), 1), a.spr)};
  }
  if (a.policy == sim::kSegmentBenefit) return Scan{r.benefit, a.S, a.S};
  if (a.policy == sim::kLru) return Scan{r.last_use, a.S, a.S};
  return Scan{r.benefit, 0, 0};
}

// Insert `seg` after the touches (fts.insert, is_write False, benefit 1):
// the free-stack top if the store has a free slot, else the policy's
// victim (`cand`: victim_scan()'s argmin, when it asked for one).  Writes
// the slot's tag, valid, dirty, benefit, last_use and row_sum, n_valid on a
// free slot, and the RowBenefit row and bitvector when none was free.
// Returns the slot.
SIM_FN int32_t insert(const Args& a, const Row& r, int32_t seg,
                      int32_t cand) {
  const int32_t S = a.S, spr = a.spr;
  const int32_t nv = *r.n_valid;
  const bool has_slot = nv < S;
  int32_t slot;
  if (has_slot) {
    slot = r.free_list[sim::clampi(nv, 0, S - 1)];
  } else if (a.policy == sim::kRowBenefit) {
    const bool fresh = need_new_row(a, r);
    const int32_t row = fresh ? cand : *r.evict_row;
    // the lowest-benefit marked slot of the victim row (gather clamped to
    // the store, as fts.gather_row)
    int32_t best = 0, jj = 0;
    for (int j = 0; j < a.MS; ++j) {
      const bool marked = fresh ? j < spr : r.evict_mask[j] != 0;
      const int32_t bj = sim::clampi(sim::wadd(sim::wmul(row, spr), j), 0,
                                     S - 1);
      const int32_t v = (j < spr && marked) ? r.benefit[bj] : sim::kBig;
      if (j == 0 || v < best) {
        best = v;
        jj = j;
      }
    }
    for (int j = 0; j < a.MS; ++j) {
      const bool marked = fresh ? j < spr : r.evict_mask[j] != 0;
      r.evict_mask[j] = (marked && j != jj) ? 1 : 0;
    }
    *r.evict_row = row;
    slot = sim::wadd(sim::wmul(row, spr), jj);
  } else if (a.policy == sim::kRandom) {
    const int64_t h =
        (static_cast<int64_t>(a.step) * 1103515245LL + 12345LL) &
        0x7FFFFFFFLL;
    const int64_t m = static_cast<int64_t>(S);
    slot = static_cast<int32_t>(((h % m) + m) % m);
  } else {
    slot = cand;
  }
  const int32_t b0 = r.benefit[slot];
  r.tags[slot] = seg;
  r.valid[slot] = 1;
  r.dirty[slot] = 0;
  r.benefit[slot] = 1;
  r.last_use[slot] = a.step;
  add_wrap(r.row_sum + sim::floordiv(slot, spr), sim::wsub(1, b0));
  if (has_slot) *r.n_valid = sim::wadd(nv, 1);
  return slot;
}

// Where selected id `seg` is read from: the inserted id from its new slot;
// a hit from its slot unless the insert just took that slot (the repair:
// the slot now holds the inserted segment, so the hit reads the slow pool,
// which always holds its exact K/V); -1 (the slow pool) otherwise.
SIM_FN int32_t slot_of(const Args& a, int32_t seg, int32_t hit_slot,
                       int32_t ins_seg, int32_t ins_slot) {
  if (seg == ins_seg) return ins_slot;
  return (hit_slot < a.S && hit_slot != ins_slot) ? hit_slot : -1;
}

// Source and destination of tensor t's (0: K, 1: V) move of the inserted
// segment `seg` of sequence b into `slot`.
SIM_FN const uint8_t* move_src(const Args& a, int t, int b, int32_t seg) {
  return a.pool[t] + b * a.pool_gs[t] + seg * a.pool_ss[t];
}
SIM_FN uint8_t* move_dst(const Args& a, int t, int b, int32_t slot) {
  return a.fast[t] + b * a.fast_gs[t] + slot * a.fast_ss[t];
}

// Every move of the launch can go through 16-byte bulk copies: all row
// addresses and the row length are multiples of 16 bytes.
SIM_FN bool bulk_ok(const Args& a) {
  unsigned long long bits = static_cast<unsigned long long>(a.seg_bytes);
  for (int t = 0; t < 2; ++t) {
    bits |= reinterpret_cast<uintptr_t>(a.pool[t]) |
            reinterpret_cast<uintptr_t>(a.fast[t]);
    bits |= static_cast<unsigned long long>(a.pool_gs[t] | a.pool_ss[t] |
                                            a.fast_gs[t] | a.fast_ss[t]);
  }
  return (bits & 15) == 0;
}

}  // namespace figkv
