"""Plain reference of the FIGCache DRAM simulator: one lane (one config
point on one channel) at a time, in plain Python integers.

It is written from the simulator's semantics (paper §4-§6, Table 1, as
the program documents them in ``DESIGN.md``), independent of the program:
it imports neither the program nor JAX, takes its timings, geometry and
mechanism knobs from the configuration file, and its traces from
``perfbench/tracegen.py``.  Every quantity is an exact integer, as in the
program (ticks of 1/8 ns, latencies in ns), so a correct program gives
the same counters bit for bit.

What it models, per request in service order (FCFS):

* the closed-loop core: at most ``mshr_per_core`` requests in flight per
  core, a ring of completion times;
* the bank: open row, busy-until time, ACT(+PRE) before the CAS unless
  the (possibly cached) target row is open, tCCD pipelining;
* the channel's shared data bus (one burst at a time);
* the FIGCache tag store of a cached mechanism, per bank: segment
  lookup, the consecutive-miss insertion threshold (256 trackers a bank),
  insert into the next free slot or over the RowBenefit victim (the
  lowest-benefit row, then its lowest-benefit marked segment, the row's
  remaining segments kept marked for the next evictions), saturating
  benefit counters, dirty write-backs and the relocation cost (FIGARO's
  RELOCs, LISA's hops, or none for the ideal cache);
* LL-DRAM: every row at the fast subarray's timings.

``derive`` turns a workload's counters into the per-config results (IPC,
latency, hit rates, execution time, energy) with the program's documented
core and energy model, whose constants are in the configuration file.

``resolution`` (in ticks) is the control: 8 computes every time in whole
nanoseconds, the precision below the configuration's 1/8 ns.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

NOOP_ISSUE = 1 << 30          # a request at or past this tick is padding
LAT_SUM_CAP = (1 << 30) - 1   # per-core latency sums saturate here
N_TRACK = 256                 # consecutive-miss trackers per bank

CACHED = ("lisa_villa", "figcache_slow", "figcache_fast", "figcache_ideal")
FAST_CACHE = ("lisa_villa", "figcache_fast", "figcache_ideal")

COUNTERS = ("acts_slow", "acts_fast", "reads", "writes", "reloc_blocks",
            "wb_blocks", "row_hits", "cache_hits", "insertions",
            "lat_sum_ns", "req_cnt", "t_end")


def ticks(cfg: dict, resolution: int = 1) -> Dict[str, int]:
    """The timing parameters in ticks of 1/``ticks_per_ns`` ns, rounded as
    the program rounds them; with ``resolution`` r, to multiples of r."""
    t = cfg["timings_ns"]
    tpn = cfg["ticks_per_ns"]

    def q(x_ns: float) -> int:
        return int(round(x_ns * tpn / resolution)) * resolution

    return {"rcd": q(t["tRCD"]), "rp": q(t["tRP"]), "cas": q(t["tCAS"]),
            "bl": q(t["tBL"]), "ccd": q(t["tCCD"]), "reloc": q(t["tRELOC"]),
            "rcd_fast": q(t["tRCD"] * t["fast_tRCD_scale"]),
            "rp_fast": q(t["tRP"] * t["fast_tRP_scale"]),
            "lisa_hop": q(t["tLISA_HOP"])}


def mech_point(cfg: dict, mechanism: str, **over) -> dict:
    """One config point: the mechanism with the configuration's defaults
    for it (``lisa_villa`` caches whole rows), then ``over``."""
    p = {"mechanism": mechanism, **cfg["figcache"]}
    p.update(cfg.get("mechanism_defaults", {}).get(mechanism, {}))
    p.update(over)
    if p["policy"] != "row_benefit":
        raise ValueError(f"the reference models RowBenefit replacement, "
                         f"not {p['policy']!r}")
    return p


def simulate_lane(trace: Sequence[Sequence[int]], point: dict, cfg: dict,
                  resolution: int = 1) -> Dict[str, object]:
    """Replay one channel's requests (``trace``: the six fields of
    ``tracegen.TRACE_FIELDS`` as sequences of ints) under config point
    ``point``; returns the counters, the per-core ones as lists."""
    geom = cfg["geometry"]
    tk = ticks(cfg, resolution)
    n_banks, n_cores = geom["n_banks"], geom["n_cores"]
    n_mshr = cfg["mshr_per_core"]
    rps = geom["rows_per_subarray"]
    cache_base = geom["n_rows"]               # cache rows' id space
    reserved_sub = geom["n_rows"] // rps - 1  # figcache_slow's reserved
    mech = point["mechanism"]
    has_cache = mech in CACHED
    fast_cache = mech in FAST_CACHE
    lisa, slow = mech == "lisa_villa", mech == "figcache_slow"
    ideal, lldram = mech == "figcache_ideal", mech == "lldram"
    rcd, rp, cas, bl, ccd = tk["rcd"], tk["rp"], tk["cas"], tk["bl"], \
        tk["ccd"]
    rcd_f, rp_f, reloc_t, hop = tk["rcd_fast"], tk["rp_fast"], \
        tk["reloc"], tk["lisa_hop"]
    seg_blocks = point["seg_blocks"]
    spr = geom["row_blocks"] // seg_blocks
    n_crow = point["cache_rows"]
    n_slots = n_crow * spr
    thr = point["insert_threshold"]
    bmax = (1 << point["benefit_bits"]) - 1

    def hops(r):                      # subarrays to the nearest fast one
        m = (r // rps) % 4
        return min(m, 4 - m)

    open_row, busy = [-1] * n_banks, [0] * n_banks
    if has_cache:
        where = [dict() for _ in range(n_banks)]        # segment -> slot
        tags = [[-1] * n_slots for _ in range(n_banks)]
        valid = [[False] * n_slots for _ in range(n_banks)]
        dirty = [[False] * n_slots for _ in range(n_banks)]
        benefit = [[0] * n_slots for _ in range(n_banks)]
        row_sum = [[0] * n_crow for _ in range(n_banks)]
        evict_row = [-1] * n_banks
        evict_mask = [[False] * spr for _ in range(n_banks)]
        miss_tag = [[-1] * N_TRACK for _ in range(n_banks)]
        miss_cnt = [[0] * N_TRACK for _ in range(n_banks)]
        n_valid = [0] * n_banks
    ring = [[0] * n_mshr for _ in range(n_cores)]
    ring_idx = [0] * n_cores
    bus_free = 0
    acts_slow = acts_fast = reads = writes = reloc_blocks = wb_blocks = 0
    row_hits = cache_hits = insertions = t_end = 0
    lat_sum, req_cnt = [0] * n_cores, [0] * n_cores

    for t_issue, b, row, col, is_write, c in zip(*trace):
        if t_issue >= NOOP_ISSUE:
            continue
        if resolution > 1:
            t_issue -= t_issue % resolution
        step_id = reads + writes
        open_b = open_row[b]
        hit = do_ins = ev_dirty = False
        reloc = moved = wb = 0
        target = row
        if has_cache:
            seg = row * spr + col // seg_blocks
            cacheable = not slow or row // rps != reserved_sub
            slot = where[b].get(seg)
            hit = slot is not None and cacheable
            if hit:
                bb = benefit[b]
                old = bb[slot]
                new = old + 1 if old < bmax else bmax
                bb[slot] = new
                row_sum[b][slot // spr] += new - old
                if is_write:
                    dirty[b][slot] = True
                target = cache_base + slot // spr
            elif cacheable and slot is None:
                k = seg % N_TRACK
                cnt = miss_cnt[b][k] + 1 if miss_tag[b][k] == seg else 1
                miss_tag[b][k], miss_cnt[b][k] = seg, cnt
                do_ins = thr <= 1 or cnt >= thr
        served_fast = (hit and fast_cache) or lldram
        row_hit = open_b == target
        if row_hit:
            pre = 0
        elif served_fast:
            pre = rcd_f + (0 if open_b < 0 else rp_f)
        else:
            pre = rcd + (0 if open_b < 0 else rp)
        new_open = target
        if do_ins:
            if n_valid[b] < n_slots:                   # a free slot
                ins = n_valid[b]
                n_valid[b] += 1
            else:                                      # RowBenefit victim
                mask = evict_mask[b]
                if evict_row[b] < 0 or not any(mask):
                    rs = row_sum[b]
                    vrow = min(range(n_crow), key=rs.__getitem__)
                    mask = [True] * spr
                else:
                    vrow = evict_row[b]
                    mask = list(mask)
                bb = benefit[b]
                base = vrow * spr
                jj = min((j for j in range(spr) if mask[j]),
                         key=lambda j: bb[base + j])
                mask[jj] = False
                evict_row[b], evict_mask[b] = vrow, mask
                ins = base + jj
                ev_dirty = valid[b][ins] and dirty[b][ins]
            old_tag = tags[b][ins]
            if valid[b][ins]:
                del where[b][old_tag]
            where[b][seg] = ins
            tags[b][ins] = seg
            valid[b][ins] = True
            dirty[b][ins] = bool(is_write)
            row_sum[b][ins // spr] += 1 - benefit[b][ins]
            benefit[b][ins] = 1
            if ideal:
                reloc = 0
            elif lisa:
                reloc = hops(row) * hop + rcd_f
                if ev_dirty:
                    reloc += hops(old_tag) * hop + rcd
            else:
                reloc = seg_blocks * reloc_t
                if ev_dirty:
                    reloc += seg_blocks * reloc_t + rcd
            new_open = cache_base + ins // spr
            moved = seg_blocks
            wb = seg_blocks if ev_dirty else 0

        ms = ring_idx[c]
        t_ready = max(t_issue, ring[c][ms])
        t0 = max(t_ready, busy[b])
        done = max(t0 + pre + cas, bus_free) + bl
        serv_end = t0 + pre + ccd
        open_row[b] = new_open
        busy[b] = serv_end + reloc
        ring[c][ms] = done
        ring_idx[c] = (ms + 1) % n_mshr
        bus_free = done
        if not row_hit:
            if served_fast:
                acts_fast += 1
            else:
                acts_slow += 1
        lat_sum[c] = min(lat_sum[c] + (done - t_ready) // 8, LAT_SUM_CAP)
        req_cnt[c] += 1
        if is_write:
            writes += 1
        else:
            reads += 1
        reloc_blocks += moved
        wb_blocks += wb
        row_hits += row_hit
        cache_hits += hit
        insertions += do_ins
        t_end = max(t_end, done, serv_end + reloc)

    return {"acts_slow": acts_slow, "acts_fast": acts_fast, "reads": reads,
            "writes": writes, "reloc_blocks": reloc_blocks,
            "wb_blocks": wb_blocks, "row_hits": row_hits,
            "cache_hits": cache_hits, "insertions": insertions,
            "lat_sum_ns": lat_sum, "req_cnt": req_cnt, "t_end": t_end}


def simulate_workload(trace: dict, point: dict, cfg: dict,
                      resolution: int = 1) -> Dict[str, np.ndarray]:
    """Every channel of one workload's ``(C, T)`` trace under ``point``:
    counters as int32 arrays, ``(C,)`` or ``(C, n_cores)``."""
    fields = ("t_issue", "bank", "row", "col", "is_write", "core")
    lanes = [simulate_lane([trace[f][ch].tolist() for f in fields], point,
                           cfg, resolution)
             for ch in range(trace["t_issue"].shape[0])]
    return {k: np.array([lane[k] for lane in lanes], dtype=np.int32)
            for k in COUNTERS}


def derive(cnt: Dict[str, np.ndarray], point: dict, apps: Sequence[dict],
           cfg: dict) -> Dict[str, object]:
    """One workload's result under one config point from its counters
    ``(C, ...)``: per-core IPC and latency, row-buffer and cache hit
    rates, execution time and energy, in float64 as the program's core
    and energy model (configuration keys ``core_model``, ``energy``)."""
    cm, en = cfg["core_model"], cfg["energy"]
    n_channels = cnt["t_end"].shape[0]
    lat = cnt["lat_sum_ns"].astype(np.float64).sum(0)
    req = cnt["req_cnt"].astype(np.float64).sum(0)
    avg_lat = np.where(req > 0, lat / np.maximum(req, 1), 0.0)
    n_apps = len(apps)
    mpki = np.array([a["mpki"] for a in apps], dtype=np.float64)
    mlp = np.array([cm["mlp_intensive"] if a["intensive"]
                    else cm["mlp_non_intensive"] for a in apps],
                   dtype=np.float64)
    r, al = req[:n_apps], avg_lat[:n_apps]
    instr = r * 1000.0 / mpki
    cycles = instr * cm["cpi_exec"] + r * (al * cm["cpu_ghz"]) / mlp
    with np.errstate(divide="ignore", invalid="ignore"):
        ipc = np.where(r > 0, instr / cycles, 1.0 / cm["cpi_exec"])
    exec_ns = float(np.where(r > 0, cycles / cm["cpu_ghz"], 0.0).max())

    def tot(k):
        return float(cnt[k].astype(np.float64).sum())

    dyn = (tot("acts_slow") * en["e_act_pre"]
           + tot("acts_fast") * en["e_act_pre_fast"]
           + tot("insertions") * en["e_act_pre_fast"]
           + tot("reads") * en["e_rd"]
           + tot("writes") * en["e_wr"]
           + (tot("reloc_blocks") + tot("wb_blocks")) * en["e_reloc_block"])
    bg = exec_ns * en["p_bg"] * n_channels
    cpu = float(instr.sum()) * en["e_cpu_instr"] \
        + exec_ns * en["p_cpu_static"] * n_apps
    n_req = tot("reads") + tot("writes")
    off = n_req * en["e_offchip_req"]
    parts = {"dram_dynamic": dyn, "dram_background": bg,
             "dram_total": dyn + bg, "cpu": cpu, "offchip": off,
             "system_total": dyn + bg + cpu + off}
    div = n_req if n_req else 1.0
    return {"ipc": ipc, "avg_lat_ns": avg_lat,
            "row_hit_rate": tot("row_hits") / div,
            "cache_hit_rate": (tot("cache_hits") / div
                               if point["mechanism"] in CACHED else 0.0),
            "exec_time_ns": exec_ns,
            "dram_energy_nj": parts["dram_total"],
            "system_energy_nj": parts["system_total"],
            "energy_parts": parts}

