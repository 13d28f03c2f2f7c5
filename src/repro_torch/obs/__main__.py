"""``python -m repro_torch.obs`` — the flight-recorder report (DESIGN.md
§15/§16), the port of ``python -m repro.obs``.

Five sections, written into ``BENCH_obs.json`` (plus CSV/figure files):

 1. **Telemetry tax** on the fig12 capacity grid: the identical chunked
    capacity sweep with telemetry off (``dram.resume`` per segment) vs on
    with frames actually collected and fenced (``sweep_resume_tel`` +
    collector + ``block()`` — the full cost a telemetry consumer pays),
    the latency-histogram planes and over-SLO counts included.  The tax is
    a ratio of walls, as in the JAX package; the run reports a FAIL if it
    is above 1.25x.
 2. **Chunked-vs-monolithic pin**: the window series of the same grid
    replayed at chunk 256 and as one monolithic segment must be
    byte-equal for every grid point.
 3. **Tail latency** on the same grid (§16): p50/p99/p999 per grid point
    from the cumulative histogram planes (with the bucket brackets),
    exact over-SLO counts against ``--slo-ns``, and a latency CDF CSV.
 4. **phase_mix re-warming**: per-window FIGCache hit rate across phase
    shifts, as CSV always and as PNG when matplotlib is importable (it is
    not a dependency of this repo).
 5. **Entry-point profile**: cold-vs-warm walls, kernel builds and warm
    dispatch counts per registered launch contract (``obs.profile``).

Everything runs on ``--device`` (default: the CUDA device, which must
exist; ``--device cpu`` runs the eager loop, which takes minutes at these
sizes).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.analysis.contracts import CAPACITY_GRID, _stack_params
from repro_torch.core import dram, streaming, workload
from repro_torch.core.timing import paper_config, shared_static
from repro_torch.device import resolve_device
from repro_torch.obs import latency
from repro_torch.obs.profile import profile_contracts
from repro_torch.obs.telemetry import WindowCollector, series_csv, window_table

# combined telemetry tax: window carry + §16 histogram planes + SLO counts
TAX_TRIPWIRE = 1.25
_QUICK_PROFILE = ("sweep.capacity", "streaming.chunked-replay",
                  "obs.telemetry-sweep", "obs.tail-latency")


def _grid_cfgs(period: int, slo_ns: int = 0):
    return [dataclasses.replace(paper_config("figcache_fast", **kw),
                                telemetry=period, slo_ns=slo_ns)
            for kw in CAPACITY_GRID]


def _trace(per_channel: int, device, family: str = "zipf_reuse",
           seed: int = 11, **kw):
    spec = workload.preset(family, n_cores=2, n_channels=1,
                           per_channel=per_channel, seed=seed, **kw)
    return dram.Trace(*[a[0] for a in workload.generate(spec,
                                                        device=device)])


def _one_sweep(tr, static, params, chunk: int, telemetry_on: bool,
               device) -> float:
    col = WindowCollector() if telemetry_on else None
    t0 = time.perf_counter()
    streaming.sweep_stream(streaming.iter_chunks(tr, chunk), static, params,
                           telemetry=col, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if col is not None:
        col.block()   # the frames are part of the product being priced
    return time.perf_counter() - t0


def measure_tax(per_channel: int, chunk: int, period: int, reps: int,
                rounds: int = 2, slo_ns: int = 0, device=None):
    """Sections 1+2: wall tax and the chunked-vs-monolithic bitwise pin.

    Both paths are deterministic costs measured under one-sided machine
    noise, so each path's min-of-reps estimates its true floor from above.
    Reps are interleaved (off, on, off, on, ...) so slow drift hits both
    paths, and the whole measurement repeats ``rounds`` times — a round
    whose on-path mins all landed in a slow phase reports a spuriously HIGH
    tax, never a low one, so the minimum round tax is the least-biased
    estimate.  Every round's tax is recorded in the output."""
    dev = resolve_device(device)
    tr = _trace(per_channel, dev)
    cfgs_on = _grid_cfgs(period, slo_ns)
    cfgs_off = [dataclasses.replace(c, telemetry=0) for c in cfgs_on]
    st_on, st_off = shared_static(cfgs_on), shared_static(cfgs_off)
    p_on, p_off = _stack_params(cfgs_on, dev), _stack_params(cfgs_off, dev)

    # warm both paths (kernel builds, allocator) out of the measurement
    _one_sweep(tr, st_off, p_off, chunk, False, dev)
    _one_sweep(tr, st_on, p_on, chunk, True, dev)
    round_taxes, off_s, on_s = [], None, None
    for _ in range(rounds):
        r_off = r_on = float("inf")
        for _ in range(reps):
            r_off = min(r_off, _one_sweep(tr, st_off, p_off, chunk, False,
                                          dev))
            r_on = min(r_on, _one_sweep(tr, st_on, p_on, chunk, True, dev))
        round_taxes.append(r_on / r_off)
        if off_s is None or r_on / r_off == min(round_taxes):
            off_s, on_s = r_off, r_on
    tax = min(round_taxes)

    # bitwise: chunked window series == monolithic, per grid point
    T = int(tr.t_issue.shape[-1])
    chunked, mono = WindowCollector(), WindowCollector()
    streaming.sweep_stream(streaming.iter_chunks(tr, chunk), st_on, p_on,
                           telemetry=chunked, device=dev)
    streaming.sweep_stream(streaming.iter_chunks(tr, T), st_on, p_on,
                           telemetry=mono, device=dev)
    bitwise = True
    for p in range(len(cfgs_on)):
        a, b = chunked.series(index=(p,)), mono.series(index=(p,))
        for k in a:
            bitwise &= bool(np.array_equal(a[k], b[k], equal_nan=True))
    return {
        "grid": "fig12 capacity (figcache_fast, cache_rows 2..64)",
        "per_channel_reqs": per_channel, "chunk_len": chunk,
        "window_period": period, "reps": reps, "rounds": rounds,
        "telemetry_off_s": round(off_s, 4),
        "telemetry_on_s": round(on_s, 4),
        "telemetry_tax": round(tax, 4),
        "telemetry_tax_rounds": [round(t, 4) for t in round_taxes],
        "tax_tripwire": TAX_TRIPWIRE,
        "windows_bitwise_chunked_vs_monolithic": bitwise,
    }, mono, cfgs_on


def tail_latency_section(mono: WindowCollector, cfgs, slo_ns: int,
                         outdir: str):
    """Section 3 (§16): per-grid-point tail percentiles + SLO + CDF CSV.

    Works off the SAME monolithic collector the bitwise pin used — the
    cumulative histogram planes are on its final carry, so the section
    costs no extra simulation."""
    per_point, hists = [], {}
    for p, cfg in enumerate(cfgs):
        cum = mono.cumulative(index=(p,))
        total = cum["hist"].sum(axis=0)          # rd+wr, summed over cores
        tot = total.sum(axis=0)
        pct = latency.percentiles(tot)
        s = mono.series(index=(p,))
        name = f"cache_rows={cfg.cache_rows}"
        hists[name] = tot
        per_point.append({
            "cache_rows": cfg.cache_rows,
            **{k: round(v.value, 2) for k, v in pct.items()},
            "p99_bracket_ns": [pct["p99"].lo, pct["p99"].hi],
            "p999_bracket_ns": [pct["p999"].lo, pct["p999"].hi],
            **{"slo_" + k: round(v, 6)
               for k, v in latency.slo_summary(s, slo_ns).items()},
        })
    csv_path = os.path.join(outdir, "obs_latency_cdf.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write(latency.cdf_csv(hists))
    return {
        "slo_ns": slo_ns,
        "per_point": per_point,
        "p99_ns_max": max(pt["p99"] for pt in per_point),
        "p999_ns_max": max(pt["p999"] for pt in per_point),
        "cdf_csv": csv_path,
    }


def phase_mix_series(per_channel: int, period: int, chunk: int,
                     phase_len: int, device=None):
    """Section 4: FIGCache re-warming across phase_mix phase shifts."""
    dev = resolve_device(device)
    tr = _trace(per_channel, dev, family="phase_mix", seed=5,
                phase_len=phase_len)
    cfg = dataclasses.replace(paper_config("figcache_fast"),
                              telemetry=period)
    col = WindowCollector()
    streaming.simulate_stream(streaming.iter_chunks(tr, chunk), cfg,
                              telemetry=col, device=dev)
    return col.series()


def _maybe_png(series, period: int, path: str):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(8, 3.2))
    x = series["win_idx"] * period
    ax.plot(x, 100 * series["hit_rate"], label="FIGCache hit %")
    ax.plot(x, 100 * series["row_hit_rate"], label="row-buffer hit %",
            alpha=0.6)
    ax2 = ax.twinx()
    ax2.bar(x, series["w_ins"], width=0.8 * period, alpha=0.25,
            color="tab:red", label="insertions/window")
    ax.set_xlabel("requests retired")
    ax.set_ylabel("hit rate (%)")
    ax2.set_ylabel("insertions per window")
    ax.set_title("phase_mix: FIGCache re-warming after phase shifts")
    ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized traces and the short profile list")
    ap.add_argument("--json", default="BENCH_obs.json",
                    help="perf-record output path")
    ap.add_argument("--outdir", default=".",
                    help="directory for the CSV/PNG outputs")
    ap.add_argument("--period", type=int, default=64,
                    help="telemetry window period (real requests)")
    ap.add_argument("--slo-ns", type=int, default=100,
                    help="latency SLO threshold for the in-replay over-SLO "
                         "count (ns; <= 0 disables)")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the contract profiling section")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 4096+ requests: below that, per-chunk dispatch constants (paid by
    # both paths, but noisier) dominate and the tax estimate is meaningless
    per_channel = 4096 if args.quick else 16384
    chunk = 256
    # min-of-10 per path per round, best of 3 rounds (see measure_tax)
    reps = 10

    print(f"[obs] telemetry tax on the fig12 grid ({per_channel} reqs, "
          f"chunk {chunk}, period {args.period}) on {dev}...")
    tax, mono, cfgs = measure_tax(per_channel, chunk, args.period, reps,
                                  rounds=3, slo_ns=args.slo_ns, device=dev)
    print(f"[obs]   off {tax['telemetry_off_s']}s  on "
          f"{tax['telemetry_on_s']}s  tax {tax['telemetry_tax']}x "
          f"(rounds {tax['telemetry_tax_rounds']})  "
          f"bitwise={tax['windows_bitwise_chunked_vs_monolithic']}")

    os.makedirs(args.outdir, exist_ok=True)
    tail = tail_latency_section(mono, cfgs, args.slo_ns, args.outdir)
    print(f"[obs] tail latency per grid point (SLO {args.slo_ns} ns):")
    for pt in tail["per_point"]:
        print(f"[obs]   cache_rows={pt['cache_rows']:<3d} "
              f"p50 {pt['p50']:>7.1f}  p99 {pt['p99']:>7.1f}  "
              f"p999 {pt['p999']:>7.1f} ns  "
              f"over-SLO {pt['slo_rate'] * 100:>5.2f}%")
    print(f"[obs]   CDF -> {tail['cdf_csv']}")

    phase_len = 512 if args.quick else 1024
    pm_reqs = 4096 if args.quick else 8192
    print(f"[obs] phase_mix re-warming series ({pm_reqs} reqs, "
          f"phase_len {phase_len})...")
    pm = phase_mix_series(pm_reqs, args.period, chunk, phase_len,
                          device=dev)
    csv_path = os.path.join(args.outdir, "obs_phase_mix.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write(series_csv(pm))
    png_path = _maybe_png(pm, args.period,
                          os.path.join(args.outdir, "obs_phase_mix.png"))
    print(window_table(pm, max_rows=12))
    print(f"[obs]   series -> {csv_path}" +
          (f", figure -> {png_path}" if png_path
           else "  (no matplotlib: CSV only)"))

    profile = {}
    if not args.no_profile:
        names = list(_QUICK_PROFILE) if args.quick else None
        print(f"[obs] profiling "
              f"{'quick subset' if args.quick else 'all contracts'}...")
        profile = profile_contracts(names, device=dev)
        for name, rec in profile.items():
            print(f"[obs]   {name}: cold {rec['cold_s']}s warm "
                  f"{rec['warm_s']}s (builds {rec['builds_cold']}->"
                  f"{rec['builds_warm']}, {rec['build_s']}s of nvcc; "
                  f"launches {rec['launches_warm']}/{rec['max_launches']}, "
                  f"sim_scan {rec['sim_scan_launches_warm']}; dispatches "
                  f"{rec['dispatches_warm']})")

    record = {
        "bench": "obs", "quick": args.quick, **tax,
        # the one key the JAX package's record lacks: where it ran
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else dev.type,
        "tail_latency": tail,
        "phase_mix": {
            "n_windows": int(len(pm["win_idx"])),
            "phase_len": phase_len,
            "min_hit_rate": round(float(pm["hit_rate"].min()), 4),
            "max_hit_rate": round(float(pm["hit_rate"].max()), 4),
            "csv": csv_path, "png": png_path,
        },
        "profile": profile,
    }
    with open(args.json, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"[obs] perf record -> {args.json}")

    ok = True
    if tax["telemetry_tax"] > TAX_TRIPWIRE:
        print(f"[obs] FAIL: telemetry tax {tax['telemetry_tax']}x exceeds "
              f"the {TAX_TRIPWIRE}x tripwire")
        ok = False
    if not tax["windows_bitwise_chunked_vs_monolithic"]:
        print("[obs] FAIL: chunked window series diverged from monolithic")
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
