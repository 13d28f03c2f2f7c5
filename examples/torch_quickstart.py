"""Quickstart on the PyTorch port: the three layers of this framework in
~70 lines (the port's counterpart of ``examples/quickstart.py``).

1. The paper-faithful FIGCache DRAM simulator (speedups vs Base) on the
   default "mcf" application trace or, with ``--scenario <family>``, on a
   device-generated scenario workload (DESIGN.md §11: stream, stride,
   pointer_chase, embed, phase_mix, zipf_reuse).
2. The FIGARO substrate as a data-plane op (segment relocation).
3. A model from the arch pool doing a forward + a decode step.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--scenario embed]
          [--telemetry] [--device cpu]

``--device`` defaults to the CUDA device, which must exist; ``--device
cpu`` runs the kernels' plain PyTorch versions.  ``REPRO_EXAMPLE_REQS``
shrinks the simulated trace (``tests/test_torch_examples.py`` runs this
file with a tiny value).
"""
import argparse
import dataclasses
import os

import torch

from repro_torch import configs
from repro_torch.core import dram, simulator, streaming, workload
from repro_torch.core.timing import paper_config
from repro_torch.device import resolve_device
from repro_torch.kernels.figaro_reloc.ops import reloc_segments
from repro_torch.models import Plan, build_model
from repro_torch.obs import latency
from repro_torch.obs.telemetry import WindowCollector, window_table

def main():
    n_reqs = int(os.environ.get("REPRO_EXAMPLE_REQS", "6144"))
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="app",
                    choices=("app",) + workload.FAMILIES,
                    help="workload: the mcf app trace (default) or a "
                         "device-generated scenario family")
    ap.add_argument("--telemetry", action="store_true",
                    help="also stream a telemetry-enabled FIGCache run and "
                         "print the per-window table: hit rates plus the §16 "
                         "p50/p99 tail-latency columns (DESIGN.md §15/§16)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args, _ = ap.parse_known_args()
    dev = resolve_device(args.device)

    # --- 1. paper reproduction: FIGCache vs Base ----------------------------
    MECHS = ("base", "figcache_fast", "lisa_villa")
    if args.scenario == "app":
        label = "mcf"
        res = simulator.run_single_core("mcf", mechanisms=MECHS,
                                        n_reqs=n_reqs, device=dev)
    else:
        label = f"scenario={args.scenario}"
        spec = workload.preset(args.scenario, n_cores=1, n_channels=1,
                               per_channel=n_reqs, seed=1)
        res = simulator.run_scenario(spec, mechanisms=MECHS, device=dev)
    s = simulator.speedup_summary(res)
    print(f"[1] {label} speedup: FIGCache-Fast {s['figcache_fast']:.3f}x "
          f"(LISA-VILLA {s['lisa_villa']:.3f}x)  "
          f"row-hit {res['base'].row_hit_rate:.2f} -> "
          f"{res['figcache_fast'].row_hit_rate:.2f}")

    # --- 1t. optional: the same mechanism, through telemetry windows -------
    if args.telemetry:
        fam = "zipf_reuse" if args.scenario == "app" else args.scenario
        spec = workload.preset(fam, n_cores=1, n_channels=1,
                               per_channel=n_reqs, seed=1)
        tr = dram.Trace(*[x[0] for x in workload.generate(spec, device=dev)])
        cfg = dataclasses.replace(paper_config("figcache_fast"),
                                  telemetry=max(32, n_reqs // 16), slo_ns=100)
        col = WindowCollector()
        streaming.simulate_stream(
            streaming.iter_chunks(tr, max(64, n_reqs // 8)), cfg,
            telemetry=col, device=dev)
        print(f"[1t] per-window telemetry ({fam}, period {cfg.telemetry} "
              f"reqs; p50/p99 from the §16 in-scan histogram):")
        print(window_table(col.series(), max_rows=12))
        pct = latency.percentiles(col.cumulative()["hist"].sum(axis=(0, 1)))
        s = latency.slo_summary(col.series(), cfg.slo_ns)
        print(f"[1t] whole-run tails: p50 {pct['p50'].value:.1f}  "
              f"p99 {pct['p99'].value:.1f}  p999 {pct['p999'].value:.1f} ns; "
              f"over-SLO({cfg.slo_ns}ns) {100 * s['rate']:.2f}%")

    # --- 2. FIGARO: fine-grained relocation, slow pool -> fast pool ---------
    pool = torch.arange(32 * 64, dtype=torch.float32,
                        device=dev).reshape(32, 64)           # 32 segments
    fast = torch.zeros((8, 64), dtype=torch.float32, device=dev)  # 8 slots
    reloc_segments(pool, fast, torch.tensor([5, 17, 29], dtype=torch.int32,
                                            device=dev),
                   torch.tensor([0, 3, 7], dtype=torch.int32, device=dev))
    assert float(fast[3, 0]) == float(pool[17, 0])
    print("[2] FIGARO reloc: segments {5,17,29} -> fast slots {0,3,7}  OK")

    # --- 3. a pool architecture: forward + decode ---------------------------
    cfg = configs.get_reduced("qwen2-7b")
    model = build_model(cfg, Plan(), device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        logits = model.forward({"tokens": toks})
    caches = model.init_decode(2, 32)
    caches, lg = model.prefill({"tokens": toks}, caches)
    caches, lg = model.decode_step(caches, toks[:, :1], 16)
    print(f"[3] qwen2-7b (reduced): forward {tuple(logits.shape)}, decode "
          f"{tuple(lg.shape)}  OK")


if __name__ == "__main__":
    main()
