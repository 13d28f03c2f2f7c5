"""FIGCache mechanism walk-through on the port's DRAM simulator: watch the
FTS warm up, segments co-locate, and the row-buffer hit rate climb (the
port's counterpart of ``examples/dram_cache_demo.py``).

    PYTHONPATH=src python examples/torch_dram_cache_demo.py [--device cpu]

``--device`` defaults to the CUDA device, which must exist.
``REPRO_EXAMPLE_REQS`` shrinks the simulated trace
(``tests/test_torch_examples.py`` runs this file with a tiny value).
"""
import argparse
import os

from repro_torch.core import simulator
from repro_torch.core.timing import DDR4
from repro_torch.device import resolve_device

N_REQS = int(os.environ.get("REPRO_EXAMPLE_REQS", "8192"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    print("=== FIGARO timing (paper §4.2) ===")
    print(f"RELOC column latency        : {DDR4.tRELOC} ns")
    print(f"isolated 1-block relocation : {DDR4.full_reloc_ns()} ns "
          "(ACT + RELOC + ACT + PRE)")
    print(f"fast subarray tRCD/tRP/tRAS : "
          f"{DDR4.tRCD*DDR4.fast_tRCD_scale:.2f}/"
          f"{DDR4.tRP*DDR4.fast_tRP_scale:.2f}/"
          f"{DDR4.tRAS*DDR4.fast_tRAS_scale:.2f} ns")

    print("\n=== one intensive app through all six systems (paper §8) ===")
    res = simulator.run_single_core("libquantum", n_reqs=N_REQS, device=dev)
    base = res["base"]
    print(f"{'mechanism':16s} {'speedup':>8s} {'row-hit':>8s} "
          f"{'cache-hit':>9s} {'DRAM mJ':>8s}")
    for m, r in res.items():
        sp = simulator.weighted_speedup(r, base)
        print(f"{m:16s} {sp:8.3f} {r.row_hit_rate:8.3f} "
              f"{r.cache_hit_rate:9.3f} {r.dram_energy_nj/1e6:8.2f}")

    print("\n=== the co-location effect (why FIGCache-Slow works) ===")
    print("FIGCache packs hot segments of DIFFERENT rows into ONE cache row;")
    print("revisits that were row-buffer conflicts become row hits:")
    for m in ("base", "figcache_slow"):
        r = res[m]
        print(f"  {m:16s} row-hit {r.row_hit_rate:.3f}")


if __name__ == "__main__":
    main()
