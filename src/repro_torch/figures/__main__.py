"""``python -m repro_torch.figures``: the paper's figures on the port.

Prints ``name,derived`` lines on stdout, one a figure, where ``derived``
is the headline number the paper reports for that figure; the full
summaries go to stderr, and ``--json PATH`` writes every figure's rows
and summary.  ``--quick`` shrinks every trace (1-core 10240 -> 2048
requests, 8-core 6144 -> 1024 a channel, long 12288 -> 2048); ``--only
a,b`` runs a comma-separated subset of the names below; ``--device``
defaults to the CUDA device, which must exist (``--device cpu`` runs the
eager loop: minutes at the full sizes).

    PYTHONPATH=src python -m repro_torch.figures --quick --device cpu
    PYTHONPATH=src python -m repro_torch.figures          # the card
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

from repro_torch.device import resolve_device
from repro_torch.figures import FULL, NAMES, QUICK

# each figure's headline: the summary key the paper's number stands for
HEADLINES = {
    "fig03_footprint": "oracle/visit_leq2",
    "fig07_single_core": "intensive/figcache_fast",
    "fig08_eight_core": "avg/figcache_fast",
    "fig09_cache_hit": "100%/figcache_fast",
    "fig10_row_hit": "100%/figcache_fast",
    "fig11_energy": "100%/figcache_fast/dram",
    "fig12_capacity": "FS=2",
    "fig13_segment_size": "seg=16",
    "fig14_replacement": "row_benefit",
    "fig15_insertion": "th=1",
    "fig16_scheduler": "frfcfs_qd16",
    "fig17_scenarios": "embed/figcache_fast",
}


def module(name: str):
    return importlib.import_module(f"repro_torch.figures.{name}")


def derived(name: str, summary: dict):
    if name == "fig_tail_latency":
        return (f"p99_gain={summary['p99_gain_mean']}x "
                f"zipf={summary.get('zipf_reuse/p99_gain')}")
    return summary.get(HEADLINES[name])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.figures",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small traces, for smoke runs")
    ap.add_argument("--only", default="",
                    help="comma-separated figure names to run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write every figure's rows and summary here")
    args = ap.parse_args(argv)
    only = {n for n in args.only.split(",") if n}
    unknown = only - set(NAMES)
    if unknown:
        ap.error(f"unknown figure(s) {sorted(unknown)}; "
                 f"choose from {list(NAMES)}")
    dev = resolve_device(args.device)
    sizes = QUICK if args.quick else FULL
    print("name,derived")
    details = {}
    for name in NAMES:
        if only and name not in only:
            continue
        rows, summary = module(name).run(dev, sizes)
        print(f"{name},{derived(name, summary)}", flush=True)
        details[name] = {"rows": rows, "summary": summary}
    print("\n# summaries", file=sys.stderr)
    for name, d in details.items():
        print(name, d["summary"], file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": str(dev), "sizes": "quick" if args.quick
                       else "full", "figures": details}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
