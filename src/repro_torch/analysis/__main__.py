"""CLI for the simulation sanitizer.

    python -m repro_torch.analysis                 # lint + graph audit
    python -m repro_torch.analysis --ci            # all passes; nonzero on
                                                   # ANY finding (the CI gate)
    python -m repro_torch.analysis --contracts     # include launch contracts
    python -m repro_torch.analysis --ci --device cpu   # contracts on the CPU
    python -m repro_torch.analysis --json r.json --sarif r.sarif
    python -m repro_torch.analysis --paths src/repro_torch/core

The contract grids run on ``--device`` (default: the CUDA device, which
must exist); the lint and the graph audit need no device.  Exit status: 0
clean; 1 findings (error-level by default, any level under ``--ci``); 2
usage errors.
"""
from __future__ import annotations

import argparse
import sys

import torch

import repro_torch.analysis as analysis
from repro_torch.analysis import lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="aten-graph audit + repo-idiom lint + launch contracts")
    ap.add_argument("--paths", nargs="*", default=None,
                    help=f"files/dirs to lint "
                         f"(default: {' '.join(lint.DEFAULT_PATHS)})")
    ap.add_argument("--repo-root", default=".",
                    help="repo root for relative finding paths")
    ap.add_argument("--ci", action="store_true",
                    help="run every pass and fail on ANY finding")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the launch-contract grids")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the graph audit (pure AST run)")
    ap.add_argument("--device", default=None,
                    help="device of the contract grids (default: cuda)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the JSON report artifact")
    ap.add_argument("--sarif", metavar="PATH",
                    help="write the SARIF 2.1.0 artifact")
    args = ap.parse_args(argv)

    with_contracts = args.ci or args.contracts
    rep = analysis.run_all(
        paths=args.paths, repo_root=args.repo_root,
        with_lint=True,
        with_audit=not args.no_audit,
        with_contracts=with_contracts, device=args.device)
    rep.meta["torch"] = torch.__version__
    if with_contracts:
        dev = torch.device(args.device or "cuda")
        rep.meta["device"] = torch.cuda.get_device_name(dev) \
            if dev.type == "cuda" else dev.type

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            f.write(rep.to_json())
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            f.write(rep.to_sarif(analysis.rule_index()))
    print(rep.render_text())
    if args.ci:
        return 1 if rep.findings else 0
    return rep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
