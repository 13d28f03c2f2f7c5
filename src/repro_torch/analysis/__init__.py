"""Simulation sanitizer (DESIGN.md §12), PyTorch port of ``repro.analysis``:
three cooperating passes.

* ``lint`` — repo-idiom AST rules over the port's Python (masked
  reductions, host reads in step code, library loads) and a shared-memory
  budget over its CUDA sources;
* ``graph_audit`` — checks on the *traced* aten graphs of the step and the
  other entry points (x64 creep, int32 carry overflow under declared
  trace-length bounds, host syncs, oversized gathers in a step);
* ``contracts`` — declarative launch and kernel-build budgets verified by
  running representative grids.

One CLI: ``python -m repro_torch.analysis`` (``--ci`` is the gate CI runs;
JSON and SARIF artifacts via ``--json``/``--sarif``).  Every rule of the
JAX package is either ported — under its own id, or renamed
(``RENAMED``: port id -> JAX id) — or listed in ``NOT_PORTED`` with the
reason it has no torch counterpart.
"""
from repro_torch.analysis.findings import (ERROR, NOTE, WARNING, Finding,
                                           Report, allowed_rules)

__all__ = ["ERROR", "NOTE", "WARNING", "Finding", "Report",
           "allowed_rules", "rule_index", "renamed", "not_ported",
           "run_all"]


def rule_index() -> dict:
    """rule id -> short description across all three passes (SARIF rules)."""
    from repro_torch.analysis import contracts, graph_audit, lint
    out = dict(lint.RULES)
    out.update(graph_audit.CHECKS)
    out.update(contracts.CHECKS)
    return out


def renamed() -> dict:
    """port rule id -> the JAX package's rule id it stands for (rules
    ported under their own id are left out)."""
    from repro_torch.analysis import contracts, graph_audit, lint
    return {**lint.RENAMED, **graph_audit.RENAMED, **contracts.RENAMED}


def not_ported() -> dict:
    """JAX rule id -> why the port has no counterpart."""
    from repro_torch.analysis import graph_audit, lint
    return {**lint.NOT_PORTED, **graph_audit.NOT_PORTED}


def run_all(paths=None, repo_root: str = ".", with_contracts: bool = True,
            with_audit: bool = True, with_lint: bool = True,
            device=None) -> Report:
    """Run the selected passes and merge their reports; the contract grids
    run on ``device`` (``None``: the CUDA device)."""
    from repro_torch.analysis import contracts, graph_audit, lint
    rep = Report()
    runs = []
    if with_lint:
        runs.append(lambda: lint.lint_paths(paths or lint.DEFAULT_PATHS,
                                            repo_root))
    if with_audit:
        runs.append(graph_audit.audit_all)
    if with_contracts:
        runs.append(lambda: contracts.check_all(device=device))
    for run in runs:
        r = run()
        rep.passes += r.passes
        rep.scanned += r.scanned
        rep.extend(r.findings)
    return rep
