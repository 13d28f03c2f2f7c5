"""Finding/report plumbing shared by the three analysis passes, the
port's copy of ``repro.analysis.findings`` (framework-free).

A ``Finding`` is one violation of a repo contract: a rule id (the catalog
lives in DESIGN.md §12; ``repro_torch.analysis.rule_index`` lists the
port's), a severity, a location (file:line for lint findings, an entry
name for graph-audit and contract findings), and a message precise enough
to act on.  ``Report`` aggregates the findings of one analyzer run and
renders them as terminal text, as JSON (the CI artifact), or as SARIF
2.1.0 (the interchange format code-review UIs ingest).

Suppression: a source line carrying ``# repro: allow(<rule-id>)`` (in CUDA
sources ``// repro: allow(<rule-id>)``) — on the flagged line or the line
directly above it — opts that one site out of a lint rule.  The spelling
is the JAX package's, so one search finds the pragmas of both packages.
Use it for *intentional* violations only; the comment is the
visible record that the violation is deliberate.  Graph-audit
and contract findings have no source line and cannot be suppressed —
they are fixed or the entry's declaration changes.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

# severity levels, in increasing order of badness
NOTE, WARNING, ERROR = "note", "warning", "error"

# ``# repro: allow(...)`` in Python, ``// repro: allow(...)`` in CUDA
_ALLOW_RE = re.compile(r"(?:#|//)\s*repro:\s*allow\(([a-z0-9_,\- ]+)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                 # rule id, e.g. "unmasked-padded-reduction"
    message: str              # one actionable sentence
    level: str = ERROR        # note | warning | error
    path: Optional[str] = None   # repo-relative file (lint findings)
    line: Optional[int] = None   # 1-based (lint findings)
    entry: Optional[str] = None  # audited entry point / contract name

    def where(self) -> str:
        if self.path is not None:
            loc = self.path if self.line is None else f"{self.path}:{self.line}"
        else:
            loc = self.entry or "<analysis>"
        return loc

    def render(self) -> str:
        return f"{self.where()}: {self.level}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict:
        d = {"rule": self.rule, "level": self.level, "message": self.message}
        if self.path is not None:
            d["path"] = self.path
            if self.line is not None:
                d["line"] = self.line
        if self.entry is not None:
            d["entry"] = self.entry
        return d


def allowed_rules(src_lines: List[str], lineno: int) -> set:
    """Rules suppressed at 1-based ``lineno`` via ``# repro: allow(...)``
    on the line itself or the line directly above."""
    out = set()
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(src_lines):
            m = _ALLOW_RE.search(src_lines[ln - 1])
            if m:
                out.update(r.strip() for r in m.group(1).split(","))
    return out


@dataclasses.dataclass
class Report:
    """One analyzer run: findings plus enough metadata to read the record
    cold (which passes ran, over what, under which torch and device)."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    passes: List[str] = dataclasses.field(default_factory=list)
    scanned: List[str] = dataclasses.field(default_factory=list)
    meta: Dict[str, str] = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.level == ERROR]

    def exit_code(self) -> int:
        """Non-zero iff any error-level finding (the CI gate)."""
        return 1 if self.errors else 0

    # ---- renderers --------------------------------------------------------

    def render_text(self) -> str:
        lines = [f.render() for f in self.findings]
        n_err = len(self.errors)
        lines.append(
            f"repro_torch.analysis: {len(self.findings)} finding(s)"
            f" ({n_err} error) from passes: {', '.join(self.passes) or '-'}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "schema_version": SCHEMA_VERSION,
            "tool": "repro_torch.analysis",
            "passes": self.passes,
            "scanned": self.scanned,
            "meta": self.meta,
            "n_findings": len(self.findings),
            "n_errors": len(self.errors),
            "findings": [f.to_dict() for f in self.findings],
        }, indent=2, sort_keys=True) + "\n"

    def to_sarif(self, rule_index: Dict[str, str]) -> str:
        """SARIF 2.1.0: one run, one result per finding.  ``rule_index``
        maps rule id -> short description (the registered catalogs)."""
        rules = [{"id": rid,
                  "shortDescription": {"text": desc}}
                 for rid, desc in sorted(rule_index.items())]
        rule_pos = {rid: i for i, (rid, _) in
                    enumerate(sorted(rule_index.items()))}
        results = []
        for f in self.findings:
            res = {
                "ruleId": f.rule,
                "level": f.level if f.level != ERROR else "error",
                "message": {"text": f.message},
            }
            if f.rule in rule_pos:
                res["ruleIndex"] = rule_pos[f.rule]
            if f.path is not None:
                loc = {"physicalLocation": {
                    "artifactLocation": {"uri": f.path}}}
                if f.line is not None:
                    loc["physicalLocation"]["region"] = {"startLine": f.line}
                res["locations"] = [loc]
            elif f.entry is not None:
                res["locations"] = [{"logicalLocations":
                                     [{"name": f.entry}]}]
            results.append(res)
        return json.dumps({
            "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                        "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
            "version": "2.1.0",
            "runs": [{
                "tool": {"driver": {
                    "name": "repro_torch.analysis",
                    "informationUri": "DESIGN.md#12-the-simulation-sanitizer",
                    "rules": rules,
                }},
                "results": results,
            }],
        }, indent=2, sort_keys=True) + "\n"
