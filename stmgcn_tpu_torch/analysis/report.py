"""Findings and report rendering of the lint passes.

A copy of ``stmgcn_tpu/analysis/report.py``: a :class:`Finding` is one
rule violation at one location (for the config passes a virtual
``<contract:...>`` path), and every pass returns a list of them, so the
CLI, the tests and any CI gate read one shape. ``render_json`` is the
machine-readable contract (``lint --format json``): a stable top-level
object with the report version, counts and per-finding records, the JAX
report's shape.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List

__all__ = ["Finding", "REPORT_VERSION", "render_json", "render_sarif", "render_text"]

#: the JAX report's version: the JSON shape is the same
REPORT_VERSION = 3


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location.

    ``path`` is repo-relative or a virtual ``<contract:...>`` path;
    ``line``/``col`` are 1-based (0 where there is no source line).
    ``chain`` (a call chain in the JAX report) is empty for every pass
    here; ``suppressed`` findings never gate."""

    rule: str
    path: str
    line: int
    message: str
    col: int = 0
    severity: str = "error"  # "error" gates; "warning" reports only
    chain: tuple = ()
    suppressed: bool = False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["chain"] = list(self.chain)
        return d

    def __str__(self) -> str:
        mark = " (suppressed)" if self.suppressed else ""
        via = f" [via {' -> '.join(self.chain)}]" if len(self.chain) > 1 else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}{via}{mark}"


def _ordered(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def render_text(findings: Iterable[Finding]) -> str:
    """One line per finding, sorted by location, and a count line."""
    ordered = _ordered(findings)
    if not ordered:
        return "stmgcn lint: clean"
    lines = [str(f) for f in ordered]
    live = [f for f in ordered if not f.suppressed]
    n_err = sum(1 for f in live if f.severity == "error")
    tail = f"stmgcn lint: {n_err} error(s), {len(live) - n_err} warning(s)"
    if len(ordered) > len(live):
        tail += f", {len(ordered) - len(live)} suppressed"
    lines.append(tail)
    return "\n".join(lines)


def render_json(findings: Iterable[Finding]) -> str:
    """The machine-readable report: suppressed findings listed, never
    counted."""
    ordered = _ordered(findings)
    live = [f for f in ordered if not f.suppressed]
    return json.dumps({
        "version": REPORT_VERSION,
        "errors": sum(1 for f in live if f.severity == "error"),
        "warnings": sum(1 for f in live if f.severity != "error"),
        "findings": [f.to_dict() for f in ordered],
    }, indent=2)


def render_sarif(findings: Iterable[Finding]) -> str:
    """One SARIF 2.1.0 document: one run, every rule that produced a
    finding in ``tool.driver.rules`` (its registry summary and long
    description), one result per finding; virtual paths are the artifact
    URIs, line 0 reported as 1."""
    from stmgcn_tpu_torch.analysis.rules import RULES

    ordered = _ordered(findings)
    rule_ids = sorted({f.rule for f in ordered})

    def text(rid, long):
        if rid not in RULES:
            return rid
        rule = RULES[rid]
        return ((rule.description or rule.summary) if long else rule.summary) or rid

    rules = [{
        "id": rid,
        "shortDescription": {"text": text(rid, False)},
        "fullDescription": {"text": text(rid, True)},
        "defaultConfiguration": {
            "level": "error" if rid in RULES and RULES[rid].severity == "error" else "warning"},
    } for rid in rule_ids]
    index = {rid: i for i, rid in enumerate(rule_ids)}
    results = []
    for f in ordered:
        res = {
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error" if f.severity == "error" else "warning",
            "message": {"text": f.message},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": max(1, f.line), "startColumn": max(1, f.col)},
            }}],
        }
        if f.chain:
            res["properties"] = {"chain": list(f.chain)}
        if f.suppressed:
            res["suppressions"] = [{"kind": "inSource"}]
        results.append(res)
    return json.dumps({
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "stmgcn-lint", "version": str(REPORT_VERSION),
                                "rules": rules}},
            "results": results,
        }],
    }, indent=2)
