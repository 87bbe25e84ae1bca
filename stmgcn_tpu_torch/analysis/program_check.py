"""Contract checks on the traced step programs.

Counterpart of ``stmgcn_tpu/analysis/jaxpr_check.py``. Traces the smoke
preset's step programs (:mod:`.programs`: ``make_fx`` over fake tensors,
no FLOPs run, no kernel launched, seconds on the CPU) and asserts
invariants that only show up at trace level:

- **fp64-promotion**: no cast to float64 and no float64 value anywhere in
  the graph. A stray float64 constant or accumulator silently doubles
  memory traffic and, on the H100, leaves the float32 and tensor-core
  paths entirely (its float64 rate is a fraction of its float32 one). The
  finding names the port's source line of the node, so a deliberate one
  takes ``# stmgcn: ignore[fp64-promotion]`` with its reason there.
- **primitive-budget**: each program's node count (its ``call_function``
  nodes, the JAX eqn count's counterpart) stays under a recorded budget.
  A rematerialized subgraph, a loop unrolled past its S, or an op that
  stopped fusing into a kernel operator shows up as node-count growth
  long before it shows up in a profile; the budget makes it a test
  failure. :data:`PRIMITIVE_BUDGETS` is keyed by route (``"cpu"``, the
  plain versions; ``"cuda"``, the kernels as one node each), since the
  two trace different graphs. Rebaseline it deliberately when a real
  feature moves the count: ``python -m stmgcn_tpu_torch.cli lint
  --rebaseline [--device cuda]`` (:func:`rebaseline`) measures the route's
  counts and rewrites its budgets with headroom in one command.

The JAX ``weak-type-output`` rule has no counterpart: PyTorch has no weak
types, and the recapture it guards against (a program's inputs changing
type between calls) is what :mod:`~stmgcn_tpu_torch.obs.graphmon`'s
``recaptures_after_warmup`` counts.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional

from stmgcn_tpu_torch.analysis.report import Finding
from stmgcn_tpu_torch.analysis.rules import RULES

__all__ = ["PRIMITIVE_BUDGETS", "check_step_contracts", "contract_findings",
           "measured_node_counts", "rebaseline", "suppress"]

#: measured node counts x ~2 headroom for legitimate feature growth, per
#: route: the guard is against order-of-magnitude regressions (a loop
#: unrolled past S multiplies the count), not single-op drift. Keep this a
#: single-line literal: ``lint --rebaseline`` rewrites the traced route's
#: entry in place from the measured counts (:func:`rebaseline`).
PRIMITIVE_BUDGETS = {'cpu': {'serve_bucket': 470, 'train_step': 1190, 'eval_step': 480, 'train_superstep': 2380, 'train_series_superstep': 2400, 'train_series_superstep_health': 2730, 'train_fleet_superstep': 2510, 'serve_fleet_bucket': 490, 'train_step_checked': 1340, 'train_step_bf16': 850, 'train_superstep_bf16': 1710, 'train_series_superstep_bf16': 1730, 'train_fleet_superstep_bf16': 1840}, 'cuda': {'serve_bucket': 270, 'train_step': 680, 'eval_step': 290, 'train_superstep': 1370, 'train_series_superstep': 1380, 'train_series_superstep_health': 1710, 'train_fleet_superstep': 1500, 'serve_fleet_bucket': 300, 'train_step_checked': 830, 'train_step_bf16': 850, 'train_superstep_bf16': 1710, 'train_series_superstep_bf16': 1730, 'train_fleet_superstep_bf16': 1840}}

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _at(rule: str, name: str, message: str, path: Optional[str], line: int) -> Finding:
    """A finding at the port's source line of a node, or at the program's
    virtual ``<contract:name>`` path when no line of the port made it."""
    if path is None:
        path, line = f"<contract:{name}>", 0
    return Finding(rule=rule, path=path, line=line, message=message,
                   severity=RULES[rule].severity)


def suppress(findings: List[Finding], include_suppressed: bool = False) -> List[Finding]:
    """Apply ``# stmgcn: ignore[rule]`` on each finding's reported source
    line (the AST rules' suppression, :mod:`.lint`): drop the suppressed
    findings, or keep them marked with ``include_suppressed``."""
    from stmgcn_tpu_torch.analysis.lint import _apply_suppressions, _suppressions

    by_path = {}
    for f in findings:
        file = os.path.join(_REPO, f.path)
        if f.path not in by_path and os.path.isfile(file):
            with open(file) as src:
                by_path[f.path] = _suppressions(src.read())
    return _apply_suppressions(findings, by_path, include_suppressed)


def _check_one(flow, budget: Optional[int]) -> List[Finding]:
    name = flow.name
    findings = []
    for ev in flow.fp64_events:
        where = f"{ev['path']}:{ev['line']}" if ev["path"] else "no port line"
        if ev["kind"] == "convert":
            message = (f"{name}: {ev['op']} to float64 from {ev['src']} "
                       f"(source: {where}, node {ev['node']})")
        else:
            message = f"{name}: {ev['op']} produces a float64 value (node {ev['node']})"
        findings.append(_at("fp64-promotion", name, message[:500], ev["path"], ev["line"]))
    if budget is not None and flow.node_count > budget:
        findings.append(_at(
            "primitive-budget", name,
            f"{name}: {flow.node_count} nodes > budget {budget} — fusion/unroll "
            "regression, or rebaseline PRIMITIVE_BUDGETS with the feature that moved it",
            None, 0))
    return findings


def contract_findings(flows: Dict[str, object], route: str = "cpu") -> List[Finding]:
    """``fp64-promotion`` and ``primitive-budget`` over walked programs
    (``{name: ProgramFlow}``) against ``route``'s budgets, unsuppressed."""
    budgets = PRIMITIVE_BUDGETS.get(route, {})
    findings = []
    for name in sorted(flows):
        findings += _check_one(flows[name], budgets.get(name))
    return findings


def check_step_contracts(route: str = "cpu", include_suppressed: bool = False
                         ) -> List[Finding]:
    """Trace the contract preset's step programs on ``route`` and check
    them (suppressions applied)."""
    from stmgcn_tpu_torch.analysis.dtype_flow import program_flows

    return suppress(contract_findings(program_flows(route), route), include_suppressed)


def measured_node_counts(route: str = "cpu") -> Dict[str, int]:
    """The current node count of every registered program on ``route``."""
    from stmgcn_tpu_torch.analysis.dtype_flow import program_flows

    return {name: flow.node_count for name, flow in program_flows(route).items()}


def _rewrite(path: str, name: str, value: dict) -> None:
    """Replace the single-line ``name = {...}`` literal of ``path``."""
    with open(path) as f:
        src = f.read()
    new_src, n = re.subn(rf"^{name} = \{{.*\}}$", f"{name} = " + repr(value), src,
                         count=1, flags=re.M)
    if n != 1:
        raise RuntimeError(f"could not find the {name} literal in {path}")
    with open(path, "w") as f:
        f.write(new_src)


def rebaseline(route: str = "cpu", path: Optional[str] = None, headroom: float = 2.0) -> dict:
    """Measure ``route``'s node counts and rewrite its entry of
    :data:`PRIMITIVE_BUDGETS` (the other route's is kept).

    Applies ``headroom`` (default the standing ~2x policy, rounded up to
    the next 10), rewrites the single-line literal in this module's source
    (``path`` overrides the target for tests) and updates the in-process
    dict, so later checks see the new budgets. Returns ``{"counts": ...,
    "budgets": ..., "route": ..., "path": ...}``."""
    if headroom < 1.0:
        raise ValueError(f"headroom must be >= 1.0, got {headroom}")
    counts = measured_node_counts(route)
    budgets = {name: int(math.ceil(c * headroom / 10.0) * 10) for name, c in counts.items()}
    path = path or __file__
    new = {**PRIMITIVE_BUDGETS, route: budgets}
    _rewrite(path, "PRIMITIVE_BUDGETS", new)
    PRIMITIVE_BUDGETS.clear()
    PRIMITIVE_BUDGETS.update(new)
    return {"counts": counts, "budgets": budgets, "route": route, "path": path}
