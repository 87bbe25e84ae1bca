"""Precision contracts: each preset's policy, and the dtype flow of every
traced program against it.

Counterpart of ``stmgcn_tpu/analysis/precision_check.py``, in two halves.
The policy half (:func:`check_precision_policy`, a config pass over every
preset) holds each preset's :class:`~stmgcn_tpu_torch.config.PrecisionPolicy`
to its own ``violations()``. The program half (:func:`check_precision`)
judges the role-classified dtype sites :mod:`.dtype_flow` extracts from
every traced contract program (:mod:`.programs`) against the contract
preset's policy, with the JAX rules and texts:

- **precision-policy**: a site's compute dtype outside its role's
  allowance, a self-contradictory policy, a registered program the walk
  missed (coverage is checked, not assumed), a master-state
  (``param``/``grad``/``opt_state``) or loss boundary leaf off the declared
  dtype, or a census drift from :data:`PRECISION_BASELINES`;
- **accum-dtype**: any mandatory-f32 reduction role (sum reductions,
  dot-general accumulators) holding a floating dtype narrower than f32;
  the finding names the exact node with its full provenance chain;
- **implicit-cast**: a float->float dtype-changing cast the policy's
  whitelist never declared (casts to f64 stay with ``fp64-promotion``).

A site's finding is reported at the port's source line of its node, so
``# stmgcn: ignore[rule]`` there suppresses it, as for the AST rules.

The per-program **dtype census** (bytes and FLOPs by dtype, count of
dtype-changing casts, nodes, S, nodes per kernel operator) is persisted,
per route, as the single-line :data:`PRECISION_BASELINES` literal by
``python -m stmgcn_tpu_torch.cli lint --rebaseline [--device cuda]``
(:func:`rebaseline_precision`): a precision migration lands as a measured
census diff plus a deliberate rebaseline, never silent drift.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs
from stmgcn_tpu_torch.analysis.report import Finding
from stmgcn_tpu_torch.analysis.rules import RULES

__all__ = ["PRECISION_BASELINES", "check_flow", "check_precision", "check_precision_policy",
           "measured_census", "precision_summary", "rebaseline_precision"]

#: measured per-program dtype census, per route: the precision twin of
#: PRIMITIVE_BUDGETS. The float-dtype *set* is gated exactly (a new
#: floating dtype in any program is drift) and the cast count at ~2x
#: headroom; the byte/FLOP values, nodes and kernel nodes are provenance
#: for census diffs, not gates. Keep this a single-line literal: ``lint
#: --rebaseline`` rewrites the traced route's entry in place from the
#: measured census (:func:`rebaseline_precision`).
PRECISION_BASELINES = {'cpu': {'eval_step': {'bytes': {'float32': 124467864, 'float64': 1280}, 'flops': {'float32': 226556800}, 'casts': 1, 'nodes': 240, 'steps': 1, 'kernels': {}}, 'serve_bucket': {'bytes': {'float32': 63263944, 'float64': 640}, 'flops': {'float32': 113278400}, 'casts': 1, 'nodes': 232, 'steps': 1, 'kernels': {}}, 'serve_fleet_bucket': {'bytes': {'bool': 3216, 'float32': 91891148, 'float64': 2688, 'int32': 128, 'int64': 800}, 'flops': {'float32': 113278400}, 'casts': 2, 'nodes': 243, 'steps': 1, 'kernels': {}}, 'train_fleet_superstep': {'bytes': {'bool': 502, 'float32': 607867768, 'float64': 793648, 'int32': 2104, 'int64': 2400}, 'flops': {'float32': 1144672000}, 'casts': 11, 'nodes': 1254, 'steps': 2, 'kernels': {}}, 'train_fleet_superstep_bf16': {'bytes': {'bfloat16': 10082280, 'bool': 502, 'float32': 237418336, 'int32': 2104, 'int64': 2400}, 'flops': {'bfloat16': 786432000, 'float32': 410668800}, 'casts': 183, 'nodes': 918, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_series_superstep': {'bytes': {'float32': 607063352, 'float64': 519680, 'int32': 2088}, 'flops': {'float32': 1144672000}, 'casts': 6, 'nodes': 1197, 'steps': 2, 'kernels': {}}, 'train_series_superstep_bf16': {'bytes': {'bfloat16': 10082280, 'float32': 236604936, 'int32': 2088}, 'flops': {'bfloat16': 786432000, 'float32': 410668800}, 'casts': 180, 'nodes': 863, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_series_superstep_health': {'bytes': {'bool': 60800, 'float32': 607247104, 'float64': 519680, 'int32': 2088, 'int64': 16}, 'flops': {'float32': 1144672000}, 'casts': 10, 'nodes': 1363, 'steps': 2, 'kernels': {}}, 'train_step': {'bytes': {'float32': 303454876, 'float64': 259840}, 'flops': {'float32': 572336000}, 'casts': 3, 'nodes': 592, 'steps': 1, 'kernels': {}}, 'train_step_bf16': {'bytes': {'bfloat16': 5041140, 'float32': 118225668}, 'flops': {'bfloat16': 393216000, 'float32': 205334400}, 'casts': 90, 'nodes': 425, 'steps': 1, 'kernels': {'fused_lstm_bwd': 1, 'fused_lstm_fwd': 1}}, 'train_step_checked': {'bytes': {'bool': 630408, 'float32': 303455212, 'float64': 259840, 'int32': 80}, 'flops': {'float32': 572336000}, 'casts': 10, 'nodes': 666, 'steps': 1, 'kernels': {}}, 'train_superstep': {'bytes': {'float32': 607063352, 'float64': 519680, 'int32': 256}, 'flops': {'float32': 1144672000}, 'casts': 6, 'nodes': 1189, 'steps': 2, 'kernels': {}}, 'train_superstep_bf16': {'bytes': {'bfloat16': 10082280, 'float32': 236604936, 'int32': 256}, 'flops': {'bfloat16': 786432000, 'float32': 410668800}, 'casts': 180, 'nodes': 855, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}}, 'cuda': {'eval_step': {'bytes': {'float32': 56393880, 'float64': 1280}, 'flops': {'float32': 226556800}, 'casts': 1, 'nodes': 143, 'steps': 1, 'kernels': {'fused_lstm_fwd': 1}}, 'serve_bucket': {'bytes': {'float32': 29186760, 'float64': 640}, 'flops': {'float32': 113278400}, 'casts': 1, 'nodes': 135, 'steps': 1, 'kernels': {'fused_lstm_fwd': 1}}, 'serve_fleet_bucket': {'bytes': {'bool': 3216, 'float32': 57813964, 'float64': 2688, 'int32': 128, 'int64': 800}, 'flops': {'float32': 113278400}, 'casts': 2, 'nodes': 146, 'steps': 1, 'kernels': {'fused_lstm_fwd': 1}}, 'train_fleet_superstep': {'bytes': {'bool': 502, 'float32': 235497336, 'float64': 793648, 'int32': 2104, 'int64': 2400}, 'flops': {'float32': 1197100800}, 'casts': 11, 'nodes': 746, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_fleet_superstep_bf16': {'bytes': {'bfloat16': 10082280, 'bool': 502, 'float32': 237418336, 'int32': 2104, 'int64': 2400}, 'flops': {'bfloat16': 786432000, 'float32': 410668800}, 'casts': 183, 'nodes': 918, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_series_superstep': {'bytes': {'float32': 234692920, 'float64': 519680, 'int32': 2088}, 'flops': {'float32': 1197100800}, 'casts': 6, 'nodes': 689, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_series_superstep_bf16': {'bytes': {'bfloat16': 10082280, 'float32': 236604936, 'int32': 2088}, 'flops': {'bfloat16': 786432000, 'float32': 410668800}, 'casts': 180, 'nodes': 863, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_series_superstep_health': {'bytes': {'bool': 60800, 'float32': 234876672, 'float64': 519680, 'int32': 2088, 'int64': 16}, 'flops': {'float32': 1197100800}, 'casts': 10, 'nodes': 855, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_step': {'bytes': {'float32': 117269660, 'float64': 259840}, 'flops': {'float32': 598550400}, 'casts': 3, 'nodes': 338, 'steps': 1, 'kernels': {'fused_lstm_bwd': 1, 'fused_lstm_fwd': 1}}, 'train_step_bf16': {'bytes': {'bfloat16': 5041140, 'float32': 118225668}, 'flops': {'bfloat16': 393216000, 'float32': 205334400}, 'casts': 90, 'nodes': 425, 'steps': 1, 'kernels': {'fused_lstm_bwd': 1, 'fused_lstm_fwd': 1}}, 'train_step_checked': {'bytes': {'bool': 630408, 'float32': 117269996, 'float64': 259840, 'int32': 80}, 'flops': {'float32': 598550400}, 'casts': 10, 'nodes': 412, 'steps': 1, 'kernels': {'fused_lstm_bwd': 1, 'fused_lstm_fwd': 1}}, 'train_superstep': {'bytes': {'float32': 234692920, 'float64': 519680, 'int32': 256}, 'flops': {'float32': 1197100800}, 'casts': 6, 'nodes': 681, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}, 'train_superstep_bf16': {'bytes': {'bfloat16': 10082280, 'float32': 236604936, 'int32': 256}, 'flops': {'bfloat16': 786432000, 'float32': 410668800}, 'casts': 180, 'nodes': 855, 'steps': 2, 'kernels': {'fused_lstm_bwd': 2, 'fused_lstm_fwd': 2}}}}

_ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}
_CAST_HEADROOM = 2.0
#: boundary labels held to the master dtype (the JAX ``param``/``opt_state``,
#: and the port's persistent ``.grad`` buffers)
_MASTER_LABELS = ("param", "grad", "opt_state")


def check_precision_policy(configs: Optional[Iterable[Tuple[str, object]]] = None
                           ) -> List[Finding]:
    """Every config's precision policy (default: every preset)."""
    findings = []
    for name, cfg in configs if configs is not None else preset_configs():
        policy = getattr(cfg, "precision", None)
        if policy is None:
            continue
        findings += [finding("precision-policy", "precision", name,
                             f"{name}: PrecisionPolicy: {v}") for v in policy.violations()]
    return findings


def _emit(findings: List[Finding], rule: str, name: str, message: str, site=None) -> None:
    path, line = (site.path, site.line) if site is not None and site.path else (
        f"<contract:precision:{name}>", 0)
    findings.append(Finding(rule=rule, path=path, line=line, message=message,
                            severity=RULES[rule].severity))


def _site_findings(flow, site, policy) -> List[Finding]:
    findings: List[Finding] = []
    if site.role == "cast":
        src = site.operand_dtypes[0] if site.operand_dtypes else "?"
        dst = site.dtype
        if (src in _ITEMSIZE and dst in _ITEMSIZE and src != dst
                and dst != "float64"  # fp64-promotion owns promotions to f64
                and (src, dst) not in policy.cast_whitelist):
            _emit(findings, "implicit-cast", flow.name,
                  f"{site.describe()}: cast {src}->{dst} is not in "
                  f"PrecisionPolicy.cast_whitelist {tuple(policy.cast_whitelist)} — a silent "
                  f"{'up' if _ITEMSIZE[dst] > _ITEMSIZE[src] else 'down'}cast the migration "
                  "plan never audited", site)
        return findings
    if site.role in policy.reduction_f32_roles:
        # accumulation roles are owned by accum-dtype (one finding per
        # hazard, not one per rule)
        if site.dtype in _ITEMSIZE and _ITEMSIZE[site.dtype] < 4:
            _emit(findings, "accum-dtype", flow.name,
                  f"{site.describe()}: reduction accumulator narrower than float32 — role "
                  f"{site.role!r} is in PrecisionPolicy.reduction_f32_roles (mandatory f32); "
                  "low-order bits are lost on every add", site)
        return findings
    allowed = policy.allowed(site.role)
    if allowed is None:
        return findings
    checked = ([d for d in site.operand_dtypes if d in _ITEMSIZE] if site.role == "dot_general"
               else ([site.dtype] if site.dtype in _ITEMSIZE else []))
    bad = sorted({d for d in checked if d not in allowed})
    if bad:
        _emit(findings, "precision-policy", flow.name,
              f"{site.describe()}: dtype(s) {bad} outside "
              f"PrecisionPolicy.role_dtypes[{site.role!r}] = {allowed}", site)
    return findings


def _boundary_findings(flow, policy) -> List[Finding]:
    """Master-state / loss dtype at the program's edges."""
    findings: List[Finding] = []
    master = policy.master_param_dtype
    loss_allowed = policy.allowed("loss") or (master,)
    for end, labels, dtypes in (("input", flow.in_labels, flow.in_dtypes),
                                ("output", flow.out_labels, flow.out_dtypes)):
        seen: Dict[str, int] = {}
        for label, dt in zip(labels, dtypes):
            i = seen.get(label, 0)
            seen[label] = i + 1
            if dt not in _ITEMSIZE:
                continue
            if label in _MASTER_LABELS and dt != master:
                _emit(findings, "precision-policy", flow.name,
                      f"{flow.name}: {end} leaf {label}[{i}] has dtype {dt}, but "
                      f"PrecisionPolicy.master_param_dtype is {master!r} — master state "
                      "must stay wide; cast for compute instead")
            elif label == "loss" and dt not in loss_allowed:
                _emit(findings, "precision-policy", flow.name,
                      f"{flow.name}: {end} leaf loss[{i}] has dtype {dt} outside "
                      f"PrecisionPolicy.role_dtypes['loss'] = {loss_allowed}")
    return findings


def check_flow(flow, policy) -> List[Finding]:
    """All three precision rules over one walked program (unsuppressed)."""
    findings: List[Finding] = []
    for site in flow.sites:
        findings.extend(_site_findings(flow, site, policy))
    findings.extend(_boundary_findings(flow, policy))
    return findings


def _floats(census: dict) -> set:
    return {d for d in census.get("bytes", {}) if d in _ITEMSIZE}


def _census_findings(name: str, census: dict, baseline: Optional[dict]) -> List[Finding]:
    findings: List[Finding] = []
    if baseline is None:
        _emit(findings, "precision-policy", name,
              f"{name}: no PRECISION_BASELINES entry — a new contract program needs a "
              "deliberate census baseline; run `python -m stmgcn_tpu_torch.cli lint "
              "--rebaseline`")
        return findings
    measured_f, baseline_f = _floats(census), _floats(baseline)
    if measured_f != baseline_f:
        _emit(findings, "precision-policy", name,
              f"{name}: floating dtype census drifted — measured {sorted(measured_f)} vs "
              f"baseline {sorted(baseline_f)}; a precision migration must land as `lint "
              "--rebaseline`, never as silent drift")
    cast_budget = int(baseline.get("casts", 0) * _CAST_HEADROOM)
    if census["casts"] > max(cast_budget, baseline.get("casts", 0)):
        _emit(findings, "precision-policy", name,
              f"{name}: {census['casts']} dtype-changing casts > budget {cast_budget} "
              f"(baseline {baseline.get('casts', 0)} x {_CAST_HEADROOM} headroom) — "
              "cast-boundary growth; rebaseline deliberately if intended")
    return findings


def check_precision(route: str = "cpu", policy=None, flows: Optional[dict] = None,
                    include_suppressed: bool = False) -> List[Finding]:
    """Walk every registered program of ``route`` and apply the policy.

    ``policy``/``flows`` overrides exist for fixtures; the default is the
    contract preset's declared policy over the cached
    :func:`~.dtype_flow.program_flows` registry. Suppressions are applied
    at each finding's source line."""
    from stmgcn_tpu_torch.analysis.dtype_flow import program_flows
    from stmgcn_tpu_torch.analysis.program_check import PRIMITIVE_BUDGETS, suppress
    from stmgcn_tpu_torch.analysis.programs import CONTRACT_PRESET, PROGRAMS
    from stmgcn_tpu_torch.config import preset

    if policy is None:
        policy = preset(CONTRACT_PRESET).precision
    findings: List[Finding] = []
    for v in policy.violations():
        _emit(findings, "precision-policy", "policy", f"PrecisionPolicy: {v}")
    if flows is None:
        flows = program_flows(route)
    # coverage is itself a contract: a registered program the dtype walk
    # never saw is a hole in the certification, not a pass
    registered = set(PROGRAMS) | set(PRIMITIVE_BUDGETS.get(route, {}))
    for name in sorted(registered - set(flows)):
        _emit(findings, "precision-policy", name,
              f"{name}: registered contract program was not walked by the dtype-flow pass "
              "— precision coverage hole")
    baselines = PRECISION_BASELINES.get(route, {})
    for name in sorted(flows):
        findings.extend(check_flow(flows[name], policy))
        findings.extend(_census_findings(name, flows[name].census, baselines.get(name)))
    return suppress(findings, include_suppressed)


def measured_census(route: str = "cpu") -> Dict[str, dict]:
    """The current per-program dtype census of ``route`` (the rebaseline
    payload)."""
    from stmgcn_tpu_torch.analysis.dtype_flow import program_flows

    return {name: flow.census for name, flow in sorted(program_flows(route).items())}


def precision_summary(route: str = "cpu") -> dict:
    """The lint gate's ``precision`` section (the JAX keys): ``programs``,
    the programs the dtype walk covered on ``route``; ``bf16_programs``,
    the mixed-precision ``_bf16`` twins among them (the gate requires > 0,
    so the bf16 certification can never silently drop out of the
    registry); ``sites``, the role-classified dtype sites; ``findings``,
    the unsuppressed precision findings (policy and programs)."""
    from stmgcn_tpu_torch.analysis.dtype_flow import program_flows

    flows = program_flows(route)
    findings = check_precision(route, flows=flows) + check_precision_policy()
    return {
        "programs": len(flows),
        "bf16_programs": sum(1 for name in flows if name.endswith("_bf16")),
        "sites": sum(len(f.sites) for f in flows.values()),
        "findings": len(findings),
    }


def rebaseline_precision(route: str = "cpu", path: Optional[str] = None) -> dict:
    """Measure ``route``'s dtype census and rewrite its entry of
    :data:`PRECISION_BASELINES` (the other route's is kept).

    The measured census is written verbatim into this module's single-line
    literal (``path`` overrides the target for tests) and updated
    in-process; cast headroom (~2x) is applied at check time, not stored.
    Returns ``{"census": ..., "route": ..., "path": ...}``."""
    from stmgcn_tpu_torch.analysis.program_check import _rewrite

    census = measured_census(route)
    path = path or __file__
    new = {**PRECISION_BASELINES, route: census}
    _rewrite(path, "PRECISION_BASELINES", new)
    PRECISION_BASELINES.clear()
    PRECISION_BASELINES.update(new)
    return {"census": census, "route": route, "path": path}
