"""``python -m stmgcn_tpu_torch.cli lint``: run the lint passes and gate on
errors.

Usage::

    python -m stmgcn_tpu_torch.cli lint                  # the package + every preset
    python -m stmgcn_tpu_torch.cli lint path/to/code ... # these files/dirs (AST only)
    python -m stmgcn_tpu_torch.cli lint --preset default # the config passes on one preset
    python -m stmgcn_tpu_torch.cli lint --no-contracts   # AST and concurrency only
    python -m stmgcn_tpu_torch.cli lint --no-whole-program  # per-module AST, no concurrency
    python -m stmgcn_tpu_torch.cli lint --include-suppressed --format json  # the audit
    python -m stmgcn_tpu_torch.cli lint --format sarif   # one SARIF document
    python -m stmgcn_tpu_torch.cli lint --list-rules     # the rule table
    python -m stmgcn_tpu_torch.cli lint --device cuda    # the contract pass on the card
    python -m stmgcn_tpu_torch.cli lint --rebaseline [--device cuda]  # re-measure

The default run is the whole-program pass over ``stmgcn_tpu_torch/`` (the
program database, the AST rules over the capture-reachable functions, the
four concurrency rules: :mod:`.lint`, :mod:`.program_db`,
:mod:`.concurrency_check`), then every config pass over every preset
(:func:`~stmgcn_tpu_torch.analysis.run_passes`: the collective shapes,
the per-rank footprints and declared manifests, memory, serving, the
sections, tiles, precision and the kernels' launch budgets), then the
contract pass: the smoke preset's 13 step programs traced into aten graphs
(:mod:`.programs`) and held to ``fp64-promotion``, ``primitive-budget``
and the precision rules. ``--device`` picks the traced route: ``cpu`` (the
default: what the CPU runs, no GPU, no kernel build) or ``cuda`` (what the
card replays, each kernel one node; raises without a card). Explicit
paths mean "lint this code": the per-module AST rules alone, as in the JAX
CLI. The whole-program pass writes one line to stderr: the database's
modules and classes and the pass's seconds. Exit code 1 when any
unsuppressed error finding is reported; warnings do not gate. No JAX.

``--rebaseline`` measures the route's programs and rewrites its entries of
``PRIMITIVE_BUDGETS`` (``analysis/program_check.py``, the node counts x ~2)
and ``PRECISION_BASELINES`` (``analysis/precision_check.py``, the dtype
census), then exits: the deliberate rebaseline for a feature that moves a
program's node count or precision census. The JAX CLI's ``WIRE_BUDGETS``
has no counterpart (``spmd-wire-budget`` reads an executed step's counted
collectives against a model, not a measured literal).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

__all__ = ["build_lint_parser", "main"]


def build_lint_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m stmgcn_tpu_torch.cli lint",
        description="whole-program AST and concurrency lint of stmgcn_tpu_torch, config and "
                    "mesh contracts and CUDA kernel launch budgets of the port's presets "
                    "(stmgcn_tpu_torch.analysis)")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (AST only; default: the stmgcn_tpu_torch "
                        "package, plus the config passes)")
    p.add_argument("--format", choices=("text", "json", "sarif"), default="text",
                   help="'sarif' emits one SARIF 2.1.0 document on stdout; 'json' the "
                        "native report")
    p.add_argument("--preset", default=None,
                   help="run the config passes on this preset only (default: every preset)")
    p.add_argument("--no-contracts", action="store_true",
                   help="skip the config passes and the contract pass over the traced step "
                        "programs (AST and concurrency only)")
    p.add_argument("--no-whole-program", action="store_true",
                   help="per-module AST lint only: no program database, no cross-module "
                        "capture-reachability, no concurrency pass")
    p.add_argument("--include-suppressed", action="store_true",
                   help="keep `# stmgcn: ignore`-suppressed findings in the report, marked "
                        "suppressed and never counted or gating")
    p.add_argument("--list-rules", action="store_true", help="print the rule table and exit")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                   help="the route the contract pass traces: what the CPU runs (default) or "
                        "what the card replays (needs a GPU)")
    p.add_argument("--rebaseline", action="store_true",
                   help="measure the route's step programs and rewrite its PRIMITIVE_BUDGETS "
                        "(node counts x ~2, analysis/program_check.py) and "
                        "PRECISION_BASELINES (dtype census, analysis/precision_check.py) "
                        "entries, then exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_lint_parser().parse_args(argv)
    from stmgcn_tpu_torch.analysis import run_passes
    from stmgcn_tpu_torch.analysis.lint import lint_package, lint_paths, package_root
    from stmgcn_tpu_torch.analysis.report import render_json, render_sarif, render_text
    from stmgcn_tpu_torch.analysis.rules import RULES

    if args.list_rules:
        width = max(len(r) for r in RULES)
        for rule in RULES.values():
            print(f"{rule.id:<{width}}  {rule.severity:<7}  {rule.summary}")
        return 0
    if args.rebaseline:
        return _rebaseline(args.device, args.format)
    configs = None
    if args.preset is not None:
        from stmgcn_tpu_torch.config import preset

        try:
            configs = [(args.preset, preset(args.preset))]
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.paths:
        findings = lint_paths(args.paths, include_suppressed=args.include_suppressed)
    elif args.no_whole_program:
        findings = lint_package(whole_program=False, include_suppressed=args.include_suppressed)
    else:
        from stmgcn_tpu_torch.analysis.program_db import ProgramDB

        t0 = time.perf_counter()
        db = ProgramDB.from_root(package_root(), type_informed=True)
        findings = lint_package(db=db, include_suppressed=args.include_suppressed)
        print(f"lint: program database of {len(db.modules)} modules, {len(db.classes)} "
              f"classes; whole-program pass {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    if not args.paths and not args.no_contracts:
        findings.extend(run_passes(configs, route=args.device,
                                   include_suppressed=args.include_suppressed))
    renderers = {"json": render_json, "sarif": render_sarif, "text": render_text}
    print(renderers[args.format](findings))
    return 1 if any(f.severity == "error" and not f.suppressed for f in findings) else 0


def _rebaseline(route: str, fmt: str) -> int:
    """``lint --rebaseline``: both literals of ``route`` rewritten."""
    import json

    from stmgcn_tpu_torch.analysis.precision_check import rebaseline_precision
    from stmgcn_tpu_torch.analysis.program_check import rebaseline

    result = rebaseline(route)
    precision = rebaseline_precision(route)
    if fmt == "json":
        print(json.dumps({**result, "precision": precision}))
        return 0
    for name, count in result["counts"].items():
        census = precision["census"][name]
        print(f"{name}: measured {count} nodes -> budget {result['budgets'][name]}; dtype "
              f"census {sorted(census['bytes'])}, {census['casts']} cast(s), kernel nodes "
              f"{census['kernels']}")
    print(f"rewrote the {route} entries of PRIMITIVE_BUDGETS in {result['path']} and of "
          f"PRECISION_BASELINES in {precision['path']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
