"""``python -m stmgcn_tpu_torch.cli lint``: run the lint passes and gate on
errors.

Usage::

    python -m stmgcn_tpu_torch.cli lint                  # every preset
    python -m stmgcn_tpu_torch.cli lint --preset default # one preset
    python -m stmgcn_tpu_torch.cli lint --format json    # the CI report
    python -m stmgcn_tpu_torch.cli lint --format sarif   # one SARIF document
    python -m stmgcn_tpu_torch.cli lint --list-rules     # the rule table

Exit code 1 when any error finding is reported; warnings do not gate.
Config math alone: no GPU, no kernel build, no JAX. The JAX lint's
``--rebaseline`` and its trace-based passes (jaxpr budgets, dtype flow,
SPMD collectives) and AST passes are deferred: they have no counterpart
in the port yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

__all__ = ["build_lint_parser", "main"]


def build_lint_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m stmgcn_tpu_torch.cli lint",
        description="config contracts and CUDA kernel launch budgets of the port's presets "
                    "(stmgcn_tpu_torch.analysis); --rebaseline and the JAX lint's "
                    "trace-based and AST passes are deferred")
    p.add_argument("--format", choices=("text", "json", "sarif"), default="text",
                   help="'sarif' emits one SARIF 2.1.0 document on stdout; 'json' the "
                        "native report")
    p.add_argument("--preset", default=None,
                   help="lint this preset only (default: every preset)")
    p.add_argument("--list-rules", action="store_true", help="print the rule table and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_lint_parser().parse_args(argv)
    from stmgcn_tpu_torch.analysis import run_passes
    from stmgcn_tpu_torch.analysis.report import render_json, render_sarif, render_text
    from stmgcn_tpu_torch.analysis.rules import RULES

    if args.list_rules:
        width = max(len(r) for r in RULES)
        for rule in RULES.values():
            print(f"{rule.id:<{width}}  {rule.severity:<7}  {rule.summary}")
        return 0
    configs = None
    if args.preset is not None:
        from stmgcn_tpu_torch.config import preset

        try:
            configs = [(args.preset, preset(args.preset))]
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    findings = run_passes(configs)
    renderers = {"json": render_json, "sarif": render_sarif, "text": render_text}
    print(renderers[args.format](findings))
    return 1 if any(f.severity == "error" and not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
