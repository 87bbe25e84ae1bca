"""``obs`` / ``health`` — inspect exported telemetry files.

Copy of ``stmgcn_tpu/obs/cli.py``, reached as ``python -m
stmgcn_tpu_torch.cli obs PATH`` and ``python -m stmgcn_tpu_torch.cli health
PATH``.

``obs TRACE`` summarizes a JSONL span trace. Text mode renders
the per-phase table; ``--format json`` prints exactly one JSON line on
stdout (machine contract, same discipline as the bench CLIs) with the
summary, meta header, and — with ``--dump`` — the raw spans; ``--format
chrome`` prints the trace in Chrome trace-event JSON for
chrome://tracing / Perfetto ("open legacy trace"), threads rendered as
tracks and nested spans as duration events.

``health PATH`` summarizes a ``health.jsonl`` file written by a
health-instrumented training run: loss/grad-norm/update-ratio rollups,
nonfinite counts, per-group gradient norms, per-city loss attribution,
and — when drift records are present — the worst-city drift z/PSI.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .health import load_health, render_health_table, summarize_health
from .report import chrome_trace, load_trace, render_table, summarize

__all__ = ["build_obs_parser", "build_health_parser", "health_main", "main"]


def _quiet_broken_pipe() -> None:
    # `stmgcn obs trace | head` closing the pipe early is fine; don't
    # let the teardown flush traceback either
    try:
        sys.stdout.close()
    except BrokenPipeError:
        pass


def build_obs_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stmgcn_tpu_torch.cli obs",
        description="Summarize a JSONL span trace (see README Observability).",
    )
    p.add_argument("trace", help="path to a --trace-out JSONL file")
    p.add_argument("--format", choices=("text", "json", "chrome"),
                   default="text",
                   help="text table, one JSON line, or a Chrome/Perfetto "
                        "trace-event JSON on stdout")
    p.add_argument("--dump", action="store_true",
                   help="include raw spans (json) / print them (text)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_obs_parser().parse_args(argv)
    try:
        meta, spans = load_trace(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"obs: cannot read trace: {e}", file=sys.stderr)
        return 2

    try:
        if args.format == "chrome":
            # redirect into a .json file and load it in chrome://tracing
            # or ui.perfetto.dev; still one JSON document on stdout
            sys.stdout.write(
                json.dumps(chrome_trace(meta, spans), sort_keys=True) + "\n"
            )
            return 0

        summary = summarize(spans)
        if args.format == "json":
            out = {"meta": meta, "summary": summary}
            if args.dump:
                out["spans"] = spans
            sys.stdout.write(json.dumps(out, sort_keys=True) + "\n")
            return 0

        print(render_table(summary, meta))
        if args.dump:
            for s in spans:
                print(json.dumps(s, sort_keys=True))
    except BrokenPipeError:
        _quiet_broken_pipe()
    return 0


def build_health_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stmgcn_tpu_torch.cli health",
        description="Summarize a health.jsonl numeric-health log "
                    "(see README Numeric health & drift).",
    )
    p.add_argument("path", help="path to a --health-out JSONL file")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="text report or one JSON line on stdout")
    p.add_argument("--dump", action="store_true",
                   help="include raw records (json) / print them (text)")
    return p


def health_main(argv: Optional[List[str]] = None) -> int:
    args = build_health_parser().parse_args(argv)
    try:
        meta, records = load_health(args.path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"health: cannot read log: {e}", file=sys.stderr)
        return 2

    summary = summarize_health(records)
    try:
        if args.format == "json":
            out = {"meta": meta, "summary": summary}
            if args.dump:
                out["records"] = records
            sys.stdout.write(json.dumps(out, sort_keys=True) + "\n")
            return 0

        print(render_health_table(summary, meta))
        if args.dump:
            for r in records:
                print(json.dumps(r, sort_keys=True))
    except BrokenPipeError:
        _quiet_broken_pipe()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
