"""Load exported traces and summarize them per phase.

Copy of ``stmgcn_tpu/obs/report.py``: it only reads files, so the
JAX package's traces are read here too (this package records no spans
yet).

A "phase" is a span name; the summary answers *where a millisecond
went*: per-phase count / total / mean and share of the traced wall
window (max span end − min span start). Self-time is what the per-phase
shares are computed from — a parent span's duration minus its children's
— so nested spans (superstep ⊃ upload ⊃ device) don't double-count and
the shares of leaf phases can meaningfully sum toward 100%.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

__all__ = ["chrome_trace", "load_trace", "summarize", "render_table"]


def load_trace(path: str) -> Tuple[Optional[dict], List[dict]]:
    """Parse a JSONL trace file → (meta-or-None, spans). Lines that are
    not valid JSON objects raise — the schema contract is strict."""
    meta: Optional[dict] = None
    spans: List[dict] = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{line_no}: expected JSON object")
            if rec.get("kind") == "meta":
                meta = rec
            else:
                spans.append(rec)
    return meta, spans


def summarize(spans: List[dict]) -> dict:
    """Aggregate spans per phase name.

    Returns ``{"wall_ms", "coverage": <self-time sum / wall>, "phases":
    [{name, count, total_ms, self_ms, mean_ms, pct_wall}, ...]}`` with
    phases sorted by self-time descending. ``pct_wall`` is self-time
    over the wall window, so a fully-instrumented single-thread trace
    sums to ~100 without nested double counting.
    """
    if not spans:
        return {"wall_ms": 0.0, "coverage": 0.0, "phases": []}

    child_ms: Dict[int, float] = {}
    for s in spans:
        parent = s.get("parent", 0)
        if parent:
            child_ms[parent] = child_ms.get(parent, 0.0) + s["dur_ms"]

    t_lo = min(s["ts"] for s in spans)
    t_hi = max(s["ts"] + s["dur_ms"] for s in spans)
    wall_ms = max(t_hi - t_lo, 1e-9)

    phases: Dict[str, dict] = {}
    for s in spans:
        self_ms = max(0.0, s["dur_ms"] - child_ms.get(s.get("id", 0), 0.0))
        p = phases.setdefault(
            s["name"], {"name": s["name"], "count": 0, "total_ms": 0.0,
                        "self_ms": 0.0}
        )
        p["count"] += 1
        p["total_ms"] += s["dur_ms"]
        p["self_ms"] += self_ms

    rows = sorted(phases.values(), key=lambda p: -p["self_ms"])
    for p in rows:
        p["total_ms"] = round(p["total_ms"], 3)
        p["self_ms"] = round(p["self_ms"], 3)
        p["mean_ms"] = round(p["total_ms"] / p["count"], 3)
        p["pct_wall"] = round(100.0 * p["self_ms"] / wall_ms, 1)

    coverage = round(sum(p["self_ms"] for p in rows) / wall_ms, 4)
    return {"wall_ms": round(wall_ms, 3), "coverage": coverage,
            "phases": rows}


def chrome_trace(meta: Optional[dict], spans: List[dict]) -> dict:
    """Convert a span list to the Chrome trace-event JSON format
    (chrome://tracing / Perfetto "load legacy trace").

    Spans become complete ("X") duration events with microsecond
    timestamps. The trace format nests same-track events by time
    containment, so tracks must hold non-overlapping roots: root spans
    (``parent == 0``) are assigned greedily to the first track whose
    previous root already ended, concurrent roots (overlapping time
    ranges — e.g. the checkpoint writer thread under a superstep) open
    new tracks, and children inherit their root's track so each nested
    family renders as one flame.
    """
    by_id = {s.get("id", 0): s for s in spans}

    def root_of(s: dict) -> int:
        seen = set()
        while s.get("parent", 0) and s["parent"] in by_id:
            if s.get("id") in seen:  # defensive: cyclic parent links
                break
            seen.add(s.get("id"))
            s = by_id[s["parent"]]
        return s.get("id", 0)

    roots = sorted(
        (s for s in spans if not (s.get("parent", 0) in by_id)),
        key=lambda s: s["ts"],
    )
    track_end: List[float] = []  # per-track latest root end time
    root_tid: Dict[int, int] = {}
    for r in roots:
        for tid, end in enumerate(track_end):
            if r["ts"] >= end:
                break
        else:
            tid = len(track_end)
            track_end.append(0.0)
        track_end[tid] = r["ts"] + r["dur_ms"]
        root_tid[r.get("id", 0)] = tid

    events = []
    for s in spans:
        ev = {
            "name": s["name"],
            "ph": "X",
            "pid": 0,
            "tid": root_tid.get(root_of(s), 0),
            "ts": round(s["ts"] * 1e3, 1),       # chrome wants microseconds
            "dur": round(s["dur_ms"] * 1e3, 1),
        }
        if s.get("attrs"):
            ev["args"] = s["attrs"]
        events.append(ev)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = {
            k: meta[k] for k in ("schema_version", "capacity", "dropped")
            if k in meta
        }
    return out


def render_table(summary: dict, meta: Optional[dict] = None) -> str:
    """Fixed-width per-phase table for terminals."""
    lines: List[str] = []
    if meta:
        lines.append(
            f"trace: {meta.get('spans', '?')} spans, "
            f"{meta.get('dropped', 0)} dropped "
            f"(ring capacity {meta.get('capacity', '?')}, "
            f"schema v{meta.get('schema_version', '?')})"
        )
    lines.append(
        f"wall window: {summary['wall_ms']:.1f} ms, "
        f"span coverage: {summary['coverage'] * 100:.1f}%"
    )
    header = (f"{'phase':<24} {'count':>7} {'total_ms':>12} "
              f"{'self_ms':>12} {'mean_ms':>10} {'%wall':>7}")
    lines.append(header)
    lines.append("-" * len(header))
    for p in summary["phases"]:
        lines.append(
            f"{p['name']:<24} {p['count']:>7} {p['total_ms']:>12.3f} "
            f"{p['self_ms']:>12.3f} {p['mean_ms']:>10.3f} "
            f"{p['pct_wall']:>7.1f}"
        )
    if not summary["phases"]:
        lines.append("(no spans)")
    return "\n".join(lines)
