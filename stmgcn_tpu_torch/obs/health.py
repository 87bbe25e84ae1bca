"""Numeric training health: the ``health.jsonl`` stream and its report.

Copy of ``stmgcn_tpu/obs/health.py``: both packages write and read the
same stream.

The training side of the health/drift layer. The training programs'
health twins (:mod:`stmgcn_tpu_torch.train.step`, ``health=True``) compute
the statistics on the device beside the losses — global/per-group gradient
norms, update ratio, nonfinite grad/loss counts, per-city loss
attribution on the fleet path — and the trainer downloads them once per
health superstep and hands them here: :class:`HealthWriter` appends the
schema-versioned JSONL stream, :func:`publish_train_health` feeds the
process-wide metrics registry, and :func:`summarize_health` /
:func:`render_health_table` back the ``health`` report command (:mod:`.cli`).

Same file discipline as the trace JSONL: a ``kind: "meta"`` header line
first, then one JSON object per record, every line stamped with
``schema_version``.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

__all__ = [
    "HEALTH_SCHEMA_VERSION",
    "HealthWriter",
    "load_health",
    "publish_train_health",
    "render_health_table",
    "summarize_health",
]

HEALTH_SCHEMA_VERSION = 1


class HealthWriter:
    """Append-only ``health.jsonl`` writer (meta header + records).

    Opens lazily on the first record so a health-enabled run that dies
    before its first health superstep leaves no empty file behind.
    """

    def __init__(self, path: str, meta: Optional[dict] = None):
        self.path = path
        self._meta = dict(meta or {})
        self._f = None
        self.records = 0

    def _ensure_open(self) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
            header = {
                "schema_version": HEALTH_SCHEMA_VERSION,
                "kind": "meta",
                **self._meta,
            }
            self._f.write(json.dumps(header) + "\n")

    def write(self, record: dict) -> None:
        self._ensure_open()
        self._f.write(json.dumps(
            {"schema_version": HEALTH_SCHEMA_VERSION, **record}) + "\n")
        self.records += 1

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def publish_train_health(record: dict, registry) -> None:
    """Feed one training health record into the metrics registry.

    Gauges are last-write-wins running state; the nonfinite counts are
    cumulative counters — the signal CI gates on (any nonfinite during
    the smoke train fails the lint gate).
    """
    for key, name in (("loss", "train.health.loss"),
                      ("grad_norm", "train.health.grad_norm"),
                      ("update_ratio", "train.health.update_ratio")):
        if key in record:
            registry.gauge(name).set(record[key])
    for key, name in (("nonfinite_grads", "train.health.nonfinite_grads"),
                      ("nonfinite_loss", "train.health.nonfinite_loss")):
        if record.get(key):
            registry.counter(name).inc(record[key])
    for group, v in (record.get("group_norms") or {}).items():
        registry.gauge("train.health.group_norm",
                       {"group": group}).set(v)
    for city, v in (record.get("city_loss") or {}).items():
        registry.gauge("train.health.city_loss",
                       {"city": str(city)}).set(v)


def load_health(path: str) -> Tuple[Optional[dict], List[dict]]:
    """Parse ``health.jsonl`` → (meta-or-None, records); strict schema,
    same contract as :func:`stmgcn_tpu_torch.obs.report.load_trace`."""
    meta: Optional[dict] = None
    records: List[dict] = []
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
                records.append(rec)
    return meta, records


def _agg(values: List[float]) -> dict:
    finite = [v for v in values if isinstance(v, (int, float))
              and math.isfinite(v)]
    if not finite:
        return {"last": None, "mean": None, "max": None}
    return {
        "last": round(finite[-1], 6),
        "mean": round(sum(finite) / len(finite), 6),
        "max": round(max(finite), 6),
    }


def summarize_health(records: List[dict]) -> dict:
    """Aggregate a health stream per phase (``train`` / ``drift``).

    Training records roll up into per-metric last/mean/max plus total
    nonfinite counts and per-group/per-city state; drift records keep
    per-city worst-case z/PSI and name the overall worst city.
    """
    train = [r for r in records if r.get("kind") == "train"]
    drift = [r for r in records if r.get("kind") == "drift"]

    out: dict = {"records": len(records), "train": None, "drift": None}

    if train:
        groups: Dict[str, List[float]] = {}
        cities: Dict[str, List[float]] = {}
        for r in train:
            for g, v in (r.get("group_norms") or {}).items():
                groups.setdefault(g, []).append(v)
            for c, v in (r.get("city_loss") or {}).items():
                cities.setdefault(str(c), []).append(v)
        out["train"] = {
            "count": len(train),
            "last_step": train[-1].get("step"),
            "loss": _agg([r.get("loss") for r in train]),
            "grad_norm": _agg([r.get("grad_norm") for r in train]),
            "update_ratio": _agg([r.get("update_ratio") for r in train]),
            "nonfinite_grads": sum(r.get("nonfinite_grads", 0) for r in train),
            "nonfinite_loss": sum(r.get("nonfinite_loss", 0) for r in train),
            "groups": {g: _agg(vs) for g, vs in sorted(groups.items())},
            "city_loss": {c: _agg(vs) for c, vs in sorted(cities.items())},
        }

    if drift:
        per_city: Dict[Tuple[str, str], dict] = {}
        for r in drift:
            key = (str(r.get("city")), str(r.get("phase")))
            cur = per_city.get(key)
            if cur is None or r.get("z_max", 0.0) > cur.get("z_max", 0.0):
                per_city[key] = r
        worst = max(per_city.values(),
                    key=lambda r: abs(r.get("z_max", 0.0)))
        out["drift"] = {
            "count": len(drift),
            "worst": {
                "city": str(worst.get("city")),
                "phase": worst.get("phase"),
                "z_max": round(worst.get("z_max", 0.0), 4),
                "psi": round(worst.get("psi", 0.0), 6),
                "generation": worst.get("generation"),
            },
            "cities": {
                f"{c}/{p}": {
                    "z_max": round(r.get("z_max", 0.0), 4),
                    "psi": round(r.get("psi", 0.0), 6),
                    "n": r.get("n"),
                    "generation": r.get("generation"),
                }
                for (c, p), r in sorted(per_city.items())
            },
        }
    return out


def render_health_table(summary: dict, meta: Optional[dict] = None) -> str:
    """Fixed-width per-phase health report for terminals."""
    lines: List[str] = []
    if meta:
        lines.append(
            f"health: schema v{meta.get('schema_version', '?')}, "
            f"every_k={meta.get('every_k', '?')}"
        )
    t = summary.get("train")
    if t:
        lines.append(
            f"train: {t['count']} health supersteps, "
            f"last step {t['last_step']}, "
            f"nonfinite grads {t['nonfinite_grads']}, "
            f"nonfinite loss {t['nonfinite_loss']}"
        )
        header = f"{'metric':<28} {'last':>12} {'mean':>12} {'max':>12}"
        lines.append(header)
        lines.append("-" * len(header))

        def row(name: str, a: dict) -> str:
            def fmt(v):
                return f"{v:>12.6g}" if v is not None else f"{'-':>12}"
            return f"{name:<28} {fmt(a['last'])} {fmt(a['mean'])} {fmt(a['max'])}"

        lines.append(row("loss", t["loss"]))
        lines.append(row("grad_norm", t["grad_norm"]))
        lines.append(row("update_ratio", t["update_ratio"]))
        for g, a in t["groups"].items():
            lines.append(row(f"grad_norm[{g}]", a))
        for c, a in t["city_loss"].items():
            lines.append(row(f"city_loss[{c}]", a))
    d = summary.get("drift")
    if d:
        w = d["worst"]
        lines.append(
            f"drift: {d['count']} records; worst city {w['city']} "
            f"({w['phase']}): z_max={w['z_max']}, psi={w['psi']} "
            f"(generation {w['generation']})"
        )
        for key, m in d["cities"].items():
            lines.append(
                f"  {key:<20} z_max={m['z_max']:<10} psi={m['psi']:<10} "
                f"n={m['n']}"
            )
    if not t and not d:
        lines.append("(no health records)")
    return "\n".join(lines)
