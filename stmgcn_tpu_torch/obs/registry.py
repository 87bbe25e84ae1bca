"""Process-wide metrics registry: counters, gauges, bounded reservoirs.

One registry per process (:data:`REGISTRY`), shared by every subsystem
that counts: :class:`~stmgcn_tpu_torch.serving.metrics.EngineStats`
totals and sheds, and hot-swap generations. The exporters answer "what
is this process doing right now" (:meth:`MetricsRegistry.to_json`) and
"scrape me" (:meth:`MetricsRegistry.to_prometheus`, text exposition
format).

Everything here is stdlib-only and cheap: counters/gauges are one
``float`` behind the registry lock, histograms are a fixed-capacity
sample ring (:class:`Reservoir`) so a year-long serving process holds
the same memory as a one-minute test.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "REGISTRY",
    "Reservoir",
    "registry",
]

#: default bounded-histogram capacity; within the documented budget the
#: ``obs-overhead`` rule enforces for preset configs
DEFAULT_RESERVOIR = 1024


class Counter:
    """Monotonic (within a reset) numeric counter."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-write-wins numeric gauge."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


class Reservoir:
    """Bounded sample ring for percentile estimation.

    Keeps the most recent ``capacity`` samples (deterministic — no
    random eviction, so short runs and tests see *exactly* the samples
    they recorded) plus the all-time ``count``/``total``, so means over
    the full stream survive eviction. ``percentiles()`` matches the
    shape of the old ``serving.metrics.percentiles`` output.
    """

    __slots__ = ("name", "labels", "capacity", "_ring", "_count", "_total",
                 "_lock")

    def __init__(self, name: str = "", capacity: int = DEFAULT_RESERVOIR,
                 labels: Tuple[Tuple[str, str], ...] = ()):
        if capacity < 1:
            raise ValueError(f"reservoir capacity must be >= 1, got {capacity}")
        self.name = name
        self.labels = labels
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._count = 0
        self._total = 0.0
        self._lock = threading.Lock()

    def add(self, v: float) -> None:
        with self._lock:
            self._ring.append(v)
            self._count += 1
            self._total += v

    def extend(self, vs) -> None:
        with self._lock:
            for v in vs:
                self._ring.append(v)
                self._count += 1
                self._total += v

    @property
    def count(self) -> int:
        """All-time samples recorded (>= len(samples()) once evicting)."""
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._total

    def samples(self) -> List[float]:
        with self._lock:
            return list(self._ring)

    def mean(self, default: float = 0.0) -> float:
        """Mean over the retained window (the wait-model estimator)."""
        with self._lock:
            if not self._ring:
                return default
            return sum(self._ring) / len(self._ring)

    def percentiles(self) -> dict:
        """p50/p95/p99/mean over the retained window (None when empty)."""
        samples = self.samples()
        if not samples:
            return {"p50": None, "p95": None, "p99": None, "mean": None}
        ordered = sorted(samples)

        def pct(q: float) -> float:
            # numpy's default linear interpolation, dependency-free
            pos = (len(ordered) - 1) * q
            lo = int(pos)
            hi = min(lo + 1, len(ordered) - 1)
            return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)

        return {
            "p50": round(pct(0.50), 3),
            "p95": round(pct(0.95), 3),
            "p99": round(pct(0.99), 3),
            "mean": round(sum(ordered) / len(ordered), 3),
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._count = 0
            self._total = 0.0


def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Thread-safe get-or-create metric store with JSON + Prometheus
    exporters. Metric identity is ``(name, sorted labels)`` — a second
    ``counter("x")`` call returns the same object, so call sites never
    hold registration state of their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}

    def _get_or_create(self, cls, name: str, labels: Optional[dict],
                       **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name=name, labels=key[1], **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[dict] = None,
                  capacity: int = DEFAULT_RESERVOIR) -> Reservoir:
        return self._get_or_create(Reservoir, name, labels, capacity=capacity)

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def to_json(self) -> dict:
        """``{name{labels}: value-or-percentiles}`` snapshot."""
        out: dict = {}
        for m in self.metrics():
            key = m.name
            if m.labels:
                rendered = ",".join(f"{k}={v}" for k, v in m.labels)
                key = f"{m.name}{{{rendered}}}"
            if isinstance(m, Reservoir):
                out[key] = {"count": m.count, **m.percentiles()}
            else:
                v = m.value
                out[key] = int(v) if float(v).is_integer() else v
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): one sample per line;
        reservoirs expose ``_count`` plus quantile-labeled samples."""
        lines: List[str] = []
        for m in self.metrics():
            name = m.name.replace(".", "_").replace("-", "_")
            base = dict(m.labels)
            if isinstance(m, Reservoir):
                pct = m.percentiles()
                lines.append(f"# TYPE {name} summary")
                lines.append(
                    f"{name}_count{_prom_labels(base)} {m.count}"
                )
                for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                    if pct[key] is not None:
                        lines.append(
                            f"{name}{_prom_labels({**base, 'quantile': q})} "
                            f"{pct[key]}"
                        )
            else:
                kind = "counter" if isinstance(m, Counter) else "gauge"
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name}{_prom_labels(base)} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Zero every metric (tests / per-leg bench accounting); metric
        objects stay registered so held references keep working."""
        for m in self.metrics():
            m.reset()

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


#: the ONE process-wide registry every subsystem records into
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY
