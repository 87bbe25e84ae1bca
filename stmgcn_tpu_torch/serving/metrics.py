"""Per-bucket serving telemetry: latency percentiles, queue/device split.

Every dispatch the engine makes — micro-batched or direct — lands here,
so a long-lived engine can answer the capacity-planning questions the
bucket ladder raises: which rungs actually fire, how much padding they
waste, and where a request's wall time goes (queue wait vs device time).
``snapshot()`` is what ``chip_smoke.py`` prints per rung.

- sample lists are bounded :class:`~stmgcn_tpu_torch.obs.registry.Reservoir`
  rings — percentiles come from the most recent ``reservoir`` samples
  per rung, so memory stays bounded in a long-lived engine;
- scalar totals (dispatches / requests / rows, shed reasons) are
  registered in the process-wide :data:`~stmgcn_tpu_torch.obs.registry
  .REGISTRY` under ``serving.*`` with an ``engine=<n>`` label, so soak
  records, the Prometheus exporter, and ``snapshot()`` all read the same
  counters instead of a private dict per engine.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List

import numpy as np

from stmgcn_tpu_torch.obs.registry import REGISTRY, Reservoir

__all__ = ["EngineStats", "percentiles"]

#: bounded-window sample capacity per rung (see config.ObsConfig.reservoir)
DEFAULT_RESERVOIR = 1024

_ENGINE_IDS = itertools.count()


def percentiles(samples: List[float]) -> dict:
    """p50/p95/p99/mean of a millisecond sample list (None when empty)."""
    if not samples:
        return {"p50": None, "p95": None, "p99": None, "mean": None}
    arr = np.asarray(samples, dtype=np.float64)
    return {
        "p50": round(float(np.percentile(arr, 50)), 3),
        "p95": round(float(np.percentile(arr, 95)), 3),
        "p99": round(float(np.percentile(arr, 99)), 3),
        "mean": round(float(arr.mean()), 3),
    }


class _BucketStats:
    __slots__ = ("dispatches", "requests", "rows", "queue_ms", "device_ms",
                 "latency_ms")

    def __init__(self, reservoir: int):
        self.dispatches = 0
        self.requests = 0
        self.rows = 0
        self.queue_ms = Reservoir(capacity=reservoir)   # one sample/request
        self.device_ms = Reservoir(capacity=reservoir)  # one sample/dispatch
        self.latency_ms = Reservoir(capacity=reservoir)  # queue + device

    def reset(self) -> None:
        self.dispatches = self.requests = self.rows = 0
        self.queue_ms.reset()
        self.device_ms.reset()
        self.latency_ms.reset()


class EngineStats:
    """Thread-safe accumulator; the micro-batch worker and any number of
    direct-path callers record concurrently. ``reservoir`` bounds the
    per-rung sample windows (memory is O(buckets x reservoir) forever)."""

    def __init__(self, reservoir: int = DEFAULT_RESERVOIR):
        self._lock = threading.Lock()
        self._reservoir = reservoir
        self._buckets: Dict[int, _BucketStats] = {}
        self._t_first = None  # wall window over all dispatches, for
        self._t_last = None   # end-to-end throughput
        # scalar totals live in the shared registry, one label-set per
        # engine instance; shed counters are created per reason on first
        # use and remembered here for snapshot()/reset()
        self._labels = {"engine": str(next(_ENGINE_IDS))}
        self._c_dispatches = REGISTRY.counter("serving.dispatches",
                                              self._labels)
        self._c_requests = REGISTRY.counter("serving.requests", self._labels)
        self._c_rows = REGISTRY.counter("serving.rows", self._labels)
        self._shed: Dict[str, object] = {}

    def record_dispatch(self, bucket: int, rows: int, queue_ms: List[float],
                        device_ms: float) -> None:
        """One program dispatch: ``rows`` real rows in a ``bucket``-sized
        batch, ``queue_ms`` holding each coalesced request's queue wait."""
        now = time.perf_counter()
        with self._lock:
            bs = self._buckets.get(bucket)
            if bs is None:
                bs = self._buckets[bucket] = _BucketStats(self._reservoir)
            bs.dispatches += 1
            bs.requests += len(queue_ms)
            bs.rows += rows
            bs.device_ms.add(device_ms)
            bs.queue_ms.extend(queue_ms)
            bs.latency_ms.extend(q + device_ms for q in queue_ms)
            start = now - device_ms / 1e3
            if self._t_first is None or start < self._t_first:
                self._t_first = start
            if self._t_last is None or now > self._t_last:
                self._t_last = now
        self._c_dispatches.inc()
        self._c_requests.inc(len(queue_ms))
        self._c_rows.inc(rows)

    def record_shed(self, reason: str) -> None:
        """One admission-control rejection (``"overloaded"`` at the queue
        bound, ``"deadline"`` at the wait estimate or in-queue expiry)."""
        with self._lock:
            c = self._shed.get(reason)
            if c is None:
                c = self._shed[reason] = REGISTRY.counter(
                    "serving.shed", {**self._labels, "reason": reason}
                )
        c.inc()

    def device_ms_estimate(self, bucket: int, default: float = 0.0) -> float:
        """Measured mean device time per dispatch for ``bucket`` — the
        admission controller's wait model. Falls back to the mean over
        every rung, then to ``default``, while the rung is still cold."""
        with self._lock:
            bs = self._buckets.get(bucket)
            if bs is not None:
                samples = bs.device_ms.samples()
                if samples:
                    return float(np.mean(samples))
            samples = [
                v for b in self._buckets.values()
                for v in b.device_ms.samples()
            ]
        return float(np.mean(samples)) if samples else default

    def shed_counts(self) -> Dict[str, int]:
        """Registry-backed shed totals by reason (the soak record source)."""
        with self._lock:
            return {reason: int(c.value) for reason, c in self._shed.items()}

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._t_first = self._t_last = None
            for c in self._shed.values():
                c.reset()
            self._shed.clear()
        self._c_dispatches.reset()
        self._c_requests.reset()
        self._c_rows.reset()

    def snapshot(self) -> dict:
        """A JSON-ready view: per-bucket percentiles + engine totals.

        Totals are read from the shared registry counters; per-bucket
        sample stats come from the bounded reservoirs, i.e. the most
        recent ``reservoir`` samples per rung.
        """
        with self._lock:
            buckets = {
                b: (bs.dispatches, bs.requests, bs.rows,
                    bs.queue_ms.samples(), bs.device_ms.samples(),
                    bs.latency_ms.samples())
                for b, bs in self._buckets.items()
            }
            window = (
                self._t_last - self._t_first
                if self._t_first is not None and self._t_last > self._t_first
                else None
            )
            shed = {reason: int(c.value) for reason, c in self._shed.items()}
        out: dict = {"buckets": {}, "totals": {}}
        tot_capacity = 0
        all_queue: List[float] = []
        all_device: List[float] = []
        for b in sorted(buckets):
            dispatches, requests, rows, queue_ms, device_ms, latency_ms = buckets[b]
            capacity = dispatches * b
            out["buckets"][str(b)] = {
                "dispatches": dispatches,
                "requests": requests,
                "rows": rows,
                "pad_waste": round(1.0 - rows / capacity, 4) if capacity else 0.0,
                "latency_ms": percentiles(latency_ms),
                "queue_wait_ms": percentiles(queue_ms),
                "device_ms": percentiles(device_ms),
            }
            tot_capacity += capacity
            all_queue.extend(queue_ms)
            all_device.extend(device_ms)
        tot_rows = int(self._c_rows.value)
        out["totals"] = {
            "dispatches": int(self._c_dispatches.value),
            "requests": int(self._c_requests.value),
            "rows": tot_rows,
            "pad_waste": round(1.0 - tot_rows / tot_capacity, 4)
            if tot_capacity else 0.0,
            "queue_wait_ms_mean": percentiles(all_queue)["mean"],
            "device_ms_mean": percentiles(all_device)["mean"],
            "rows_per_sec": round(tot_rows / window, 1) if window else None,
            "shed": shed,
        }
        return out
