"""Serving-side distribution drift: streaming moment sketches vs a
training-time baseline.

Copy of ``stmgcn_tpu/obs/drift.py``: a baseline either package writes
into checkpoint meta is read by both.

The retrain trigger for ROADMAP item 1: does live traffic still look
like the data the params were trained on? A :class:`MomentSketch` keeps
per-channel Welford moments (count/mean/M2 — inherently bounded, no
sample buffer) plus a fixed-bin histogram over *baseline-standardized*
values, so the PSI comparison needs no raw data retention. The baseline
is computed once at training time (:func:`baseline_from_samples`),
persisted inside checkpoint meta (``health_baseline``), and compared
live by a :class:`DriftMonitor` sitting at the serving normalize /
denormalize boundaries.

numpy + stdlib only: the engines observe on the host, after a dispatch's
readback.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "DRIFT_SCHEMA_VERSION",
    "DriftMonitor",
    "MomentSketch",
    "baseline_from_samples",
    "drift_metrics",
    "psi",
]

DRIFT_SCHEMA_VERSION = 1

#: pooled standardized histograms span [-Z_EDGE, Z_EDGE]; the two outer
#: bins are open-ended so mass never falls off the support
Z_EDGE = 4.0

_EPS = 1e-6


def _as_channels(values, n_channels: int) -> np.ndarray:
    """Coerce an observation batch to ``(rows, C)`` float64."""
    a = np.asarray(values, dtype=np.float64)
    if a.ndim == 0:
        a = a.reshape(1, 1)
    if a.shape[-1] != n_channels:
        a = a.reshape(-1, 1) if n_channels == 1 else a.reshape(-1, n_channels)
    else:
        a = a.reshape(-1, n_channels)
    return a


def _hist_edges(bins: int) -> np.ndarray:
    """Internal edges of the pooled standardized histogram: ``bins``
    buckets over [-Z_EDGE, Z_EDGE] with open outer buckets."""
    if bins == 1:
        return np.empty(0)  # single catch-all bucket
    return np.linspace(-Z_EDGE, Z_EDGE, bins - 1)


class MomentSketch:
    """Streaming per-channel moments + pooled standardized histogram.

    ``norm=(mean, std)`` fixes the standardization the histogram uses —
    the *baseline's* moments for a live sketch, so live and baseline
    histograms share bins and PSI is well-defined. Without ``norm`` the
    sketch tracks moments only (histogram counts stay zero).
    """

    __slots__ = ("n_channels", "bins", "n", "mean", "m2", "counts", "_norm")

    def __init__(self, n_channels: int, bins: int = 64,
                 norm: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        if bins < 1:
            raise ValueError(f"bins must be >= 1, got {bins}")
        self.n_channels = n_channels
        self.bins = bins
        self.n = 0
        self.mean = np.zeros(n_channels)
        self.m2 = np.zeros(n_channels)
        self.counts = np.zeros(bins, dtype=np.int64)
        self._norm = None
        if norm is not None:
            mu, sd = norm
            self._norm = (
                np.asarray(mu, dtype=np.float64).reshape(n_channels),
                np.maximum(np.asarray(sd, dtype=np.float64)
                           .reshape(n_channels), _EPS),
            )

    def update(self, values) -> int:
        """Merge a batch of observations; returns rows consumed."""
        a = _as_channels(values, self.n_channels)
        nb = a.shape[0]
        if nb == 0:
            return 0
        # batched Welford merge: exact, no per-row loop
        mean_b = a.mean(axis=0)
        m2_b = ((a - mean_b) ** 2).sum(axis=0)
        tot = self.n + nb
        delta = mean_b - self.mean
        self.mean = self.mean + delta * (nb / tot)
        self.m2 = self.m2 + m2_b + delta**2 * (self.n * nb / tot)
        self.n = tot
        if self._norm is not None:
            mu, sd = self._norm
            z = ((a - mu) / sd).reshape(-1)
            idx = np.searchsorted(_hist_edges(self.bins), z)
            self.counts += np.bincount(idx, minlength=self.bins)
        return nb

    def var(self) -> np.ndarray:
        if self.n < 2:
            return np.zeros(self.n_channels)
        return self.m2 / (self.n - 1)

    def std(self) -> np.ndarray:
        return np.sqrt(self.var())

    def probs(self) -> np.ndarray:
        total = self.counts.sum()
        if total == 0:
            return np.full(self.bins, 1.0 / self.bins)
        return self.counts / total

    def to_dict(self) -> dict:
        return {
            "n": int(self.n),
            "mean": [float(v) for v in self.mean],
            "std": [float(v) for v in self.std()],
            "hist": [float(v) for v in self.probs()],
        }


def baseline_from_samples(samples, bins: int = 64,
                          n_channels: Optional[int] = None) -> dict:
    """Exact (two-pass) per-phase baseline from training-time data.

    Returns the JSON-able ``{"n", "mean", "std", "hist"}`` blob stored
    per city/phase inside checkpoint meta's ``health_baseline``; the
    histogram is over the samples standardized by their *own* moments,
    the same bins a live sketch standardized by this baseline uses.
    """
    a = np.asarray(samples, dtype=np.float64)
    c = n_channels if n_channels is not None else (
        a.shape[-1] if a.ndim >= 2 else 1)
    a = _as_channels(a, c)
    if a.shape[0] == 0:
        raise ValueError("baseline needs at least one sample row")
    mean = a.mean(axis=0)
    std = np.maximum(a.std(axis=0, ddof=1) if a.shape[0] > 1
                     else np.zeros(c), _EPS)
    z = ((a - mean) / std).reshape(-1)
    idx = np.searchsorted(_hist_edges(bins), z)
    counts = np.bincount(idx, minlength=bins).astype(np.float64)
    return {
        "n": int(a.shape[0]),
        "mean": [float(v) for v in mean],
        "std": [float(v) for v in std],
        "hist": [float(v) for v in counts / counts.sum()],
    }


def psi(expected, actual) -> float:
    """Population stability index between two probability vectors;
    epsilon-smoothed so empty bins don't blow up. Rule of thumb:
    < 0.1 stable, 0.1–0.25 moderate shift, > 0.25 major shift."""
    p = np.maximum(np.asarray(expected, dtype=np.float64), _EPS)
    q = np.maximum(np.asarray(actual, dtype=np.float64), _EPS)
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


def drift_metrics(baseline: dict, sketch: MomentSketch) -> dict:
    """Compare a live sketch against a per-phase baseline blob.

    ``z_max`` is the worst per-channel standardized mean shift
    ``(mu_live - mu_base) / (sigma_base / sqrt(n_live))`` — the classic
    large-sample z test for a drifted mean; ``psi`` compares the pooled
    standardized histograms.
    """
    if sketch.n == 0:
        return {"n": 0, "z_max": 0.0, "psi": 0.0}
    mu_b = np.asarray(baseline["mean"], dtype=np.float64)
    sd_b = np.maximum(np.asarray(baseline["std"], dtype=np.float64), _EPS)
    z = (sketch.mean - mu_b) / (sd_b / math.sqrt(sketch.n))
    return {
        "n": int(sketch.n),
        "z_max": float(np.max(np.abs(z))),
        "psi": psi(baseline["hist"], sketch.probs()),
    }


class DriftMonitor:
    """Generation-labeled live drift state for a serving engine.

    One monitor per engine; ``observe_*`` runs on the dispatch path so
    everything is lock-protected and numpy-cheap. ``reset(generation)``
    — called atomically with ``swap_params`` — drops every live sketch
    (and optionally swaps the baseline the new params were trained
    against), so gauges never mix traffic across param generations.
    """

    def __init__(self, baseline: dict, *, registry=None, generation: int = 0):
        self._lock = threading.Lock()
        self._registry = registry
        self.generation = generation
        self._baseline: Dict[str, Dict[str, dict]] = {}
        self._sketches: Dict[Tuple[str, str], MomentSketch] = {}
        with self._lock:  # same guard discipline as reset()
            self._set_baseline(baseline)

    def _set_baseline(self, baseline: dict) -> None:
        self.bins = int(baseline.get("bins", 64))
        self._baseline = {
            phase: {str(c): blob for c, blob in cities.items()}
            for phase, cities in (
                ("input", baseline.get("input", {})),
                ("prediction", baseline.get("prediction", {})),
            )
        }
        self._sketches = {}

    def _sketch_for(self, phase: str, city: str) -> Optional[MomentSketch]:
        blob = self._baseline.get(phase, {}).get(city)
        if blob is None:
            return None
        key = (phase, city)
        sk = self._sketches.get(key)
        if sk is None:
            sk = MomentSketch(
                len(blob["mean"]), bins=self.bins,
                norm=(np.asarray(blob["mean"]), np.asarray(blob["std"])),
            )
            self._sketches[key] = sk
        return sk

    def _observe(self, phase: str, city, values) -> None:
        city = str(city)
        with self._lock:
            sk = self._sketch_for(phase, city)
            if sk is None:
                return  # no baseline for this city/phase: nothing to compare
            sk.update(values)
            if self._registry is not None:
                m = drift_metrics(self._baseline[phase][city], sk)
                labels = {"city": city, "phase": phase,
                          "generation": str(self.generation)}
                self._registry.gauge("serving.drift.z_max", labels).set(
                    m["z_max"])
                self._registry.gauge("serving.drift.psi", labels).set(
                    m["psi"])
                self._registry.gauge("serving.drift.n", labels).set(m["n"])

    def observe_input(self, city, values) -> None:
        """Normalized model inputs for one city (the normalize boundary)."""
        self._observe("input", city, values)

    def observe_prediction(self, city, values) -> None:
        """Denormalized predictions for one city (the denormalize
        boundary)."""
        self._observe("prediction", city, values)

    def reset(self, generation: int, baseline: Optional[dict] = None) -> None:
        """Drop live sketches for a new param generation (hot-swap)."""
        with self._lock:
            self.generation = generation
            if baseline is not None:
                self._set_baseline(baseline)
            else:
                self._sketches = {}
            if self._registry is not None:
                self._registry.gauge(
                    "serving.drift.generation").set(generation)

    def snapshot(self) -> dict:
        """JSON-able drift state: per city/phase metrics + generation."""
        with self._lock:
            cities: Dict[str, dict] = {}
            for (phase, city), sk in self._sketches.items():
                m = drift_metrics(self._baseline[phase][city], sk)
                cities.setdefault(city, {})[phase] = m
            return {
                "schema_version": DRIFT_SCHEMA_VERSION,
                "generation": self.generation,
                "cities": cities,
            }
