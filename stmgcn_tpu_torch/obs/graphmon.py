"""Capture telemetry: the port's counterpart of ``stmgcn_tpu/obs/jaxmon.py``.

The JAX package counts backend compiles; the port's counterpart of a
compile is a CUDA-graph capture (:mod:`stmgcn_tpu_torch.graphs`), so this
module counts captures and their milliseconds as they happen, with
jaxmon's warmup semantics: after the caller declares warmup complete
(:func:`mark_warmup_complete`, which the trainer does after its first
epoch, once every block and tail program of the loop has been captured),
any further capture is a recapture alarm, read from the
``graphs.recaptures_after_warmup`` gauge (refreshed by :func:`snapshot`)
until :func:`freeze_recaptures` pins it (the trainer does on entering
``test``).

A serving engine's ``swap_params`` captures the new generation's ladder
before publishing it. The JAX package compiles nothing for a swap, so
those captures are counted apart (``graphs.swap_captures``) and never read
as recaptures.

Uploads are counted where they are made: every program's one host->device
copy of its packed inputs calls :func:`record_upload`.

All counters live in :data:`~stmgcn_tpu_torch.obs.registry.REGISTRY`;
module scope is stdlib-only.
"""

from __future__ import annotations

from typing import Optional

from .registry import REGISTRY

__all__ = [
    "freeze_recaptures",
    "mark_warmup_complete",
    "record_capture",
    "record_upload",
    "snapshot",
]

#: recapture count pinned by :func:`freeze_recaptures`; None = live
_FROZEN: Optional[float] = None


def record_capture(ms: float, *, swap: bool = False) -> None:
    """Account one capture of ``ms`` milliseconds; ``swap`` for a capture
    made for a serving engine's new parameter generation."""
    REGISTRY.counter("graphs.swap_captures" if swap else "graphs.captures").inc()
    REGISTRY.counter("graphs.capture_ms").inc(ms)


def record_upload(nbytes: int, n: int = 1) -> None:
    """Account a host->device transfer of a program's inputs."""
    REGISTRY.counter("graphs.upload_bytes").inc(nbytes)
    REGISTRY.counter("graphs.uploads").inc(n)


def mark_warmup_complete() -> float:
    """Snapshot the capture count as the warmup baseline; every capture
    after this point shows in ``graphs.recaptures_after_warmup``. Returns
    the baseline. Re-marking re-baselines and unfreezes the gauge."""
    global _FROZEN
    _FROZEN = None
    baseline = REGISTRY.counter("graphs.captures").value
    REGISTRY.gauge("graphs.warmup_captures").set(baseline)
    REGISTRY.gauge("graphs.warmup_marked").set(1.0)
    REGISTRY.gauge("graphs.recaptures_after_warmup").set(0.0)
    return baseline


def freeze_recaptures() -> float:
    """Pin ``graphs.recaptures_after_warmup`` at its current value (the
    warmed loop has ended); returns it. A later
    :func:`mark_warmup_complete` unfreezes."""
    global _FROZEN
    _FROZEN = _refresh_recaptures()
    return _FROZEN


def _refresh_recaptures() -> float:
    if _FROZEN is not None:
        return _FROZEN
    recaptures = 0.0
    if REGISTRY.gauge("graphs.warmup_marked").value:
        baseline = REGISTRY.gauge("graphs.warmup_captures").value
        recaptures = max(0.0, REGISTRY.counter("graphs.captures").value - baseline)
    REGISTRY.gauge("graphs.recaptures_after_warmup").set(recaptures)
    return recaptures


def snapshot(steps: Optional[int] = None) -> dict:
    """Current telemetry as a plain dict; ``steps`` adds the per-step
    upload rate when the caller knows how many steps the counters cover."""
    recaptures = _refresh_recaptures()
    out = {
        "captures": int(REGISTRY.counter("graphs.captures").value),
        "swap_captures": int(REGISTRY.counter("graphs.swap_captures").value),
        "capture_ms": round(REGISTRY.counter("graphs.capture_ms").value, 3),
        "recaptures_after_warmup": int(recaptures),
        "upload_bytes": int(REGISTRY.counter("graphs.upload_bytes").value),
        "uploads": int(REGISTRY.counter("graphs.uploads").value),
    }
    if steps:
        out["upload_bytes_per_step"] = round(out["upload_bytes"] / steps, 1)
    return out
