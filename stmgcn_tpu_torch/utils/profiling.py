"""Tracing and throughput measurement.

Counterpart of ``stmgcn_tpu/utils/profiling.py``:

- :func:`fence` — wait until the device work behind a tree of tensors has
  finished: ``torch.cuda.synchronize`` on every CUDA device the tensors
  live on (CPU tensors are finished when they exist);
- :func:`time_chained` — steady-state seconds per step over N chained
  steps with one fence at the end, so launches pipeline as in a run;
- :class:`StepTimer` — per-step timing with a fence per step;
- :func:`trace` — a ``torch.profiler`` capture of a block (CUDA activity on
  a card) written as a Chrome trace into a directory
  (``chrome://tracing`` or Perfetto read it; the kernels are named in it);
- :func:`region_timesteps_per_sec` — demand points advanced per second.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = [
    "StepTimer",
    "fence",
    "region_timesteps_per_sec",
    "time_chained",
    "trace",
]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def fence(tree) -> None:
    """Block until ``tree``'s computation has finished: synchronize every
    CUDA device its tensors (in nested dicts, lists and tuples) live on.
    Raises when ``tree`` holds no non-empty tensor — a silent pass would
    turn a timing into a launch-only number."""
    tensors = [t for t in _tensors(tree) if t.numel() > 0]
    if not tensors:
        raise ValueError(
            "fence: no non-empty tensor to wait on — return (or pass) at least one "
            "computed tensor, or the time measured is the launches' alone"
        )
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def time_chained(step, iters: int, warmup: int = 3) -> float:
    """Mean seconds/step of ``step`` over ``iters`` chained calls.

    ``step()`` performs one iteration whose inputs depend on the previous
    one's outputs and returns something :func:`fence` can wait on. The
    fence comes once after the timed loop: the steady state of launches
    queued back to back.
    """
    out = None
    for _ in range(warmup):
        out = step()
    if out is not None:
        fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step()
    fence(out)
    return (time.perf_counter() - t0) / iters


class StepTimer:
    """Per-step wall time with a fence per step::

        timer = StepTimer(warmup=3)
        for batch in batches:
            result = timer.measure(step, batch)
        print(timer.summary())

    Each fence costs a synchronisation billed to its step; use
    :func:`time_chained` when steady-state throughput is the quantity of
    interest.
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._times: list = []
        self._seen = 0

    def measure(self, fn, *args, **kwargs):
        """Run ``fn``, fence its result, record the time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        fence(out)
        self.record(time.perf_counter() - t0)
        return out

    def record(self, seconds: float) -> None:
        """Record an externally measured (already fenced) step."""
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(seconds)

    @property
    def times(self) -> np.ndarray:
        return np.asarray(self._times)

    @property
    def mean(self) -> float:
        return float(self.times.mean()) if self._times else float("nan")

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = self.times
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "min_s": float(t.min()),
        }


def region_timesteps_per_sec(
    batch_size: int, seq_len: int, n_nodes: int, step_seconds: float
) -> float:
    """Demand points advanced per second."""
    return batch_size * seq_len * n_nodes / step_seconds


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the host's activity, and
    the card's kernels when CUDA is available) and write it as a Chrome
    trace, ``trace-<pid>.json``, into ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
