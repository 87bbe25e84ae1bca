"""Nested wall-clock span tracing into a bounded ring buffer.

The port's counterpart of ``stmgcn_tpu/obs/trace.py``, with its JSONL
schema, so the port's ``obs`` report (:mod:`stmgcn_tpu_torch.obs.report`)
and the JAX package's read one file either package wrote.

Spans are host-side timers — ``with span("train.epoch", epoch=e):`` —
nested through a per-thread stack, recorded into a thread-safe ring (the
oldest evicted and counted in :attr:`Tracer.dropped`, never unbounded
growth) and exported as schema-versioned JSONL. A CUDA launch returns
once it is enqueued, so a span over device work closes through
:meth:`Span.fence`, which synchronizes an event recorded on the stream of
the tensors it is given: the device-completion edge.

The tracer is process-global and off by default, and the disabled path
costs nothing: hot loops read :func:`active_tracer` once, outside the
loop, and skip every call when it is ``None``, timing with locals and
reporting through :meth:`Tracer.record_span` after the fact (no span
object, no kwargs dict). Nothing is traced inside a captured program, so
tracing never changes a program's ops.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "SCHEMA_VERSION",
    "Span",
    "Tracer",
    "active_tracer",
    "configure",
    "enabled",
    "fence",
    "span",
]

#: the JSONL span record's version (the JAX package's ``SCHEMA_VERSION``)
SCHEMA_VERSION = 1

#: default ring capacity, within ``OBS_RING_BUDGET``
DEFAULT_RING = 4096


def fence(tensors) -> None:
    """Block until the device work that produced ``tensors`` (a tensor or
    an iterable of them; other values are skipped) is done: an event
    recorded on each CUDA device's current stream, synchronized. CPU
    tensors are done when they exist."""
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


class Span:
    """One open span. Close it with :meth:`end` (host work) or
    :meth:`fence` (device work); only the first close records."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "depth", "t0", "_open")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[Dict[str, Any]],
                 span_id: int, parent: int, depth: int):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id = span_id
        self.parent = parent
        self.depth = depth
        self.t0 = time.perf_counter()
        self._open = True

    def end(self) -> None:
        if not self._open:
            return
        self._open = False
        self.tracer._close(self, time.perf_counter())

    def fence(self, tensors) -> None:
        """Wait for ``tensors``' device work (:func:`fence`), then close."""
        fence(tensors)
        self.end()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end()


class _NoopSpan:
    """The shared stand-in :func:`span` returns when tracing is off."""

    __slots__ = ()

    def end(self) -> None:
        pass

    def fence(self, tensors) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Bounded thread-safe span recorder: closed spans land in a ring of at
    most ``capacity`` records, the oldest evicted (and counted in
    :attr:`dropped`) when it is full; nesting (parent, depth) is tracked
    per thread."""

    def __init__(self, capacity: int = DEFAULT_RING):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 1
        self._t_origin = time.perf_counter()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new_id(self) -> int:
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        return span_id

    def span(self, name: str, **attrs: Any) -> Span:
        stack = self._stack()
        sp = Span(self, name, attrs or None, self._new_id(), stack[-1] if stack else 0,
                  len(stack))
        stack.append(sp.id)
        return sp

    def _close(self, sp: Span, t1: float) -> None:
        stack = self._stack()
        # unwind to this span: an unbalanced close (an exception path)
        # drops the abandoned children from the stack, not from the ring
        while stack and stack[-1] != sp.id:
            stack.pop()
        if stack:
            stack.pop()
        self._record(sp.name, sp.t0, t1, sp.id, sp.parent, sp.depth, sp.attrs)

    def record_span(self, name: str, t0: float, t1: float,
                    attrs: Optional[Dict[str, Any]] = None) -> None:
        """A span from two ``time.perf_counter`` readings, recorded after
        the fact at the calling thread's nesting level (the hot loops'
        form)."""
        stack = self._stack()
        self._record(name, t0, t1, self._new_id(), stack[-1] if stack else 0, len(stack),
                     attrs)

    def _record(self, name: str, t0: float, t1: float, span_id: int, parent: int,
                depth: int, attrs: Optional[Dict[str, Any]]) -> None:
        rec = {
            "schema_version": SCHEMA_VERSION,
            "id": span_id,
            "parent": parent,
            "depth": depth,
            "name": name,
            "ts": round((t0 - self._t_origin) * 1e3, 3),
            "dur_ms": round((t1 - t0) * 1e3, 3),
        }
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def export_jsonl(self, path: str) -> int:
        """Write the ring as JSONL, a ``meta`` header line then one object
        per span (the JAX schema); returns the spans written."""
        with self._lock:  # the header's dropped count matches its spans
            spans = list(self._ring)
            dropped = self.dropped
        meta = {"schema_version": SCHEMA_VERSION, "kind": "meta", "capacity": self.capacity,
                "dropped": dropped, "spans": len(spans)}
        with open(path, "w") as f:
            f.write(json.dumps(meta, sort_keys=True) + "\n")
            for rec in spans:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(spans)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


_TRACER: Optional[Tracer] = None


def configure(enable: bool = True, capacity: int = DEFAULT_RING) -> Optional[Tracer]:
    """Turn tracing on (a fresh :class:`Tracer`) or off (``None``)."""
    global _TRACER
    _TRACER = Tracer(capacity) if enable else None
    return _TRACER


def active_tracer() -> Optional[Tracer]:
    """The hot-loop gate: read it once outside the loop and guard every
    trace call with ``is not None``."""
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, **attrs: Any):
    """A span when tracing is on, the shared no-op otherwise (for paths
    that run once per epoch or request batch, not per step)."""
    trc = _TRACER
    if trc is None:
        return _NOOP_SPAN
    return trc.span(name, **attrs)
