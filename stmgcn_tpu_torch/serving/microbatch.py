"""Dynamic micro-batching: coalesce pending requests into one dispatch.

A single worker thread owns the queue. The dispatch policy:

- **saturation** — the worker dispatches immediately when the pending
  prefix can no longer grow: it fills the top ladder rung exactly, or
  the next queued request would overflow it. Under sustained load the
  queue refills while the worker is inside a dispatch, so consecutive
  dispatches run back-to-back at full rungs with *zero* added delay
  (continuous batching) — which is why deployments size the top rung to
  their peak concurrency.
- **deadline** — an unsaturated queue waits for more arrivals until the
  oldest pending request has aged ``max_delay_ms``, then dispatches the
  longest queue prefix that fits the top rung, padded up to the smallest
  covering rung. A lone caller therefore pays at most ``max_delay_ms``;
  latency-critical single callers use ``ServingEngine.predict_direct``,
  which bypasses the queue entirely.
- requests are never split and never reordered.

Failure contract (the part overload turns from nicety into necessity):

- an exception from a coalesced dispatch reaches **every** waiter of
  that batch as its own typed :class:`~stmgcn_tpu_torch.serving.admission
  .DispatchError` carrying the batch context, and the worker survives;
- a ``BaseException`` escaping a dispatch — or anything killing the
  worker loop itself — marks the batcher **wedged**: every queued
  waiter is released with :class:`~stmgcn_tpu_torch.serving.admission
  .BatcherWedged` and every later ``submit`` raises it immediately (the
  engine then degrades to its inline path). No caller ever blocks on a
  dead worker;
- ``submit`` after ``close()`` raises immediately;
- with an :class:`~stmgcn_tpu_torch.serving.admission.AdmissionController`
  attached, arrivals are admission-checked under the queue lock (typed
  ``Overloaded``/``DeadlineExceeded`` sheds) and admitted requests
  carry their deadline: ones that expire *before dispatch* are shed at
  the dispatch boundary instead of burning device time;
- a fault plan (``before_dispatch(ordinal)``) is consulted at
  dispatch entry (by 0-based dispatch ordinal) so all of the above is
  reproducible in tests; the empty plan is a production no-op.

Throughput discipline for one-core hosts: the submit side only wakes the
worker when it can act (first arrival starts the deadline clock,
saturation triggers a dispatch — intermediate arrivals just enqueue),
and results scatter back to callers as numpy *views* of the batched
output — zero-copy. A single request whose rows exactly fill a rung is
passed through to the dispatch without a pad copy at all.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from stmgcn_tpu_torch.serving.admission import (
    BatcherWedged,
    DeadlineExceeded,
    DispatchError,
)
from stmgcn_tpu_torch.serving.bucketing import smallest_covering_bucket
from stmgcn_tpu_torch.serving.metrics import EngineStats

__all__ = ["MicroBatcher"]


class _Request:
    __slots__ = ("rows", "n", "tag", "done", "result", "error", "t_enqueue",
                 "t_deadline", "info")

    def __init__(self, rows: np.ndarray, tag, deadline_s: Optional[float]):
        self.rows = rows
        self.n = rows.shape[0]
        self.tag = tag
        self.done = False
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        #: absolute expiry (perf_counter seconds); None = no deadline
        self.t_deadline = (
            None if deadline_s is None else self.t_enqueue + deadline_s
        )
        #: dispatch-scoped metadata the dispatch callable may attach
        #: (the engine stamps its param generation here)
        self.info = None


class MicroBatcher:
    """The request queue + worker behind :class:`ServingEngine.predict`.

    ``dispatch(payload, bucket, segments)`` runs the bucket's
    program over the coalesced ``(bucket, ...)`` payload and returns the
    prediction array (host-side numpy) — or a ``(array, info)`` pair,
    in which case ``info`` is stamped on every coalesced request of the
    dispatch (the engine returns its param generation this way, making
    the stamp atomic with the params the dispatch actually used).
    ``segments`` is a tuple of ``(offset, n_rows, tag)`` triples — one
    per coalesced request, in payload order — so the dispatch can apply
    per-request handling (the engine uses ``tag`` for pre-normalized
    inputs) while still running every expensive transform once per
    *batch*, not once per request.
    """

    def __init__(self, dispatch: Callable[[np.ndarray, int, tuple], np.ndarray],
                 buckets, max_delay_ms: float, stats: EngineStats,
                 admission=None, fault_plan=None):
        self._dispatch = dispatch
        self._buckets = tuple(sorted(buckets))
        self._cap = self._buckets[-1]
        self._max_delay_s = max_delay_ms / 1e3
        self._stats = stats
        self._admission = admission
        self._fault_plan = fault_plan
        self._dispatch_seq = 0  # ordinal for the fault plan
        # two condvars on ONE lock: submitters signal the worker on
        # _cond; the worker signals completions on _done (a per-request
        # Event would cost an allocation + an extra lock round-trip per
        # request — measurable at micro-batched request rates)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._done = threading.Condition(self._lock)
        self._pending: collections.deque = collections.deque()
        self._pending_rows = 0
        self._closed = False
        self._dead: Optional[BaseException] = None  # worker-death cause
        self._worker = threading.Thread(
            target=self._run, name="stmgcn-microbatch", daemon=True
        )
        self._worker.start()

    @property
    def wedged(self) -> bool:
        """Whether the worker thread has died (submits now fail fast)."""
        with self._lock:
            return self._dead is not None

    def submit(self, rows: np.ndarray, tag=None, *, with_info: bool = False):
        """Enqueue one request and block until its predictions are ready.

        Raises immediately (never blocks) when the batcher is closed or
        wedged, and with the typed shed error when admission rejects the
        arrival. ``with_info=True`` returns ``(result, info)`` with the
        dispatch's stamped metadata (None for array-only dispatches).
        """
        if rows.shape[0] > self._cap:
            raise ValueError(
                f"request of {rows.shape[0]} rows exceeds the largest bucket "
                f"{self._cap} — the engine splits oversized batches before "
                "submitting"
            )
        adm = self._admission
        req = _Request(rows, tag, adm.deadline_s if adm is not None else None)
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            if self._dead is not None:
                raise self._wedged_error()
            if adm is not None:
                adm.admit(req.n, self._pending_rows)  # raises the typed shed
            self._pending.append(req)
            self._pending_rows += req.n
            # wake the worker only when it can act: the first arrival
            # starts the deadline clock; saturation triggers a dispatch;
            # anything in between would be a wasted GIL hand-off
            if len(self._pending) == 1 or self._pending_rows >= self._cap:
                self._cond.notify_all()
            while not req.done:
                self._done.wait()
        if req.error is not None:
            raise req.error
        return (req.result, req.info) if with_info else req.result

    def close(self) -> None:
        """Stop accepting requests, drain the queue, join the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._worker.join()

    # -- worker side ----------------------------------------------------

    def _wedged_error(self) -> BatcherWedged:
        err = BatcherWedged(
            "micro-batch worker is dead — serve via predict_direct or "
            "rebuild the engine"
        )
        err.__cause__ = self._dead
        return err

    def _shed_expired(self) -> None:
        """Drop queue-front requests whose deadline already passed (FIFO +
        uniform deadlines keep expiry monotonic in queue order). Runs
        under the lock at the dispatch boundary: device time is never
        spent on rows nobody is waiting for."""
        now = time.perf_counter()
        shed = 0
        while (
            self._pending
            and self._pending[0].t_deadline is not None
            and now > self._pending[0].t_deadline
        ):
            req = self._pending.popleft()
            self._pending_rows -= req.n
            if self._admission is not None:
                self._admission.release_rows(req.n)
            req.error = DeadlineExceeded(
                f"request expired in queue after "
                f"{(now - req.t_enqueue) * 1e3:.1f} ms — shed at the "
                "dispatch boundary instead of served late"
            )
            req.done = True
            shed += 1
            self._stats.record_shed("deadline")
        if shed:
            self._done.notify_all()

    def _take_prefix(self) -> List[_Request]:
        batch: List[_Request] = []
        total = 0
        while self._pending and total + self._pending[0].n <= self._cap:
            req = self._pending.popleft()
            batch.append(req)
            total += req.n
        self._pending_rows -= total
        if self._admission is not None:
            self._admission.release_rows(total)
        return batch

    def _run(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:  # noqa: BLE001 — a dying worker must
            # never strand its waiters: release everyone, fail new submits
            with self._lock:
                self._dead = e
                while self._pending:
                    req = self._pending.popleft()
                    req.error = self._wedged_error()
                    req.done = True
                if self._admission is not None:
                    self._admission.release_rows(self._pending_rows)
                self._pending_rows = 0
                self._done.notify_all()

    def _run_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:
                    return  # closed and drained
                deadline = self._pending[0].t_enqueue + self._max_delay_s
                while not self._closed:
                    # saturated: the FIFO prefix cannot grow any further
                    # (>= cap means it either fills the top rung exactly
                    # or a queued request is too big to join) — waiting
                    # longer cannot improve this dispatch
                    if self._pending_rows >= self._cap:
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                self._shed_expired()
                batch = self._take_prefix()
            if batch:
                self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        total = sum(req.n for req in batch)
        t0 = time.perf_counter()
        bucket = None
        info = None
        try:
            bucket = smallest_covering_bucket(total, self._buckets)
            if self._fault_plan is not None:
                ordinal, self._dispatch_seq = (
                    self._dispatch_seq, self._dispatch_seq + 1
                )
                self._fault_plan.before_dispatch(ordinal)
            segments, ofs = [], 0
            if len(batch) == 1:
                # single request: hand the caller's array straight to the
                # dispatch (exact fit never copies; the dispatch pads)
                payload = batch[0].rows
                segments.append((0, total, batch[0].tag))
            else:
                payload = np.empty(
                    (bucket,) + batch[0].rows.shape[1:], dtype=np.float32
                )
                for req in batch:
                    payload[ofs:ofs + req.n] = req.rows
                    segments.append((ofs, req.n, req.tag))
                    ofs += req.n
                payload[total:] = 0.0
            out = self._dispatch(payload, bucket, tuple(segments))
            if isinstance(out, tuple):
                out, info = out
            t1 = time.perf_counter()
            ofs = 0
            for req in batch:
                req.result = out[ofs:ofs + req.n]  # view — zero-copy scatter
                req.info = info
                ofs += req.n
        except Exception as e:  # a dying dispatch releases every coalesced
            # caller — each gets its OWN typed error with the batch context
            t1 = time.perf_counter()
            for req in batch:
                err = DispatchError(
                    f"coalesced dispatch failed (bucket {bucket}, {total} "
                    f"rows, {len(batch)} requests): "
                    f"{type(e).__name__}: {e}",
                    bucket=bucket, rows=total, requests=len(batch),
                )
                err.__cause__ = e
                req.error = err
        except BaseException as e:  # worker-killing fault (BatcherKilled,
            # interpreter teardown): release THIS batch, then let _run's
            # protector wedge the batcher and release the queued rest
            for req in batch:
                err = BatcherWedged(
                    "micro-batch worker died mid-dispatch"
                )
                err.__cause__ = e
                req.error = err
            with self._lock:
                for req in batch:
                    req.done = True
                self._done.notify_all()
            raise
        finally:
            if all(not req.done for req in batch):
                with self._lock:
                    for req in batch:
                        req.done = True
                    self._done.notify_all()
        device_ms = (t1 - t0) * 1e3
        queue_ms = [(t0 - req.t_enqueue) * 1e3 for req in batch]
        self._stats.record_dispatch(bucket, total, queue_ms, device_ms)
