"""SLO admission control: typed load shedding in front of the batcher.

Under overload an unbounded micro-batch queue converts excess arrival
rate into unbounded p99 — every request is eventually served, all of
them late. The operable behavior is the opposite: decide *at arrival*
whether a request can plausibly meet its deadline, and shed it with a
typed error if not, so admitted requests keep their latency and callers
get an actionable signal (retry elsewhere / back off) instead of a
timeout.

:class:`AdmissionController` fronts :class:`~stmgcn_tpu_torch.serving
.microbatch.MicroBatcher` with two tests, both O(1) under the queue
lock:

- **bounded queue** — more than ``queue_bound_rows`` pending rows
  rejects with :class:`Overloaded` (the queue-depth circuit breaker);
- **estimated wait** — pending dispatches ahead x the measured per-rung
  device time (:meth:`~stmgcn_tpu_torch.serving.metrics.EngineStats
  .device_ms_estimate`) already past ``deadline_ms`` rejects with
  :class:`DeadlineExceeded` — the request would miss its SLO even if
  everything goes right, so device time is not spent on it.

Admitted requests carry their deadline into the queue; the batcher sheds
any whose deadline expires *before dispatch* (same typed error), so a
stalled device never burns a dispatch on rows nobody is waiting for.

Both knobs live on :class:`~stmgcn_tpu_torch.config.ServingConfig`
(``deadline_ms`` / ``queue_bound_rows`` / ``shed_policy`` /
``degrade_rung``) and are validated by ``violations()``. The no-SLO
config (all defaults) builds no controller at all — the engine behaves
exactly as before this layer existed.

**Tier-wide budget** (the federation layer): per-replica bounds cannot
see each other, so M replicas each under their local bound can still
jointly hold M x ``queue_bound_rows`` rows — a tier-sized backlog no
single controller would admit. :class:`GlobalBudget` is one shared
pending-row account every replica's controller draws down at admission
and the replica's batcher pays back as rows leave its queue (dispatch,
expiry shed, or wedge-drain). Lock discipline: the budget has its own
lock, always acquired *inside* a batcher's queue lock and never the
reverse — queue-lock → budget-lock is the only order, so M batchers
sharing one budget cannot deadlock.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = [
    "AdmissionController",
    "BatcherWedged",
    "DeadlineExceeded",
    "DispatchError",
    "GlobalBudget",
    "Overloaded",
    "ShedError",
]


class ShedError(RuntimeError):
    """Base of the typed admission rejections — a request the engine
    chose not to serve (never a half-served one). Catch this to treat
    both shed kinds uniformly (e.g. retry against another replica)."""


class Overloaded(ShedError):
    """Rejected at arrival: the pending queue is over its row bound."""


class DeadlineExceeded(ShedError):
    """Rejected because the deadline cannot (estimated wait at arrival)
    or did not (expiry while queued) leave room to serve the request."""


class DispatchError(RuntimeError):
    """A coalesced dispatch died; every waiter of that batch receives its
    own instance carrying the batch context (``bucket``, ``rows``,
    ``requests``) with the device error as ``__cause__``."""

    def __init__(self, message: str, *, bucket: Optional[int] = None,
                 rows: Optional[int] = None, requests: Optional[int] = None):
        super().__init__(message)
        self.bucket = bucket
        self.rows = rows
        self.requests = requests


class BatcherWedged(RuntimeError):
    """The micro-batch worker thread is dead (injected fault, interpreter
    shutdown, or a BaseException escaping a dispatch). Queued and future
    ``submit`` calls fail fast with this instead of blocking forever; the
    engine degrades to the inline ``predict_direct`` path on seeing it."""


class GlobalBudget:
    """One tier-wide pending-row account shared by every replica's
    :class:`AdmissionController`.

    ``try_draw`` either reserves ``n`` rows atomically or refuses (the
    caller sheds ``Overloaded``); ``release`` pays rows back when they
    leave a replica's queue. All state lives behind the budget's own
    lock; callers hold at most one batcher queue lock while calling in,
    and the budget never calls out — the queue-lock → budget-lock order
    is acyclic by construction.
    """

    def __init__(self, total_rows: int):
        if total_rows < 1:
            raise ValueError(
                f"GlobalBudget needs total_rows >= 1, got {total_rows}"
            )
        self.total_rows = int(total_rows)
        self._lock = threading.Lock()
        self._outstanding = 0
        self._peak = 0
        self._refused = 0

    def try_draw(self, n: int) -> bool:
        """Reserve ``n`` rows of the tier budget; False = over budget."""
        with self._lock:
            if self._outstanding + n > self.total_rows:
                self._refused += 1
                return False
            self._outstanding += n
            if self._outstanding > self._peak:
                self._peak = self._outstanding
            return True

    def release(self, n: int) -> None:
        """Pay back ``n`` rows that left a replica's queue. Clamped at
        zero so a double-release (e.g. a wedge-drain racing an expiry
        shed) can never manufacture budget."""
        with self._lock:
            self._outstanding = max(0, self._outstanding - n)

    def snapshot(self) -> dict:
        """JSON-ready accounting view (the soak record source)."""
        with self._lock:
            return {
                "total_rows": self.total_rows,
                "outstanding": self._outstanding,
                "peak": self._peak,
                "refused": self._refused,
            }


class AdmissionController:
    """Arrival-time admission decisions for one micro-batch queue.

    Stateless beyond its config + a telemetry handle: the queue depth is
    passed in by the batcher (which owns the lock), and the per-dispatch
    device-time estimate comes from the live :class:`EngineStats` the
    same engine records into — the wait model tracks the actual host.
    With a :class:`GlobalBudget` attached, an arrival must clear the
    local checks *and* draw its rows from the tier account — and the
    batcher pays the account back through :meth:`release_rows` as rows
    leave its queue.
    """

    def __init__(self, config, stats, buckets, *, global_budget=None):
        self.deadline_ms: Optional[float] = config.deadline_ms
        self.queue_bound_rows: int = int(config.queue_bound_rows)
        self._stats = stats
        self._global: Optional[GlobalBudget] = global_budget
        self._top = max(buckets)
        #: conservative floor used until the first dispatch is measured:
        #: the coalescing delay itself (a dispatch can never be estimated
        #: faster than the wait the batcher deliberately adds)
        self._floor_ms = float(config.max_delay_ms)

    @property
    def deadline_s(self) -> Optional[float]:
        return None if self.deadline_ms is None else self.deadline_ms / 1e3

    def estimated_wait_ms(self, pending_rows: int) -> float:
        """Expected queue wait for an arrival behind ``pending_rows``:
        full dispatches ahead of it x the measured per-rung device time
        (top rung — saturated dispatches are what a backlog drains as).
        """
        dispatches_ahead = pending_rows // self._top
        per_dispatch = self._stats.device_ms_estimate(
            self._top, default=self._floor_ms
        )
        return dispatches_ahead * per_dispatch

    def admit(self, n_rows: int, pending_rows: int) -> None:
        """Raise the typed rejection for an arrival of ``n_rows`` behind
        ``pending_rows`` queued rows; return silently when admitted.
        Called by the batcher under its queue lock."""
        if (
            self.queue_bound_rows
            and pending_rows + n_rows > self.queue_bound_rows
        ):
            self._stats.record_shed("overloaded")
            raise Overloaded(
                f"queue holds {pending_rows} rows, bound is "
                f"{self.queue_bound_rows} — request of {n_rows} rows shed"
            )
        if self.deadline_ms is not None:
            est = self.estimated_wait_ms(pending_rows)
            if est > self.deadline_ms:
                self._stats.record_shed("deadline")
                raise DeadlineExceeded(
                    f"estimated queue wait {est:.1f} ms exceeds the "
                    f"{self.deadline_ms} ms deadline at arrival — shed "
                    "instead of serving late"
                )
        # tier budget last: a locally-shed request must never draw it down
        if self._global is not None and not self._global.try_draw(n_rows):
            self._stats.record_shed("tier-overloaded")
            raise Overloaded(
                f"tier-wide budget of {self._global.total_rows} pending "
                f"rows is exhausted — request of {n_rows} rows shed"
            )

    def release_rows(self, n_rows: int) -> None:
        """Pay ``n_rows`` back to the tier budget (no-op without one).
        The batcher calls this wherever admitted rows leave its queue:
        dispatch take, in-queue expiry, and the wedge drain."""
        if self._global is not None and n_rows:
            self._global.release(n_rows)
