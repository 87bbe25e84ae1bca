"""Device-resident ingest ring: the live-feed end of the closed loop.

Counterpart of ``stmgcn_tpu/data/ring.py``. :class:`SeriesRing` keeps the
freshest ``capacity`` timesteps of one city's normalized ``(T, N, C)``
series in one device buffer, allocated once. Each row lands with one
in-place write (``index_copy_`` at a slot index held in a device tensor),
fed from a pinned staging row, so ingest allocates nothing on the device
after construction (the JAX ring's donated, jitted
``dynamic_update_slice`` at a traced slot). The host keeps the
monotonic-timestamp bookkeeping a real feed needs, copied from the JAX
ring:

- **gaps** — a timestamp jump forward-fills the missing slots with the
  last observed row (counted per missing step), so logical row ``i`` is
  always timestamp ``origin_ts + i``;
- **out-of-order rows** — a late arrival within ``reorder_window`` steps
  overwrites its (still resident) slot; older than that it is a typed
  reject (:class:`StaleObservationError`);
- **duplicates** — re-delivery of a timestamp that already holds a real
  observation is dropped and counted;
- **nonfinite observations** — quarantined on the host (bounded list of
  ``(ts, reason)``) and counted; the slot forward-fills, so NaN never
  reaches the device buffer.

The buffer's physical order is the ring's: logical row ``i`` lives in slot
``(i + origin_slot) % capacity``. :meth:`SeriesRing.series` returns the
rows in logical order (the JAX ring's roll); a consumer that must not see
a new shape per row (the continual trainer's captured fine-tune) gathers
straight from :attr:`SeriesRing.buffer` with those slot indices, which is
exactly the roll followed by the gather.

Ingest-stage fault drills run through
:class:`~stmgcn_tpu_torch.resilience.IngestFaultPlan` via
:func:`ingest_stream`; an absent or empty plan is the production path.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.ops.layers import resolve_device

__all__ = ["SeriesRing", "StaleObservationError", "ingest_stream"]


class StaleObservationError(ValueError):
    """A row arrived too late to place: older than the ring's reorder
    window (or before the ring's first timestamp entirely). Typed so feed
    drivers can count and route rejects without matching messages."""


class SeriesRing:
    """Ring buffer holding the freshest ``capacity`` rows of one city's
    normalized ``(T, N, C)`` series on ``device`` (``None`` means the GPU).

    :meth:`series` returns rows in time order, row ``i`` being timestamp
    ``origin_ts + i``: bit for bit the slice ``full_series[-L:]`` a host
    feed would produce. All anomaly handling happens on the host before
    the device write, so the buffer only ever holds finite, time-ordered
    data.
    """

    def __init__(self, capacity: int, n_nodes: int, n_feats: int, *, reorder_window: int = 4,
                 start_ts: Optional[int] = None, city: int = 0, registry=None,
                 max_quarantine: int = 64, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 0 <= reorder_window < capacity:
            raise ValueError(f"reorder_window must be in [0, capacity), got {reorder_window} "
                             f"for capacity {capacity}")
        self.capacity = int(capacity)
        self.n_nodes = int(n_nodes)
        self.n_feats = int(n_feats)
        self.reorder_window = int(reorder_window)
        self.city = int(city)
        self.start_ts: Optional[int] = None if start_ts is None else int(start_ts)
        self.device = resolve_device(device)
        #: rows ever committed (real + forward-fills); the ts<->index map
        self.count = 0
        self.rows = 0
        self.gaps = 0
        self.out_of_order = 0
        self.duplicates = 0
        self.nonfinite = 0
        #: most recent quarantined observations, newest last
        self.quarantined: list[Tuple[int, str]] = []
        self.max_quarantine = int(max_quarantine)
        dev = self.device
        self._buf = torch.zeros((self.capacity, n_nodes, n_feats), dtype=torch.float32,
                                device=dev)
        # one write's operands on the device, fed from pinned staging (on
        # the CPU the staging is the operand itself)
        self._row = torch.zeros((n_nodes, n_feats), dtype=torch.float32, device=dev)
        self._slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        cuda = dev.type == "cuda"
        self._row_host = (torch.zeros(self._row.shape, dtype=torch.float32, pin_memory=True)
                          if cuda else self._row)
        self._slot_host = (torch.zeros((1,), dtype=torch.int64, pin_memory=True)
                           if cuda else self._slot)
        self._staged = None  # event after the last copy out of the staging rows
        self._last_row: Optional[np.ndarray] = None
        self._real: set[int] = set()
        reg = REGISTRY if registry is None else registry
        labels = {"city": str(self.city)}
        self._c_rows = reg.counter("ingest.rows", labels)
        self._c_gaps = reg.counter("ingest.gaps", labels)
        self._c_ooo = reg.counter("ingest.out_of_order", labels)
        self._c_dup = reg.counter("ingest.duplicates", labels)
        self._c_nonfinite = reg.counter("ingest.nonfinite", labels)
        self._g_occupancy = reg.gauge("ring.occupancy", labels)

    # -- construction from an existing series -----------------------------

    @classmethod
    def from_series(cls, series, *, start_ts: int = 0, capacity: Optional[int] = None,
                    **kwargs) -> "SeriesRing":
        """Pre-fill a ring from an existing ``(T, N, C)`` series. With
        ``capacity >= T`` (the default: exactly ``T``) :meth:`series`
        returns the input bit for bit; with less, only the freshest rows
        are resident, exactly as if every row had been ingested live."""
        arr = np.asarray(series, dtype=np.float32)
        if arr.ndim != 3:
            raise ValueError(f"series must be (T, N, C), got {arr.shape}")
        T, n, c = arr.shape
        cap = T if capacity is None else int(capacity)
        ring = cls(cap, n, c, start_ts=start_ts, **kwargs)
        keep = arr[-cap:]
        buf = np.zeros((cap, n, c), dtype=np.float32)
        buf[np.arange(T - keep.shape[0], T) % cap] = keep
        ring._buf.copy_(torch.from_numpy(buf))
        ring.count = T
        ring.rows = T
        ring._last_row = arr[-1].copy()
        last_ts = start_ts + T - 1
        ring._real = {t for t in range(last_ts - ring.reorder_window, last_ts + 1)
                      if t >= start_ts}
        ring._c_rows.inc(T)
        ring._g_occupancy.set(min(T, cap) / cap)
        return ring

    # -- properties ---------------------------------------------------------

    def __len__(self) -> int:
        """Logical length: resident rows (<= capacity)."""
        return min(self.count, self.capacity)

    @property
    def next_ts(self) -> Optional[int]:
        """Timestamp the next in-order row should carry."""
        return None if self.start_ts is None else self.start_ts + self.count

    @property
    def origin_ts(self) -> Optional[int]:
        """Timestamp of logical row 0 (the ring's logical origin)."""
        if self.start_ts is None:
            return None
        return self.start_ts + self.count - len(self)

    @property
    def origin_slot(self) -> int:
        """The buffer slot of logical row 0: row ``i`` lives in slot
        ``(i + origin_slot) % capacity``."""
        return (self.count - len(self)) % self.capacity

    @property
    def buffer(self) -> torch.Tensor:
        """The physical ``(capacity, N, C)`` buffer (one tensor for the
        ring's life; read it through slot indices, see :attr:`origin_slot`)."""
        return self._buf

    @property
    def nbytes(self) -> int:
        """Device-resident footprint of the ring buffer."""
        return self.capacity * self.n_nodes * self.n_feats * 4

    # -- ingest -------------------------------------------------------------

    def _write(self, slot: int, row: np.ndarray) -> None:
        """One in-place device write of ``row`` into ``slot``."""
        if self._staged is not None:  # the last write has left the staging rows
            self._staged.synchronize()
        self._row_host.numpy()[...] = row
        self._slot_host.numpy()[0] = slot
        if self._row_host is not self._row:
            self._row.copy_(self._row_host, non_blocking=True)
            self._slot.copy_(self._slot_host, non_blocking=True)
            self._staged = torch.cuda.Event()
            self._staged.record()
        self._buf.index_copy_(0, self._slot, self._row[None])

    def _commit(self, row: np.ndarray) -> None:
        # Device write first, host bookkeeping after: a SIGTERM between the
        # two leaves the new row outside the logical window (count not yet
        # advanced), so the visible state stays a valid, fully written
        # series — the mid-ingest preemption invariant.
        self._write(self.count % self.capacity, row)
        self.count += 1

    def ingest(self, ts: int, values) -> str:
        """Feed one observation row; returns what happened to it:
        ``"append"``, ``"gap-fill"`` (after forward-filling missing
        timestamps), ``"late"`` (a slot overwrite inside the reorder
        window), ``"duplicate"`` (dropped) or ``"nonfinite"``
        (quarantined, slot forward-filled). Rows older than the reorder
        window raise :class:`StaleObservationError`."""
        ts = int(ts)
        row = np.asarray(values, dtype=np.float32)
        if row.shape != (self.n_nodes, self.n_feats):
            raise ValueError(f"row must be ({self.n_nodes}, {self.n_feats}), got {row.shape}")
        if self.start_ts is None:
            self.start_ts = ts
        outcome = self._place(ts, row)
        self._g_occupancy.set(len(self) / self.capacity)
        return outcome

    def _place(self, ts: int, row: np.ndarray) -> str:
        nxt = self.start_ts + self.count
        if not bool(np.isfinite(row).all()):
            self.nonfinite += 1
            self._c_nonfinite.inc()
            self.quarantined.append((ts, "nonfinite"))
            del self.quarantined[: -self.max_quarantine]
            if ts < nxt:
                return "nonfinite"  # late and broken: nothing to place
            self._fill_to(ts + 1)  # forward-fill through the bad slot
            return "nonfinite"
        if ts >= nxt:
            missing = ts - nxt
            if missing:
                self._fill_to(ts)
                self.gaps += missing
                self._c_gaps.inc(missing)
            self._commit(row)
            self._last_row = row.copy()
            self._note_real(ts)
            self.rows += 1
            self._c_rows.inc()
            return "gap-fill" if missing else "append"
        # late arrival: staleness is decided first — beyond the reorder
        # window even a re-delivery is a typed reject (the _real set is
        # pruned to the window, so dedupe past it would be unreliable)
        if ts < self.start_ts or nxt - ts > self.reorder_window:
            raise StaleObservationError(
                f"row at ts={ts} is {nxt - ts} steps behind the ring head (reorder window "
                f"{self.reorder_window}) — too stale to place")
        if ts in self._real:
            self.duplicates += 1
            self._c_dup.inc()
            return "duplicate"
        self._write((ts - self.start_ts) % self.capacity, row)
        self._note_real(ts)
        self.out_of_order += 1
        self._c_ooo.inc()
        self.rows += 1
        self._c_rows.inc()
        return "late"

    def _fill_to(self, ts: int) -> None:
        """Forward-fill committed slots up to (excluding) ``ts``. Fills
        beyond one full capacity are skipped on the device (they would be
        overwritten before ever becoming visible) but still advance
        ``count``, so the ts<->index map stays exact."""
        missing = ts - (self.start_ts + self.count)
        skip = max(0, missing - self.capacity)
        self.count += skip
        fill = (self._last_row if self._last_row is not None
                else np.zeros((self.n_nodes, self.n_feats), np.float32))
        for _ in range(missing - skip):
            self._commit(fill)

    def _note_real(self, ts: int) -> None:
        self._real.add(ts)
        if len(self._real) > 4 * (self.reorder_window + 1):
            head = self.start_ts + self.count
            self._real = {t for t in self._real if t >= head - self.reorder_window - 1}

    # -- reading ------------------------------------------------------------

    def slots(self, local) -> np.ndarray:
        """The buffer slots of logical rows ``local`` (int array)."""
        return (np.asarray(local, np.int64) + self.origin_slot) % self.capacity

    def series(self, last: Optional[int] = None) -> torch.Tensor:
        """The resident series ``(L, N, C)`` in logical time order, a copy
        on the ring's device (``last=K`` trims to the freshest K rows). A
        roll of the buffer once it has wrapped; a slice before that."""
        L = len(self)
        if self.count <= self.capacity:
            view = self._buf[:L].clone()
        else:
            view = torch.roll(self._buf, -(self.count % self.capacity), dims=0)
        if last is not None:
            view = view[-min(int(last), L):]
        return view

    def index_of(self, ts: int) -> int:
        """Logical index of timestamp ``ts`` in :meth:`series`."""
        if self.start_ts is None:
            raise ValueError("ring is empty")
        i = int(ts) - self.origin_ts
        if not 0 <= i < len(self):
            raise StaleObservationError(
                f"ts={ts} is not resident (ring spans [{self.origin_ts}, "
                f"{self.origin_ts + len(self) - 1}])")
        return i

    def target_indices(self, spec, last: Optional[int] = None) -> np.ndarray:
        """Valid target indices into :meth:`series` — "train on the last K
        hours" as an index range (``last=K`` keeps only the freshest K
        targets); ``WindowSpec.target_indices`` over the resident length."""
        L = len(self)
        if L <= spec.burn_in + spec.horizon - 1:
            raise ValueError(f"ring holds {L} rows; need more than "
                             f"burn_in+horizon-1={spec.burn_in + spec.horizon - 1}")
        idx = spec.target_indices(L).astype(np.int32)
        if last is not None:
            idx = idx[-int(last):]
        return idx

    def window_at(self, spec, ts: int) -> np.ndarray:
        """Model input window ``(seq_len, N, C)`` for predicting timestamp
        ``ts``, gathered from the ring: the caller ships ``(city, ts)`` and
        the ring supplies the history."""
        t = self.index_of(ts)
        if t < spec.burn_in:
            raise StaleObservationError(f"ts={ts} has only {t} resident history rows; the "
                                        f"window needs {spec.burn_in}")
        rows = torch.as_tensor(self.slots(t + spec.offsets), device=self.device)
        return self._buf.index_select(0, rows).cpu().numpy()


def ingest_stream(ring: SeriesRing, rows: Iterable[Tuple[int, np.ndarray]],
                  fault_plan=None) -> dict:
    """Drive a feed of ``(ts, values)`` rows into ``ring``, optionally
    through an :class:`~stmgcn_tpu_torch.resilience.IngestFaultPlan` (absent
    or empty = production pass-through). Stale rows are counted, not
    raised. Returns ``{"fed", "accepted", "rejected"}``."""
    summary = {"fed": 0, "accepted": 0, "rejected": 0}
    for ts, values in rows:
        arrivals = [(ts, values)] if fault_plan is None else fault_plan.feed(ts, values)
        for ats, avalues in arrivals:
            summary["fed"] += 1
            try:
                ring.ingest(ats, avalues)
                summary["accepted"] += 1
            except StaleObservationError:
                summary["rejected"] += 1
    return summary
