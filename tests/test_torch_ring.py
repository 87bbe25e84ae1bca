"""The port's ingest ring (``stmgcn_tpu_torch/data/ring.py``) against the JAX
package's ``SeriesRing`` (mirroring ``tests/test_ring.py``).

Both rings take the same rows (numpy, from a seed) and must agree exactly:
every ingest outcome, every counter and the registry's counters and
occupancy gauge, and ``series()``, ``target_indices`` and ``window_at``
bitwise — over a messy feed (gaps, reordering inside the window,
duplicates, a nonfinite row), wraparound, a gap beyond the capacity, stale
rejects, the nonfinite quarantine, ``from_series`` pre-fills and the
mid-ingest SIGTERM invariant. The port's ring writes each row in place
into one buffer allocated at construction (its address never moves), and
the windows gathered through its slot map equal the JAX gather over the
rolled series.
"""

import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.data import SeriesRing as JaxRing
from stmgcn_tpu.data import WindowSpec as JaxWindowSpec
from stmgcn_tpu.data import ingest_stream as jax_ingest_stream
from stmgcn_tpu.obs.registry import MetricsRegistry as JaxRegistry
from stmgcn_tpu.resilience import IngestFaultPlan as JaxIngestPlan
from stmgcn_tpu.resilience import IngestFaultSpec as JaxIngestSpec
from stmgcn_tpu.train.step import gather_window_batch as jax_gather
from stmgcn_tpu_torch.data import SeriesRing, StaleObservationError, WindowSpec, ingest_stream
from stmgcn_tpu_torch.obs.registry import MetricsRegistry
from stmgcn_tpu_torch.resilience import IngestFaultPlan, IngestFaultSpec
from stmgcn_tpu_torch.train.continual import _gather, _window_slots

torch.set_num_threads(1)

COUNTERS = ("ingest.rows", "ingest.gaps", "ingest.out_of_order", "ingest.duplicates",
            "ingest.nonfinite")
SPEC = dict(serial_len=3, daily_len=1, weekly_len=0, day_timesteps=4, horizon=1)


def _series(T, N=4, C=2, seed=0):
    return np.random.default_rng(seed).normal(size=(T, N, C)).astype(np.float32)


class Twin:
    """A port ring and a JAX ring fed the same calls."""

    def __init__(self, *args, prefill=None, **kwargs):
        self.regs = (MetricsRegistry(), JaxRegistry())
        if prefill is None:
            self.ours = SeriesRing(*args, registry=self.regs[0], device="cpu", **kwargs)
            self.theirs = JaxRing(*args, registry=self.regs[1], **kwargs)
        else:
            self.ours = SeriesRing.from_series(prefill, registry=self.regs[0], device="cpu",
                                               **kwargs)
            self.theirs = JaxRing.from_series(prefill, registry=self.regs[1], **kwargs)

    def ingest(self, ts, row):
        outcomes = []
        for ring in (self.ours, self.theirs):
            try:
                outcomes.append(ring.ingest(ts, row))
            except (StaleObservationError, ValueError) as e:
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1], (ts, outcomes)
        return outcomes[0]

    def check(self, spec=None):
        a, b = self.ours, self.theirs
        for attr in ("count", "rows", "gaps", "out_of_order", "duplicates", "nonfinite",
                     "quarantined", "next_ts", "origin_ts"):
            assert getattr(a, attr) == getattr(b, attr), attr
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.series().numpy(), np.asarray(b.series()))
        for last in (1, 3):
            np.testing.assert_array_equal(a.series(last=last).numpy(),
                                          np.asarray(b.series(last=last)))
        labels = {"city": "0"}
        for name in COUNTERS:
            assert self.regs[0].counter(name, labels).value == \
                self.regs[1].counter(name, labels).value, name
        assert self.regs[0].gauge("ring.occupancy", labels).value == \
            self.regs[1].gauge("ring.occupancy", labels).value
        if spec is not None:
            ours, theirs = WindowSpec(**spec), JaxWindowSpec(**spec)
            targets = a.target_indices(ours)
            np.testing.assert_array_equal(targets, b.target_indices(theirs))
            np.testing.assert_array_equal(a.target_indices(ours, last=5),
                                          b.target_indices(theirs, last=5))
            for t in targets[-3:]:
                ts = a.origin_ts + int(t)
                np.testing.assert_array_equal(a.window_at(ours, ts), b.window_at(theirs, ts))


def test_wraparound_at_exact_capacity():
    full = _series(12)
    twin = Twin(12, 4, 2, start_ts=0)
    addr = twin.ours.buffer.data_ptr()
    for t in range(12):
        assert twin.ingest(t, full[t]) == "append"
    twin.check()
    np.testing.assert_array_equal(twin.ours.series().numpy(), full)
    extra = _series(1, seed=9)[0]
    twin.ingest(12, extra)  # wraps: slot 0 is overwritten, the view shifts by one
    twin.check()
    assert twin.ours.origin_ts == 1 and twin.ours.origin_slot == 1
    assert twin.ours.buffer.data_ptr() == addr  # every write in place


def test_from_series_parity_and_tail():
    full = _series(20)
    twin = Twin(prefill=full, start_ts=7)
    twin.check()
    small = Twin(prefill=full, start_ts=7, capacity=6)
    small.check()
    more = _series(3, seed=5)
    for i in range(3):
        small.ingest(27 + i, more[i])
    small.check()
    np.testing.assert_array_equal(small.ours.series().numpy(),
                                  np.concatenate([full, more])[-6:])


def test_messy_feed_matches_and_gathers():
    """Gaps, bounded reordering, duplicates and a nonfinite row land alike
    in both rings through a wrap, and the window gather through the port's
    slot map equals the JAX gather over its rolled series."""
    full = _series(60, seed=3)
    twin = Twin(24, 4, 2, start_ts=0, reorder_window=3)
    events, t = [], 0
    while t < 60:
        if t == 10:  # gap: skip two timestamps
            t += 2
        if t == 20:  # a swap inside the reorder window
            events += [(21, full[21]), (20, full[20])]
            t = 22
            continue
        if t == 30:  # duplicate delivery
            events += [(30, full[30]), (30, full[30])]
            t = 31
            continue
        if t == 40:  # nonfinite observation
            bad = full[40].copy()
            bad[0, 0] = np.inf
            events.append((40, bad))
            t = 41
            continue
        events.append((t, full[t]))
        t += 1
    outcomes = [twin.ingest(ts, row) for ts, row in events]
    assert {"append", "gap-fill", "late", "duplicate", "nonfinite"} <= set(outcomes)
    twin.check(SPEC)
    ring = twin.ours
    assert ring.gaps == 3 and ring.out_of_order == 1
    assert ring.duplicates == 1 and ring.nonfinite == 1
    spec, jspec = WindowSpec(**SPEC), JaxWindowSpec(**SPEC)
    targets = ring.target_indices(spec)
    x_slots, y_slots = (torch.as_tensor(a) for a in _window_slots(ring, spec, targets))
    x, y = _gather(ring.buffer, x_slots, y_slots, spec.horizon)
    jx, jy = jax_gather(twin.theirs.series(), jnp.asarray(targets),
                        jnp.asarray(jspec.offsets), jnp.arange(targets.shape[0]))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_gap_forward_fill_is_deterministic():
    full = _series(16, seed=4)
    twin = Twin(16, 4, 2, start_ts=0)
    for ts in (0, 1, 5, 6, 11):
        twin.ingest(ts, full[ts])
    twin.check()
    got = twin.ours.series().numpy()
    np.testing.assert_array_equal(got[2], full[1])
    np.testing.assert_array_equal(got[7], full[6])


def test_gap_larger_than_capacity():
    full = _series(4)
    twin = Twin(4, 4, 2, start_ts=0, reorder_window=2)
    twin.ingest(0, full[0])
    assert twin.ingest(100, full[1]) == "gap-fill"  # 99 missing rows, 4 slots resident
    twin.check()
    assert len(twin.ours) == 4 and twin.ours.next_ts == 101 and twin.ours.gaps == 99


def test_stale_rows_rejected_without_a_trace():
    full = _series(10)
    twin = Twin(8, 4, 2, start_ts=0, reorder_window=2)
    for t in range(8):
        twin.ingest(t, full[t])
    assert twin.ingest(3, full[3]) == "StaleObservationError"  # 5 behind, window 2
    assert twin.ingest(-1, full[0]) == "StaleObservationError"  # before the first ts
    assert twin.ingest(6, full[6]) == "duplicate"
    assert twin.ingest(0, full[0][:2]) == "ValueError"  # wrong row shape
    twin.check()
    np.testing.assert_array_equal(twin.ours.series().numpy(), full[:8])
    with pytest.raises(StaleObservationError):
        twin.ours.index_of(20)


def test_nonfinite_quarantined_and_counted():
    full = _series(6)
    twin = Twin(8, 4, 2, start_ts=0)
    twin.ingest(0, full[0])
    bad = full[1].copy()
    bad[1, 0] = np.nan
    assert twin.ingest(1, bad) == "nonfinite"
    twin.ingest(2, full[2])
    late_bad = full[1].copy()
    late_bad[0, 0] = np.nan
    assert twin.ingest(1, late_bad) == "nonfinite"  # late and broken: nothing placed
    twin.check()
    got = twin.ours.series().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], full[0])  # forward-filled
    assert twin.ours.quarantined == [(1, "nonfinite"), (1, "nonfinite")]


def test_ingest_stream_through_a_fault_plan():
    """The same IngestFaultPlan mix (late, duplicate, gap, nonfinite and a
    row held past the reorder window) fed to both rings."""
    full = _series(40, seed=6)
    twin = Twin(16, 4, 2, start_ts=0, reorder_window=2)

    def specs(mod):
        return [mod[1](kind="out-of-order", row=3, delay=2),
                mod[1](kind="duplicate", row=8), mod[1](kind="gap", row=12),
                mod[1](kind="nonfinite", row=17),
                mod[1](kind="out-of-order", row=22, delay=5)]

    rows = [(t, full[t]) for t in range(40)]
    ours = ingest_stream(twin.ours, rows, IngestFaultPlan(specs((None, IngestFaultSpec))))
    theirs = jax_ingest_stream(twin.theirs, rows, JaxIngestPlan(specs((None, JaxIngestSpec))))
    assert ours == theirs and ours["rejected"] == 1
    twin.check(SPEC)


def test_mid_ingest_sigterm_leaves_ring_consistent():
    """SIGTERM delivered mid-stream by the ingest fault plan leaves every
    committed row written and the bookkeeping matching the buffer; resuming
    the feed converges to the uninterrupted result."""

    class _Term(Exception):
        pass

    def _handler(signum, frame):
        raise _Term

    full = _series(12)
    ring = SeriesRing(8, 4, 2, start_ts=0, registry=MetricsRegistry(), device="cpu")
    plan = IngestFaultPlan([IngestFaultSpec(kind="sigterm", row=5)])
    rows = [(t, full[t]) for t in range(12)]
    old = signal.signal(signal.SIGTERM, _handler)
    try:
        with pytest.raises(_Term):
            ingest_stream(ring, rows, plan)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert ring.count == 5 and len(ring) == 5
    np.testing.assert_array_equal(ring.series().numpy(), full[:5])
    ingest_stream(ring, rows[5:], plan)
    np.testing.assert_array_equal(ring.series().numpy(), full[-8:])


def test_ring_validation_and_footprint():
    with pytest.raises(ValueError, match="capacity"):
        SeriesRing(0, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="reorder_window"):
        SeriesRing(4, 4, 2, reorder_window=4, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        SeriesRing(8, 4, 2, device="cpu").index_of(0)
    with pytest.raises(ValueError, match="need more than"):
        SeriesRing.from_series(_series(3), reorder_window=0,
                               device="cpu").target_indices(WindowSpec(**SPEC))
    ring = SeriesRing(8, 4, 2, device="cpu")
    assert ring.nbytes == JaxRing(8, 4, 2, registry=JaxRegistry()).nbytes == 8 * 4 * 2 * 4
