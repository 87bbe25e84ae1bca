"""Deterministic fault injection for the training loop.

Copy of ``stmgcn_tpu/resilience/faults.py``; its counters go to this
package's registry (:mod:`stmgcn_tpu_torch.obs.registry`).

A :class:`FaultPlan` is a set of :class:`FaultSpec` triggers the trainer
consults at fixed points of its hot loop — before each step (or fused
S-step block), when building each batch's loss mask, and when handing
serialized checkpoint bytes to the writer. The empty plan is the
default and every hook returns immediately, so production runs exercise
*exactly* the code paths the fault drills test; there is no
"instrumented build".

Step faults address batches by ``(epoch, step)`` where ``step`` is the
0-based ordinal of the batch **within its epoch, counting consumed
batches** (guard-skipped and dropped batches advance it, like the resume
cursor in checkpoint meta). This makes triggers reproducible across the
per-step and superstep paths and across a divergence-guard rollback
re-run: the re-run revisits the same ordinals, so a ``poison`` fault
re-fires on exactly the batch it poisoned before (``poison``/``drop``
are pure matches; ``raise``/``sigterm``/write faults fire once).

Write faults address checkpoint writes by filename glob + ordinal among
the matching writes, and corrupt the serialized bytes *before* they
reach the atomic writer — simulating disk-level truncation/bit rot of a
file that did land, the case ``os.replace`` atomicity cannot cover.

The serving side gets the same treatment (:class:`ServeFaultPlan` /
:class:`ServeFaultSpec`): faults address the micro-batcher's *dispatch
ordinal* (0-based count of coalesced dispatches) instead of training
steps, plus an at-rest checkpoint corruption hook the hot-swap watcher
consults and a promotion-gate hook the continual-learning gate consults
— so every shed/degrade/swap/promote path in the serving engine is
exercised deterministically, and the empty plan is again a production
no-op.

The closed continual loop adds the last two stages. Ingest faults
(:class:`IngestFaultPlan` / :class:`IngestFaultSpec`) are a
deterministic *stream transformer* addressed by source-row ordinal:
drop a row (gap), hold one back (out-of-order arrival), replay one
(duplicate), poison one with NaN, or deliver SIGTERM mid-ingest —
applied to the ``(timestamp, values)`` stream *before* it reaches the
ring, because that is where real feeds break. Daemon faults reuse
:class:`FaultPlan` with the retrain ordinal as the "epoch": raise /
hang / poison mid-fine-tune plus the write kinds against candidate
checkpoints, including ``torn-write`` — a crash *between* the tmp-file
write and the atomic rename, the one window ``os.replace`` atomicity
cannot cover from inside the process.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import signal
from typing import Optional, Tuple

from stmgcn_tpu_torch.obs.registry import REGISTRY

__all__ = [
    "BatcherKilled",
    "FEDERATION_KINDS",
    "FaultPlan",
    "FaultSpec",
    "FederationFaultPlan",
    "FederationFaultSpec",
    "INGEST_KINDS",
    "IngestFaultPlan",
    "IngestFaultSpec",
    "InjectedFault",
    "Preempted",
    "SERVE_KINDS",
    "ServeFaultPlan",
    "ServeFaultSpec",
    "WRITE_DRILL_EVERY",
    "WRITE_DRILL_RAISES",
    "raised_record",
    "write_drill_plan",
    "write_drill_problems",
]

_STEP_KINDS = ("raise", "sigterm", "hang", "poison", "drop")
_WRITE_KINDS = ("truncate-write", "corrupt-write", "torn-write")
KINDS = _STEP_KINDS + _WRITE_KINDS
SERVE_KINDS = (
    "dispatch-raise",
    "dispatch-slow",
    "dispatch-hang",
    "batcher-die",
    "corrupt-checkpoint",
    "promotion-raise",
)
INGEST_KINDS = ("gap", "out-of-order", "duplicate", "nonfinite", "sigterm")
FEDERATION_KINDS = (
    "replica-kill",
    "hang-on-drain",
    "herd-spike",
    "poisoned-candidate",
)


def _count_fault(kind: str) -> None:
    """Registry tally of faults that actually FIRED (never armed specs —
    the empty-plan hooks short-circuit before reaching this)."""
    REGISTRY.counter("faults.injected", {"kind": kind}).inc()


class InjectedFault(RuntimeError):
    """Raised by a ``kind="raise"`` fault — a stand-in for the step fn
    dying mid-epoch (driver crash, XLA error, host OOM)."""


class Preempted(BaseException):
    """SIGTERM was delivered and the emergency checkpoint has landed.

    Deliberately a ``BaseException`` (like ``KeyboardInterrupt``): broad
    ``except Exception`` retry/recovery code must not swallow a shutdown
    request — the process has been asked to die and should exit after
    unwinding. ``--resume auto`` continues the run bit-exactly.
    """


class BatcherKilled(BaseException):
    """Raised by a ``kind="batcher-die"`` serve fault at dispatch entry.

    Deliberately a ``BaseException``: the micro-batcher's dispatch error
    handling catches ``Exception`` (a dying *dispatch* releases its
    waiters and the worker lives on), so this escapes that handler and
    kills the worker thread itself — the wedged-batcher scenario the
    engine's degrade-to-direct fallback exists for.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic trigger in a :class:`FaultPlan`.

    Step kinds (addressed by ``epoch``/``step``):

    - ``"raise"``    — raise :class:`InjectedFault` before the step runs.
    - ``"sigterm"``  — deliver SIGTERM to this process before the step
      (``signal.raise_signal``): exercises the trainer's grace-window
      handler, emergency checkpoint, and :class:`Preempted` unwind.
    - ``"hang"``     — sleep ``hang_ms`` before the step (one-shot): the
      stalled-device / wedged-host stand-in for the continual daemon's
      supervision drills — a fine-tune that hangs must never block the
      serving path.
    - ``"poison"``   — inject ``payload`` (default NaN) into the batch's
      loss mask: the loss and every gradient go non-finite exactly as
      they would for NaN input data, tripping checkify/the divergence
      guard at that one step.
    - ``"drop"``     — consume the batch without stepping. The control
      for divergence drills: a guard-skip run must end bit-identical to
      a drop run that never saw the poisoned batch.

    Write kinds (addressed by ``path_glob``/``write_index``):

    - ``"truncate-write"`` — keep only the first ``keep_fraction`` of the
      serialized bytes.
    - ``"corrupt-write"``  — flip one bit of byte ``flip_byte``
      (-1 = middle of the file).
    - ``"torn-write"``     — crash between the tmp-file write and the
      atomic rename: the first ``keep_fraction`` of the bytes land in
      the ``*.tmp.<pid>`` file, :class:`InjectedFault` fires before
      ``os.replace``, and the destination file is never touched — the
      window ``os.replace`` atomicity cannot cover, left as a documented
      gap by the original write-fault harness.
    """

    kind: str
    epoch: Optional[int] = None  # step faults: epoch to fire in (None = any)
    step: Optional[int] = None  # step faults: batch ordinal in the epoch
    payload: float = float("nan")
    hang_ms: float = 0.0
    path_glob: str = "*.ckpt"
    write_index: int = 0
    keep_fraction: float = 0.5
    flip_byte: int = -1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind in ("poison", "drop") and self.step is None:
            raise ValueError(f"{self.kind!r} faults need an explicit step ordinal")
        if self.kind == "hang" and self.hang_ms <= 0:
            raise ValueError("hang faults need hang_ms > 0")
        if not 0.0 < self.keep_fraction < 1.0:
            raise ValueError(
                f"keep_fraction must be in (0, 1), got {self.keep_fraction}"
            )

    def _matches_step(self, epoch: int, start: int, stop: int) -> bool:
        if self.epoch is not None and self.epoch != epoch:
            return False
        step = self.step if self.step is not None else start
        return start <= step < stop


class FaultPlan:
    """A deterministic set of faults, consulted by the trainer's hot loop.

    The empty plan (``FaultPlan()``) is the production default: every
    hook short-circuits on ``self.specs`` being empty. One-shot state
    (which ``raise``/``sigterm``/write faults already fired, per-glob
    write counters) lives on the plan instance, so reusing a plan across
    trainers re-arms it only if you build a fresh plan.
    """

    def __init__(self, *specs: FaultSpec):
        if len(specs) == 1 and not isinstance(specs[0], FaultSpec):
            specs = tuple(specs[0])  # accept FaultPlan([spec, ...])
        for s in specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"FaultPlan takes FaultSpecs, got {type(s).__name__}")
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self._fired: set = set()
        self._write_counts: dict = {}

    @property
    def active(self) -> bool:
        return bool(self.specs)

    def before_step(self, epoch: int, start: int, stop: Optional[int] = None) -> None:
        """Fire any one-shot ``raise``/``sigterm``/``hang`` fault addressed
        to a batch ordinal in ``[start, stop)`` of ``epoch`` (a superstep
        block passes its full range: the fault lands at the block boundary,
        the same safe point the emergency checkpoint uses)."""
        if not self.specs:
            return
        stop = start + 1 if stop is None else stop
        for i, spec in enumerate(self.specs):
            if spec.kind not in ("raise", "sigterm", "hang"):
                continue
            key = ("step", i)
            if key in self._fired or not spec._matches_step(epoch, start, stop):
                continue
            self._fired.add(key)
            _count_fault(spec.kind)
            if spec.kind == "sigterm":
                signal.raise_signal(signal.SIGTERM)
            elif spec.kind == "hang":
                import time

                time.sleep(spec.hang_ms / 1e3)
            else:
                raise InjectedFault(
                    f"injected fault at epoch {epoch}, step {spec.step}"
                )

    def poison_value(self, epoch: int, step: int) -> Optional[float]:
        """The NaN/Inf payload to inject at this batch, or ``None``.

        A pure match (no one-shot state): a rollback re-run that revisits
        this ordinal must poison it again, or the re-run would train on a
        batch the original pass skipped.
        """
        for spec in self.specs:
            if spec.kind == "poison" and spec._matches_step(epoch, step, step + 1):
                _count_fault("poison")
                return spec.payload
        return None

    def should_drop(self, epoch: int, step: int) -> bool:
        """Whether this batch is consumed without an optimizer step."""
        hit = any(
            spec.kind == "drop" and spec._matches_step(epoch, step, step + 1)
            for spec in self.specs
        )
        if hit:
            _count_fault("drop")
        return hit

    def any_drop(self, epoch: int, start: int, stop: int) -> bool:
        """Whether any ordinal in ``[start, stop)`` carries a drop fault —
        a fused block containing one falls back to the per-step path."""
        return any(
            spec.kind == "drop" and spec._matches_step(epoch, start, stop)
            for spec in self.specs
        )

    def mutate_write(self, path: str, data: bytes) -> bytes:
        """Corrupt checkpoint bytes bound for ``path`` per any matching
        one-shot write fault (counted per spec over writes whose basename
        matches its glob). ``torn-write`` is NOT handled here — it is not
        a byte mutation but a crash inside the atomic writer, so it lives
        in :meth:`torn_write`, consulted by ``write_checkpoint_bytes``
        itself."""
        if not self.specs:
            return data
        name = os.path.basename(path)
        for i, spec in enumerate(self.specs):
            if spec.kind not in ("truncate-write", "corrupt-write"):
                continue
            if not fnmatch.fnmatch(name, spec.path_glob):
                continue
            key = ("write", i)
            count = self._write_counts.get(key, 0)
            self._write_counts[key] = count + 1
            if count != spec.write_index or key in self._fired:
                continue
            self._fired.add(key)
            _count_fault(spec.kind)
            if spec.kind == "truncate-write":
                data = data[: max(1, int(len(data) * spec.keep_fraction))]
            else:
                idx = spec.flip_byte if spec.flip_byte >= 0 else len(data) // 2
                mutated = bytearray(data)
                mutated[idx] ^= 0x01
                data = bytes(mutated)
        return data

    def torn_write(self, path: str, data: bytes, tmp: str) -> None:
        """Crash the atomic writer between tmp write and rename.

        Consulted by ``write_checkpoint_bytes`` *before* it writes the
        tmp file: a matching one-shot ``torn-write`` spec leaves the
        first ``keep_fraction`` of ``data`` in ``tmp`` and raises
        :class:`InjectedFault` — the destination ``path`` is never
        replaced, exactly what a crash between ``f.write`` and
        ``os.replace`` leaves behind (stale-but-intact destination plus
        a partial ``*.tmp.<pid>`` orphan). Write ordinals are counted
        per spec over writes whose basename matches its glob, same
        addressing as :meth:`mutate_write`.
        """
        if not self.specs:
            return
        name = os.path.basename(path)
        for i, spec in enumerate(self.specs):
            if spec.kind != "torn-write":
                continue
            if not fnmatch.fnmatch(name, spec.path_glob):
                continue
            key = ("torn", i)
            count = self._write_counts.get(key, 0)
            self._write_counts[key] = count + 1
            if count != spec.write_index or key in self._fired:
                continue
            self._fired.add(key)
            _count_fault("torn-write")
            with open(tmp, "wb") as f:
                f.write(data[: max(1, int(len(data) * spec.keep_fraction))])
            raise InjectedFault(
                f"injected torn write: crashed before renaming {tmp} "
                f"over {path}"
            )


# -- the drill of a failed checkpoint write on a mesh (the port's own) --------

#: the drill's ``latest`` cadence (``checkpoint_every_steps``): the lead's
#: first ``latest.ckpt`` write, which :func:`write_drill_plan` tears, lands
#: after this many steps
WRITE_DRILL_EVERY = 2
#: what every rank raises in the drill, by checkpoint mode: (type, its
#: cause's type); a synchronous write raises the writer's fault, an
#: asynchronous one the flush's wrapper of it
WRITE_DRILL_RAISES = {"sync": ("InjectedFault", None),
                      "async": ("RuntimeError", "InjectedFault")}


def write_drill_plan() -> FaultPlan:
    """The drill's plan: the lead's first ``latest.ckpt`` write torn
    (:class:`InjectedFault` in the writer)."""
    return FaultPlan(FaultSpec("torn-write", path_glob="latest.ckpt", write_index=0))


def raised_record(error: Optional[BaseException]) -> Optional[dict]:
    """What a rank raised in the drill, as :func:`write_drill_problems`
    reads it: its type, its cause's type and its message; None for none."""
    if error is None:
        return None
    cause = error.__cause__
    return {"type": type(error).__name__, "message": str(error),
            "cause": None if cause is None else type(cause).__name__}


def write_drill_problems(runs: list, mode: str) -> list:
    """What went wrong in the drill in ``mode`` ("sync" or "async") over the
    ranks of a mesh: ``runs[r]`` is rank r's ``{"raised": raised_record,
    "global_step": int}``. The lead must raise ``WRITE_DRILL_RAISES[mode]``
    (with synchronous writes at the first cadence write, global step
    WRITE_DRILL_EVERY), and every other rank the same type and cause at the
    lead's global step, under a message that names the lead. Empty: the
    drill passed."""
    want = WRITE_DRILL_RAISES[mode]
    lead_step = runs[0]["global_step"]
    problems = []
    if mode == "sync" and lead_step != WRITE_DRILL_EVERY:
        problems.append(f"the lead raised at global step {lead_step}, not at the first "
                        f"cadence write ({WRITE_DRILL_EVERY})")
    for r, got in enumerate(runs):
        raised = got["raised"]
        if raised is None:
            problems.append(f"rank {r} went on past the lead's failed write")
            continue
        if (raised["type"], raised["cause"]) != want:
            problems.append(f"rank {r} raised {raised['type']} (cause {raised['cause']}), "
                            f"not {want[0]} (cause {want[1]})")
        if got["global_step"] != lead_step:
            problems.append(f"rank {r} raised at global step {got['global_step']}, the lead "
                            f"at {lead_step}")
        if r and not raised["message"].startswith("the lead rank failed to write a checkpoint"):
            problems.append(f"rank {r}'s message does not name the lead: {raised['message']}")
    return problems


@dataclasses.dataclass(frozen=True)
class ServeFaultSpec:
    """One deterministic serving-side trigger in a :class:`ServeFaultPlan`.

    Dispatch kinds (addressed by ``dispatch``, the 0-based ordinal of
    coalesced micro-batch dispatches; ``None`` = every dispatch):

    - ``"dispatch-raise"`` — raise :class:`InjectedFault` at dispatch
      entry (one-shot): the XLA-error/driver-crash stand-in. The batcher
      must wrap it per waiter and the worker must survive.
    - ``"dispatch-slow"``  — sleep ``slow_ms`` before the dispatch (pure
      match): sustained device slowdown, the regime that backs the queue
      up and makes admission control shed.
    - ``"dispatch-hang"``  — sleep ``hang_ms`` before the dispatch (pure
      match): a long stall; queued requests' deadlines expire behind it
      and must be shed at dispatch time, not served late.
    - ``"batcher-die"``    — raise :class:`BatcherKilled` at dispatch
      entry (one-shot): kills the worker thread itself; pending and
      future submits must fail fast (``BatcherWedged``) and the engine
      must degrade to its inline path.

    Checkpoint kind (addressed by ``path_glob``):

    - ``"corrupt-checkpoint"`` — flip one bit of byte ``flip_byte`` of a
      matching checkpoint file *at rest* (one-shot per spec), before the
      hot-swap watcher reads it: the mid-watch bit-rot drill. The
      watcher must quarantine and keep serving the old params.

    Promotion kind (addressed by ``dispatch`` as the 0-based ordinal of
    promotion-gate evaluations):

    - ``"promotion-raise"`` — raise :class:`InjectedFault` at gate entry
      (one-shot): the gate's own evaluation dying mid-decision. The gate
      must quarantine the candidate with a typed ``gate-error`` reason
      and the engine must keep serving its current generation.
    """

    kind: str
    dispatch: Optional[int] = None
    slow_ms: float = 0.0
    hang_ms: float = 0.0
    path_glob: str = "latest.ckpt"
    flip_byte: int = -1

    def __post_init__(self):
        if self.kind not in SERVE_KINDS:
            raise ValueError(
                f"serve fault kind must be one of {SERVE_KINDS}, got "
                f"{self.kind!r}"
            )
        if self.kind == "dispatch-slow" and self.slow_ms <= 0:
            raise ValueError("dispatch-slow faults need slow_ms > 0")
        if self.kind == "dispatch-hang" and self.hang_ms <= 0:
            raise ValueError("dispatch-hang faults need hang_ms > 0")
        if (
            self.kind in ("dispatch-raise", "batcher-die", "promotion-raise")
            and self.dispatch is None
        ):
            raise ValueError(
                f"{self.kind!r} faults need an explicit dispatch ordinal"
            )

    def _matches_dispatch(self, ordinal: int) -> bool:
        return self.dispatch is None or self.dispatch == ordinal


class ServeFaultPlan:
    """Deterministic serving faults, consulted by the micro-batch worker
    at dispatch entry and by the hot-swap watcher before each poll.

    Same contract as :class:`FaultPlan`: the empty plan is the
    production default and every hook short-circuits immediately — the
    engine has no instrumented build. One-shot state lives on the plan
    instance.
    """

    def __init__(self, *specs: ServeFaultSpec):
        if len(specs) == 1 and not isinstance(specs[0], ServeFaultSpec):
            specs = tuple(specs[0])  # accept ServeFaultPlan([spec, ...])
        for s in specs:
            if not isinstance(s, ServeFaultSpec):
                raise TypeError(
                    f"ServeFaultPlan takes ServeFaultSpecs, got "
                    f"{type(s).__name__}"
                )
        self.specs: Tuple[ServeFaultSpec, ...] = tuple(specs)
        self._fired: set = set()

    @property
    def active(self) -> bool:
        return bool(self.specs)

    def before_dispatch(self, ordinal: int) -> None:
        """Fire any fault addressed to this dispatch ordinal. Sleeps for
        slow/hang kinds; raises for raise/die kinds (one-shot)."""
        if not self.specs:
            return
        import time

        for i, spec in enumerate(self.specs):
            if not spec._matches_dispatch(ordinal):
                continue
            if spec.kind == "dispatch-slow":
                _count_fault("dispatch-slow")
                time.sleep(spec.slow_ms / 1e3)
            elif spec.kind == "dispatch-hang":
                _count_fault("dispatch-hang")
                time.sleep(spec.hang_ms / 1e3)
            elif spec.kind in ("dispatch-raise", "batcher-die"):
                key = ("dispatch", i)
                if key in self._fired:
                    continue
                self._fired.add(key)
                _count_fault(spec.kind)
                if spec.kind == "batcher-die":
                    raise BatcherKilled(
                        f"injected batcher death at dispatch {ordinal}"
                    )
                raise InjectedFault(
                    f"injected dispatch fault at dispatch {ordinal}"
                )

    def before_promotion(self, ordinal: int) -> None:
        """Fire any one-shot ``promotion-raise`` fault addressed to this
        promotion-gate evaluation ordinal (the gate catches it and
        quarantines the candidate with a ``gate-error`` reason)."""
        if not self.specs:
            return
        for i, spec in enumerate(self.specs):
            if spec.kind != "promotion-raise":
                continue
            if not spec._matches_dispatch(ordinal):
                continue
            key = ("promotion", i)
            if key in self._fired:
                continue
            self._fired.add(key)
            _count_fault("promotion-raise")
            raise InjectedFault(
                f"injected promotion-gate fault at evaluation {ordinal}"
            )

    def corrupt_checkpoints(self, out_dir: str) -> list:
        """Flip bytes at rest in checkpoint files matching any one-shot
        ``corrupt-checkpoint`` spec; returns the corrupted paths. Called
        by the hot-swap watcher at poll start, BEFORE verification — the
        drill is bit rot landing between writer and reader."""
        if not self.specs:
            return []
        hit = []
        for i, spec in enumerate(self.specs):
            if spec.kind != "corrupt-checkpoint":
                continue
            key = ("ckpt", i)
            if key in self._fired:
                continue
            try:
                names = sorted(os.listdir(out_dir))
            except OSError:
                continue
            for name in names:
                if not fnmatch.fnmatch(name, spec.path_glob):
                    continue
                path = os.path.join(out_dir, name)
                try:
                    with open(path, "rb") as f:
                        data = bytearray(f.read())
                    if not data:
                        continue
                    idx = (
                        spec.flip_byte
                        if spec.flip_byte >= 0
                        else len(data) // 2
                    )
                    data[idx] ^= 0x01
                    with open(path, "wb") as f:
                        f.write(bytes(data))
                except OSError:
                    continue
                self._fired.add(key)
                _count_fault("corrupt-checkpoint")
                hit.append(path)
                break
        return hit


@dataclasses.dataclass(frozen=True)
class IngestFaultSpec:
    """One deterministic source-stream trigger in an
    :class:`IngestFaultPlan`, addressed by ``row`` — the 0-based ordinal
    of rows the *source* offers (faulted rows still advance it, so a
    plan reads like a script of the feed).

    - ``"gap"``          — the source never delivers this row: the ring
      sees a timestamp jump at the next arrival and must forward-fill.
    - ``"out-of-order"`` — hold this row back and deliver it after the
      next ``delay`` rows: a late arrival inside (or beyond) the ring's
      reorder window.
    - ``"duplicate"``    — deliver this row twice back to back: the
      at-least-once transport case the ring must dedupe.
    - ``"nonfinite"``    — overwrite the row's first cell with
      ``payload`` (default NaN): a sensor glitch the ring must
      quarantine instead of letting onto the device.
    - ``"sigterm"``      — deliver SIGTERM to this process before the
      row: the mid-ingest preemption drill (the ring must stay
      consistent — every committed row fully written, bookkeeping
      matching the device state).
    """

    kind: str
    row: int
    delay: int = 1
    payload: float = float("nan")

    def __post_init__(self):
        if self.kind not in INGEST_KINDS:
            raise ValueError(
                f"ingest fault kind must be one of {INGEST_KINDS}, got "
                f"{self.kind!r}"
            )
        if self.row < 0:
            raise ValueError(f"row ordinal must be >= 0, got {self.row}")
        if self.kind == "out-of-order" and self.delay < 1:
            raise ValueError("out-of-order faults need delay >= 1")


class IngestFaultPlan:
    """Deterministic ingest-stream transformer for the live-feed drills.

    Sits between the observation source and the continual loop's ingest ring: :meth:`feed` takes each source row and returns
    the rows that actually *arrive* (possibly none, possibly several,
    possibly mutated or reordered) — the empty plan passes every row
    through untouched, so production ingest runs exactly the drilled
    code path. One-shot state (held back rows, which specs fired) lives
    on the plan instance.
    """

    def __init__(self, *specs: IngestFaultSpec):
        if len(specs) == 1 and not isinstance(specs[0], IngestFaultSpec):
            specs = tuple(specs[0])  # accept IngestFaultPlan([spec, ...])
        for s in specs:
            if not isinstance(s, IngestFaultSpec):
                raise TypeError(
                    f"IngestFaultPlan takes IngestFaultSpecs, got "
                    f"{type(s).__name__}"
                )
        self.specs: Tuple[IngestFaultSpec, ...] = tuple(specs)
        self._seen = 0
        #: held back out-of-order rows: [rows_remaining, ts, values]
        self._held: list = []

    @property
    def active(self) -> bool:
        return bool(self.specs)

    def feed(self, ts, values) -> list:
        """Transform one source row into the rows that arrive now.

        Returns ``[(ts, values), ...]`` in arrival order. Held-back rows
        release *after* the current row once their delay has elapsed, so
        an ``out-of-order`` spec turns into a genuinely late arrival.
        """
        if not self.specs:
            return [(ts, values)]
        ordinal = self._seen
        self._seen += 1
        out = [(ts, values)]
        for spec in self.specs:
            if spec.row != ordinal:
                continue
            _count_fault(f"ingest-{spec.kind}")
            if spec.kind == "gap":
                out = []
            elif spec.kind == "duplicate":
                out = [(ts, values), (ts, values)]
            elif spec.kind == "nonfinite":
                import numpy as np

                poisoned = np.array(values, copy=True)
                poisoned.reshape(-1)[0] = spec.payload
                out = [(ts, poisoned)]
            elif spec.kind == "out-of-order":
                self._held.append([spec.delay, ts, values])
                out = []
            elif spec.kind == "sigterm":
                signal.raise_signal(signal.SIGTERM)
        released = []
        for h in self._held:
            h[0] -= 1
            if h[0] <= 0:
                released.append((h[1], h[2]))
        self._held = [h for h in self._held if h[0] > 0]
        return out + released


@dataclasses.dataclass(frozen=True)
class FederationFaultSpec:
    """One deterministic tier-level trigger in a
    :class:`FederationFaultPlan`, addressed by the federation router's
    *scatter ordinal* — the 0-based count of multi-city scatter/gather
    operations the router has run (every scatter advances it, so a plan
    reads like a script of tier traffic).

    - ``"replica-kill"`` — at scatter ordinal ``dispatch``, the router
      hard-kills replica ``replica`` mid-traffic (one-shot): the handle
      goes dead, its in-flight cities come back as typed per-city errors
      (never a hung caller), and the router must re-shard the dead
      replica's cities onto survivors.
    - ``"hang-on-drain"`` — the next drain of replica ``replica`` stalls
      ``hang_ms`` before its in-flight work flushes (one-shot): the
      bounded-handover drill — a drain must report a wedged replica
      within its timeout instead of blocking the tier forever.
    - ``"herd-spike"`` — at scatter ordinal ``dispatch``, the open-loop
      schedule injects ``burst`` extra back-to-back requests for
      ``city`` (one-shot): the thundering-herd drill — one city's
      replica saturates and must shed typed errors while the rest of
      the tier keeps its SLO.
    - ``"poisoned-candidate"`` — flip one bit of byte ``flip_byte`` of
      the next candidate checkpoint whose basename matches
      ``path_glob``, before the tier promotion gate evaluates it
      (one-shot): the tier-wide-rejection drill — the gate must
      quarantine the candidate exactly once, not once per replica.
    """

    kind: str
    replica: Optional[int] = None
    dispatch: Optional[int] = None
    hang_ms: float = 0.0
    city: Optional[int] = None
    burst: int = 0
    path_glob: str = "candidate-*.ckpt"
    flip_byte: int = -1

    def __post_init__(self):
        if self.kind not in FEDERATION_KINDS:
            raise ValueError(
                f"federation fault kind must be one of {FEDERATION_KINDS}, "
                f"got {self.kind!r}"
            )
        if self.kind == "replica-kill" and (
            self.replica is None or self.dispatch is None
        ):
            raise ValueError(
                "replica-kill faults need explicit replica and dispatch "
                "ordinals"
            )
        if self.kind == "hang-on-drain":
            if self.replica is None:
                raise ValueError("hang-on-drain faults need a replica")
            if self.hang_ms <= 0:
                raise ValueError("hang-on-drain faults need hang_ms > 0")
        if self.kind == "herd-spike" and (
            self.city is None or self.dispatch is None or self.burst < 1
        ):
            raise ValueError(
                "herd-spike faults need a city, a dispatch ordinal, and "
                "burst >= 1"
            )


class FederationFaultPlan:
    """Deterministic tier-level faults, consulted by the federation
    router at scatter entry and drain entry, and by the tier promotion
    gate before each evaluation.

    Same contract as :class:`FaultPlan`: the empty plan is the
    production default and every hook short-circuits immediately — the
    router has no instrumented build. One-shot state lives on the plan
    instance.
    """

    def __init__(self, *specs: FederationFaultSpec):
        if len(specs) == 1 and not isinstance(specs[0], FederationFaultSpec):
            specs = tuple(specs[0])  # accept FederationFaultPlan([spec, ...])
        for s in specs:
            if not isinstance(s, FederationFaultSpec):
                raise TypeError(
                    f"FederationFaultPlan takes FederationFaultSpecs, got "
                    f"{type(s).__name__}"
                )
        self.specs: Tuple[FederationFaultSpec, ...] = tuple(specs)
        self._fired: set = set()

    @property
    def active(self) -> bool:
        return bool(self.specs)

    def kill_at_scatter(self, ordinal: int) -> Optional[int]:
        """The replica id to hard-kill at this scatter ordinal, or None
        (one-shot). The router runs its own kill path on the returned
        id so the drill exercises exactly the production code."""
        if not self.specs:
            return None
        for i, spec in enumerate(self.specs):
            if spec.kind != "replica-kill" or spec.dispatch != ordinal:
                continue
            key = ("kill", i)
            if key in self._fired:
                continue
            self._fired.add(key)
            _count_fault("replica-kill")
            return spec.replica
        return None

    def on_drain(self, replica: int) -> None:
        """Stall a drain of ``replica`` per any one-shot hang-on-drain
        spec — the router's drain timeout must bound the stall."""
        if not self.specs:
            return
        for i, spec in enumerate(self.specs):
            if spec.kind != "hang-on-drain" or spec.replica != replica:
                continue
            key = ("drain", i)
            if key in self._fired:
                continue
            self._fired.add(key)
            _count_fault("hang-on-drain")
            import time

            time.sleep(spec.hang_ms / 1e3)

    def herd_burst(self, ordinal: int) -> list:
        """``[(city, burst), ...]`` spikes scheduled at this scatter
        ordinal (each one-shot) — the open-loop driver injects them as
        extra back-to-back arrivals for the city."""
        if not self.specs:
            return []
        out = []
        for i, spec in enumerate(self.specs):
            if spec.kind != "herd-spike" or spec.dispatch != ordinal:
                continue
            key = ("herd", i)
            if key in self._fired:
                continue
            self._fired.add(key)
            _count_fault("herd-spike")
            out.append((spec.city, spec.burst))
        return out

    def poison_candidate(self, path: str) -> bool:
        """Flip a byte of ``path`` at rest per any matching one-shot
        poisoned-candidate spec; True when the file was corrupted.
        Called by the tier promotion gate before evaluation."""
        if not self.specs:
            return False
        name = os.path.basename(path)
        for i, spec in enumerate(self.specs):
            if spec.kind != "poisoned-candidate":
                continue
            if not fnmatch.fnmatch(name, spec.path_glob):
                continue
            key = ("poison", i)
            if key in self._fired:
                continue
            try:
                with open(path, "rb") as f:
                    data = bytearray(f.read())
                if not data:
                    continue
                idx = spec.flip_byte if spec.flip_byte >= 0 else len(data) // 2
                data[idx] ^= 0x01
                with open(path, "wb") as f:
                    f.write(bytes(data))
            except OSError:
                continue
            self._fired.add(key)
            _count_fault("poisoned-candidate")
            return True
        return False
