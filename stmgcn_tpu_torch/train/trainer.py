"""The training loop: epochs over resident or streamed data, with
checkpoints.

Counterpart of ``stmgcn_tpu/train/trainer.py`` (``Trainer``), on one
device or as one rank of a mesh (**Meshes**, below). **Data placement**
(``data_placement``, ``window_free``, ``prefetch``;
``trainer.py:163-180``, ``:410-455``) decides where batches come from, as
the JAX trainer decides it:

- *window-free resident* (the default wherever it fits): the normalized
  ``(T, N, C)`` series, the per-mode int32 target vectors and the window's
  offset table are uploaded once; every batch is an index vector, gathered
  on the device (``gather_window_batch``);
- *materialized resident* (``window_free=False``): each mode's windowed
  ``(S, T, N, C)`` / ``(S, [H,] N, C)`` arrays are uploaded once, on first
  use (``_resident_arrays``), and each step takes its batch by
  ``index_select`` on axis 0 (the JAX ``jnp.take``); a pure copy, so every
  loss and parameter is bitwise the window-free route's;
- *streaming* (``data_placement="stream"``): batches carry host arrays and
  each is uploaded per step, ``prefetch`` batches ahead
  (:class:`~stmgcn_tpu_torch.graphs.Prefetcher`: a copy stream of its own,
  a ring of ``prefetch + 1`` pinned buffers), and lands in the one-step
  program's static ``x``/``y`` by a device-to-device copy in the replay's
  stream order; streamed training never takes blocks (the JAX
  ``_superstep_ready``), and a mid-epoch resume skips consumed batches
  without placing them;
- ``"auto"`` is resident when the bytes that would sit on the device
  (``resident_nbytes`` window-free, ``nbytes`` materialized) fit
  :meth:`Trainer._resident_cap_bytes`: half of what the card can still
  give this process, never below ``RESIDENT_CAP_BYTES`` (the CPU: that
  floor);
- batches come from ``DemandDataset.batches(..., pad_last=True,
  with_arrays=False)`` in the JAX order (``shuffle``/``seed``/``epoch``),
  and a ``(B,)`` sample mask drops the padded tail from the loss;
- ``steps_per_superstep=S`` runs S optimizer steps per block on resident
  data (``train_path`` ``"series_superstep"``, or ``"superstep"`` over
  materialized windows), the tail short of S one step at a time, each
  block one program over static buffers: one host->device copy of its
  ``(S, B)`` index block, ``(S, B)`` sample mask and ``(S, 2)`` optimizer
  scalars, one ``loss (S,)`` readback. On CUDA the programs are captured (``graphs``, default on for
  CUDA; :mod:`stmgcn_tpu_torch.graphs`): one CUDA graph per (city or
  fleet class, S) and per one-step tail, replayed for every later block,
  the counterpart of the JAX package's jitted superstep scans;
  ``graphs=False`` runs the same programs eagerly;
- epoch losses are sample-weighted; best-on-val uses ``<=``, with
  patience and early stop, as the reference does;
- ``test()`` reports denormalized ``regression_report``s per mode.

Checkpoints are the JAX package's files (``train/checkpoint.py``), so
either package resumes or serves the other's: ``best.ckpt`` on every
improvement (and ``top_k`` ``best_e{epoch}.ckpt`` snapshots), ``latest.ckpt``
every epoch and, with ``checkpoint_every_steps=K``, every K optimizer steps
at block boundaries, carrying the mid-epoch resume cursor and the partial
loss accumulators; ``latest`` rotates to ``latest.prev`` before each write.
With ``async_checkpoint`` the state is serialized to bytes on the training
thread and a background thread writes the file; ``flush_checkpoints()``
waits for it and re-raises its failure. ``restore()``/``restore_auto()``
walk the verified recovery chain and re-enter a mid-epoch checkpoint's
epoch, skipping the batches it had consumed.

``precision="bf16"`` trains float32 master parameters through the model at
a bf16 compute dtype (``train/step.py``), for the train and eval steps
alike; ``sr_seed`` stochastically rounds the master -> bf16 casts with
noise drawn from a ``torch.Generator`` seeded from ``(sr_seed,
global_step)``, so a resumed run draws what the uninterrupted one did.
Checkpoints hold the float32 masters at either precision, with the
precision (and ``sr_seed``) in the meta as provenance; a restore accepts
either.

Heterogeneous cities (``HeteroCityDataset``) and per-city graphs
(``CitySupports``) train per city: each city's batches gather from its own
resident series against its own supports. **Fleet shape classes**
(``fleet``, ``stmgcn_tpu/train/trainer.py:554-640``) group heterogeneous
cities by padded node count (``data/fleet.py``): each member's supports
are zero-padded to the class rung (a dense stack, or a tiled plan grown by
``pad_to`` and widened by ``with_block_cols`` to the class's block-column
width), the members' series are node-padded and concatenated along time
into one resident class series, and every step of a member takes its
rung-padded supports, gathers its batch by class-absolute targets,
feeds its real-node count to the gate and masks the loss with a ``(B,
N_c)`` mask (``train/step.py`` ``train_step(n_real=)``). With
``steps_per_superstep=S`` a member's consecutive batches run in blocks of
S (``train_path == "fleet_superstep"``); cities the planner leaves
unassigned, and every run's tail short of S, step one at a time at the
city's own shape, and ``fallback_reason`` says so. The fleet engages on
resident data only; over materialized windows its cities step one at a
time from their rung-padded arrays (the JAX parity oracle). ``test()`` reports per
city, denormalized with each city's normalizer, and checkpoints carry one
normalizer per city (``normalizers``).

A captured step reads and writes the same tensors on every replay: the
parameters, their ``.grad`` and Adam's moments are allocated once, and
:meth:`Trainer.restore` writes a checkpoint into them in place. Capture
telemetry follows the JAX trainer's jaxmon calls
(:mod:`stmgcn_tpu_torch.obs.graphmon`): warmup is marked complete after
the first epoch and the recapture gauge frozen on entering ``test``.
Stochastic rounding (``sr_seed``) draws from one generator reseeded from
``(sr_seed, step)`` before every step; under ``graphs`` its steps are
captured one at a time with the generator's state registered with each
graph (``CUDAGraph.register_generator_state``; a torch without it raises
at construction). Evaluation and ``test`` forwards run eagerly.

**Resilience** (``stmgcn_tpu/train/trainer.py:1615-1720``, ``:1743-2130``),
at the JAX trainer's points:

- a :class:`~stmgcn_tpu_torch.resilience.FaultPlan` (``fault_plan``; the
  empty plan is the default and every hook a no-op) fires its step faults
  per block or step (``before_step``); a block holding a ``drop`` runs
  step by step; a ``poison`` payload is written into the step's row of the
  block's static sample mask before the upload (no new program); the write
  faults reach every checkpoint write, the async writer's too;
- the **divergence guard** (``divergence_guard``, ``_action``,
  ``_patience``, ``_lr_cut``) copies the parameters and Adam's moments
  into snapshot buffers before each block, on the programs' stream, and on
  a non-finite loss copies them back in place (the captured graphs keep
  their addresses) and replays the block step by step, where the
  offending step is skipped or deferred to the epoch's end (deferred
  batches survive a mid-epoch resume, by ordinal, in meta ``deferred``).
  A rolled-back block advances neither ``optimizer.count`` nor
  ``global_step``, so the replay reads the scalars of the original counts.
  ``lr_cut`` multiplies the host-side scalars (``Optimizer.lr_scale``,
  meta ``lr_scale``); ``patience`` consecutive trips abort with
  ``DivergenceError``;
- **SIGTERM** (main thread only) sets a flag; at the next block boundary
  (or eval batch, or epoch bookkeeping) the trainer writes an emergency
  ``latest`` with the resume cursor, flushes the writer and raises
  ``Preempted``; the previous handler is restored on the way out.

**Health** (``health``, ``health_every_k``, ...; ``trainer.py:994-1120``):
every ``health_every_k``-th dispatch (a block, or a step) runs the health
twin of its program, captured lazily and keyed apart from the plain one,
whose one readback packs the losses and per-step stats (``train/step.py``
``health_row``; a fleet class's twin adds each step's loss scattered to its
member's column, ``city_loss``); the trainer writes ``health.jsonl``
(:class:`~stmgcn_tpu_torch.obs.health.HealthWriter`) and publishes to the
registry, and with ``health_baseline`` puts the training-time drift
baseline into checkpoint meta. A twin captured after the first epoch counts
as a recapture, as the JAX trainer's lazy health compile counts as a
recompile.

**Sanitizers** (``checks``, the JAX ``make_step_fns(checks=...)``): each
step of a program computes its flag word (``train/step.py``
:class:`~stmgcn_tpu_torch.train.step.Sanitizer`), read back with the
block's losses as one more column; the first set bit raises
:class:`~stmgcn_tpu_torch.train.step.CheckError` after the block, naming
the check, the epoch, the step and the site. Evaluation forwards take the
same checks, read back once per epoch. ``debug_nans`` (the CLI's
``--debug-nans``, the JAX ``jax_debug_nans``) is a debug mode: the
programs run eagerly (graphs off, logged), every module's output is held
finite by a hook that raises ``FloatingPointError`` naming the module, and
the epochs run under autograd's anomaly detection, which names the
backward op that made a NaN.

**Tracing** (:mod:`~stmgcn_tpu_torch.obs.trace`, the JAX trainer's spans,
``trainer.py:756-797``, ``:1799-1876``, ``:2136-2143``, ``:2417``):
``event.*`` marks, ``train.checkpoint``, per dispatch ``train.host_pack``,
``train.upload`` (the program's static-input copy) and ``train.superstep``
(to the readback, so past the device's work), ``train.epoch`` over
``train.train_epoch`` and ``train.eval_epoch``, and ``train.test``; the
tracer is read once per dispatch or epoch and nothing is recorded inside
a program, so tracing changes no program.

**Meshes** (``model.placement``, a
:class:`~stmgcn_tpu_torch.parallel.placement.MeshPlacement`; the JAX
trainer's mesh routing, ``trainer.py:411-455``): each rank of a ``dp x
region x branch`` job runs this trainer on its slice.

- *Data*: every rank draws the same global batch order from the seed and
  takes its contiguous ``dp`` rows; on the window-free resident route
  each holds the whole series and gathers its rows, and streamed (the
  mesh default under "auto", as in JAX) each uploads only its rows;
  materialized windows cannot be resident on a mesh (raises, as in JAX).
  Every rank holds the whole ``(B,)`` (or fleet ``(B, N_c)``) mask, so
  each step's loss is its rows' error sum over the global count
  (``train/step.py`` ``masked_loss``), and fleet classes take their rows
  over ``dp`` likewise.
- *Region*: on a ``region > 1`` mesh each rank also holds only its node
  rows: of the resident series, of each streamed batch, of every dense
  support stack (a row strip) or banded strip; the mask is the whole
  ``(B, N)`` sample-by-node one, its padded node rows (``node_pad``: a
  city's node axis rounded up to a multiple of ``region``, zero series
  rows) zero. A padded city of a heterogeneous set passes its real count
  as ``n_real`` to the gate. Fleet classes engage where the JAX trainer's
  do (window-free resident data, dense per-city stacks): the classes are
  planned over the padded node counts, so every rung is a multiple of
  ``region`` and a member's pad is ``rung - n_real``; each member's stack
  is grown to the rung before the rank keeps its row strip, the class
  series is cut to the rank's node rows, and every rank selects the same
  slot, real-node mask and gate divisor.
- *Steps*: the optimizer's ``GradSync`` sums the gradients over the ``dp x
  region`` group once a step (one float64 bucket, so the sum does not
  depend on its order) and gives the clip its global norm; the model's
  branch fusion all-reduces over ``branch``. The block
  programs run eagerly: a gloo collective cannot be captured, so
  ``graphs=None`` resolves to eager (logged) and ``graphs=True`` raises.
  Each dispatch's losses are summed over ``dp x region`` (all ranks read
  the same values), evaluation's loss sums once per epoch, and ``test()``
  all-gathers the predictions (node rows over ``region``, then batch rows
  over ``dp``): every rank's history, decisions (best, top-k, patience,
  early stop) and report equal the single-device ones.
- *Checkpoints*: the branch slices (parameters and moments) are gathered
  over ``branch`` into the mesh-free layout; only the lead (global rank 0)
  serializes and writes. Reads (``restore``, ``restore_auto``,
  ``test(checkpoint=...)``) happen on the lead, which broadcasts the file's
  length and bytes; an error travels in that payload and raises on every
  rank (the JAX ``trainer.py:2215-2249``, ``:2339-2393``).
- *SIGTERM*: each safe point sums the ranks' flags over the whole job
  (a 4-byte all-reduce), so a signal to any rank stops every rank at the
  same boundary, where all of them save (the lead writes) and raise
  ``Preempted``.
- *The opt-in features*: no rank decides alone. The divergence guard's
  non-finite flag is summed over every rank, so every rank rolls back (its
  own slice), cuts the rate and replays at the same steps; the
  sanitizers' flag words are or-ed over every rank (their bits summed),
  so every rank raises the same ``CheckError``; under ``debug_nans`` each
  module hook's flag is agreed the same way, and the backward's NaN check
  is one agreed check of the summed gradients (anomaly detection keeps its
  traces, not its per-rank raise). Health rows read the summed gradients,
  the branch slices' squares and counts summed over ``branch`` (the
  replicated head's counted once), the losses summed as the loss is;
  only the lead writes ``health.jsonl``. A fault plan's step faults fire
  on every rank at the same boundary (a ``poison`` payload in the whole
  mask every rank holds; ``sigterm`` takes the summed stop); its write
  faults reach the lead's writes only. ``sr_seed`` reseeds from ``(sr_seed,
  step)`` on every rank, and a branch rank draws each stacked leaf's noise
  at the whole stack's shape, rounding its slice as one device does.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import errno
import functools
import itertools
import os
import queue
import signal
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from stmgcn_tpu_torch.config import WINDOW_FREE_NEEDS_RESIDENT, check_placement, check_precision
from stmgcn_tpu_torch.data.splits import MODES
from stmgcn_tpu_torch.graphs import (
    CapturedProgram,
    DeviceOps,
    GraphPool,
    Prefetcher,
    Program,
    resolve_graphs,
)
from stmgcn_tpu_torch.models.params import (
    from_jax_params,
    health_groups,
    jax_layout,
    to_jax_params,
)
from stmgcn_tpu_torch.obs import graphmon
from stmgcn_tpu_torch.obs import trace as obs_trace
from stmgcn_tpu_torch.obs.health import HealthWriter, publish_train_health
from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.ops.layers import resolve_device, set_compute_dtype
from stmgcn_tpu_torch.ops.spmm import place_supports
from stmgcn_tpu_torch.ops.tiling import StackedPlans, TiledSupports
from stmgcn_tpu_torch.parallel.collectives import GradSync, replica_sum, world_any, world_or
from stmgcn_tpu_torch.parallel.placement import sharded_names
from stmgcn_tpu_torch.resilience.faults import FaultPlan, Preempted
from stmgcn_tpu_torch.resilience.guard import DivergenceGuard
from stmgcn_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_checkpoint_bytes,
    load_latest_verified,
    serialize_checkpoint,
    write_checkpoint_bytes,
)
from stmgcn_tpu_torch.train.metrics import regression_report
from stmgcn_tpu_torch.train.step import (
    CHECK_SITES,
    HEALTH_COLUMNS,
    LOSSES,
    CheckError,
    Sanitizer,
    eval_step,
    gather_window_batch,
    make_optimizer,
    train_step,
)
from stmgcn_tpu_torch.utils import comm

__all__ = ["CitySupports", "Trainer"]


def _watch_finite(model, mesh=None) -> None:
    """``debug_nans``: a forward hook on every module of ``model`` that
    raises ``FloatingPointError`` naming the module whose output holds a
    NaN or an Inf (a host sync per module: a debug mode). On a ``mesh``
    each hook's flag is agreed over every rank first (every rank runs the
    same modules in the same order), so every rank raises at the same
    module, which then names the first module whose output is non-finite
    on any rank: one device's."""
    def check(name):
        def hook(module, args, out):
            bad = any(isinstance(t, torch.Tensor) and t.is_floating_point()
                      and not bool(torch.isfinite(t).all())
                      for t in (out if isinstance(out, (tuple, list)) else (out,)))
            if mesh is not None:
                bad = world_any(bad, mesh, what="debug-nans")
            if bad:
                raise FloatingPointError(
                    f"debug-nans: non-finite output of module {name or 'model'} "
                    f"({type(module).__name__})")
        return hook

    for name, module in model.named_modules():
        module.register_forward_hook(check(name))


def _file_op(op: str, path: str, payload, fault_plan) -> None:
    """One checkpoint file operation: a write (through ``fault_plan``'s
    torn-write hook), a rotation ``latest -> latest.prev`` or a removal."""
    if op == "write":
        write_checkpoint_bytes(path, payload, fault_plan)
        return
    try:
        if op == "rotate":  # latest -> latest.prev
            os.replace(path, payload)
        else:  # "rm": FIFO with the writes, so a dropped snapshot stays dropped
            os.remove(path)
    except OSError:  # nothing to rotate or remove yet
        pass


def _write_jobs(jobs: queue.Queue, fault_plan, failures: list) -> None:
    """The background writer: file operations in queue order until a
    ``None`` (its trainer was freed); failures are kept for
    ``Trainer.flush_checkpoints``."""
    while True:
        job = jobs.get()
        try:
            if job is None:
                return
            _file_op(*job, fault_plan)
        except Exception as e:  # surfaced by flush_checkpoints
            failures.append(e)
        finally:
            jobs.task_done()


class CitySupports:
    """Per-city supports for multi-city training with differing graphs
    (``stmgcn_tpu/train/trainer.py:98-120``): one support form (a dense
    stack, a tiled plan or M block-sparse groups) per city. Batches never
    mix cities; the trainer applies ``for_city(batch.city)``."""

    def __init__(self, per_city):
        self.per_city = tuple(per_city)
        if not self.per_city:
            raise ValueError("need at least one city's supports")

    def __len__(self) -> int:
        return len(self.per_city)

    def for_city(self, city: int):
        return self.per_city[city]

    def map(self, fn) -> "CitySupports":
        return CitySupports(fn(s) for s in self.per_city)

    def to(self, device) -> "CitySupports":
        """Every city's supports on ``device`` (``place_supports``)."""
        return self.map(lambda s: place_supports(s, device))


@dataclasses.dataclass(frozen=True)
class _FleetCity:
    """One fleet city's place in its shape class (the JAX trainer's record
    less the slot and rung, which nothing here reads: a city's steps take
    its own padded supports, and the rung is ``n_real + pad``)."""

    cls: int  # shape-class index in the plan
    n_real: int  # real node rows (the gate's pooling divisor)
    pad: int  # rung - n_real
    t_offset: int  # the city's time offset in the class's concatenated series


@dataclasses.dataclass
class _CityData:
    """What one city's steps read on the device: on the window-free route
    its resident series (the class series for a fleet city) and the
    per-mode target vectors into it (None on the other routes); its
    supports (rung-padded for a fleet city), the gate's real-node count
    (fleet cities only) and the padded node rows the loss masks out."""

    series: Optional[torch.Tensor]
    targets: Optional[dict]
    supports: object
    n_real: Optional[torch.Tensor]
    pad: int
    #: on a region mesh the real-node mask ``(N_padded,)`` the loss mask
    #: crosses (None elsewhere)
    node_mask: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Site:
    """What one training program's steps read: one city's resident series,
    per-mode targets and supports; or a fleet shape class's, shared by its
    members as the JAX fleet superstep shares one program: the class
    series, the members' targets concatenated member after member (each
    batch's indices shifted to its member's start), their supports stacked
    on a member axis (a dense stack or :class:`StackedPlans`) and their
    real-node counts, both selected by the block's slot on the device."""

    series: Optional[torch.Tensor]
    targets: Optional[dict]
    supports: object
    n_real: Optional[torch.Tensor]  # (members,) int32 for a class, None for a city
    rung: Optional[int] = None  # a class's padded node count
    #: a region mesh city's real-node mask (``_CityData.node_mask``) and
    #: this rank's node rows of it
    node_mask: Optional[torch.Tensor] = None
    nodes: Optional[slice] = None
    #: materialized windows, uploaded on first use: mode -> (x_all, y_all),
    #: the members' rung-padded arrays concatenated for a class
    arrays: dict = dataclasses.field(default_factory=dict)

    def gather(self, mode: str, idx: torch.Tensor, offsets, horizon: int,
               sanitizer: Optional[Sanitizer] = None) -> tuple:
        """The batch ``(x, y)`` at ``idx``: the window gather from the
        series, or rows of the materialized arrays (``index_select`` on
        axis 0, indices clamped and flagged under an ``"index"``
        sanitizer, as a JAX take clamps)."""
        if self.series is not None:
            return gather_window_batch(self.series, self.targets[mode], offsets, idx,
                                       horizon, sanitizer)
        x_all, y_all = self.arrays[mode]
        if sanitizer is not None and "index" in sanitizer.kinds:
            n = x_all.shape[0]
            sanitizer.flag("window index", ((idx < 0) | (idx >= n)).any())
            idx = idx.clamp(0, n - 1)
        return x_all.index_select(0, idx), y_all.index_select(0, idx)

    def select(self, slot: Optional[torch.Tensor]) -> tuple:
        """``(supports, n_real)`` of the member at ``slot`` (``(1,)``; a
        city's site has no slot)."""
        if self.rung is None:  # a city: its own supports (and real count, padded)
            return self.supports, self.n_real
        if isinstance(self.supports, StackedPlans):
            sup = self.supports.select(slot)
        else:
            sup = self.supports.index_select(0, slot)[0]
        return sup, self.n_real.index_select(0, slot).reshape(())


class _Ahead:
    """Batches placed ``prefetch`` ahead of their consumer, with the JAX
    ``_placed_batches`` queue's counts: when batch i is consumed, batches
    0 .. i + prefetch have been placed. The first ``prefetch + 1`` are
    placed before batch 0 is handed out; each later one when the consumer
    calls :meth:`advance` (the trainer does, once a step's program is
    enqueued, so its upload runs while that step's kernels do), or else at
    the next hand-out. ``prefetch=0`` places and consumes in turn."""

    def __init__(self, batches, place, prefetch: int):
        self._batches = iter(batches)
        self._place = place
        self._prefetch = prefetch
        self._queue: collections.deque = collections.deque()
        self._started = False
        self._owed = False  # a hand-out whose placement ahead has not run yet

    def advance(self) -> None:
        """Place the next batch, if any."""
        self._owed = False
        batch = next(self._batches, None)
        if batch is not None:
            self._queue.append((batch, self._place(batch)))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            self._started = True
            for _ in range(self._prefetch + 1):
                self.advance()
        elif self._owed:
            self.advance()
        if not self._queue:
            raise StopIteration
        self._owed = True
        return self._queue.popleft()


class Trainer:
    """Trains an :class:`~stmgcn_tpu_torch.models.STMGCN` over a
    :class:`~stmgcn_tpu_torch.data.DemandDataset`.

    ``supports`` is the model's support form — the dense ``(M, K, N, N)``
    stack, a ``TiledSupports`` plan or the M per-branch block-sparse
    groups, or a :class:`CitySupports` of one per city — placed on the
    device once, here; ``dataset`` a ``DemandDataset`` or a
    ``HeteroCityDataset``; ``fleet``, ``fleet_max_classes`` and
    ``fleet_max_pad_waste`` as the JAX trainer's; ``initial_state`` a
    ``state_dict`` to start from (e.g. the JAX trainer's converted initial
    parameters, ``from_jax_params``). ``out_dir`` receives the checkpoints
    (created on the first write); ``extra_meta`` is merged into every
    checkpoint's meta (``build_trainer`` puts the config and the derived
    model facts there, as the JAX package does). ``device=None`` means the
    GPU, and raises without one. ``graphs`` captures the training programs
    as CUDA graphs (``None``: on for CUDA; ``True`` on the CPU raises);
    ``graphs=False`` runs them eagerly. ``data_placement``
    (``"auto"``, ``"resident"`` or ``"stream"``), ``window_free`` (None:
    wherever resident; True requires it; False materializes the windows)
    and ``prefetch`` (batches placed ahead when streaming), ``fault_plan``,
    the ``divergence_*`` and ``health*`` arguments, ``checks`` and
    ``debug_nans``: the module docstring. A ``model`` built with a
    ``placement`` (a
    :class:`~stmgcn_tpu_torch.parallel.placement.MeshPlacement`) trains
    this rank's slice of that mesh (module docstring); without one, one
    device. Other arguments as the JAX ``Trainer``'s.
    """

    #: "auto" placement stays resident up to this many bytes at least (the
    #: CPU's whole budget; on the card the floor of :meth:`_resident_cap_bytes`)
    RESIDENT_CAP_BYTES = 1 << 30

    def __init__(self, model, dataset, supports, *, lr: float = 2e-3,
                 weight_decay: float = 1e-4, lr_schedule: str = "none",
                 warmup_epochs: float = 0.0, min_lr_fraction: float = 0.0,
                 grad_clip_norm: Optional[float] = None, loss: str = "mse",
                 n_epochs: int = 100, batch_size: int = 32, patience: int = 10,
                 shuffle: bool = False, seed: int = 0, steps_per_superstep: int = 1,
                 prefetch: int = 1, data_placement: str = "auto",
                 window_free: Optional[bool] = None, fleet: Optional[bool] = None,
                 fleet_max_classes: int = 8, fleet_max_pad_waste: float = 0.5,
                 out_dir: str = "output", top_k: int = 1, async_checkpoint: bool = True,
                 checkpoint_every_steps: int = 0, precision: str = "fp32",
                 sr_seed: Optional[int] = None, divergence_guard: bool = False,
                 divergence_action: str = "skip", divergence_patience: int = 3,
                 divergence_lr_cut: Optional[float] = None,
                 fault_plan: Optional[FaultPlan] = None, health: bool = False,
                 health_every_k: int = 1, health_out: Optional[str] = None,
                 health_baseline: bool = True, health_sketch_size: int = 64,
                 checks: Optional[str] = None, debug_nans: bool = False,
                 node_pad=0, extra_meta: Optional[dict] = None,
                 initial_state: Optional[dict] = None, device=None,
                 graphs: Optional[bool] = None, verbose: bool = True):
        check_precision(precision, sr_seed)
        if loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
        check_placement(prefetch, data_placement)
        if steps_per_superstep < 1:
            raise ValueError(f"steps_per_superstep must be >= 1, got {steps_per_superstep}")
        if top_k < 1:
            raise ValueError("top_k must be >= 1")
        if checkpoint_every_steps < 0:
            raise ValueError(
                f"checkpoint_every_steps must be >= 0, got {checkpoint_every_steps}")
        if fleet_max_classes < 1:
            raise ValueError(f"fleet_max_classes must be >= 1, got {fleet_max_classes}")
        if not 0.0 <= fleet_max_pad_waste < 1.0:
            raise ValueError(
                f"fleet_max_pad_waste must be in [0, 1), got {fleet_max_pad_waste}")
        if health_every_k < 1:
            raise ValueError(f"health_every_k must be >= 1, got {health_every_k}")
        if health_sketch_size < 1:
            raise ValueError(f"health_sketch_size must be >= 1, got {health_sketch_size}")
        for mode in ("train", "validate"):
            if dataset.mode_size(mode) == 0:
                raise ValueError(
                    f"the {mode!r} split is empty — adjust split fractions/dates "
                    "or provide more data"
                )
        #: the in-program checks (None: no sanitizer op exists)
        self.sanitizer = Sanitizer(checks) if checks is not None else None
        self.debug_nans = bool(debug_nans)
        self.device = resolve_device(device)
        self.verbose = verbose
        #: the model's mesh placement and this rank's mesh (None: one device)
        self.placement = placement = getattr(model, "placement", None)
        self.mesh = getattr(placement, "mesh", None)
        if self.mesh is not None:
            self._check_mesh(graphs)
        if self.debug_nans and graphs:
            raise ValueError("debug_nans runs the programs eagerly; it cannot take graphs=True")
        self.graphs = resolve_graphs(
            False if self.debug_nans or self.mesh is not None else graphs, self.device)
        #: this rank's rows of every batch (None: the whole batch)
        self._rows = None if self.mesh is None else placement.rows(batch_size)
        #: on a region mesh (None elsewhere): the mesh
        self._region = self.mesh if self.mesh is not None and self.mesh.region > 1 else None
        n_cities = getattr(dataset, "n_cities", 1) if not dataset.shared_graphs else 1
        pads = tuple(node_pad) if isinstance(node_pad, (tuple, list)) else (node_pad,) * n_cities
        if len(pads) != n_cities or min(pads) < 0:
            raise ValueError(f"node_pad must be >= 0, one per city (n_cities={n_cities}), "
                             f"got {node_pad!r}")
        if any(pads) and self._region is None:
            raise ValueError("node_pad pads the node axis of a region mesh; this trainer "
                             "has none")
        #: padded node rows per city (per support stack: one for a shared graph)
        self._node_pads = pads
        if self.graphs and sr_seed is not None and not hasattr(
                torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"sr_seed under graphs: torch {torch.__version__} has no "
                "CUDAGraph.register_generator_state to replay the rounding draws; "
                "pass graphs=False to train eagerly")
        self.dataset = dataset
        self.loss = loss
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.patience = patience
        self.shuffle = shuffle
        self.seed = seed
        self.steps_per_superstep = steps_per_superstep
        self.prefetch = prefetch
        self.data_placement = data_placement
        self._place_resident(window_free)
        self.out_dir = out_dir
        self.top_k = top_k
        self.async_checkpoint = async_checkpoint
        self.checkpoint_every_steps = checkpoint_every_steps
        self.extra_meta = extra_meta or {}
        self.precision = precision
        self.sr_seed = sr_seed
        #: deterministic fault injection; the empty plan makes every hook a no-op
        self.fault_plan = fault_plan if fault_plan is not None else FaultPlan()
        self._guard = (DivergenceGuard(action=divergence_action, patience=divergence_patience,
                                       lr_cut=divergence_lr_cut)
                       if divergence_guard else None)
        self._snapshot: Optional[list] = None  # the guard's buffers, made on first use
        # guard action="defer": (ordinal, batch) retried at the epoch's end;
        # ordinals restored from a mid-epoch checkpoint's meta
        self._deferred: list = []
        self._resume_deferred: list = []
        self._preempted = False  # SIGTERM arrived; unwind at the next safe point
        self._lr_scale = 1.0  # the guard's cumulative lr cut
        self.health = bool(health)
        self.health_every_k = health_every_k
        self.health_sketch_size = health_sketch_size
        self._health_out = health_out
        self._health_baseline_on = bool(health_baseline)
        self._health_counter = 0
        self._health_writer: Optional[HealthWriter] = None
        self._health_baseline_cache: Optional[dict] = None
        self.model = model.to(self.device)
        if precision == "bf16":  # the train and eval bodies' bf16 clone
            set_compute_dtype(self.model, torch.bfloat16)
        if initial_state is not None:  # mesh-free: this rank takes its slice
            self.model.load_state_dict(self._local_state(initial_state))
        if self.sanitizer is not None:
            self.sanitizer.watch(self.model)
        if self.debug_nans:
            _watch_finite(self.model, self.mesh)
            self._log("[debug-nans] CUDA graphs off: the programs run eagerly, every "
                      "module's output is held finite and the backward runs under "
                      "anomaly detection")
        #: the flax tree layout checkpoints use: the JAX model's for this
        #: support mode
        self.layout = jax_layout(self.model.support_mode, self.model.loop_layout)
        self._param_names = [name for name, _ in self.model.named_parameters()]
        #: the health stats' layer groups, the JAX tree's top-level keys
        self._health_groups = health_groups(self._param_names, self.model.m_graphs,
                                            layout=self.layout)

        dev = self.device
        self.hetero = getattr(dataset, "heterogeneous", False)
        self.fleet = fleet
        self.fleet_max_classes = fleet_max_classes
        self.fleet_max_pad_waste = fleet_max_pad_waste
        #: the shape classes (None when the fleet is not engaged) and each
        #: member city's place in them
        self.fleet_plan = None
        self._fleet_cities: dict = {}
        #: each fleet class's member supports stacked (dense) or
        #: StackedPlans (tiled), by class index
        self._class_supports: dict = {}
        blocker = self._fleet_blocker(supports)
        if fleet is True and blocker is not None:
            raise ValueError(f"fleet=True cannot engage: {blocker}")
        if blocker is None and (fleet is True or (fleet is None and steps_per_superstep > 1)):
            self._plan_fleet()
            if self._region is not None:  # grown to the rung before the node-row cut
                supports = CitySupports(
                    self._grow(sup, self._node_counts(c)[1])
                    for c, sup in enumerate(supports.per_city))
        if self.mesh is not None:  # the rank's branch slice (and node rows) of each stack
            put = functools.partial(self.placement.put, kind="supports")
            supports = supports.map(put) if isinstance(supports, CitySupports) else put(supports)
        self.supports = (supports.to(dev) if isinstance(supports, CitySupports)
                         else place_supports(supports, dev))
        if self._fleet_cities:
            self._stack_classes()
        self.offsets = torch.as_tensor(np.asarray(dataset.window.offsets, np.int32), device=dev)
        self.horizon = dataset.window.horizon
        #: the streaming route's copies, ``prefetch + 1`` staging buffers
        self._prefetcher = None if self._resident else Prefetcher(dev, prefetch + 1)
        #: the resident data, uploaded once per city (one series serves every
        #: mode; a fleet class's members share one)
        self._cities = self._resident_cities()
        for data in self._cities.values():
            self.model.check_supports(data.supports)
        self.train_path, self.fallback_reason = self._train_path(blocker)
        if self.fallback_reason is not None:
            self._log(f"[slow-path] {self.fallback_reason} (steps_per_superstep="
                      f"{steps_per_superstep}, train_path={self.train_path})")
        self._sites, self._city_site = self._training_sites()
        #: the graph pool of every captured training program (None when
        #: ``graphs`` is off); its ``reserved_bytes`` is their memory
        self.graph_pool = GraphPool(dev) if self.graphs else None
        self._ops = self.graph_pool or DeviceOps(dev)
        self._programs: dict = {}
        # one stochastic-rounding generator, reseeded before each step
        self._sr_gen = (torch.Generator(device=dev) if sr_seed is not None else None)

        # schedule extents are optimizer steps (pad_last: one per batch)
        spe = self.train_steps_per_epoch
        self.optimizer = make_optimizer(
            self.model.parameters(), lr, weight_decay, schedule=lr_schedule,
            warmup_steps=int(warmup_epochs * spe), decay_steps=n_epochs * spe,
            min_lr_fraction=min_lr_fraction, grad_clip_norm=grad_clip_norm,
        )
        if self.mesh is not None:
            self.optimizer.sync = GradSync(self.mesh, self.optimizer.params,
                                           sharded_names(self._param_names, self.mesh.branch),
                                           self._branches())
        self.epoch = 0
        #: optimizer steps across the whole run (survives resume)
        self.global_step = 0
        self.best_val = float("inf")
        self.patience_left = patience
        self._kept: list = []  # (val_loss, -epoch, path) of the best_e*.ckpt snapshots
        # mid-epoch resume: batches consumed in the current epoch, the skip a
        # restored checkpoint asks for, and the epoch's loss accumulators
        self._batch_in_epoch = 0
        self._resume_skip = 0
        self._epoch_losses: list = []
        self._epoch_counts: list = []
        self._last_cadence_step = 0
        self._write_queue: Optional[queue.Queue] = None
        #: what the background writer raised since the last flush
        self._write_failures: list = []

    # -- the mesh -------------------------------------------------------------
    def _check_mesh(self, graphs) -> None:
        """A mesh's one refusal (``graphs=True``) and its eager blocks."""
        mesh = self.mesh
        if graphs:
            raise ValueError(
                "graphs=True on a mesh: a block's collectives cannot be captured into a "
                "CUDA graph (gloo's cannot at all), so mesh blocks run eagerly; pass "
                "graphs=None or False")
        self._log(f"[mesh] rank {mesh.rank} of {mesh.world} at {mesh.coords} over "
                  f"{mesh.backend}: blocks of S run eagerly (no CUDA graphs on a mesh)")

    def _branches(self) -> Optional[slice]:
        """This rank's slice of the stacked branches (None: all)."""
        if self.mesh is None or self.mesh.branch == 1:
            return None
        return self.placement.branches(self.model.m_graphs)

    def _local_state(self, state: dict) -> dict:
        """A mesh-free ``state_dict``'s slice that this rank holds."""
        return state if self.mesh is None else self.placement.state_slice(state)

    @property
    def is_lead(self) -> bool:
        """Whether this rank writes checkpoints (one device: always)."""
        return self.mesh is None or self.mesh.is_lead

    def _lead_read(self, read):
        """``read()`` on the lead only, its result on every rank: the lead
        sends the file it read (its path and bytes), or its error, which
        then raises on every rank; ``read`` returns ``(path, meta, params,
        opt_state)`` or None, and the other ranks decode the bytes as the
        lead did (``opt_state`` None when the lead skipped it)."""
        if self.mesh is None:
            return read()
        result, error = None, None
        if self.mesh.is_lead:
            try:
                result = read()
                if result is None:
                    payload = b"N"
                else:
                    path = result[0].encode()
                    with open(result[0], "rb") as f:
                        body = f.read()
                    flag = b"C" if result[3] is not None else b"P"
                    payload = flag + len(path).to_bytes(4, "little") + path + body
            except Exception as e:  # noqa: BLE001 — sent to every rank, then raised
                error = e
                payload = b"E" + f"{type(e).__name__}\0{e}".encode()
        payload = comm.broadcast_bytes(payload if self.mesh.is_lead else None, self.mesh,
                                       what="checkpoint")
        if self.mesh.is_lead:
            if error is not None:
                raise error
            return result
        flag = payload[:1]
        if flag == b"E":
            name, _, msg = payload[1:].decode().partition("\0")
            cls = {"FileNotFoundError": FileNotFoundError, "ValueError": ValueError,
                   "CorruptCheckpointError": ValueError}.get(name, RuntimeError)
            raise cls(f"the lead rank failed to read the checkpoint: {name}: {msg}")
        if flag == b"N":
            return None
        n = int.from_bytes(payload[1:5], "little")
        path = payload[5:5 + n].decode()
        meta, params, opt_state = load_checkpoint_bytes(payload[5 + n:], path,
                                                        load_opt_state=flag == b"C")
        return path, meta, params, opt_state

    # -- data placement -----------------------------------------------------
    def _resident_cap_bytes(self) -> int:
        """Byte budget of "auto" resident placement: half of what the card
        can still give this process (``torch.cuda.mem_get_info``'s free
        bytes plus the caching allocator's reserved but unallocated ones),
        the other half left for parameters, optimizer state, activations
        and graph pools; never below :attr:`RESIDENT_CAP_BYTES`, which is
        the whole budget off CUDA (the JAX ``_resident_cap_bytes``)."""
        if self.device.type != "cuda":
            return self.RESIDENT_CAP_BYTES
        free, _ = torch.cuda.mem_get_info(self.device)
        spare = torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        return max(self.RESIDENT_CAP_BYTES, (free + spare) // 2)

    def _place_resident(self, window_free: Optional[bool]) -> None:
        """``_resident`` and ``_window_free`` as the JAX trainer decides
        them (``trainer.py:426-455``): "auto" sizes against what would sit
        on the device, the raw series where the window-free gather can
        serve, the windowed arrays otherwise."""
        ds = self.dataset
        wf_supported = hasattr(ds, "series") and hasattr(ds, "mode_targets")
        if window_free and not wf_supported:
            raise ValueError(
                "window_free=True requires the series/mode_targets protocol "
                "(DemandDataset or HeteroCityDataset) — this dataset only "
                "materializes windows")
        wf_candidate = wf_supported and window_free is not False
        meshy = self.mesh is not None
        if self.data_placement == "resident" and meshy and not wf_candidate:
            raise ValueError(
                "data_placement='resident' on a mesh placement composes only through "
                "the window-free gather (window_free must not be False and the dataset "
                "must speak the series/mode_targets protocol); materialized windows "
                "stream on meshes")
        resident_bytes = ds.resident_nbytes if wf_candidate else ds.nbytes
        # a mesh under "auto" streams unless window_free=True opts in (the JAX rule)
        self._resident = self.data_placement == "resident" or (
            self.data_placement == "auto" and (not meshy or window_free is True)
            and resident_bytes <= self._resident_cap_bytes())
        #: resident batches gather from the raw series on the device instead
        #: of materialized window arrays (bitwise the same batches)
        self._window_free = wf_candidate and self._resident
        if window_free and not self._window_free:
            raise ValueError(WINDOW_FREE_NEEDS_RESIDENT)

    # -- cities and fleet classes -------------------------------------------
    def _fleet_blocker(self, supports) -> Optional[str]:
        """Why the fleet cannot engage on ``supports`` (as given, before
        placement; the JAX trainer's texts), or None."""
        if not self.hetero:
            return "the dataset is homogeneous (one shared graph fuses already)"
        if not self._resident:
            return "data placement is not resident (stream/mesh upload per batch)"
        per_city = supports.per_city if isinstance(supports, CitySupports) else ()
        tiled = bool(per_city) and all(isinstance(s, TiledSupports) for s in per_city)
        dense = bool(per_city) and all(getattr(s, "ndim", None) == 4 for s in per_city)
        if not (tiled or dense):
            return ("per-city supports are neither dense (M, K, N, N) stacks "
                    "nor uniformly tiled (TiledSupports) plans")
        return None

    def _plan_fleet(self) -> None:
        """Plan the shape classes over the cities' node counts padded as the
        mesh pads them (``node_pad``: a rung then stays a multiple of
        ``region``), each member's pad then becoming ``rung - n_real``
        (``stmgcn_tpu/train/trainer.py:595-626``)."""
        # imported here: the planner reaches the serving package, which
        # imports this module
        from stmgcn_tpu_torch.data.fleet import plan_shape_classes

        ds = self.dataset
        self.fleet_plan = plan_shape_classes(
            [self._node_counts(c)[1] for c in range(ds.n_cities)],
            max_classes=self.fleet_max_classes, max_pad_waste=self.fleet_max_pad_waste)
        pads = list(self._node_pads)
        for ci, cls in enumerate(self.fleet_plan.classes):
            t_off = 0
            for c in cls.cities:
                n = ds.city_n_nodes[c]
                pads[c] = cls.n_nodes - n
                self._fleet_cities[c] = _FleetCity(cls=ci, n_real=n, pad=pads[c],
                                                   t_offset=t_off)
                t_off += ds.series(c).shape[0]
        self._node_pads = tuple(pads)

    @staticmethod
    def _grow(sup, n: int):
        """A member's supports grown to its class rung of ``n`` nodes: a
        tiled plan by ``pad_to``, a dense stack (array or tensor) by zero
        node rows and columns (none when its columns number ``n``
        already: a region rank's row strip of a grown stack)."""
        if isinstance(sup, TiledSupports):
            return sup.pad_to(n)
        grow = n - sup.shape[-1]
        if not grow:
            return sup
        if isinstance(sup, torch.Tensor):
            return torch.nn.functional.pad(sup, (0, grow, 0, grow))
        return np.pad(np.asarray(sup), [(0, 0)] * (sup.ndim - 2) + [(0, grow), (0, grow)])

    def _stack_classes(self) -> None:
        """Each class's members' supports, placed, at one shape: grown to
        the rung (:meth:`_grow`), tiled plans then widened to the class's
        common block-column counts by ``with_block_cols``, and stacked on a
        member axis (``stmgcn_tpu/train/trainer.py:626-644``)."""
        sups = list(self.supports.per_city)
        for ci, cls in enumerate(self.fleet_plan.classes):
            for c in cls.cities:
                sups[c] = self._grow(sups[c], cls.n_nodes)
            if isinstance(sups[cls.cities[0]], TiledSupports):
                c_common = max(sups[c].block_cols for c in cls.cities)
                c_t_common = max(sups[c].data_t.shape[3] for c in cls.cities)
                for c in cls.cities:
                    sups[c] = sups[c].with_block_cols(c_common, c_t_common)
                compute = getattr(self.model, "compute_dtype", None)
                self._class_supports[ci] = StackedPlans(
                    [sups[c] for c in cls.cities], dtypes=(compute,) if compute else ())
            else:  # one stack; each member's supports a view of its slot
                stack = torch.stack([sups[c] for c in cls.cities])
                self._class_supports[ci] = stack
                for slot, c in enumerate(cls.cities):
                    sups[c] = stack[slot]
        self.supports = CitySupports(sups)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.float32), device=self.device)

    def _node_pad(self, city: int) -> int:
        """The padded node rows of ``city``'s support stack."""
        return self._node_pads[0 if self.dataset.shared_graphs else city]

    def _local_nodes(self, array: np.ndarray, city: int, axis: int) -> np.ndarray:
        """A host array whose node axis is ``axis``, zero-padded to the
        city's padded count (a region mesh's multiple, a fleet member's
        rung), then on a region mesh cut to the rank's node rows."""
        pad = self._node_pad(city)
        if pad:
            widths = [(0, 0)] * array.ndim
            widths[axis] = (0, pad)
            array = np.pad(array, widths)
        if self._region is None:
            return array
        index = [slice(None)] * array.ndim
        index[axis] = self.placement.nodes(array.shape[axis])
        return array[tuple(index)]

    def _node_counts(self, city: int) -> tuple:
        """``(real, padded)`` node counts of ``city``'s support stack."""
        ds = self.dataset
        n = ds.n_nodes if ds.shared_graphs else ds.city_n_nodes[city]
        return n, n + self._node_pad(city)

    def _nodes(self, city: int) -> Optional[slice]:
        """A region rank's node rows of ``city`` (None off a region mesh)."""
        if self._region is None:
            return None
        return self.placement.nodes(self._node_counts(city)[1])

    def _node_mask(self, city: int) -> Optional[torch.Tensor]:
        """On a region mesh, ``city``'s real-node mask over its padded node
        axis (float32 0/1)."""
        if self._region is None:
            return None
        n, padded = self._node_counts(city)
        return torch.as_tensor((np.arange(padded) < n).astype(np.float32), device=self.device)

    def _resident_cities(self) -> dict:
        """Each city's :class:`_CityData`; one entry (city 0) when every
        city shares one graph stack, whose batches index the cities'
        concatenated series. Only the window-free route uploads a series
        here."""
        ds, dev, wf = self.dataset, self.device, self._window_free

        def targets(c, offset=0):
            if not wf:
                return None
            return {m: torch.as_tensor(np.asarray(ds.mode_targets(m, c), np.int64) + offset,
                                       dtype=torch.int32, device=dev) for m in MODES}

        def upload(series, c=0):
            return self._upload(self._local_nodes(series, c, 1)) if wf else None

        if ds.shared_graphs:
            return {0: _CityData(upload(ds.series_stack()), targets(None),
                                 self.supports, None, self._node_pads[0], self._node_mask(0))}
        class_series = {}  # the members' series at the rung (a region rank's rows)
        for ci, cls in enumerate(self.fleet_plan.classes if self.fleet_plan and wf else ()):
            class_series[ci] = self._upload(np.concatenate([
                self._local_nodes(ds.series(c), c, 1) for c in cls.cities]))
        cities = {}
        for c in range(ds.n_cities):
            info = self._fleet_cities.get(c)
            sup = self.supports.for_city(c)
            if info is None:
                pad = self._node_pads[c]
                # a padded city of a region mesh pools over its real count
                n_real = (torch.tensor(ds.city_n_nodes[c], dtype=torch.int32, device=dev)
                          if pad else None)
                cities[c] = _CityData(upload(ds.series(c), c), targets(c), sup, n_real, pad,
                                      self._node_mask(c))
            else:
                cities[c] = _CityData(class_series.get(info.cls), targets(c, info.t_offset), sup,
                                      torch.tensor(info.n_real, dtype=torch.int32, device=dev),
                                      info.pad)
        return cities

    def _resident_arrays(self, mode: str, key) -> tuple:
        """The materialized route's ``(x_all, y_all)`` of ``mode`` at site
        ``key``, uploaded once per run (the JAX ``_resident_arrays``): the
        mode's windows of every city over a shared graph stack, of one city,
        or of a fleet class's members node-padded to the rung and
        concatenated member after member (the order of the class's
        concatenated targets)."""
        site = self._sites[key]
        if mode not in site.arrays:
            ds = self.dataset
            if key[0] == "city" and ds.shared_graphs:
                x, y = ds.arrays(mode)
            else:
                cities = ((key[1],) if key[0] == "city"
                          else self.fleet_plan.classes[key[1]].cities)
                xs, ys = [], []
                for c in cities:
                    x, y = ds.city_arrays(mode, c)
                    info = self._fleet_cities.get(c)
                    if info is not None and info.pad:
                        x = np.pad(x, [(0, 0)] * 2 + [(0, info.pad), (0, 0)])
                        y = np.pad(y, [(0, 0)] * (y.ndim - 2) + [(0, info.pad), (0, 0)])
                    xs.append(x)
                    ys.append(y)
                x, y = (xs[0], ys[0]) if len(xs) == 1 else (np.concatenate(xs),
                                                            np.concatenate(ys))
            site.arrays[mode] = (self._upload(x), self._upload(y))
        return site.arrays[mode]

    def _training_sites(self) -> tuple:
        """``(sites, where)``: every training program's :class:`_Site` by
        key (``("city", c)``, or ``("class", ci)`` shared by a fleet class's
        members), and each city's ``(site key, slot, {mode: target
        start})``."""
        sites, where = {}, {}
        for c, data in self._cities.items():
            if c not in self._fleet_cities:
                sites["city", c] = _Site(data.series, data.targets, data.supports, data.n_real,
                                         node_mask=data.node_mask, nodes=self._nodes(c))
                where[c] = (("city", c), 0, dict.fromkeys(MODES, 0))
        for ci, cls in enumerate(self.fleet_plan.classes if self._fleet_cities else ()):
            members = [self._cities[c] for c in cls.cities]
            targets = ({m: torch.cat([d.targets[m] for d in members]) for m in MODES}
                       if self._window_free else None)
            starts = {m: np.cumsum([0] + [len(self.dataset.mode_targets(m, c))
                                          for c in cls.cities]) for m in MODES}
            n_real = torch.tensor([self._fleet_cities[c].n_real for c in cls.cities],
                                  dtype=torch.int32, device=self.device)
            sites["class", ci] = _Site(members[0].series, targets, self._class_supports[ci],
                                       n_real, cls.n_nodes, nodes=self._nodes(cls.cities[0]))
            for slot, c in enumerate(cls.cities):
                where[c] = (("class", ci), slot, {m: int(starts[m][slot]) for m in MODES})
        return sites, where

    def _train_path(self, blocker) -> tuple:
        """``(train_path, fallback_reason)`` as the JAX trainer names them:
        the path training epochs take ("series_superstep", "superstep",
        "fleet_superstep" or "per_step") and, when S > 1 asked for blocks, why (part of) the
        run steps one batch at a time."""
        if self.steps_per_superstep == 1:
            return "per_step", None
        if self._resident and self.dataset.shared_graphs:
            return "series_superstep" if self._window_free else "superstep", None
        if self._fleet_cities and self._window_free:
            unassigned = self.fleet_plan.unassigned
            return "fleet_superstep", None if not unassigned else (
                f"no-class-fit: cities {sorted(unassigned)} fit no shape class "
                f"(fleet_max_classes={self.fleet_max_classes}, fleet_max_pad_waste="
                f"{self.fleet_max_pad_waste}) and run the per-step loop")
        if not self._resident:
            return "per_step", "stream: data placement is not resident, batches upload per step"
        if self.hetero and self.fleet is False:
            return "per_step", ("hetero: heterogeneous cities with fleet=False take the "
                                "materialized per-city loop")
        if self.hetero and blocker is not None:
            return "per_step", f"hetero: {blocker}"
        if self.hetero and not self._window_free:
            return "per_step", ("hetero: window_free=False keeps the materialized per-city "
                                "loop (the fleet parity oracle)")
        if self.hetero:
            return "per_step", "hetero: no city fits any shape class"
        return "per_step", ("per-city support stacks (CitySupports) on a homogeneous "
                            "dataset gather per step")

    @property
    def train_steps_per_epoch(self) -> int:
        """Optimizer steps per training epoch: one per batch, and batches
        never span two cities with their own graphs."""
        ds, b = self.dataset, self.batch_size
        if self.hetero:
            return sum(-(-c.mode_size("train") // b) for c in ds.cities)
        if ds.shared_graphs:
            return -(-ds.mode_size("train") // b)
        return ds.num_batches("train", b)

    @property
    def best_path(self) -> str:
        return os.path.join(self.out_dir, "best.ckpt")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.out_dir, "latest.ckpt")

    @property
    def latest_prev_path(self) -> str:
        return os.path.join(self.out_dir, "latest.prev.ckpt")

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def _event(self, name: str, text: str) -> None:
        """A phase event: a zero-length ``event.<name>`` span in the active
        trace, and ``text`` logged (the JAX trainer's ``_event``)."""
        trc = obs_trace.active_tracer()
        if trc is not None:
            t = time.perf_counter()
            trc.record_span(f"event.{name}", t, t)
        self._log(text)

    # -- checkpoints ------------------------------------------------------
    def _meta(self) -> dict:
        """The JAX trainer's meta keys (``trainer.py`` ``_meta``)."""
        meta = {
            "epoch": self.epoch,
            "best_val": self.best_val,
            "patience_left": self.patience_left,
            "seed": self.seed,
            "kept": self._kept,
            "global_step": self.global_step,
            # 0 means "epoch boundary: resume at epoch + 1"
            "batch_in_epoch": self._batch_in_epoch,
            # (seed, shuffle, epoch) fix the data order; resume checks them
            "shuffle": self.shuffle,
            "steps_per_superstep": self.steps_per_superstep,
            # provenance: the parameters are float32 masters at any precision
            "precision": self.precision,
        }
        if self.sr_seed is not None:
            meta["sr_seed"] = self.sr_seed
        if self.mesh is not None:  # provenance: the mesh and its transport
            meta["mesh"] = {**self.mesh.shape, "transport": self.mesh.backend}
        if self._lr_scale != 1.0:
            meta["lr_scale"] = self._lr_scale
        if self._batch_in_epoch:
            meta["partial"] = {"losses": [float(v) for v in self._epoch_losses],
                               "counts": [int(c) for c in self._epoch_counts]}
            if self._deferred:
                # the guard's pending "defer" retries, by ordinal: a resume
                # retries them at the epoch's end instead of dropping them
                meta["deferred"] = [ordinal for ordinal, _ in self._deferred]
        if self.hetero:
            meta["normalizers"] = [n.to_dict() if n is not None else None
                                   for n in self.dataset.normalizers]
        elif self.dataset.normalizer is not None:
            meta["normalizer"] = self.dataset.normalizer.to_dict()
        if self.health and self._health_baseline_on:
            meta["health_baseline"] = self._health_baseline_blob()
        meta.update(self.extra_meta)
        return meta

    def state_trees(self) -> tuple:
        """``(params, opt_state)`` as the JAX package checkpoints them:
        numpy flax trees in this model's layout (copied off the device)."""
        m = self.model.m_graphs
        gather = None
        if self._branches() is not None:  # every rank: the branch slices, gathered
            gather = self.placement.state_gather
        state = self.model.state_dict()
        params = to_jax_params(state if gather is None else gather(state, "params"), m,
                               layout=self.layout)
        return params, self.optimizer.state_tree(self._param_names, m, self.layout, gather)

    def snapshot(self) -> bytes:
        """The current state serialized as one checkpoint file's bytes."""
        return serialize_checkpoint(*self.state_trees(), self._meta())

    def _save(self, path: str) -> bytes:
        if not self.is_lead:  # its part of the gather; the lead writes
            if self._branches() is not None:
                self.state_trees()
            return b""
        trc = obs_trace.active_tracer()
        t0 = time.perf_counter() if trc is not None else 0.0
        data = self.snapshot()
        if path == self.latest_path:
            # rotate first: if this write lands corrupt, latest.prev is the
            # previous verified state and the recovery chain falls back to it
            self._queue("rotate", path, self.latest_prev_path)
        self._queue("write", path, data)
        if trc is not None:  # serialize and enqueue; the writer's IO is off-thread
            trc.record_span("train.checkpoint", t0, time.perf_counter(),
                            {"path": os.path.basename(path), "bytes": len(data)})
        return data

    def _queue(self, op: str, path: str, payload=None) -> None:
        if not self.is_lead:  # only the lead touches the files
            return
        os.makedirs(self.out_dir, exist_ok=True)
        if op == "write":  # the plan's byte faults, on the training thread
            payload = self.fault_plan.mutate_write(path, payload)
        if not self.async_checkpoint:
            _file_op(op, path, payload, self.fault_plan)
            return
        if self._write_queue is None:
            # bounded: each entry holds a whole serialized state, so a slow
            # out_dir applies backpressure instead of growing host memory
            self._write_queue = queue.Queue(maxsize=4)
            # the thread holds the queue, the plan and the failure list, not
            # the trainer: a trainer (and its graph pool) it wrote for can be
            # freed, and the thread ends with it
            threading.Thread(target=_write_jobs,
                             args=(self._write_queue, self.fault_plan, self._write_failures),
                             daemon=True, name="stmgcn-ckpt-writer").start()
            weakref.finalize(self, self._write_queue.put, None)
        self._write_queue.put((op, path, payload))

    def flush_checkpoints(self) -> None:
        """Block until pending checkpoint writes land; re-raise a failure."""
        if self._write_queue is not None:
            self._write_queue.join()
        if self._write_failures:
            err = self._write_failures[0]
            self._write_failures.clear()
            raise RuntimeError("background checkpoint write failed") from err

    def _install(self, meta: dict, params: dict, opt_state) -> None:
        """Load a checkpoint's trees into the live model and optimizer (on
        the trainer's device) and its meta into the loop state."""
        m, branches = self.model.m_graphs, self._branches()
        self.model.load_state_dict(from_jax_params(params, m, branches))
        if opt_state is not None:
            self.optimizer.load_state_tree(opt_state, self._param_names, m, branches)
        self._apply_meta(meta)

    def _apply_meta(self, meta: dict) -> None:
        """The JAX trainer's ``_apply_meta``: the loop state, and for a
        mid-epoch checkpoint the resume cursor, partial losses and the
        guard's deferred ordinals, refused when the data order would differ;
        the guard's ``lr_scale``."""
        self.epoch = meta["epoch"]
        self.best_val = meta["best_val"]
        self.patience_left = meta["patience_left"]
        self._kept = [tuple(entry) for entry in meta.get("kept", [])]
        self.global_step = int(meta.get("global_step", 0))
        self._last_cadence_step = self.global_step
        self._resume_skip = int(meta.get("batch_in_epoch", 0))
        self._set_lr_scale(float(meta.get("lr_scale", 1.0)))
        if self._resume_skip:
            if int(meta.get("seed", self.seed)) != self.seed:
                raise ValueError(
                    f"mid-epoch checkpoint was written with seed {meta['seed']}, trainer "
                    f"has seed {self.seed} — the data order would differ; resume with "
                    "the same seed")
            if bool(meta.get("shuffle", self.shuffle)) != self.shuffle:
                raise ValueError(
                    f"mid-epoch checkpoint was written with shuffle={meta['shuffle']}, "
                    f"trainer has shuffle={self.shuffle} — the data order would differ")
            S = int(meta.get("steps_per_superstep", self.steps_per_superstep))
            if S != self.steps_per_superstep:
                raise ValueError(
                    f"mid-epoch checkpoint was written with steps_per_superstep={S}, "
                    f"trainer has {self.steps_per_superstep} — its cursor sits on "
                    "another block boundary")
            if self._resume_skip > self.train_steps_per_epoch:
                raise ValueError(
                    f"mid-epoch resume cursor {self._resume_skip} exceeds "
                    f"{self.train_steps_per_epoch} steps per epoch — checkpoint from a "
                    "different data configuration?")
            partial = meta.get("partial") or {"losses": [], "counts": []}
            self._epoch_losses = [float(v) for v in partial["losses"]]
            self._epoch_counts = [int(c) for c in partial["counts"]]
            self._resume_deferred = [int(o) for o in meta.get("deferred", [])]
        else:
            self._epoch_losses, self._epoch_counts = [], []
            self._resume_deferred = []
        self._batch_in_epoch = self._resume_skip

    def restore(self, path: Optional[str] = None) -> dict:
        """Load a checkpoint into the live state; returns its meta. With
        ``path``, that file (which must verify); without, the newest
        verified checkpoint in ``out_dir`` (:meth:`restore_auto`), raising
        ``FileNotFoundError`` when nothing is resumable."""
        if path is None:
            meta = self.restore_auto()
            if meta is None:
                raise FileNotFoundError(errno.ENOENT, "no verified checkpoint to resume from",
                                        self.latest_path)
            return meta
        self.flush_checkpoints()  # a pending write may own this path
        _, meta, params, opt_state = self._lead_read(lambda: (path, *load_checkpoint(path)))
        self._install(meta, params, opt_state)
        return meta

    def restore_auto(self) -> Optional[dict]:
        """Resume from the newest verified checkpoint in ``out_dir`` (latest
        -> latest.prev -> best_e* -> best, corrupt files quarantined);
        returns its meta, or ``None`` when nothing loads."""
        self.flush_checkpoints()
        found = self._lead_read(lambda: load_latest_verified(self.out_dir, log=self._log))
        if found is None:
            return None
        path, meta, params, opt_state = found
        self._install(meta, params, opt_state)
        self._log(f"resumed from {path} (epoch {self.epoch}, step {self.global_step})")
        return meta

    # -- the loop -----------------------------------------------------------
    def batches(self, mode: str, *, shuffle: bool = False):
        """The mode's index-only batches, padded to ``batch_size``, in the
        JAX trainer's order for this epoch."""
        return self.dataset.batches(
            mode, self.batch_size, shuffle=shuffle, seed=self.seed, epoch=self.epoch,
            pad_last=True, with_arrays=False,
        )

    def _placed_batches(self, mode: str, *, shuffle: bool = False, skip: int = 0) -> "_Ahead":
        """``(batch, placed)`` of the streaming route with ``prefetch``
        batches placed ahead (:class:`_Ahead`, the JAX ``_placed_batches``
        queue); the first ``skip`` batches (a mid-epoch resume's consumed
        ones) are not placed."""
        batches = self.dataset.batches(
            mode, self.batch_size, shuffle=shuffle, seed=self.seed, epoch=self.epoch,
            pad_last=True, with_arrays=True)
        return _Ahead(itertools.islice(batches, skip, None),
                      lambda batch: self._place_stream(batch, mode), self.prefetch)

    def _place_stream(self, batch, mode: str):
        """Start the upload of a streamed batch's ``x`` and ``y`` (from the
        mode's windowed arrays when it carries only indices: a deferred
        batch of a resumed epoch)."""
        x, y = batch.x, batch.y
        if x is None:
            ds = self.dataset
            x_all, y_all = (ds.arrays(mode) if ds.shared_graphs
                            else ds.city_arrays(mode, batch.city))
            x, y = x_all[batch.indices], y_all[batch.indices]
        if self._rows is not None:  # a dp rank uploads its rows only
            x, y = x[self._rows], y[self._rows]
        # a region rank its node rows
        x, y = self._local_nodes(x, batch.city, 2), self._local_nodes(y, batch.city, y.ndim - 2)
        return self._prefetcher.place({"x": x, "y": y})

    def place(self, batch, mode: str, sanitizer: Optional[Sanitizer] = None, placed=None):
        """``(x, y, mask)`` on the device: the batch gathered from its
        city's resident data (the series, or the materialized windows), or
        streamed (``placed``, or placed now), and the mask of real samples,
        ``(B,)``, or ``(B, N_c)`` crossed with the real nodes for a fleet
        city (at every pad, as the JAX trainer's one mask shape per class).
        On a ``dp`` mesh ``x`` and ``y`` are this rank's rows, the mask the
        whole batch's.
        ``sanitizer`` (a step open on it) checks the gather's indices."""
        if not self._resident:
            placed = placed if placed is not None else self._place_stream(batch, mode)
            tensors = placed.ready()
            x, y = tensors["x"], tensors["y"]
        else:
            key, _, starts = self._city_site[batch.city]
            if not self._window_free:
                self._resident_arrays(mode, key)
            idx = np.asarray(batch.indices, np.int64) + starts[mode]
            if self._rows is not None:  # a dp rank gathers its rows only
                idx = idx[self._rows]
            idx = torch.as_tensor(idx, device=self.device)
            x, y = self._sites[key].gather(mode, idx, self.offsets, self.horizon, sanitizer)
        mask = torch.as_tensor((np.arange(len(batch)) < batch.n_real).astype(np.float32),
                               device=self.device)
        info = self._fleet_cities.get(batch.city)
        if info is not None:
            n = info.n_real + info.pad
            node = torch.as_tensor((np.arange(n) < info.n_real).astype(np.float32),
                                   device=self.device)
            mask = mask[:, None] * node[None, :]
        elif self._region is not None:  # the whole (B, N) mask on every region rank
            mask = mask[:, None] * self._cities[self._city_key(batch.city)].node_mask[None, :]
        return x, y, mask

    def _city_key(self, city: int) -> int:
        """The ``_cities`` entry of ``city`` (one for a shared graph)."""
        return 0 if self.dataset.shared_graphs else city

    def _sr_seed(self, step: int) -> int:
        """The stochastic-rounding seed of optimizer step ``step``, from
        ``(sr_seed, step)`` alone, so a resumed run draws what the
        uninterrupted one did."""
        return (self.sr_seed * 1_000_003 + step) % (1 << 63)

    def _block_body(self, site: _Site, steps: int, mode: str, health: bool = False):
        """The program body of ``steps`` optimizer steps over ``site``: each
        step gathers its batch from the static index block, masks its loss
        with the static sample mask (crossed with the member's real nodes
        in a fleet class) and updates from its static optimizer scalars;
        returns the ``(steps,)`` losses. The ``health`` twin returns the
        ``(steps, 5 + G)`` health rows instead (the loss their first
        column), and over a fleet class each step's loss scattered to its
        member's column after them (``city_loss``). Under ``checks`` each
        step's flag word follows as a last column (``(steps, 2)`` plain)."""
        groups = self._health_groups if health else None
        san = self.sanitizer
        streamed = not self._resident
        rows = self._rows
        nodes = site.nodes
        grad_check = self._grad_check if self.debug_nans and self.mesh is not None else None

        def body(v):
            supports, n_real = site.select(v.get("slot"))
            node = site.node_mask
            if n_real is not None and site.rung is not None:
                node = (torch.arange(site.rung, device=self.device) < n_real).to(torch.float32)
            outs, flags = [], []
            for s in range(steps):
                if san is not None:
                    san.begin(self.device)
                if streamed:  # one step over the landed batch
                    x, y = v["x"], v["y"]
                else:
                    idx = v["idx"][s] if rows is None else v["idx"][s][rows]
                    x, y = site.gather(mode, idx, self.offsets, self.horizon, san)
                mask = v["mask"][s] if node is None else v["mask"][s][:, None] * node[None, :]
                outs.append(train_step(self.model, self.optimizer, supports, x, y, mask,
                                       self.loss, sr_generator=self._sr_gen, n_real=n_real,
                                       scalars=v["adam"][s], health=groups, sanitizer=san,
                                       rows=rows, nodes=nodes, grad_check=grad_check))
                if san is not None:
                    flags.append(san.end())
            if not health:
                out = torch.stack(outs)
            else:
                out = torch.stack([row for _, row in outs])
                if site.rung is not None:
                    members = site.n_real.shape[0]
                    onehot = (torch.arange(members, device=self.device) == v["slot"]).float()
                    out = torch.cat([out, out[:, :1] * onehot[None, :]], dim=1)
            if san is None:
                return out
            words = torch.stack(flags).float()[:, None]  # exact: words < 2^24
            return torch.cat([out[:, None] if out.dim() == 1 else out, words], dim=1)

        return body

    def _route(self) -> str:
        """Where the programs' batches come from: ``"series"``
        (window-free), ``"windows"`` (materialized) or ``"stream"``."""
        if not self._resident:
            return "stream"
        return "series" if self._window_free else "windows"

    def _program(self, key, steps: int, mode: str, health: bool = False,
                 placed=None) -> Program:
        """The training program of ``steps`` steps over site ``key``, or its
        health twin (made, and on CUDA captured at its first call, once).
        Keyed ``(key, steps, mode, health)`` on the window-free route, with
        the route appended on the others; a streamed program (one step)
        reads static ``x``/``y`` device inputs shaped as ``placed``'s."""
        route = self._route()
        name = (key, steps, mode, health) + (() if route == "series" else (route,))
        program = self._programs.get(name)
        if program is None:
            site = self._sites[key]
            spec = {"mask": ((steps, self.batch_size), torch.float32),
                    "adam": ((steps, 2), torch.float32)}
            device_spec = None
            if route == "stream":
                device_spec = {k: (tuple(t.shape), t.dtype) for k, t in placed.tensors.items()}
            else:
                spec = {"idx": ((steps, self.batch_size), torch.int32), **spec}
            if route == "windows":
                self._resident_arrays(mode, key)
            if site.rung is not None:
                spec["slot"] = ((1,), torch.int32)
            body = self._block_body(site, steps, mode, health)
            label = (f"training block {key[0]} {key[1]}, {steps} step(s)"
                     + ("" if route == "series" else f", {route}")
                     + (", health" if health else ""))
            if self.graphs:
                program = CapturedProgram(body, spec, self.graph_pool, name=label,
                                          generator=self._sr_gen, upload_span="train.upload",
                                          device_spec=device_spec)
            else:
                program = Program(body, spec, self._ops, name=label,
                                  upload_span="train.upload", device_spec=device_spec)
            self._programs[name] = program
        return program

    def _dispatch(self, block: list, mode: str = "train", health: bool = False,
                  poisons: Optional[dict] = None, placed=None, ahead=None) -> tuple:
        """The optimizer steps of ``block`` (one city's batches) as one
        program call, or one call per step under stochastic rounding (its
        generator is reseeded per step), from the optimizer's count and the
        global step as they stand; advances neither. ``poisons`` maps a
        step of the block to the payload written into its first mask entry.
        A streamed block is one batch, ``placed`` ahead or placed here;
        ``ahead`` (host work, the next batch's placement) runs while the
        program does. Returns ``(losses, health rows or None)``."""
        if not self._resident and placed is None:
            placed = self._place_stream(block[0], mode)
        key, slot, starts = self._city_site[block[0].city]
        runs = [[b] for b in block] if self._sr_gen is not None else [block]
        count, step = self.optimizer.count, self.global_step
        trc = obs_trace.active_tracer()
        outs, first = [], 0
        for run in runs:
            t_p0 = time.perf_counter() if trc is not None else 0.0
            mask = np.stack([np.arange(len(b)) < b.n_real for b in run]).astype(np.float32)
            for s, payload in (poisons or {}).items():
                if first <= s < first + len(run):
                    mask[s - first, 0] = payload
            values = {
                "mask": mask,
                "adam": np.array([self.optimizer.scalars(count + first + i)
                                  for i in range(len(run))]),
            }
            if self._resident:
                values["idx"] = np.stack([np.asarray(b.indices) + starts[mode] for b in run])
            if key[0] == "class":
                values["slot"] = np.array([slot])
            if self._sr_gen is not None:
                self._sr_gen.manual_seed(self._sr_seed(step + first))
            program = self._program(key, len(run), mode, health, placed)
            if trc is None:
                outs.append(program(values, placed, ahead))
            else:
                t_d0 = time.perf_counter()
                trc.record_span("train.host_pack", t_p0, t_d0, {"steps": len(run)})
                # ends in the readback: the device is done
                outs.append(program(values, placed, ahead))
                trc.record_span("train.superstep", t_d0, time.perf_counter(),
                                {"step": step + first, "s": len(run)})
            first += len(run)
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        if self.mesh is not None:
            out = self._mesh_reduce(out, health)
        if self.sanitizer is not None:
            self._raise_flags(out[:, -1], block, "train")
            out = out[:, :-1] if health else out[:, 0]
        if health:
            rows = out.numpy()
            return rows[:, 0].tolist(), rows
        return out.tolist(), None

    def _mesh_reduce(self, out: torch.Tensor, health: bool) -> torch.Tensor:
        """A dispatch's readback agreed over the mesh: each rank's share of
        the global means summed over ``dp x region`` (the losses, and a
        fleet class's ``city_loss`` columns), the health rows' norms and
        counts kept (every rank's already: read after the gradient sum,
        branch slices summed in the step), their non-finite-loss flag read
        again off the summed loss, and the sanitizers' flag words or-ed over
        every rank (:func:`world_or`)."""
        if out.dim() == 1:  # the plain losses
            return replica_sum(out, self.mesh, what="loss")
        out = out.clone()
        width = out.shape[1] - (self.sanitizer is not None)
        first = len(HEALTH_COLUMNS) + len(self._health_groups)
        cols = torch.tensor([0] + (list(range(first, width)) if health else []))
        out[:, cols] = replica_sum(out[:, cols].contiguous(), self.mesh, what="loss")
        if health:
            out[:, HEALTH_COLUMNS.index("nonfinite_loss")] = (~torch.isfinite(out[:, 0])).float()
        if self.sanitizer is not None:
            out[:, -1] = world_or(out[:, -1], len(CHECK_SITES), self.mesh, what="checks")
        return out

    def _all_finite(self, losses) -> bool:
        """Whether every loss is finite, on a mesh agreed over every rank
        (the divergence guard's one decision)."""
        bad = not np.isfinite(losses).all()
        if self.mesh is not None:
            bad = world_any(bad, self.mesh, what="guard")
        return not bad

    def _grad_check(self, grads) -> None:
        """``debug_nans`` on a mesh: the summed gradients' finiteness,
        agreed over every rank, raising on all of them (the backward's
        anomaly detection there names no op: a rank raising alone inside
        its backward would leave its peers waiting in a collective)."""
        bad = not bool(torch.isfinite(torch.stack([g.abs().max() for g in grads])).all())
        if world_any(bad, self.mesh, what="debug-nans"):
            raise FloatingPointError("debug-nans: non-finite gradients after the backward "
                                     "(summed over the mesh)")

    def _raise_flags(self, words, batches, mode: str) -> None:
        """The sanitizers' verdict on a dispatch or an eval epoch: raise
        :class:`CheckError` at the first step whose flag word is set,
        naming it (``words`` float32, one per entry of ``batches``)."""
        bad = np.flatnonzero(np.asarray(words) != 0)
        if not bad.size:
            return
        i = int(bad[0])
        if mode == "train":
            where = (f"epoch {self.epoch}, step {self._batch_in_epoch + i} (global step "
                     f"{self.global_step + i}; step {i + 1} of a block of {len(batches)} from "
                     f"step {self._batch_in_epoch})")
        else:
            where = f"epoch {self.epoch}, {mode} batch {i} of {len(batches)}"
        raise CheckError.from_word(int(words[i]), where)

    def _advance(self, steps: int) -> None:
        self.optimizer.count += steps
        self.global_step += steps

    def _run_block(self, block: list, mode: str = "train") -> list:
        """The optimizer steps of ``block`` (:meth:`_dispatch`), counted;
        returns the per-step losses."""
        losses, _ = self._dispatch(block, mode)
        self._advance(len(block))
        return losses

    def train_batch(self, batch, mode: str = "train") -> torch.Tensor:
        """One optimizer step on ``batch`` (its one-step program); returns
        its loss as a host scalar tensor."""
        return torch.tensor(self._run_block([batch], mode)[0])

    def _blocks(self, batches: list, skip: int) -> list:
        """The epoch's remaining batches as dispatch blocks, each with one
        loss readback: blocks of S over the shared series, the tail short
        of S one batch at a time; on the fleet path (entered at a block
        boundary, ``skip % S == 0``, as the JAX trainer's), blocks of S
        within each run of one fleet city's batches, its tail and
        unassigned cities one batch at a time; otherwise one batch at a
        time."""
        S, rest = self.steps_per_superstep, batches[skip:]
        if self.train_path in ("series_superstep", "superstep"):
            full = len(rest) // S * S
            return [rest[i:i + S] for i in range(0, full, S)] + [[b] for b in rest[full:]]
        if self.train_path != "fleet_superstep" or skip % S:
            return [[b] for b in rest]
        blocks = []
        for city, run in itertools.groupby(rest, key=lambda b: b.city):
            run = list(run)
            full = len(run) // S * S if city in self._fleet_cities else 0
            blocks += [run[k:k + S] for k in range(0, full, S)] + [[b] for b in run[full:]]
        return blocks

    # -- the guard, health and preemption ------------------------------------
    def _guarded(self) -> list:
        opt = self.optimizer
        return list(opt.params) + opt.exp_avg + opt.exp_avg_sq

    @torch.no_grad()
    def _take_snapshot(self) -> None:
        """Copy the parameters and Adam's moments into the guard's buffers,
        on the programs' stream (ordered with their replays)."""
        live = self._guarded()
        if self._snapshot is None:
            self._snapshot = [torch.empty_like(t) for t in live]
        with self._ops.stream_context():
            for dst, src in zip(self._snapshot, live):
                dst.copy_(src)

    @torch.no_grad()
    def _rollback(self) -> None:
        """Copy the snapshot back into the live tensors, in place: the
        captured programs read and write those very tensors."""
        with self._ops.stream_context():
            for dst, src in zip(self._guarded(), self._snapshot):
                dst.copy_(src)

    def _set_lr_scale(self, scale: float) -> None:
        """The guard's cumulative lr cut (or a resumed run's): the optimizer
        scales its host-side scalars, so no program changes."""
        self._lr_scale = scale
        self.optimizer.lr_scale = scale

    def _health_due(self) -> bool:
        """Cadence gate, ticked once per dispatch unit (a block, or a
        step)."""
        if not self.health:
            return False
        due = self._health_counter % self.health_every_k == 0
        self._health_counter += 1
        return due

    def _health_out_path(self) -> str:
        return self._health_out or os.path.join(self.out_dir, "health.jsonl")

    def _health_emit(self, stats: np.ndarray, cities=None) -> None:
        """One health dispatch's rows (:meth:`_block_body`) as the JAX
        trainer's record: the last step's loss and norms, the block's
        non-finite counts, per-group norms and, for a fleet block
        (``cities``: its class's members by slot), each member's summed
        loss; published to the registry and appended to ``health.jsonl``."""
        names = [g for g, _ in self._health_groups]
        col = {c: i for i, c in enumerate(HEALTH_COLUMNS)}
        last = stats[-1]
        rec = {
            "kind": "train",
            "epoch": self.epoch,
            "step": self.global_step,
            "steps": int(stats.shape[0]),
            "loss": float(last[col["loss"]]),
            "grad_norm": float(last[col["grad_norm"]]),
            "update_ratio": float(last[col["update_ratio"]]),
            "nonfinite_grads": int(np.sum(stats[:, col["nonfinite_grads"]])),
            "nonfinite_loss": int(np.sum(stats[:, col["nonfinite_loss"]])),
            "group_norms": {g: float(v) for g, v in
                            zip(names, last[len(HEALTH_COLUMNS):len(HEALTH_COLUMNS) + len(names)])},
        }
        if cities is not None:
            csum = stats[:, len(HEALTH_COLUMNS) + len(names):].sum(axis=0)
            rec["city_loss"] = {str(cities[slot]): float(v) for slot, v in enumerate(csum)
                                if slot < len(cities)}
        publish_train_health(rec, REGISTRY)
        if not self.is_lead:  # every rank's record is the lead's; the lead writes it
            return
        if self._health_writer is None:
            os.makedirs(os.path.dirname(self._health_out_path()) or ".", exist_ok=True)
            self._health_writer = HealthWriter(self._health_out_path(),
                                               {"every_k": self.health_every_k,
                                                "groups": names})
        self._health_writer.write(rec)

    def _health_baseline_blob(self) -> dict:
        """The training-time drift baseline for checkpoint meta (the JAX
        trainer's ``_health_baseline_blob``): per city, the normalized
        series (``input``) and its denormalized values (``prediction``),
        stride-subsampled to at most 65,536 rows; cached."""
        if self._health_baseline_cache is not None:
            return self._health_baseline_cache
        from stmgcn_tpu_torch.obs.drift import baseline_from_samples

        ds, bins = self.dataset, self.health_sketch_size
        blob = {"schema_version": 1, "bins": bins, "input": {}, "prediction": {}}
        for c in range(getattr(ds, "n_cities", 1)):
            series = np.asarray(ds.series(c), dtype=np.float64)
            flat = series.reshape(-1, series.shape[-1])
            flat = flat[::max(1, flat.shape[0] // 65536)]
            denorm = ds.denormalize(flat, city=c) if self.hetero else ds.denormalize(flat)
            blob["input"][str(c)] = baseline_from_samples(flat, bins=bins)
            blob["prediction"][str(c)] = baseline_from_samples(
                np.asarray(denorm, dtype=np.float64), bins=bins)
        self._health_baseline_cache = blob
        return blob

    def _after_train_batch(self) -> None:
        """The step-cadence ``latest`` write and the SIGTERM safe point,
        after every consumed batch or block."""
        K = self.checkpoint_every_steps
        if K and self.global_step - self._last_cadence_step >= K:
            self._save(self.latest_path)
            self._last_cadence_step = self.global_step
        self._check_preempt()

    def _check_preempt(self) -> None:
        """After SIGTERM: write the emergency checkpoint here, a safe
        boundary whose meta cursor is consistent, and unwind with
        :class:`~stmgcn_tpu_torch.resilience.Preempted`. On a mesh the
        ranks agree first: every safe point sums the flag over all ranks,
        so a signal to any one of them stops every rank at the same
        boundary (a rank that stopped alone would leave its peers waiting
        in the next collective)."""
        stop = self._preempted
        if self.mesh is not None:
            flag = torch.tensor([float(stop)])
            stop = bool(comm.all_reduce(flag, "world", self.mesh, what="preempt").item())
        if not stop:
            return
        self._log(f"SIGTERM received — emergency checkpoint at epoch {self.epoch}, "
                  f"step {self.global_step}")
        self._save(self.latest_path)
        self.flush_checkpoints()
        raise Preempted(f"preempted at epoch {self.epoch}, step {self.global_step}; "
                        "restart with --resume auto to continue bit-exactly")

    # -- the loop -------------------------------------------------------------
    def _train_one(self, batch, retry: bool = False, placed=None, ahead=None) -> None:
        """One optimizer step with the fault plan and the guard (the JAX
        ``_train_one``). ``retry`` marks a deferred batch's re-run at the
        epoch's end: the plan is not consulted and the cursor does not
        advance. ``placed``: a streamed batch's upload, started ahead;
        ``ahead``: the next placement, run while the step does."""
        plan, guard = self.fault_plan, self._guard
        step = self._batch_in_epoch
        poisons = {}
        if not retry:
            plan.before_step(self.epoch, step)
            if plan.should_drop(self.epoch, step):
                self._batch_in_epoch += 1
                return
            poison = plan.poison_value(self.epoch, step)
            if poison is not None:
                poisons[0] = poison
        if guard is not None:
            self._take_snapshot()
        losses, stats = self._dispatch([batch], "train", self._health_due(), poisons, placed,
                                       ahead)
        loss = losses[0]
        if not retry:
            self._batch_in_epoch += 1
        if guard is not None and not self._all_finite([loss]):
            self._rollback()
            self._log(f"divergence guard: non-finite loss at epoch {self.epoch}, step {step} "
                      f"— rolled back, {guard.action} batch")
            if guard.lr_cut is not None:
                self._set_lr_scale(self._lr_scale * guard.lr_cut)
            guard.trip(loss, self.epoch, step)
            if guard.action == "defer" and not retry:
                self._deferred.append((step, batch))
            return  # no loss or count recorded; the step counts do not advance
        if guard is not None:
            guard.ok()
        self._advance(1)
        self._epoch_losses.append(loss)
        self._epoch_counts.append(batch.n_real)
        if stats is not None:
            self._health_emit(stats)

    def _steps_one_by_one(self, block: list) -> None:
        for batch in block:
            self._train_one(batch)
            self._after_train_batch()

    def _train_block(self, block: list) -> None:
        """A block of S steps as one program call, with the plan's step
        faults at its boundary (a ``drop`` inside runs it step by step;
        ``poison`` payloads go into the block's mask) and the guard's
        snapshot: on a non-finite loss the block is rolled back and
        replayed step by step, where the guard isolates the bad batch."""
        plan, guard, S = self.fault_plan, self._guard, len(block)
        start = self._batch_in_epoch
        plan.before_step(self.epoch, start, start + S)
        if plan.active and plan.any_drop(self.epoch, start, start + S):
            self._steps_one_by_one(block)
            return
        poisons = {}
        if plan.active:
            for s in range(S):
                poison = plan.poison_value(self.epoch, start + s)
                if poison is not None:
                    poisons[s] = poison
        if guard is not None:
            self._take_snapshot()
        losses, stats = self._dispatch(block, "train", self._health_due(), poisons)
        if guard is not None and not self._all_finite(losses):
            self._rollback()
            fleet = "fleet " if block[0].city in self._fleet_cities else ""
            self._log(f"divergence guard: non-finite loss in {fleet}superstep block at epoch "
                      f"{self.epoch}, steps {start}..{start + S - 1} — rolled back, "
                      "replaying per-step")
            self._steps_one_by_one(block)
            return
        if guard is not None:
            guard.ok()
        self._batch_in_epoch += S
        self._advance(S)
        self._epoch_losses += losses
        self._epoch_counts += [b.n_real for b in block]
        if stats is not None:
            cls = self._fleet_cities.get(block[0].city)
            self._health_emit(stats, cities=None if cls is None else
                              self.fleet_plan.classes[cls.cls].cities)
        self._after_train_batch()

    def _run_train_epoch(self) -> float:
        """The epoch's remaining batches in blocks (:meth:`_blocks`), then
        the guard's deferred batches once each; after a mid-epoch restore
        the first ``skip`` batches were consumed before the save, and the
        deferred ordinals it carried come first among the retries."""
        batches = list(self.batches("train", shuffle=self.shuffle))
        skip, self._resume_skip = self._resume_skip, 0
        if skip > len(batches):
            raise ValueError(f"resume cursor {skip} exceeds the epoch's {len(batches)} "
                             "batches — checkpoint from a different data configuration?")
        if skip == 0:
            self._epoch_losses, self._epoch_counts = [], []
        self._batch_in_epoch = skip
        resume_deferred, self._resume_deferred = self._resume_deferred, []
        unknown = sorted(o for o in resume_deferred if not 0 <= o < len(batches))
        if unknown:
            raise ValueError(f"mid-epoch checkpoint defers batch ordinals {unknown} that this "
                             "epoch does not produce — checkpoint from a different data "
                             "configuration?")
        self._deferred = [(o, batches[o]) for o in sorted(set(resume_deferred))]
        if not self._resident:  # streamed: one step per batch, placed ahead
            feed = self._placed_batches("train", shuffle=self.shuffle, skip=skip)
            for batch, placed in feed:
                self._train_one(batch, placed=placed, ahead=feed.advance)
                self._after_train_batch()
        for block in self._blocks(batches, skip) if self._resident else ():
            if len(block) == 1:
                self._train_one(block[0])
                self._after_train_batch()
            else:
                self._train_block(block)
        deferred, self._deferred = self._deferred, []
        for _, batch in deferred:  # guard action="defer": one retry at the epoch's end
            self._train_one(batch, retry=True)
            self._after_train_batch()
        return self._weighted(self._epoch_losses, self._epoch_counts)

    def _eval_batches(self, mode: str):
        """``(batch, placed)`` over an evaluation mode: index-only batches
        gathered when consumed on the resident routes (``placed`` None),
        host batches placed ahead when streaming."""
        if not self._resident:
            return self._placed_batches(mode)
        return ((batch, None) for batch in self.batches(mode))

    def _run_eval_epoch(self, mode: str) -> float:
        losses, counts, words = [], [], []
        san = self.sanitizer
        for batch, placed in self._eval_batches(mode):
            if san is not None:
                san.begin(self.device)
            x, y, mask = self.place(batch, mode, san, placed)
            data = self._cities[batch.city]
            losses.append(eval_step(self.model, data.supports, x, y, mask, self.loss,
                                    n_real=data.n_real, sanitizer=san, rows=self._rows,
                                    nodes=self._nodes(batch.city))[0])
            counts.append(batch.n_real)
            if san is not None:
                words.append(san.end())
            self._check_preempt()
        if san is not None:
            words = torch.stack(words)
            if self.mesh is not None:
                words = world_or(words, len(CHECK_SITES), self.mesh, what="checks")
            self._raise_flags(words.cpu().numpy(), counts, mode)
        losses = torch.stack(losses)
        if self.mesh is not None:  # the ranks' shares, summed once per epoch
            losses = replica_sum(losses, self.mesh, what="eval-loss")
        return self._weighted(losses.tolist(), counts)

    @staticmethod
    def _weighted(losses, counts) -> float:
        """Sample-weighted mean, a float32 dot as in the JAX trainer."""
        if not counts:
            raise ValueError("no samples in the mode")
        weights = torch.tensor(counts, dtype=torch.float32)
        return float(torch.tensor(losses, dtype=torch.float32) @ weights) / float(weights.sum())

    def train(self) -> dict:
        """Run the epoch loop; returns ``{"train": [...], "validate": [...]}``
        for the epochs run here. Pending checkpoint writes land before it
        returns, or before an exception leaves it. On the main thread,
        SIGTERM is caught while it runs (module docstring) and the previous
        handler restored on the way out."""
        history = {"train": [], "validate": []}
        self._event("train_start", f"Training starts at: {time.ctime()}")
        in_main = threading.current_thread() is threading.main_thread()
        previous = None
        if in_main:
            def on_sigterm(signum, frame):
                self._preempted = True

            previous = signal.signal(signal.SIGTERM, on_sigterm)
        # a mid-epoch cursor re-enters its epoch; a boundary starts the next
        start_epoch = self.epoch + (1 if self._resume_skip == 0 else 0)
        try:
            # on a mesh the backward's NaN check is the agreed _grad_check
            with (torch.autograd.set_detect_anomaly(True, check_nan=self.mesh is None)
                  if self.debug_nans else contextlib.nullcontext()):
                self._epoch_loop(history, start_epoch)
        except BaseException:
            try:  # the loop's own exception stays the one raised
                self.flush_checkpoints()
            except Exception as flush_exc:
                self._log(f"checkpoint flush failed during teardown: {flush_exc}")
            raise
        finally:
            if in_main:
                signal.signal(signal.SIGTERM, previous)
            if self._health_writer is not None:
                self._health_writer.flush()
        self.flush_checkpoints()
        self._event("train_end", f"Training ends at: {time.ctime()}")
        return history

    def _epoch_loop(self, history: dict, start_epoch: int) -> None:
        trc = obs_trace.active_tracer()
        for epoch in range(start_epoch, self.n_epochs + 1):
            self.epoch = epoch
            t0 = time.time()
            sp_epoch = None if trc is None else trc.span("train.epoch", epoch=epoch)
            sp = None if trc is None else trc.span("train.train_epoch")
            train_loss = self._run_train_epoch()
            if sp is not None:
                sp.end()
            self._check_preempt()
            sp = None if trc is None else trc.span("train.eval_epoch")
            val_loss = self._run_eval_epoch("validate")
            if sp is not None:
                sp.end()
            self._check_preempt()
            if epoch == start_epoch:
                # every block and tail program of the loop has been captured:
                # a later capture is a recapture (the JAX trainer's jaxmon mark)
                graphmon.mark_warmup_complete()
            # the epoch is consumed: the saves below point a resume at epoch + 1
            self._batch_in_epoch = 0
            self._epoch_losses, self._epoch_counts = [], []
            history["train"].append(train_loss)
            history["validate"].append(val_loss)
            if val_loss <= self.best_val:  # <= : reference Model_Trainer.py:48
                self._log(f"Epoch {epoch}, val_loss drops from {self.best_val:.5} to "
                          f"{val_loss:.5}. Updating best checkpoint..")
                self.best_val = val_loss
                self.patience_left = self.patience
                data = self._save(self.best_path)
                if self.top_k > 1:
                    # best-k snapshots reuse best.ckpt's bytes; ranked by
                    # (loss, newest first on ties) as the <= rule
                    path = os.path.join(self.out_dir, f"best_e{epoch}.ckpt")
                    self._queue("write", path, data)
                    self._kept.append((val_loss, -epoch, path))
                    self._kept.sort()
                    while len(self._kept) > self.top_k:
                        self._queue("rm", self._kept.pop()[2])
            else:
                self.patience_left -= 1
                self._log(f"Epoch {epoch}, val_loss {val_loss:.5} does not improve from "
                          f"{self.best_val:.5} (patience {self.patience_left})")
            self._save(self.latest_path)
            self._log(f"Epoch {epoch}: train_loss {train_loss:.6g}, val_loss "
                      f"{val_loss:.6g}, {time.time() - t0:.3f} s")
            if sp_epoch is not None:
                sp_epoch.end()
            if self.patience_left == 0:
                self._log(f"Early stopping at epoch {epoch}..")
                break
            self._check_preempt()  # SIGTERM during the bookkeeping

    @torch.no_grad()
    def _predict_mode(self, mode: str, state: Optional[dict] = None) -> dict:
        """Normalized ``(pred, true)`` over a mode's real samples and each
        city's real nodes, per city, with ``state`` (a ``state_dict``) or
        the live parameters."""
        preds, trues = {}, {}
        for batch, placed in self._eval_batches(mode):
            x, y, _ = self.place(batch, mode, placed=placed)
            if batch.y is not None:  # streamed: the metrics read the host arrays
                y = torch.from_numpy(np.asarray(batch.y))
            data = self._cities[batch.city]
            args = (data.supports, x, data.n_real)
            if state is None:
                pred = self.model(*args)
            else:
                pred = torch.func.functional_call(self.model, state, args)
            if self.mesh is not None:  # the whole batch on every rank
                pred = comm.all_gather(pred.contiguous(), "region", self.mesh,
                                       dim=pred.dim() - 2, what="predictions")
                pred = comm.all_gather(pred, "dp", self.mesh, what="predictions")
                if batch.y is None:
                    y = comm.all_gather(y.contiguous(), "region", self.mesh, dim=y.dim() - 2,
                                        what="targets")
                    y = comm.all_gather(y, "dp", self.mesh, what="targets")
            n = pred.shape[-2] - data.pad  # drop padded node rows
            preds.setdefault(batch.city, []).append(
                pred[: batch.n_real, ..., :n, :].float().cpu().numpy())
            trues.setdefault(batch.city, []).append(y[: batch.n_real, ..., :n, :].cpu().numpy())
        return {c: (np.concatenate(preds[c]), np.concatenate(trues[c])) for c in sorted(preds)}

    def test(self, modes=("train", "test"), checkpoint: Optional[str] = "best") -> dict:
        """Denormalized metrics per mode (``Model_Trainer.py:68-98``, train
        split re-scored too), with the parameters of ``out_dir/best.ckpt``
        (``checkpoint="best"``), of the checkpoint file at a path, or the
        live ones (``None``). The file's parameters are placed on the
        trainer's device; the live state is left as it is. Heterogeneous
        cities are denormalized each with its own normalizer and reported
        per city too (``per_city``); the overall report pools every city's
        raw-unit values."""
        # the warmed training loop is over: pin the recapture gauge
        graphmon.freeze_recaptures()
        state = None
        if checkpoint is not None:
            path = self.best_path if checkpoint == "best" else checkpoint
            self.flush_checkpoints()  # a pending write may own this path
            _, _, params, _ = self._lead_read(
                lambda: (path, *load_checkpoint(path, load_opt_state=False)))
            state = {k: v.to(self.device) for k, v in
                     from_jax_params(params, self.model.m_graphs, self._branches()).items()}
        sp_test = obs_trace.span("train.test")  # the shared no-op when tracing is off
        self._event("test_start", f"Testing starts at: {time.ctime()}")
        results = {}
        for mode in modes:
            per_city = self._predict_mode(mode, state)
            if self.hetero:
                raw = {c: tuple(self.dataset.denormalize(a, city=c) for a in pair)
                       for c, pair in per_city.items()}
                results[mode] = report = regression_report(
                    np.concatenate([p.ravel() for p, _ in raw.values()]),
                    np.concatenate([t.ravel() for _, t in raw.values()]))
                report["per_city"] = {f"city{c}": regression_report(p, t)
                                      for c, (p, t) in raw.items()}
            else:
                pred, true = (np.concatenate([pair[i] for pair in per_city.values()])
                              for i in (0, 1))
                results[mode] = report = regression_report(
                    self.dataset.denormalize(pred), self.dataset.denormalize(true))
            self._log(f"{mode} true MSE: {report['mse']:.6g}  RMSE: {report['rmse']:.6g}  "
                      f"MAE: {report['mae']:.6g}  MAPE: {report['mape'] * 100:.4g}%  "
                      f"PCC: {report['pcc']:.4g}")
            for name, rep in report.get("per_city", {}).items():
                self._log(f"  {mode}/{name} RMSE: {rep['rmse']:.6g}  MAE: {rep['mae']:.6g}  "
                          f"PCC: {rep['pcc']:.4g}")
        self._event("test_end", f"Testing ends at: {time.ctime()}")
        sp_test.end()
        return results
