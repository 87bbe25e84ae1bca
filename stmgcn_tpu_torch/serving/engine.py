"""Shape-bucketed serving engine with dynamic micro-batching.

Counterpart of ``stmgcn_tpu/serving/engine.py`` (``ServingEngine``):

- **shape buckets** — one program per ladder rung
  (``ServingConfig.buckets``); every batch is zero-padded up to the
  smallest covering rung, so the device only ever sees ladder shapes. The
  JAX engine compiles each rung ahead of time; here each rung is captured
  ahead of time as a CUDA graph (``graphs``, default on for CUDA;
  :mod:`stmgcn_tpu_torch.graphs`) over a static history buffer, so a
  request is one host->device copy, one replay and one readback, with
  concurrent callers serialized by the generation's pool lock;
  ``graphs=False`` (and the CPU) runs the same rung programs eagerly;
- **device-resident operands** — the support stack (for a metro-scale
  city, the tiled plan) is placed on the device once, and every
  generation's graphs read it there; the model and its rungs live behind
  one atomic ``(generation, model, programs)`` reference, so the history
  window is the only per-request upload and :meth:`ServingEngine.swap_params`
  hot-swaps new weights between dispatches, capturing the new
  generation's ladder (counted apart from recaptures) before publishing
  it. Every response can report the generation that produced it and is
  never mixed-generation — a dispatch reads the reference once;
- **dynamic micro-batching** — concurrent callers coalesce into the
  smallest covering rung (:mod:`stmgcn_tpu_torch.serving.microbatch`), with
  per-bucket latency/queue/pad-waste telemetry
  (:mod:`stmgcn_tpu_torch.serving.metrics`);
- **SLO admission + typed sheds** — with ``ServingConfig.deadline_ms`` /
  ``queue_bound_rows`` set, overload sheds at arrival with typed errors
  (:mod:`stmgcn_tpu_torch.serving.admission`); ``shed_policy="degrade"``
  serves shed requests inline at a smaller rung instead, and a wedged
  batcher degrades ``predict`` to the inline path. A
  :class:`~stmgcn_tpu_torch.serving.admission.GlobalBudget`
  (``global_budget=``) is drawn down by every engine that shares it, so a
  replica tier's pending rows stay bounded as a whole.

- **checkpoint hot-swap** — :meth:`ServingEngine.watch_checkpoints`
  polls a training run's ``out_dir`` (:class:`CheckpointWatcher`) and
  swaps each newer verified checkpoint in through ``swap_params``, and
  :meth:`ServingEngine.params_from_checkpoint` reads a checkpoint into the
  served model's ``state_dict`` layout (what the promotion gate scores);
- **drift** — :meth:`ServingEngine.enable_drift` attaches a
  :class:`~stmgcn_tpu_torch.obs.drift.DriftMonitor` that compares each
  dispatch's normalized inputs and denormalized predictions with the
  training-time baseline of checkpoint meta, on the host after the
  readback, outside the pool lock; ``from_forecaster`` attaches it when the
  checkpoint has a baseline and its config ``health.drift``, and
  ``swap_params`` resets it with the generation;
- **fault drills** — a :class:`~stmgcn_tpu_torch.resilience.ServeFaultPlan`
  (``fault_plan=``) reaches the micro-batcher at dispatch entry and the
  checkpoint watcher before each poll (``corrupt-checkpoint``);
- **export artifacts** — :meth:`ServingEngine.from_artifact` serves an
  :class:`~stmgcn_tpu_torch.export.ExportedForecaster`: each rung is the
  artifact's exported program (its LSTM the B1 operator) over the pinned
  supports, captured as a CUDA graph like any other rung; the parameters
  are baked into the program, so such an engine refuses ``swap_params``
  and checkpoint watching.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from stmgcn_tpu_torch.graphs import (
    CapturedProgram,
    DeviceOps,
    GraphPool,
    Program,
    resolve_graphs,
)
from stmgcn_tpu_torch.models.params import from_jax_params
from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.ops.spmm import place_supports
from stmgcn_tpu_torch.ops.tiling import TiledSupports
from stmgcn_tpu_torch.serving.admission import (
    AdmissionController,
    BatcherWedged,
    ShedError,
)
from stmgcn_tpu_torch.serving.bucketing import pad_to_bucket, smallest_covering_bucket
from stmgcn_tpu_torch.serving.metrics import EngineStats
from stmgcn_tpu_torch.serving.microbatch import MicroBatcher
from stmgcn_tpu_torch.train.checkpoint import load_checkpoint, load_latest_verified

__all__ = ["CheckpointWatcher", "Generation", "ServingEngine", "rung_program"]

#: bound on the re-dispatch loop that keeps multi-chunk responses on one
#: param generation — hit only under pathological swap churn
_SWAP_RETRIES = 20


def _bucket_program(sup_dev, device: torch.device):
    """A rung's forward, ``(model, history) -> predictions``, over the
    supports (a dense stack or a tiled plan) resident on ``device``; each
    generation builds its rung programs on it (:func:`rung_program`)."""

    def forward(model, history: torch.Tensor) -> torch.Tensor:
        return model(sup_dev, history)

    return forward


def rung_program(ops: DeviceOps, bucket: int, expected: tuple, forward: Callable, *,
                 graphs: bool, name: str, swap: bool = False, slots: bool = False):
    """One rung's program on ``ops``: ``forward(history[, slots])`` over a
    static ``(bucket, *expected)`` history buffer (and ``(bucket,)`` int
    slots). Under ``graphs`` it is captured into ``ops`` (a
    :class:`GraphPool`) here, warmed up on zeros; otherwise it runs eagerly
    on every call. Returns ``run(history[, slots]) -> predictions`` on the
    host; the history may be shorter than the rung (its tail rows are
    zeros)."""
    spec = {"history": ((bucket,) + tuple(expected), torch.float32)}
    if slots:
        spec["slots"] = ((bucket,), torch.int32)

    def body(v):
        with torch.inference_mode():
            args = (v["history"], v["slots"]) if slots else (v["history"],)
            return forward(*args).float()  # a bf16 model's predictions, exactly

    if graphs:
        program = CapturedProgram(body, spec, ops, name=name, swap=swap)
        program({})
    else:
        program = Program(body, spec, ops, name=name)

    def run(history: np.ndarray, slot_rows: Optional[np.ndarray] = None) -> np.ndarray:
        values = {"history": history}
        if slots:
            values["slots"] = slot_rows
        return program(values).numpy()

    return run


def params_from_checkpoint(path: str, m_graphs: int) -> dict:
    """A checkpoint's parameters as a ``state_dict`` of ``m_graphs``
    branches (the optimizer blob skipped)."""
    _, params, _ = load_checkpoint(path, load_opt_state=False)
    return from_jax_params(params, m_graphs)


def release_programs(generation: "Generation") -> "Generation":
    """``generation`` without its programs and pool: what a closed engine
    keeps (its number, for reports)."""
    return dataclasses.replace(generation, programs={}, pool=None)


@dataclasses.dataclass(frozen=True)
class Generation:
    """One parameter generation of an engine: its number, its model(s) and
    its rung programs (captured into ``pool``, or eager when ``pool`` is
    None). A dispatch reads the engine's one reference to it once."""

    number: int
    model: object
    programs: dict
    pool: Optional[GraphPool] = None


def swapped_copy(model, state_dict):
    """A fresh eval-mode copy of ``model`` loaded with ``state_dict``, which
    must match its keys, shapes and dtypes exactly (``swap_params``)."""
    live = model.state_dict()
    if set(state_dict) != set(live):
        raise ValueError(
            "swap_params: new params have different keys than the served "
            f"model (missing {sorted(set(live) - set(state_dict))}, "
            f"unexpected {sorted(set(state_dict) - set(live))})"
        )
    for name, t in live.items():
        new = state_dict[name]
        if tuple(new.shape) != tuple(t.shape) or new.dtype != t.dtype:
            raise ValueError(
                f"swap_params: {name} is {tuple(t.shape)}/{t.dtype} in the "
                f"served model, got {tuple(new.shape)}/{new.dtype}"
            )
    fresh = copy.deepcopy(model)
    fresh.load_state_dict(state_dict)
    return fresh.eval()


class CheckpointWatcher:
    """Hot-swap poller: the newest verified checkpoint in ``out_dir`` →
    ``engine.swap_params`` (the JAX package's ``CheckpointWatcher``).

    It watches by mtime and only ever moves forward: a new checkpoint that
    fails verification is quarantined by ``load_latest_verified`` and
    counted in :attr:`rejected`, and the engine keeps serving its current
    parameters rather than fall back to a checkpoint older than the live
    one. ``poll()`` is one synchronous scan; with ``poll_s`` a daemon
    thread calls it every ``poll_s`` seconds until :meth:`stop`. The
    engine's serve fault plan gets its ``corrupt-checkpoint`` shot before
    each scan, and a swap hands the engine the new checkpoint's
    ``health_baseline``.
    """

    #: stop() waits this long for an in-flight poll before detaching
    JOIN_TIMEOUT_S = 5.0

    def __init__(self, engine, out_dir: str, poll_s: Optional[float] = None, log=None):
        self._engine = engine
        self.out_dir = out_dir
        self.swaps = 0
        self.rejected = 0
        self.last_path: Optional[str] = None
        self._log = log if log is not None else (lambda msg: None)
        # start from the present: only checkpoints written from now on swap
        self._seen_mtime = self._newest_mtime() or -1.0
        self._applied_mtime = self._seen_mtime
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if poll_s is not None:
            self._thread = threading.Thread(target=self._loop, args=(float(poll_s),),
                                            name="stmgcn-ckpt-watch", daemon=True)
            self._thread.start()

    def _newest_mtime(self) -> Optional[float]:
        try:
            names = os.listdir(self.out_dir)
        except OSError:
            return None
        mtimes = []
        for name in names:
            if name.endswith(".ckpt"):
                try:
                    mtimes.append(os.path.getmtime(os.path.join(self.out_dir, name)))
                except OSError:
                    continue  # rotated away between listdir and stat
        return max(mtimes) if mtimes else None

    def _loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self.poll()
            except Exception as e:  # one bad scan must not end hot-swapping
                self._log(f"checkpoint watch: {type(e).__name__}: {e}")

    def _reject(self) -> bool:
        self.rejected += 1
        REGISTRY.counter("serving.ckpt_rejected").inc()
        return False

    def poll(self) -> bool:
        """One scan; returns True when a swap was applied."""
        plan = getattr(self._engine, "_fault_plan", None)
        if plan is not None:
            for path in plan.corrupt_checkpoints(self.out_dir):
                self._log(f"fault plan corrupted {path}")
        newest = self._newest_mtime()
        if newest is None or newest <= self._seen_mtime:
            return False
        self._seen_mtime = newest
        got = load_latest_verified(self.out_dir, load_opt_state=False, quarantine=True,
                                   log=self._log)
        if got is None:
            return self._reject()
        path, meta, params, _ = got
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = newest
        if mtime <= self._applied_mtime:
            # the newest file failed verification and the chain fell back to
            # something no newer than what is already serving
            return self._reject()
        self._engine.swap_params(from_jax_params(params, self._engine.m_graphs),
                                 health_baseline=meta.get("health_baseline"))
        self.swaps += 1
        self.last_path = path
        self._applied_mtime = mtime
        return True

    def stop(self, timeout_s: Optional[float] = None) -> bool:
        """Stop polling and join the thread within ``timeout_s`` (default
        :attr:`JOIN_TIMEOUT_S`); False when an in-flight poll outlasted it
        (the daemon thread then ends after that poll)."""
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(self.JOIN_TIMEOUT_S if timeout_s is None else timeout_s)
        if t.is_alive():
            REGISTRY.counter("serving.watcher_wedged").inc()
            self._log(f"checkpoint watch on {self.out_dir}: stop() timed out joining an "
                      "in-flight poll")
            return False
        self._thread = None
        return True


class ServingEngine:
    """Bucket ladder + micro-batcher over one model::

        engine = ServingEngine.from_forecaster(fc, supports)
        pred = engine.predict(history)          # micro-batched, raw units
        pred = engine.predict_direct(history)   # bypass the queue
        pred, gen = engine.predict(history, with_generation=True)
        engine.swap_params(new_state_dict)      # atomic
        engine.watch_checkpoints(out_dir).poll() # newer verified checkpoint in
        engine.stats.snapshot()                 # per-bucket telemetry
        engine.close()

    ``predict`` keeps the forecaster's validate → normalize → call →
    denormalize contract (normalization vectorized once per coalesced
    dispatch), so results agree with ``Forecaster.predict`` at any request
    size. Under an SLO config it raises the typed sheds of
    :mod:`stmgcn_tpu_torch.serving.admission` (or serves degraded inline
    when ``shed_policy="degrade"``).
    """

    def __init__(self, forwards, model, normalizer, expected, config, device, *,
                 graphs: bool = False, fault_plan=None, global_budget=None):
        # bucket -> forward(model, history): each rung's forward
        self._forwards = dict(forwards)
        #: whether each generation's rungs are captured CUDA graphs
        self.graphs = graphs
        self.normalizer = normalizer
        self.expected = tuple(expected)  # (seq_len, n_nodes, input_dim)
        self.config = config
        self.device = device
        self._buckets = tuple(sorted(self._forwards))
        self.stats = EngineStats()
        # ONE reference holds the generation (number, model, programs):
        # dispatches read it once, swaps replace it whole — a response is
        # never computed from a mix of generations (CPython reference reads
        # are atomic)
        self._current = self._generation(0, model)
        self.admission = (
            AdmissionController(config, self.stats, self._buckets,
                                global_budget=global_budget)
            if (config.deadline_ms is not None or config.queue_bound_rows
                or global_budget is not None)
            else None
        )
        self._fault_plan = fault_plan if fault_plan is not None and fault_plan.active else None
        self._batcher = MicroBatcher(
            self._run_program, self._buckets, config.max_delay_ms, self.stats,
            admission=self.admission, fault_plan=self._fault_plan,
        )
        self._watcher: Optional[CheckpointWatcher] = None
        #: the live drift monitor (None until :meth:`enable_drift`)
        self.drift = None
        self._drift_city = "0"
        self._closed = False
        #: the wrapped artifact of an engine built :meth:`from_artifact`
        #: (None otherwise), and the dense supports it was pinned to
        self.exported = None
        self.supports_np: Optional[np.ndarray] = None

    # -- construction ---------------------------------------------------

    @staticmethod
    def _resolve_config(config):
        from stmgcn_tpu_torch.config import ServingConfig

        cfg = config if config is not None else ServingConfig()
        bad = cfg.violations()
        if bad:
            raise ValueError("invalid serving config: " + "; ".join(bad))
        return cfg

    def _generation(self, number: int, model, swap: bool = False) -> Generation:
        """Generation ``number`` over ``model``: its rung programs, under
        ``graphs`` captured into one new pool (a swap's captures counted as
        such) before anything can read them."""
        ops = GraphPool(self.device) if self.graphs else DeviceOps(self.device)
        programs = {b: rung_program(ops, b, self.expected, functools.partial(fwd, model),
                                    graphs=self.graphs, name=f"serving rung {b}", swap=swap)
                    for b, fwd in self._forwards.items()}
        return Generation(number, model, programs, ops if self.graphs else None)

    @property
    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes the current generation's graph pool reserved
        (None when the rungs run eagerly)."""
        pool = self._current.pool
        return None if pool is None else pool.reserved_bytes

    @classmethod
    def from_forecaster(cls, fc, supports, *, config=None, city=None, device=None,
                        graphs: Optional[bool] = None, fault_plan=None,
                        global_budget=None) -> "ServingEngine":
        """Engine over a :class:`~stmgcn_tpu_torch.inference.Forecaster`
        (over one city of a heterogeneous checkpoint, whose normalizer and
        region count it bakes in: ``city=``, checked as
        ``Forecaster.city_view`` checks it).

        ``device=None`` means the GPU (and raises without one). The
        supports — a dense ``(M, K, N, N)`` stack, or for the large-N path
        a :class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports` plan served
        by a tiled model — are validated against the model and placed on
        the device once, where they stay across ``swap_params``; the
        engine serves its own copy of the forecaster's model. ``graphs``
        captures one CUDA graph per rung here and per rung at every swap
        (``None``: on for CUDA; ``True`` on the CPU raises); ``graphs=False``
        runs each rung eagerly. ``fault_plan`` is a
        :class:`~stmgcn_tpu_torch.resilience.ServeFaultPlan`;
        ``global_budget`` a :class:`~stmgcn_tpu_torch.serving.admission.GlobalBudget`
        the engine's admission draws down (with engines sharing it). The
        drift monitor is attached when the checkpoint carries a
        ``health_baseline`` and its config enables ``health.drift``.
        """
        device = resolve_device(device)
        graphs = resolve_graphs(graphs, device)
        cfg = cls._resolve_config(
            config if config is not None else getattr(fc.config, "serving", None)
        )
        model = fc.model
        if fc.normalizers is not None and city is None:
            raise ValueError("heterogeneous multi-city checkpoint: the engine bakes one "
                             "city's region count and normalizer — pass city=")
        normalizer, expected = fc.city_view(city)
        n_nodes = expected[1]
        if isinstance(supports, TiledSupports):
            got = (supports.m_graphs, supports.n_supports, supports.n)
            want = (model.m_graphs, model.n_supports, n_nodes)
            if got != want:
                raise ValueError(f"tiled supports must plan (M, K, N)={want}, got {got}")
        else:
            want = (model.m_graphs, model.n_supports, n_nodes, n_nodes)
            supports = np.asarray(supports, dtype=np.float32)
            if supports.shape != want:
                raise ValueError(f"supports must be {want}, got {supports.shape}")
        sup_dev = place_supports(supports, device)
        model.check_supports(sup_dev)
        forward = _bucket_program(sup_dev, device)
        served = copy.deepcopy(model).to(device).eval()
        engine = cls({b: forward for b in cfg.buckets}, served, normalizer, expected, cfg,
                     device, graphs=graphs, fault_plan=fault_plan, global_budget=global_budget)
        baseline = getattr(fc, "health_baseline", None)
        health = getattr(fc.config, "health", None)
        if baseline is not None and health is not None and health.drift:
            engine.enable_drift(baseline, city=city if city is not None else 0)
        return engine

    @classmethod
    def from_artifact(cls, source, supports, *, config=None, device=None,
                      graphs: Optional[bool] = None, fault_plan=None) -> "ServingEngine":
        """Engine over an export artifact: a path, or a loaded
        :class:`~stmgcn_tpu_torch.export.ExportedForecaster` (the JAX
        engine's ``from_artifact``).

        ``device=None`` means the GPU for a path (and raises without one);
        a loaded artifact serves on its own device. Each rung of the ladder
        runs the artifact's exported program over the dense ``(M, K, N,
        N)`` ``supports``, placed on the device once; under ``graphs`` (the
        default on CUDA) each rung is captured as one CUDA graph, as
        :meth:`from_forecaster` captures them. The artifact's own
        ``predict`` is re-routed through this engine's ladder (the same
        supports required). The parameters are baked into the program, so
        :meth:`swap_params` and :meth:`watch_checkpoints` raise: rebuild
        from a new artifact.
        """
        from stmgcn_tpu_torch.export import ExportedForecaster

        if isinstance(source, ExportedForecaster):
            ex = source
            if device is not None and torch.device(device) != ex.device:
                raise ValueError(f"the artifact was loaded on {ex.device}, not {device}: "
                                 "load it there, or pass its path")
        else:
            ex = ExportedForecaster.load(source, device=device)
        device = ex.device
        graphs = resolve_graphs(graphs, device)
        cfg = cls._resolve_config(config)
        supports_np = ex.check_supports(supports)
        forward = _bucket_program(torch.as_tensor(supports_np, device=device), device)
        meta = ex.meta
        expected = (meta["seq_len"], meta["n_nodes"], meta["input_dim"])
        engine = cls({b: forward for b in cfg.buckets}, ex.module, ex.normalizer, expected,
                     cfg, device, graphs=graphs, fault_plan=fault_plan)
        engine.exported, engine.supports_np = ex, supports_np
        ex._engine = engine  # route ex.predict through the bucket ladder
        return engine

    def _refuse_baked(self, what: str) -> None:
        if self.exported is not None:
            raise RuntimeError(
                f"this engine was built from_artifact — the parameters are baked into "
                f"the exported program, so it cannot {what}; rebuild the engine from a "
                "new artifact")

    # -- drift ----------------------------------------------------------

    def enable_drift(self, baseline: dict, *, city: int = 0, registry=REGISTRY):
        """Attach a :class:`~stmgcn_tpu_torch.obs.drift.DriftMonitor`
        comparing live traffic with a training-time ``health_baseline``
        blob (checkpoint meta), as ``city``. Returns the monitor."""
        from stmgcn_tpu_torch.obs.drift import DriftMonitor

        self._drift_city = str(city)
        self.drift = DriftMonitor(baseline, registry=registry, generation=self.generation)
        return self.drift

    def drift_snapshot(self) -> Optional[dict]:
        """JSON-able live drift state, or None without a monitor."""
        return None if self.drift is None else self.drift.snapshot()

    # -- hot swap --------------------------------------------------------

    @property
    def generation(self) -> int:
        """Monotonic param-generation counter (0 = construction params)."""
        return self._current.number

    def swap_params(self, state_dict, *, health_baseline: Optional[dict] = None) -> int:
        """Atomically replace the serving parameters; returns the new
        generation.

        ``state_dict`` must match the served model's keys, shapes and
        dtypes exactly. The new weights load into a fresh copy of the
        model (whose rungs are captured first, under ``graphs``), which is
        published as one reference swap: in-flight dispatches finish on the
        generation they read at entry, every later dispatch sees the new
        one. An attached drift monitor resets with it (to
        ``health_baseline`` when given), and observes no dispatch of an
        older generation after that.
        """
        self._refuse_baked("swap_params")
        cur = self._current
        gen = cur.number + 1
        self._current = self._generation(gen, swapped_copy(cur.model, state_dict), swap=True)
        if self.drift is not None:
            self.drift.reset(gen, baseline=health_baseline)
        REGISTRY.counter("serving.swaps").inc()
        REGISTRY.gauge("serving.generation").set(gen)
        return gen

    @property
    def m_graphs(self) -> int:
        """The served model's branch count (what a checkpoint tree needs)."""
        return self._current.model.m_graphs

    def params_from_checkpoint(self, path: str) -> dict:
        """The parameters of checkpoint ``path`` as the served model's
        ``state_dict`` (CPU tensors, what ``swap_params`` takes; the JAX
        engine's ``_params_template`` load). Raises on a corrupt file."""
        return params_from_checkpoint(path, self.m_graphs)

    def watch_checkpoints(self, out_dir: str, *, poll_s: Optional[float] = None,
                          log=None) -> CheckpointWatcher:
        """Hot-swap new verified checkpoints from ``out_dir`` as they land.

        ``poll_s=None`` returns a passive watcher: call its ``poll()``
        yourself. With ``poll_s`` a daemon thread polls on that period until
        its ``stop()`` or the engine's ``close()``. Corrupt checkpoints are
        quarantined and never swapped in (counted in ``rejected``); the
        engine keeps its current parameters.
        """
        self._refuse_baked("hot-swap checkpoints")
        if self._watcher is not None:
            self._watcher.stop()
        self._watcher = CheckpointWatcher(self, out_dir, poll_s, log)
        return self._watcher

    # -- serving --------------------------------------------------------

    @property
    def buckets(self) -> tuple:
        return self._buckets

    def _run_program(self, payload: np.ndarray, bucket: int, segments):
        """One dispatch: normalize (vectorized, once per *batch*), pad to
        the rung, run the rung's program, denormalize. Returns
        ``(predictions, generation)``; the batcher stamps the generation
        on every coalesced request. ``segments`` is ``((offset, n_rows,
        pre_normalized), ...)`` in payload order; pre-normalized rows are
        kept verbatim."""
        current = self._current  # ONE read — whole dispatch, one gen
        norm = self.normalizer
        if norm is None or all(pre for _, _, pre in segments):
            batch = payload
        else:
            batch = norm.transform(payload)
            for ofs, n, pre in segments:
                if pre:
                    batch[ofs:ofs + n] = payload[ofs:ofs + n]
        out = current.programs[bucket](pad_to_bucket(batch, bucket))
        out = norm.inverse(out) if norm is not None else out
        drift = self.drift
        if drift is not None and drift.generation == current.number:
            # the real rows only, on the host after the readback (the pool
            # lock is released): padded rows are bucket filler, not traffic
            n_rows = payload.shape[0]
            drift.observe_input(self._drift_city, batch[:n_rows])
            drift.observe_prediction(self._drift_city, out[:n_rows])
        return out, current.number

    def _call_batched(self, history: np.ndarray, normalized: bool):
        """Micro-batched path; returns ``(out, generation)`` with every
        chunk of an oversized batch on the SAME generation (stale chunks
        re-dispatch until the generations agree)."""
        cap = self._buckets[-1]
        if history.shape[0] <= cap:
            return self._batcher.submit(history, tag=normalized, with_info=True)
        return self._same_generation(
            history, cap,
            lambda chunk: self._batcher.submit(chunk, tag=normalized, with_info=True),
        )

    def _dispatch_inline(self, chunk: np.ndarray, normalized: bool):
        bucket = smallest_covering_bucket(chunk.shape[0], self._buckets)
        t0 = time.perf_counter()
        out, gen = self._run_program(
            chunk, bucket, ((0, chunk.shape[0], normalized),)
        )
        device_ms = (time.perf_counter() - t0) * 1e3
        self.stats.record_dispatch(bucket, chunk.shape[0], [0.0], device_ms)
        return out[:chunk.shape[0]], gen

    def _call_direct(self, history: np.ndarray, normalized: bool,
                     cap: Optional[int] = None):
        """Inline path; ``cap`` chunks at a smaller rung (the degrade
        policy's knob). Same one-generation rule as the batched path."""
        cap = cap if cap is not None else self._buckets[-1]
        return self._same_generation(
            history, cap, lambda chunk: self._dispatch_inline(chunk, normalized)
        )

    @staticmethod
    def _same_generation(history: np.ndarray, cap: int, dispatch):
        """Split ``history`` into ``cap``-row chunks, dispatch each, and
        re-dispatch stale chunks until every chunk carries one generation
        (generations only move forward, so the loop converges unless
        swaps outrun dispatches)."""
        spans = [
            (i, min(i + cap, history.shape[0]))
            for i in range(0, history.shape[0], cap)
        ]
        parts: list = [None] * len(spans)
        gens: list = [None] * len(spans)
        for _ in range(_SWAP_RETRIES):
            target = max((g for g in gens if g is not None), default=None)
            for k, (i, j) in enumerate(spans):
                if gens[k] is None or gens[k] != target:
                    parts[k], gens[k] = dispatch(history[i:j])
            if len(set(gens)) == 1:
                out = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
                return out, gens[0]
        raise RuntimeError(
            "could not assemble a single-generation response in "
            f"{_SWAP_RETRIES} rounds — params are swapping faster than "
            "dispatches complete"
        )

    def _validate(self, history) -> np.ndarray:
        history = np.asarray(history, dtype=np.float32)
        if history.ndim != 4 or history.shape[1:] != self.expected:
            raise ValueError(
                f"history must be (B, seq_len={self.expected[0]}, "
                f"n_nodes={self.expected[1]}, n_feats={self.expected[2]}) "
                f"for this model, got {history.shape}"
            )
        return history

    def predict(self, history, *, normalized: bool = False,
                with_generation: bool = False) -> np.ndarray:
        """Micro-batched raw-units forecast — the concurrent-caller path.

        Blocks until this request's coalesced dispatch completes. Sheds
        raise :class:`~stmgcn_tpu_torch.serving.admission.Overloaded` /
        :class:`~stmgcn_tpu_torch.serving.admission.DeadlineExceeded`
        under ``shed_policy="reject"``; ``"degrade"`` serves the request
        inline at ``degrade_rung`` instead. A wedged batcher falls back to
        the inline path — callers never hang. ``with_generation=True``
        returns ``(pred, generation)``.
        """
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        h = self._validate(history)
        try:
            out, gen = self._call_batched(h, normalized)
        except BatcherWedged:
            out, gen = self._call_direct(h, normalized)
        except ShedError:
            if self.config.shed_policy != "degrade":
                raise
            self.stats.record_shed("degraded")
            out, gen = self._call_direct(
                h, normalized,
                cap=self.config.degrade_rung or self._buckets[0],
            )
        return (out, gen) if with_generation else out

    def predict_direct(self, history, *, normalized: bool = False,
                       with_generation: bool = False) -> np.ndarray:
        """Bypass the queue: pad to the covering rung and dispatch inline
        (the latency-critical single-caller path; same results).
        ``with_generation=True`` returns ``(pred, generation)``."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        out, gen = self._call_direct(self._validate(history), normalized)
        return (out, gen) if with_generation else out

    def close(self) -> None:
        """Stop the watcher and the batcher, and release the generation's
        programs (its graph pool's memory returns to the allocator once no
        dispatch still holds it)."""
        if not self._closed:
            self._closed = True
            if self._watcher is not None:
                self._watcher.stop()
            self._batcher.close()
            self._current = release_programs(self._current)
            if self.exported is not None and self.exported._engine is self:
                self.exported._engine = None  # the artifact serves on its own again

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
