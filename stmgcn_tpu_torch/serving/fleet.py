"""Fleet serving: one engine, many cities, per-shape-class programs.

Counterpart of ``stmgcn_tpu/serving/fleet.py`` (``FleetServingEngine``).
:class:`~stmgcn_tpu_torch.serving.engine.ServingEngine` pins one city: its
region count, normalizer and supports are fixed at construction, so
concurrent requests for different cities never coalesce. Here the cities
of one heterogeneous checkpoint group into shape classes by the planner
training uses (:func:`~stmgcn_tpu_torch.data.fleet.plan_shape_classes`).
Each class keeps a ``(members, M, K, rung, rung)`` support stack and a
``(members,)`` real-node count on the device and its own micro-batcher; a
``(city -> class)`` routing layer lets requests for different cities of
one class coalesce into one dispatch (counted in
:attr:`FleetServingEngine.cross_city_dispatches`). Every row of a dispatch
gathers its city's stack and count by slot, so the dense conv runs over
per-row supports and the gate pools over each row's real nodes (an exact
fit takes the plain mean). Normalization touches only a city's real-node
slice, and padded node rows are stripped before return, so results agree
with per-city ``Forecaster.predict``.

Cities the planner leaves unassigned get a private exact-fit class. A city
whose supports are a :class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports`
plan always serves in a private exact-fit class, through the tiled model
(the plan owns its whole reordered node axis), never with per-row stacks.
The models of every class sit behind one ``(generation, models,
programs)`` reference, so one ``swap_params`` (or the checkpoint watcher)
re-points the whole fleet, and every dispatch reads one generation.

With ``graphs`` (default on for CUDA) each (class, batch rung) is one CUDA
graph, the counterpart of the JAX engine's one compiled program per
(class, bucket): a dense class's graph takes the rows' slots as a static
int buffer and gathers each row's support stack and real-node count
inside the graph; a tiled city's private class binds its plan. A swap
captures the new generation's programs before publishing them.

One drift monitor (:meth:`FleetServingEngine.enable_drift`) keeps a sketch
per city: each dispatch's segments are observed over their city's real-node
slice, after the readback. A :class:`~stmgcn_tpu_torch.resilience.ServeFaultPlan`
(``fault_plan=``) reaches every class's micro-batcher, each counting its
own dispatch ordinals, and the checkpoint watcher. A
:class:`~stmgcn_tpu_torch.serving.admission.GlobalBudget`
(``global_budget=``) is shared by every class's admission controller, and
by every engine of a replica tier that was given it.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from stmgcn_tpu_torch.graphs import DeviceOps, GraphPool, resolve_graphs
from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.ops.tiling import TiledSupports
from stmgcn_tpu_torch.serving.admission import AdmissionController, BatcherWedged, ShedError
from stmgcn_tpu_torch.serving.bucketing import pad_to_bucket, smallest_covering_bucket
from stmgcn_tpu_torch.serving.engine import (
    CheckpointWatcher,
    Generation,
    ServingEngine,
    params_from_checkpoint,
    release_programs,
    rung_program,
    swapped_copy,
)
from stmgcn_tpu_torch.serving.metrics import EngineStats
from stmgcn_tpu_torch.serving.microbatch import MicroBatcher

__all__ = ["FleetServingEngine"]


def _dense_forward(models, stack_dev, n_real_dev):
    """A dense class's forward ``(history, slots)``: each row takes its
    city's support stack and real-node count by slot."""

    def forward(history, slots):
        return models["dense"](stack_dev.index_select(0, slots), history,
                               n_real_dev.index_select(0, slots))

    return forward


def _tiled_forward(models, plan_dev):
    """A tiled city's private exact-fit forward (no slot gather)."""

    def forward(history, slots):
        return models["tiled"](plan_dev, history)

    return forward


class FleetServingEngine:
    """City-routed, class-coalesced serving over one heterogeneous
    checkpoint::

        engine = FleetServingEngine.from_forecaster(fc, city_supports)
        pred = engine.predict(history, city=1)        # micro-batched
        pred = engine.predict_direct(history, city=0) # bypass the queue
        engine.swap_params(new_state_dict)            # whole fleet, atomic
        engine.class_stats[engine.class_of(1)].snapshot()
        engine.cross_city_dispatches                  # coalescing proof
        engine.close()
    """

    def __init__(self, plan, groups, forwards, batch_buckets, normalizers, city_n, seq_len,
                 input_dim, config, models, m_graphs: int, *, graphs: bool, device,
                 fault_plan=None, global_budget=None):
        #: the shape-class plan (the extra exact-fit classes of unassigned
        #: and tiled cities appear in ``groups`` only)
        self.plan = plan
        self._groups = tuple(groups)  # (rung, (city, ...)) per class
        #: class -> ``forward(models) -> (history, slots) -> out``
        self._forwards = forwards
        #: whether each generation's (class, rung) programs are captured
        self.graphs = graphs
        self.device = device
        self._buckets = tuple(sorted(batch_buckets))
        self._normalizers = list(normalizers)
        self._city_n = list(city_n)
        self._seq_len = seq_len
        self._input_dim = input_dim
        self.config = config
        self.m_graphs = m_graphs
        self._city_cls: dict = {}
        self._city_slot: dict = {}
        for ci, (_, cities) in enumerate(self._groups):
            for slot, c in enumerate(cities):
                self._city_cls[c] = ci
                self._city_slot[c] = slot
        #: dispatches whose coalesced rows spanned more than one city
        self.cross_city_dispatches = 0
        # ONE reference holds the generation (number, models, programs)
        # for the whole fleet
        self._current = self._generation(0, models)
        self._watcher: Optional[CheckpointWatcher] = None
        #: per-class telemetry (bucket keys are batch rungs)
        self.class_stats = {ci: EngineStats() for ci in range(len(self._groups))}
        slo = (config.deadline_ms is not None or config.queue_bound_rows
               or global_budget is not None)
        self.class_admission = {
            ci: AdmissionController(config, self.class_stats[ci], self._buckets,
                                    global_budget=global_budget) if slo else None
            for ci in range(len(self._groups))
        }
        self._fault_plan = fault_plan if fault_plan is not None and fault_plan.active else None
        self._batchers = {
            ci: MicroBatcher(
                lambda payload, bucket, segments, k=ci: self._run_program(
                    k, payload, bucket, segments),
                self._buckets, config.max_delay_ms, self.class_stats[ci],
                admission=self.class_admission[ci], fault_plan=self._fault_plan,
            )
            for ci in range(len(self._groups))
        }
        #: the live drift monitor, per-city sketches inside (None until
        #: :meth:`enable_drift`)
        self.drift = None
        self._closed = False

    # -- construction ---------------------------------------------------

    def _generation(self, number: int, models, swap: bool = False) -> Generation:
        """Generation ``number`` over ``models``: each class's programs by
        batch rung, under ``graphs`` captured into one new pool first."""
        ops = GraphPool(self.device) if self.graphs else DeviceOps(self.device)
        programs = {}
        for ci, forward in self._forwards.items():
            fwd = forward(models)
            expected = (self._seq_len, self._groups[ci][0], self._input_dim)
            programs[ci] = {b: rung_program(ops, b, expected, fwd, graphs=self.graphs,
                                            swap=swap, slots=True,
                                            name=f"fleet class {ci} rung {b}")
                            for b in self._buckets}
        return Generation(number, models, programs, ops if self.graphs else None)

    @property
    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes the current generation's graph pool reserved
        (None when the classes run eagerly)."""
        pool = self._current.pool
        return None if pool is None else pool.reserved_bytes

    @classmethod
    def from_forecaster(cls, fc, city_supports, *, config=None, max_classes: int = 8,
                        max_pad_waste: float = 0.5, fault_plan=None, global_budget=None,
                        device=None, graphs: Optional[bool] = None) -> "FleetServingEngine":
        """Engine over a heterogeneous multi-city
        :class:`~stmgcn_tpu_torch.inference.Forecaster`.

        ``city_supports``: one dense ``(M, K, n_c, n_c)`` stack or one
        ``TiledSupports`` plan per city (a ``CitySupports`` or a plain
        sequence). The checkpoint's weights serve in a dense model (and a
        tiled one when a city brings a plan), on ``device`` (``None``
        means the GPU); each dense class's rung-padded support stack and
        real-node counts are placed there once. ``graphs`` captures one CUDA
        graph per (class, batch rung) here and at every swap (``None``: on
        for CUDA; ``True`` on the CPU raises); ``graphs=False`` runs them
        eagerly. ``fault_plan`` is a
        :class:`~stmgcn_tpu_torch.resilience.ServeFaultPlan`;
        ``global_budget`` a :class:`~stmgcn_tpu_torch.serving.admission.GlobalBudget`
        every class's admission draws down. The drift monitor is attached
        when the checkpoint carries a ``health_baseline`` and its config
        enables ``health.drift``.
        """
        from stmgcn_tpu_torch.data.fleet import plan_shape_classes
        from stmgcn_tpu_torch.experiment import build_model

        device = resolve_device(device)
        graphs = resolve_graphs(graphs, device)
        cfg = ServingEngine._resolve_config(
            config if config is not None else getattr(fc.config, "serving", None))
        if getattr(fc, "normalizers", None) is None:
            raise ValueError(
                "FleetServingEngine needs a heterogeneous multi-city checkpoint "
                "(per-city normalizers) — homogeneous checkpoints use ServingEngine")
        n_nodes = [int(n) for n in fc.derived["n_nodes"]]
        sups = list(getattr(city_supports, "per_city", city_supports))
        if len(sups) != len(n_nodes):
            raise ValueError(f"got {len(sups)} support stacks for {len(n_nodes)} cities")
        m, k = fc.model.m_graphs, fc.model.n_supports
        tiled_cities = frozenset(c for c, s in enumerate(sups) if isinstance(s, TiledSupports))
        for c, (s, n) in enumerate(zip(sups, n_nodes)):
            if c in tiled_cities:
                got, want = (s.m_graphs, s.n_supports, s.n), (m, k, n)
                if got != want:
                    raise ValueError(f"city {c} tiled supports must plan (M, K, N)={want}, "
                                     f"got {got}")
                continue
            sups[c] = np.asarray(s, dtype=np.float32)
            if sups[c].shape != (m, k, n, n):
                raise ValueError(f"city {c} supports must be {(m, k, n, n)}, got "
                                 f"{sups[c].shape}")
        plan = plan_shape_classes(n_nodes, max_classes=max_classes, max_pad_waste=max_pad_waste)
        groups = []
        for sc in plan.classes:
            dense_members = tuple(c for c in sc.cities if c not in tiled_cities)
            if dense_members:
                groups.append((sc.n_nodes, dense_members))
        groups += [(n_nodes[c], (c,)) for c in plan.unassigned if c not in tiled_cities]
        groups += [(n_nodes[c], (c,)) for c in sorted(tiled_cities)]

        # the weights are the same in every support mode: one model per form
        state = fc.model.state_dict()
        models = {}
        for kind in {"tiled" if c in tiled_cities else "dense" for c in range(len(sups))}:
            mcfg = dataclasses.replace(fc.config.model, tiled=kind == "tiled", sparse=False)
            model = build_model(dataclasses.replace(fc.config, model=mcfg),
                                fc.derived["input_dim"], device=device)
            model.load_state_dict(state)
            models[kind] = model.eval()
        forwards = {}
        for ci, (rung, cities) in enumerate(groups):
            if cities[0] in tiled_cities:
                forwards[ci] = functools.partial(_tiled_forward,
                                                 plan_dev=sups[cities[0]].to(device))
                continue
            stack = np.zeros((len(cities), m, k, rung, rung), np.float32)
            for slot, c in enumerate(cities):
                stack[slot, :, :, :n_nodes[c], :n_nodes[c]] = sups[c]
            n_real = torch.tensor([n_nodes[c] for c in cities], dtype=torch.int32,
                                  device=device)
            forwards[ci] = functools.partial(_dense_forward,
                                             stack_dev=torch.as_tensor(stack, device=device),
                                             n_real_dev=n_real)
        engine = cls(plan, groups, forwards, cfg.buckets, fc.normalizers, n_nodes, fc.seq_len,
                     fc.derived["input_dim"], cfg, models, m, graphs=graphs, device=device,
                     fault_plan=fault_plan, global_budget=global_budget)
        baseline = getattr(fc, "health_baseline", None)
        health = getattr(fc.config, "health", None)
        if baseline is not None and health is not None and health.drift:
            engine.enable_drift(baseline)
        return engine

    # -- drift ----------------------------------------------------------

    def enable_drift(self, baseline: dict, *, registry=REGISTRY):
        """Attach a :class:`~stmgcn_tpu_torch.obs.drift.DriftMonitor`
        comparing each city's live traffic with its training-time baseline
        (checkpoint meta ``health_baseline``). Returns the monitor."""
        from stmgcn_tpu_torch.obs.drift import DriftMonitor

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
        """Atomically re-point every shape class at new parameters (a
        ``state_dict`` matching the served models'); returns the new
        generation. In-flight dispatches finish on the generation they
        read at entry; under ``graphs`` the new generation's programs are
        captured before it is published. An attached drift monitor resets
        with it, as :meth:`ServingEngine.swap_params`'."""
        cur = self._current
        gen = cur.number + 1
        fresh = {kind: swapped_copy(model, state_dict) for kind, model in cur.model.items()}
        self._current = self._generation(gen, fresh, swap=True)
        if self.drift is not None:
            self.drift.reset(gen, baseline=health_baseline)
        REGISTRY.counter("serving.swaps").inc()
        REGISTRY.gauge("serving.generation").set(gen)
        return gen

    def params_from_checkpoint(self, path: str) -> dict:
        """The parameters of checkpoint ``path`` as the served models'
        ``state_dict`` (:meth:`ServingEngine.params_from_checkpoint`)."""
        return params_from_checkpoint(path, self.m_graphs)

    def watch_checkpoints(self, out_dir: str, *, poll_s: Optional[float] = None,
                          log=None) -> CheckpointWatcher:
        """Hot-swap new verified checkpoints from ``out_dir`` fleet-wide
        (:meth:`ServingEngine.watch_checkpoints`' semantics)."""
        if self._watcher is not None:
            self._watcher.stop()
        self._watcher = CheckpointWatcher(self, out_dir, poll_s, log)
        return self._watcher

    # -- serving --------------------------------------------------------

    @property
    def buckets(self) -> tuple:
        return self._buckets

    @property
    def n_cities(self) -> int:
        return len(self._city_n)

    def class_of(self, city: int) -> int:
        """The shape class a city routes to."""
        self._check_city(city)
        return self._city_cls[city]

    def _check_city(self, city) -> None:
        if city not in self._city_cls:
            raise ValueError(f"city must be in [0, {len(self._city_n)}), got {city}")

    def _run_program(self, cls_id: int, payload: np.ndarray, bucket: int, segments):
        """One coalesced dispatch of a class; returns ``(predictions,
        generation)``. ``segments`` is ``((offset, n_rows, (city,
        pre_normalized)), ...)``: each segment is normalized over its
        city's real-node slice only (padded node rows stay zero), and
        denormalized likewise; ``predict`` strips the padded rows."""
        current = self._current  # ONE read — whole dispatch, one gen
        if all(pre for _, _, (_, pre) in segments):
            batch = payload
        else:
            batch = payload.copy()
            for ofs, n, (c, pre) in segments:
                norm = self._normalizers[c]
                if not pre and norm is not None:
                    nc = self._city_n[c]
                    batch[ofs:ofs + n, :, :nc, :] = norm.transform(payload[ofs:ofs + n, :, :nc, :])
        slots = np.zeros(bucket, np.int32)
        for ofs, n, (c, _) in segments:
            slots[ofs:ofs + n] = self._city_slot[c]
        out = current.programs[cls_id][bucket](pad_to_bucket(batch, bucket), slots)
        for ofs, n, (c, _) in segments:
            norm = self._normalizers[c]
            if norm is not None:
                nc = self._city_n[c]
                out[ofs:ofs + n, ..., :nc, :] = norm.inverse(out[ofs:ofs + n, ..., :nc, :])
        drift = self.drift
        if drift is not None and drift.generation == current.number:
            # per segment, over its city's real nodes: padded node columns
            # are class filler, not any city's traffic
            for ofs, n, (c, _) in segments:
                nc = self._city_n[c]
                drift.observe_input(c, batch[ofs:ofs + n, :, :nc, :])
                drift.observe_prediction(c, out[ofs:ofs + n, ..., :nc, :])
        if len({c for _, _, (c, _) in segments}) > 1:
            self.cross_city_dispatches += 1
        return out, current.number

    def _validate(self, history, city: int) -> np.ndarray:
        self._check_city(city)
        history = np.asarray(history, dtype=np.float32)
        expected = (self._seq_len, self._city_n[city], self._input_dim)
        if history.ndim != 4 or history.shape[1:] != expected:
            raise ValueError(
                f"history must be (B, seq_len={expected[0]}, n_nodes={expected[1]}, "
                f"n_feats={expected[2]}) for city {city}, got {history.shape}")
        pad = self._groups[self._city_cls[city]][0] - self._city_n[city]
        return np.pad(history, [(0, 0), (0, 0), (0, pad), (0, 0)]) if pad else history

    def _strip(self, out: np.ndarray, city: int) -> np.ndarray:
        nc = self._city_n[city]
        return out[..., :nc, :] if out.shape[-2] != nc else out

    def _call_batched(self, h: np.ndarray, city: int, normalized: bool):
        batcher = self._batchers[self._city_cls[city]]
        cap = self._buckets[-1]
        if h.shape[0] <= cap:
            return batcher.submit(h, tag=(city, normalized), with_info=True)
        # oversized: ladder-top chunks, re-dispatched until one generation
        return ServingEngine._same_generation(
            h, cap, lambda chunk: batcher.submit(chunk, tag=(city, normalized), with_info=True))

    def _dispatch_inline(self, chunk: np.ndarray, city: int, normalized: bool):
        cls_id = self._city_cls[city]
        bucket = smallest_covering_bucket(chunk.shape[0], self._buckets)
        t0 = time.perf_counter()
        out, gen = self._run_program(cls_id, chunk, bucket,
                                     ((0, chunk.shape[0], (city, normalized)),))
        device_ms = (time.perf_counter() - t0) * 1e3
        self.class_stats[cls_id].record_dispatch(bucket, chunk.shape[0], [0.0], device_ms)
        return out[:chunk.shape[0]], gen

    def _call_direct(self, h: np.ndarray, city: int, normalized: bool,
                     cap: Optional[int] = None):
        return ServingEngine._same_generation(
            h, cap if cap is not None else self._buckets[-1],
            lambda chunk: self._dispatch_inline(chunk, city, normalized))

    def predict(self, history, *, city: int, normalized: bool = False,
                with_generation: bool = False) -> np.ndarray:
        """Micro-batched raw-units forecast for one city: concurrent
        callers, for other cities of the same class too, coalesce into one
        dispatch. Sheds, the degrade policy and the wedged-batcher fallback
        behave as :meth:`ServingEngine.predict`'s; ``with_generation=True``
        returns ``(pred, generation)``."""
        if self._closed:
            raise RuntimeError("FleetServingEngine is closed")
        h = self._validate(history, city)
        try:
            out, gen = self._call_batched(h, city, normalized)
        except BatcherWedged:
            out, gen = self._call_direct(h, city, normalized)
        except ShedError:
            if self.config.shed_policy != "degrade":
                raise
            self.class_stats[self._city_cls[city]].record_shed("degraded")
            out, gen = self._call_direct(h, city, normalized,
                                         cap=self.config.degrade_rung or self._buckets[0])
        out = self._strip(out, city)
        return (out, gen) if with_generation else out

    def predict_direct(self, history, *, city: int, normalized: bool = False,
                       with_generation: bool = False) -> np.ndarray:
        """Bypass the queue: pad to the covering rung and dispatch inline
        (same results; no coalescing)."""
        if self._closed:
            raise RuntimeError("FleetServingEngine is closed")
        out, gen = self._call_direct(self._validate(history, city), city, normalized)
        out = self._strip(out, city)
        return (out, gen) if with_generation else out

    def close(self) -> None:
        """Stop the watcher and every batcher, and release the generation's
        programs (:meth:`ServingEngine.close`)."""
        if not self._closed:
            self._closed = True
            if self._watcher is not None:
                self._watcher.stop()
            for b in self._batchers.values():
                b.close()
            self._current = release_programs(self._current)

    def __enter__(self) -> "FleetServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
