"""Continual fine-tuning behind the serving path: the loop's train side.

Counterpart of ``stmgcn_tpu/train/continual.py``. The closed loop is: live
rows land in a device-resident :class:`~stmgcn_tpu_torch.data.SeriesRing`;
the engine's drift gauges (or a wall-clock cadence) trip a retrain;
:class:`ContinualTrainer` fine-tunes on the freshest ring contents and
writes a CRC-verified candidate checkpoint (an ``STMG2`` file the JAX
package reads too); :class:`~stmgcn_tpu_torch.serving.PromotionGate`
promotes it through the engine's hot-swap path or quarantines it with a
typed reason.

The fine-tune is one program of ``finetune_steps`` optimizer steps with the
health row (the trainer's block body, ``train/trainer.py`` ``_block_body``,
over the ring): captured as a CUDA graph on the card into the trainer's own
:class:`~stmgcn_tpu_torch.graphs.GraphPool`, run eagerly on the CPU. A
captured program reads fixed tensors, so:

- the committed state lives on the **host** (parameters and Adam's
  moments as CPU tensors, and its step count), as in the JAX trainer; a
  fine-tune copies it into the model's and the optimizer's device tensors
  in place and produces *pending* state, which :meth:`ContinualTrainer.commit`
  adopts after the gate accepts its checkpoint and
  :meth:`ContinualTrainer.discard` drops. The device tensors are never
  rebound, so a fine-tune after a discard gives the first one's candidate
  bit for bit;
- each step's windows are gathered from the ring's physical buffer through
  slot indices (``(logical index + origin) % capacity``, uploaded with the
  step's mask and Adam scalars), which equals the JAX ring's roll followed
  by the gather; the program's shapes are the block's alone, so a growing
  or wrapping ring never recaptures.

:class:`ContinualDaemon` supervises ``finetune()`` with exponential
backoff and deterministic jitter under a bounded restart budget; spent, the
daemon marks itself ``down`` and serving continues on the last promoted
generation. Daemon drills ride the training
:class:`~stmgcn_tpu_torch.resilience.FaultPlan`: ``raise``/``hang`` at
the fine-tune's step boundary, ``poison`` NaN in one step's loss mask (the
gate then rejects the candidate as ``nonfinite``), and the write kinds
corrupt or tear the candidate file.

``closed_loop_smoke`` packs the whole loop into a CPU-sized drill.
"""

from __future__ import annotations

import copy
import functools
import os
import random
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from stmgcn_tpu_torch.graphs import CapturedProgram, DeviceOps, GraphPool, Program, resolve_graphs
from stmgcn_tpu_torch.models.params import health_groups, jax_layout, to_jax_params, to_optax_state
from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.ops.spmm import place_supports
from stmgcn_tpu_torch.train.checkpoint import save_checkpoint
from stmgcn_tpu_torch.train.step import eval_step, make_optimizer, train_step

__all__ = [
    "ContinualDaemon",
    "ContinualTrainer",
    "closed_loop_smoke",
    "make_holdout_eval",
]


def _window_slots(ring, spec, targets: np.ndarray) -> tuple:
    """``(x slots (..., seq_len), y slots (..., horizon))`` int32: the
    buffer rows of each target's input window and forecast steps."""
    x = ring.slots(targets[..., None] + spec.offsets)
    y = ring.slots(targets[..., None] + np.arange(spec.horizon))
    return x.astype(np.int32), y.astype(np.int32)


def _gather(buf: torch.Tensor, x_slots: torch.Tensor, y_slots: torch.Tensor, horizon: int):
    """``(x, y)`` from the ring buffer at slot indices: the resident-series
    gather (``gather_window_batch``) through the ring's slot map."""
    y = buf[y_slots]
    return buf[x_slots], (y[:, 0] if horizon == 1 else y)


class ContinualTrainer:
    """Fine-tune on the freshest ring contents; emit candidate checkpoints.

    ``model`` is the port's STMGCN (copied onto ``device``, ``None`` meaning
    the GPU); ``optimizer`` makes the port's
    :class:`~stmgcn_tpu_torch.train.step.Optimizer` over a parameter list
    (``functools.partial(make_optimizer, lr=1e-3)`` is the JAX loop's
    ``optax.adam(1e-3)``); ``supports`` the model's support form.
    ``params`` (a ``state_dict``; default: the model's) and ``opt_state``
    (an optax tree as checkpoints hold it; default: a fresh Adam) are the
    first committed state. ``graphs`` captures the fine-tune (``None``: on
    for CUDA). The committed state never changes on its own: ``finetune()``
    stages pending state, which :meth:`commit` or :meth:`discard` settles.
    """

    def __init__(self, model, optimizer, supports, ring, spec, config, out_dir: str, *,
                 params: Optional[dict] = None, opt_state=None, loss: str = "mse",
                 holdout: int = 4, fault_plan=None, health_baseline=None,
                 meta: Optional[dict] = None, registry=None, log=None, device=None,
                 graphs: Optional[bool] = None):
        self.ring = ring
        self.spec = spec
        self.config = config
        self.out_dir = out_dir
        self.candidate_dir = os.path.join(out_dir, "candidates")
        os.makedirs(self.candidate_dir, exist_ok=True)
        self.holdout = int(holdout)
        self.fault_plan = fault_plan
        self.health_baseline = health_baseline
        self.meta = dict(meta) if meta else {}
        self.loss = loss
        self.device = resolve_device(device)
        self.graphs = resolve_graphs(graphs, self.device)
        self.model = copy.deepcopy(model).to(self.device).train()
        if params is not None:
            self.model.load_state_dict(params)
        self._supports = place_supports(supports, self.device)
        self.model.check_supports(self._supports)
        self._names = [name for name, _ in self.model.named_parameters()]
        self.layout = jax_layout(self.model.support_mode, self.model.loop_layout)
        self._groups = health_groups(self._names, self.model.m_graphs, layout=self.layout)
        self.optimizer = optimizer(list(self.model.parameters()))
        if opt_state is not None:
            self.optimizer.load_state_tree(opt_state, self._names, self.model.m_graphs)
        # committed truth on the host: (params, (count, exp_avg, exp_avg_sq))
        self._committed = self._read_state()
        self._pending: Optional[tuple] = None
        #: the fine-tune's graph pool (None eager); its bytes are the program's
        self.graph_pool = GraphPool(self.device) if self.graphs else None
        self._program = None
        self.ordinal = 0
        self._reg = REGISTRY if registry is None else registry
        self._log = log if log is not None else (lambda msg: None)

    @property
    def params(self) -> dict:
        """The committed (last accepted) parameters, CPU tensors."""
        return self._committed[0]

    def _read_state(self) -> tuple:
        """The device state as host copies."""
        opt = self.optimizer
        params = {n: p.detach().to("cpu", copy=True)
                  for n, p in zip(self._names, opt.params, strict=True)}
        return params, (opt.count, [m.to("cpu", copy=True) for m in opt.exp_avg],
                        [v.to("cpu", copy=True) for v in opt.exp_avg_sq])

    @torch.no_grad()
    def _stage(self, state: tuple) -> None:
        """Copy a host state into the model's and the optimizer's device
        tensors, in place (the captured fine-tune keeps reading them)."""
        params, (count, exp_avg, exp_avg_sq) = state
        opt = self.optimizer
        for name, p in zip(self._names, opt.params):
            p.copy_(params[name])
        for dst, src in zip(opt.exp_avg + opt.exp_avg_sq, exp_avg + exp_avg_sq):
            dst.copy_(src)
        opt.count = count

    def _train_idx_block(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(targets, idx_block)``: the freshest S*B training samples, as
        the JAX trainer takes them — ring-local targets without the last
        ``holdout`` (the gate's held-out rows), and an ``(S, B)`` block into
        them, wrapping when the ring holds fewer than a block."""
        cfg = self.config
        last = cfg.finetune_window if cfg.finetune_window else None
        targets = self.ring.target_indices(self.spec, last=last)
        if self.holdout and len(targets) > self.holdout:
            targets = targets[: -self.holdout]
        n = len(targets)
        s, b = cfg.finetune_steps, cfg.finetune_batch
        flat = (np.arange(s * b) + max(0, n - s * b)) % n
        return targets, flat.reshape(s, b).astype(np.int32)

    def _block(self):
        """The fine-tune program (made, and captured at its first call on
        the card, once): S steps gathering from the ring's buffer, each with
        its health row; returns the ``(S, 5 + G)`` rows."""
        if self._program is not None:
            return self._program
        s, b = self.config.finetune_steps, self.config.finetune_batch
        spec, ring = self.spec, self.ring
        model, opt, sup, groups = self.model, self.optimizer, self._supports, self._groups

        def body(v):
            rows = []
            for k in range(s):
                x, y = _gather(ring.buffer, v["x"][k], v["y"][k], spec.horizon)
                _, row = train_step(model, opt, sup, x, y, v["mask"][k], self.loss,
                                    scalars=v["adam"][k], health=groups)
                rows.append(row)
            return torch.stack(rows)

        shapes = {"x": ((s, b, spec.seq_len), torch.int32),
                  "y": ((s, b, spec.horizon), torch.int32),
                  "mask": ((s, b), torch.float32), "adam": ((s, 2), torch.float32)}
        name = f"continual fine-tune, {s} step(s)"
        self._program = (CapturedProgram(body, shapes, self.graph_pool, name=name)
                         if self.graphs else
                         Program(body, shapes, DeviceOps(self.device), name=name))
        return self._program

    def finetune(self) -> Tuple[str, dict]:
        """One supervised fine-tune: S steps on the freshest ring rows, the
        candidate checkpoint written, the health summary returned.

        Returns ``(candidate_path, health)``, ``health`` being what the gate
        reads: ``nonfinite`` (non-finite gradient and loss observations),
        ``grad_norm_max``, ``update_ratio_max``, ``loss_last``. Raises
        whatever the fault plan or the step raises: supervision is the
        daemon's job."""
        ordinal = self.ordinal
        self.ordinal += 1
        cfg = self.config
        s, b = cfg.finetune_steps, cfg.finetune_batch
        targets, idx_block = self._train_idx_block()
        mask = np.ones((s, b), np.float32)
        plan = self.fault_plan
        if plan is not None:
            plan.before_step(ordinal, 0, s)  # raise/sigterm/hang drills
            for step in range(s):
                payload = plan.poison_value(ordinal, step)
                if payload is not None:
                    mask[step, 0] = payload
        x_slots, y_slots = _window_slots(self.ring, self.spec, targets[idx_block])
        self._stage(self._committed)
        count = self.optimizer.count
        values = {"x": x_slots, "y": y_slots, "mask": mask,
                  "adam": np.array([self.optimizer.scalars(count + k) for k in range(s)])}
        rows = self._block()(values).numpy()
        self.optimizer.count = count + s
        self._pending = self._read_state()
        health = {
            "nonfinite": int(rows[:, 3].sum() + rows[:, 4].sum()),
            "grad_norm_max": float(np.max(rows[:, 1])),
            "update_ratio_max": float(np.max(rows[:, 2])),
            "loss_last": float(rows[-1, 0]),
        }
        path = os.path.join(self.candidate_dir, f"candidate-{ordinal:04d}.ckpt")
        meta = dict(self.meta)
        meta.update({
            "kind": "continual", "ordinal": ordinal, "steps": s, "batch": b,
            "next_ts": int(self.ring.next_ts),
            "health": {k: v for k, v in health.items() if v == v},  # NaN-free JSON
        })
        if self.health_baseline is not None:
            meta["health_baseline"] = self.health_baseline
        params, (count, exp_avg, exp_avg_sq) = self._pending
        m = self.model.m_graphs
        save_checkpoint(path, to_jax_params(params, m, layout=self.layout),
                        to_optax_state(self.optimizer.parts, count,
                                       dict(zip(self._names, exp_avg)),
                                       dict(zip(self._names, exp_avg_sq)), m,
                                       layout=self.layout),
                        meta, fault_plan=plan)
        self._reg.counter("continual.retrains").inc()
        self._log(f"fine-tune {ordinal}: loss {health['loss_last']:.5f}, candidate {path}")
        return path, health

    def commit(self) -> None:
        """Adopt the pending fine-tune as committed (the gate accepted)."""
        if self._pending is not None:
            self._committed, self._pending = self._pending, None

    def discard(self) -> None:
        """Drop the pending fine-tune (the gate rejected it, or the step
        crashed); the next fine-tune restarts from the committed state."""
        self._pending = None


def make_holdout_eval(model, supports, ring, spec, *, holdout: int = 4, loss: str = "mse",
                      device=None) -> Callable:
    """``evaluate(state_dict) -> float``: the loss on the ring's freshest
    ``holdout`` targets (which :class:`ContinualTrainer` leaves out of its
    training block), through the port's ``eval_step``. The gate scores the
    candidate and the live parameters on the same rows; each call re-reads
    the ring. ``model`` is copied onto ``device`` (``None``: the GPU) once,
    and each call loads the parameters into that copy in place."""
    device = resolve_device(device)
    net = copy.deepcopy(model).to(device).eval()
    sup = place_supports(supports, device)
    net.check_supports(sup)
    mask = torch.ones((holdout,), dtype=torch.float32, device=device)

    def evaluate(params) -> float:
        net.load_state_dict(params)
        targets = ring.target_indices(spec)[-holdout:]
        x_slots, y_slots = (torch.as_tensor(a, device=device)
                            for a in _window_slots(ring, spec, targets))
        x, y = _gather(ring.buffer, x_slots, y_slots, spec.horizon)
        value, _ = eval_step(net, sup, x, y, mask, loss)
        return float(value)

    return evaluate


class ContinualDaemon:
    """Supervise the fine-tune → gate loop; never endanger serving.

    A synchronous core (``should_retrain``/``poll``/``retrain``) plus an
    optional background thread (``start``/``stop``: stop event, daemon
    thread, bounded join). A fine-tune that raises is retried with
    exponential backoff and deterministic jitter up to
    ``config.max_restarts`` times; the budget spent, the daemon goes
    ``down`` (gauge ``continual.daemon_up`` 0) and retires. The serving
    engine keeps answering from its last promoted generation throughout.
    """

    JOIN_TIMEOUT_S = 5.0

    def __init__(self, trainer: ContinualTrainer, gate, *, config, time_fn=time.monotonic,
                 sleep_fn=time.sleep, rng_seed: int = 0, registry=None, log=None,
                 replica: Optional[str] = None):
        self.trainer = trainer
        self.gate = gate
        self.config = config
        self._time = time_fn
        self._sleep = sleep_fn
        self._rng = random.Random(rng_seed)
        self._reg = REGISTRY if registry is None else registry
        self._log = log if log is not None else (lambda msg: None)
        # federation shards run one daemon each: a replica label keeps their
        # up/down gauges apart in one registry
        self._labels = None if replica is None else {"replica": str(replica)}
        self._last_retrain = time_fn()
        self.down = False
        self.restarts = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reg.gauge("continual.daemon_up", self._labels).set(1)

    # -- trigger --------------------------------------------------------------

    def should_retrain(self) -> Optional[str]:
        """``"drift"`` | ``"cadence"`` | None: why to retrain now. Drift
        wins: any city/phase gauge of the engine's live drift snapshot over
        ``drift_z_max``/``drift_psi`` fires. Cadence fires when
        ``cadence_s > 0`` has passed since the last completed retrain."""
        if self.down:
            return None
        snap = self.gate._engine.drift_snapshot()
        if snap is not None:
            cfg = self.config
            for phases in snap.get("cities", {}).values():
                for gauges in phases.values():
                    z = float(gauges.get("z_max", 0.0))
                    psi = float(gauges.get("psi", 0.0))
                    if z > cfg.drift_z_max or psi > cfg.drift_psi:
                        return "drift"
        if self.config.cadence_s > 0:
            if self._time() - self._last_retrain >= self.config.cadence_s:
                return "cadence"
        return None

    def poll(self):
        """Check the trigger; run one retrain cycle if it fires. Returns the
        gate's decision, or None when idle, down or exhausted."""
        reason = self.should_retrain()
        if reason is None:
            return None
        return self.retrain(reason)

    def retrain(self, reason: str):
        """One supervised fine-tune → gate cycle. A crash inside
        ``finetune()`` is retried under the restart budget with backoff
        ``min(backoff_s * 2**k, backoff_max_s)`` plus up to 10%
        deterministic jitter; the budget spent, the daemon goes ``down``
        and returns None. A completed fine-tune always reaches the gate,
        whose verdict decides commit or discard."""
        cfg = self.config
        attempts = 0
        while True:
            try:
                path, health = self.trainer.finetune()
                break
            except Exception as e:  # Preempted is a BaseException: it passes
                self.trainer.discard()
                attempts += 1
                self.restarts += 1
                if attempts > cfg.max_restarts:
                    self.down = True
                    self._reg.gauge("continual.daemon_up", self._labels).set(0)
                    self._log(f"retrain ({reason}) abandoned after {attempts} attempts: "
                              f"{e!r} — daemon down, serving continues on the live "
                              "generation")
                    return None
                delay = min(cfg.backoff_s * (2.0 ** (attempts - 1)), cfg.backoff_max_s)
                delay *= 1.0 + 0.1 * self._rng.random()
                self._log(f"retrain ({reason}) attempt {attempts} failed: {e!r}; backing "
                          f"off {delay * 1e3:.0f} ms")
                self._sleep(delay)
        decision = self.gate.consider(path, health)
        if decision.accepted:
            self.trainer.commit()
        else:
            self.trainer.discard()
        self._last_retrain = self._time()
        self._log(f"retrain ({reason}) -> {decision.reason} (generation "
                  f"{decision.generation})")
        return decision

    # -- background supervision ---------------------------------------------

    def start(self, poll_s: float = 1.0) -> "ContinualDaemon":
        """Poll the trigger on a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(poll_s):
                try:
                    self.poll()
                except Exception as e:  # the daemon never kills serving
                    self._log(f"continual daemon poll error: {e!r}")
                if self.down:
                    return

        self._thread = threading.Thread(target=loop, name="continual-daemon", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: Optional[float] = None) -> bool:
        """Signal the loop and join it, bounded (a daemon thread: a
        straggler cannot hold the process open). True when it exited."""
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(self.JOIN_TIMEOUT_S if timeout_s is None else timeout_s)
        if t.is_alive():
            return False
        self._thread = None
        return True


def closed_loop_smoke(out_dir: str, *, poison: bool = True, seed: int = 0,
                      device=None) -> dict:
    """The whole closed loop, CPU-sized (``device="cpu"``; ``None`` means the
    GPU): the JAX package's drill. A tiny serial-only model and ring, live
    serving throughout, and two retrain cycles: one clean (promoted through
    the gate into the engine) and, with ``poison=True``, one with a NaN in
    the fine-tune's loss mask (rejected as ``nonfinite``; serving stays on
    the promoted generation). Returns the JAX function's verdict:
    ``promotions``, ``rejections``, ``nonfinite`` (of the clean fine-tune),
    ``rejection_reason``, ``generation`` and the ingest and serving
    evidence."""
    from stmgcn_tpu_torch.config import ContinualConfig, ServingConfig, preset
    from stmgcn_tpu_torch.data import (
        DemandDataset,
        MinMaxNormalizer,
        SeriesRing,
        WindowSpec,
        synthetic_dataset,
    )
    from stmgcn_tpu_torch.experiment import build_model
    from stmgcn_tpu_torch.inference import Forecaster
    from stmgcn_tpu_torch.ops import SupportConfig
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec
    from stmgcn_tpu_torch.serving import PromotionGate

    device = resolve_device(device)
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 2, 64
    cfg.data.serial_len, cfg.data.daily_len, cfg.data.weekly_len = 3, 0, 0
    spec = WindowSpec(3, 0, 0, 24 // cfg.data.dt, cfg.data.horizon)
    data = synthetic_dataset(rows=2, n_timesteps=64, seed=seed)
    ds = DemandDataset(data, spec)
    supports = np.asarray(SupportConfig(cfg.model.kernel_type, cfg.model.K).build_all(
        list(ds.adjs.values())), np.float32)[: cfg.model.m_graphs]
    model = build_model(cfg, ds.n_feats, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    params = model.state_dict()
    norm = MinMaxNormalizer.fit(np.asarray(data.demand))
    normalized = np.asarray(norm.transform(np.asarray(data.demand)), np.float32)

    warm = 48  # pre-filled history; the rest arrives live below
    ring = SeriesRing.from_series(normalized[:warm], capacity=64, reorder_window=2,
                                  device=device)
    fc = Forecaster(model, params, norm, cfg, {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes},
                    device=device)
    engine = fc.serving_engine(supports, config=ServingConfig(buckets=(1, 2), max_batch=2,
                                                              max_delay_ms=2.0), device=device)
    ccfg = ContinualConfig(
        enabled=True, ring_capacity=64, reorder_window=2, finetune_steps=2, finetune_batch=2,
        max_restarts=1, backoff_s=0.01, backoff_max_s=0.02, promote_grad_norm_max=1e6,
        promote_update_ratio_max=100.0, promote_eval_margin=10.0,
    )
    # the second fine-tune (ordinal 1) gets NaN in step 0's loss mask
    plan = FaultPlan(FaultSpec(kind="poison", epoch=1, step=0)) if poison else FaultPlan()
    trainer = ContinualTrainer(model, functools.partial(make_optimizer, lr=1e-3), supports,
                               ring, spec, ccfg, out_dir, params=params, holdout=2,
                               fault_plan=plan, device=device)
    gate = PromotionGate.from_config(
        engine, out_dir, ccfg,
        holdout_eval=make_holdout_eval(model, supports, ring, spec, holdout=2, device=device),
        live_params=params,
    )
    daemon = ContinualDaemon(trainer, gate, config=ccfg)
    rng = np.random.default_rng(seed)

    def serve() -> np.ndarray:
        hist = rng.uniform(0, 50, (1, spec.seq_len, ds.n_nodes, ds.n_feats)).astype(np.float32)
        return np.asarray(engine.predict(hist))

    try:
        predictions = 1
        serve()  # generation 0 answers before any retrain
        for ts in range(warm, 56):  # live rows land mid-loop
            ring.ingest(ts, normalized[ts])
        clean = daemon.retrain("drift")
        predictions += 1
        serve()  # the promoted generation answers
        for ts in range(56, 64):
            ring.ingest(ts, normalized[ts])
        second = daemon.retrain("cadence")
        predictions += 1
        serve()  # the rejection left serving untouched
        return {
            "schema_version": 1,
            "promotions": gate.promotions,
            "rejections": gate.rejections,
            "nonfinite": int(clean.checks.get("nonfinite", -1)) if clean is not None else -1,
            "rejection_reason": None if second is None else second.reason,
            "generation": engine.generation,
            "rows_ingested": int(ring.rows),
            "ring_len": len(ring),
            "predictions": predictions,
            "daemon_down": daemon.down,
        }
    finally:
        engine.close()
