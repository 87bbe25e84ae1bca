"""Shape-bucketed serving engine with dynamic micro-batching.

Counterpart of ``stmgcn_tpu/serving/engine.py`` (``ServingEngine``):

- **shape buckets** — one callable per ladder rung
  (``ServingConfig.buckets``); every batch is zero-padded up to the
  smallest covering rung, so the device only ever sees ladder shapes. The
  JAX engine compiles each rung ahead of time; here a rung is a plain
  eager forward (per-rung CUDA graphs are later work);
- **device-resident operands** — the support stack is placed on the
  device once; the model lives behind one atomic ``(generation, model)``
  reference, so the history window is the only per-request upload and
  :meth:`ServingEngine.swap_params` hot-swaps new weights between
  dispatches. Every response can report the generation that produced it
  and is never mixed-generation — a dispatch reads the reference once;
- **dynamic micro-batching** — concurrent callers coalesce into the
  smallest covering rung (:mod:`stmgcn_tpu_torch.serving.microbatch`), with
  per-bucket latency/queue/pad-waste telemetry
  (:mod:`stmgcn_tpu_torch.serving.metrics`);
- **SLO admission + typed sheds** — with ``ServingConfig.deadline_ms`` /
  ``queue_bound_rows`` set, overload sheds at arrival with typed errors
  (:mod:`stmgcn_tpu_torch.serving.admission`); ``shed_policy="degrade"``
  serves shed requests inline at a smaller rung instead, and a wedged
  batcher degrades ``predict`` to the inline path.

Not ported yet: ``CheckpointWatcher``, ``from_artifact`` and the drift
monitor.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch

from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.serving.admission import (
    AdmissionController,
    BatcherWedged,
    ShedError,
)
from stmgcn_tpu_torch.serving.bucketing import pad_to_bucket, smallest_covering_bucket
from stmgcn_tpu_torch.serving.metrics import EngineStats
from stmgcn_tpu_torch.serving.microbatch import MicroBatcher

__all__ = ["ServingEngine"]

#: bound on the re-dispatch loop that keeps multi-chunk responses on one
#: param generation — hit only under pathological swap churn
_SWAP_RETRIES = 20


def _bucket_program(sup_dev: torch.Tensor, device: torch.device):
    """One rung's serving program: ``(model, history) -> predictions`` on
    the host, supports bound device-resident."""

    def run(model, history: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = model(sup_dev, torch.as_tensor(history, device=device))
        return out.cpu().numpy()

    return run


class ServingEngine:
    """Bucket ladder + micro-batcher over one model::

        engine = ServingEngine.from_forecaster(fc, supports)
        pred = engine.predict(history)          # micro-batched, raw units
        pred = engine.predict_direct(history)   # bypass the queue
        pred, gen = engine.predict(history, with_generation=True)
        engine.swap_params(new_state_dict)      # atomic
        engine.stats.snapshot()                 # per-bucket telemetry
        engine.close()

    ``predict`` keeps the forecaster's validate → normalize → call →
    denormalize contract (normalization vectorized once per coalesced
    dispatch), so results agree with ``Forecaster.predict`` at any request
    size. Under an SLO config it raises the typed sheds of
    :mod:`stmgcn_tpu_torch.serving.admission` (or serves degraded inline
    when ``shed_policy="degrade"``).
    """

    def __init__(self, programs, model, normalizer, expected, config, device):
        self._programs = dict(programs)  # bucket -> run(model, history)
        self.normalizer = normalizer
        self.expected = tuple(expected)  # (seq_len, n_nodes, input_dim)
        self.config = config
        self.device = device
        self._buckets = tuple(sorted(self._programs))
        self.stats = EngineStats()
        # ONE reference holds (generation, model): dispatches read it once,
        # swaps replace it whole — a response is never computed from a mix
        # of generations (CPython reference reads are atomic)
        self._current = (0, model)
        self.admission = (
            AdmissionController(config, self.stats, self._buckets)
            if config.deadline_ms is not None or config.queue_bound_rows
            else None
        )
        self._batcher = MicroBatcher(
            self._run_program, self._buckets, config.max_delay_ms, self.stats,
            admission=self.admission,
        )
        self._closed = False

    # -- construction ---------------------------------------------------

    @staticmethod
    def _resolve_config(config):
        from stmgcn_tpu_torch.config import ServingConfig

        cfg = config if config is not None else ServingConfig()
        bad = cfg.violations()
        if bad:
            raise ValueError("invalid serving config: " + "; ".join(bad))
        return cfg

    @classmethod
    def from_forecaster(cls, fc, supports, *, config=None, device=None) -> "ServingEngine":
        """Engine over a :class:`~stmgcn_tpu_torch.inference.Forecaster`.

        ``device=None`` means the GPU (and raises without one). The
        supports are validated against the model and placed on the device
        once; the engine serves its own copy of the forecaster's model.
        """
        device = resolve_device(device)
        cfg = cls._resolve_config(
            config if config is not None else getattr(fc.config, "serving", None)
        )
        model = fc.model
        n_nodes = fc.derived["n_nodes"]
        want = (model.m_graphs, model.n_supports, n_nodes, n_nodes)
        supports_np = np.asarray(supports, dtype=np.float32)
        if supports_np.shape != want:
            raise ValueError(f"supports must be {want}, got {supports_np.shape}")
        sup_dev = torch.as_tensor(supports_np, device=device)
        program = _bucket_program(sup_dev, device)
        served = copy.deepcopy(model).to(device).eval()
        return cls({b: program for b in cfg.buckets}, served, fc.normalizer,
                   fc.expected, cfg, device)

    # -- hot swap --------------------------------------------------------

    @property
    def generation(self) -> int:
        """Monotonic param-generation counter (0 = construction params)."""
        return self._current[0]

    def swap_params(self, state_dict) -> int:
        """Atomically replace the serving parameters; returns the new
        generation.

        ``state_dict`` must match the served model's keys, shapes and
        dtypes exactly. The new weights load into a fresh copy of the
        model, which is published as one reference swap: in-flight
        dispatches finish on the generation they read at entry, every
        later dispatch sees the new one.
        """
        gen, cur = self._current
        live = cur.state_dict()
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
        fresh = copy.deepcopy(cur)
        fresh.load_state_dict(state_dict)
        self._current = (gen + 1, fresh.eval())
        REGISTRY.counter("serving.swaps").inc()
        REGISTRY.gauge("serving.generation").set(gen + 1)
        return gen + 1

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
        gen, model = self._current  # ONE read — whole dispatch, one gen
        norm = self.normalizer
        if norm is None or all(pre for _, _, pre in segments):
            batch = payload
        else:
            batch = norm.transform(payload)
            for ofs, n, pre in segments:
                if pre:
                    batch[ofs:ofs + n] = payload[ofs:ofs + n]
        out = self._programs[bucket](model, pad_to_bucket(batch, bucket))
        out = norm.inverse(out) if norm is not None else out
        return out, gen

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
        if not self._closed:
            self._closed = True
            self._batcher.close()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
