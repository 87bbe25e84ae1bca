"""``stmgcn serve-bench``: the serving benchmark of the port.

Counterpart of ``stmgcn_tpu/serving/bench.py``, with the same legs and the
same record keys. On one card (``--device``, default ``cuda``) it
measures the generations of the inference path over one throwaway
checkpoint (:func:`train_throwaway`, trained through ``build_trainer``):

- **naive** — ``Forecaster.predict`` and ``ExportedForecaster.predict``
  called per request (an eager forward, and the exported program, each
  with its host-side normalization and readback);
- **engine (direct)** — :class:`~stmgcn_tpu_torch.serving.engine.ServingEngine`
  rung programs (one captured CUDA graph per rung on the card), no queue;
- **engine (micro-batched)** — N concurrent batch-1 clients coalesced by
  the micro-batcher into rung-sized dispatches.

Each timed leg reports mean/p50/p95/p99 latency and predictions/sec with
warmup excluded; the record carries the engine's per-bucket telemetry and
two ratios as ``speedup``. ``record["fleet"]`` is one
:class:`~stmgcn_tpu_torch.serving.fleet.FleetServingEngine` over a
two-city heterogeneous view of the checkpoint (:func:`fleet_forecaster`)
with mixed-city concurrent clients and a per-city bit-parity check.
``--soak`` adds the overload leg (:func:`run_soak_leg`,
``record["soak"]``): open-loop arrivals above the calibrated capacity
against an SLO-configured engine — typed shed counts, admitted-request
percentiles against the derived SLO target, a mid-soak hot swap with
per-generation bit parity, a drift rider (a shifted stream against a
calibration-fitted baseline, its gauges reset by the swap) and a
``contended`` marker from :mod:`stmgcn_tpu_torch.utils.hostload` — and
``record["soak"]["continual"]``, the closed-loop drill
(:func:`stmgcn_tpu_torch.train.continual.closed_loop_smoke`: live ring
ingest, a fine-tune, one guarded promotion, one poisoned candidate
rejected as ``nonfinite``). ``--federation M`` adds the replica-tier soak
(:func:`run_federation_soak`, ``record["federation"]``): M fleet replicas
and a warm spare behind a :class:`~stmgcn_tpu_torch.serving.federation.
FederationRouter` under open-loop scatter/gather load, through the four
drills of one fault plan (replica kill, herd spike against the shared
:class:`~stmgcn_tpu_torch.serving.admission.GlobalBudget`, a poisoned
candidate rejected once for the whole tier then a tier-wide promotion
with no cross-generation response, hang-on-drain and the spare's
re-shard), with the tier's measured throughput over the calibrated
single-engine rate (``capacity_x``) and the host's core count and load.
The soak and federation calibrations are measured on the host running
the bench: their numbers on a card are not a CPU's.

Not imported by ``stmgcn_tpu_torch.serving``'s ``__init__``: the
throwaway trainer pulls in the whole stack.

The default operating point is the JAX bench's: a 4x4 grid (N=16) with
slim hidden widths, the ladder topped at the client count — a regime
where per-call overhead dominates. ``--full-model --rows 16`` is the
``default`` preset's full width at the dense city's N = 256. The shapes
ride in the record.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np

from stmgcn_tpu_torch.serving.metrics import percentiles

__all__ = [
    "federation_forecaster",
    "fleet_forecaster",
    "main",
    "run_federation_soak",
    "run_fleet_serve_bench",
    "run_serve_bench",
    "run_soak_leg",
    "train_throwaway",
]


def _leg(samples_s: List[float], batch: int) -> dict:
    """One timed leg: per-call seconds -> latency stats + throughput."""
    mean_s = float(np.mean(samples_s))
    ms = [s * 1e3 for s in samples_s]
    pct = percentiles(ms)
    return {
        "ms": round(mean_s * 1e3, 3),
        "p50_ms": pct["p50"],
        "p95_ms": pct["p95"],
        "p99_ms": pct["p99"],
        "predictions_per_sec": round(batch / mean_s, 1),
    }


def _timed(fn, warmup: int, iters: int) -> List[float]:
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return samples


def train_throwaway(rows: int = 4, epochs: int = 2, batch_size: int = 16,
                    out_dir: Optional[str] = None, slim: bool = True, device=None):
    """A 2-epoch throwaway checkpoint at the serve-bench operating point,
    trained through ``build_trainer`` on ``device`` (``None`` means the
    GPU) and read back with ``Forecaster.from_checkpoint``.

    Accuracy is irrelevant — only the prediction path's wall clock
    matters. ``slim`` keeps the full 3-branch ST-MGCN but shrinks the
    hidden widths so per-call overhead dominates the forward;
    ``slim=False`` is the ``default`` preset's full width. Returns
    ``(forecaster, supports)``.
    """
    from stmgcn_tpu_torch.config import preset
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.inference import Forecaster

    cfg = preset("default")
    cfg.data.rows = rows
    cfg.data.n_timesteps = 24 * 7 * 2 + 64
    cfg.train.epochs = epochs
    cfg.train.batch_size = batch_size
    tmp_ckpt_dir = None
    if out_dir is None:
        # throwaway means throwaway: the checkpoint dir exists only long
        # enough to round-trip the forecaster through from_checkpoint
        tmp_ckpt_dir = tempfile.mkdtemp(prefix="stmgcn_serve_")
        out_dir = tmp_ckpt_dir
    cfg.train.out_dir = out_dir
    if slim:
        cfg.model.lstm_hidden_dim = 8
        cfg.model.lstm_num_layers = 1
        cfg.model.gcn_hidden_dim = 8
    try:
        trainer = build_trainer(cfg, device=device, verbose=False)
        trainer.train()
        fc = Forecaster.from_checkpoint(os.path.join(out_dir, "best.ckpt"), device=device)
    finally:
        if tmp_ckpt_dir is not None:
            shutil.rmtree(tmp_ckpt_dir, ignore_errors=True)
    supports = np.asarray(
        cfg.model.support_config.build_all(trainer.dataset.adjs.values()),
        np.float32,
    )
    return fc, supports


def fleet_forecaster(fc, supports):
    """Lift the throwaway checkpoint into a two-city heterogeneous
    forecaster for the fleet leg: the trained grid serves as city 0 and a
    fresh 2x7 grid (N=14) joins as city 1 — at the default 4x4 grid inside
    the default waste budget, so both land in ONE shape class and their
    requests can coalesce (at a 16x16 grid the second city takes a class
    of its own). The model's parameters are node-count agnostic (the graph
    convs contract feature axes, the supports carry N), so one checkpoint
    serves both, on the forecaster's device. Returns
    ``(hetero_fc, per_city_supports, n_nodes)``.
    """
    from stmgcn_tpu_torch.data import MinMaxNormalizer, synthetic_dataset
    from stmgcn_tpu_torch.inference import Forecaster
    from stmgcn_tpu_torch.ops import SupportConfig

    cfg = fc.config
    m = cfg.model.m_graphs
    small = synthetic_dataset(rows=2, cols=7, n_timesteps=24 * 7 * 2 + 40,
                              seed=2)
    small_sup = np.asarray(
        SupportConfig(cfg.model.kernel_type, cfg.model.K).build_all(
            small.adjs.values()
        ),
        np.float32,
    )[:m]
    sups = [np.asarray(supports, np.float32)[:m], small_sup]
    n_nodes = [sups[0].shape[-1], sups[1].shape[-1]]
    normalizers = [
        fc.normalizer if fc.normalizer is not None
        else MinMaxNormalizer.fit(
            np.asarray(
                synthetic_dataset(rows=4, n_timesteps=24 * 7 * 2 + 40,
                                  seed=1).demand
            )
        ),
        MinMaxNormalizer.fit(np.asarray(small.demand)),
    ]
    hetero = Forecaster(
        fc.model, fc.state_dict, None, cfg,
        {"input_dim": fc.derived["input_dim"], "n_nodes": n_nodes},
        normalizers, device=fc.device,
    )
    return hetero, sups, n_nodes


def _microbatch_leg(engine, history_row: np.ndarray, clients: int,
                    per_client: int) -> dict:
    """N concurrent batch-1 clients hammering ``engine.predict``."""
    # warmup outside the measured window (threads + first coalesced
    # dispatches), then reset telemetry so the snapshot is measurement-only
    for _ in range(2):
        engine.predict(history_row)
    engine.stats.reset()

    latencies_ms: List[float] = []
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)

    def client():
        mine = []
        barrier.wait()
        for _ in range(per_client):
            t0 = time.perf_counter()
            engine.predict(history_row)
            # predict returns host numpy: its readback fences the span
            mine.append((time.perf_counter() - t0) * 1e3)  # stmgcn: ignore[unfenced-timing]
        with lock:
            latencies_ms.extend(mine)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for th in threads:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    # the clients' predict calls return host numpy: joined, they are fenced
    elapsed = time.perf_counter() - t0  # stmgcn: ignore[unfenced-timing]
    total = clients * per_client
    pct = percentiles(latencies_ms)
    return {
        "clients": clients,
        "requests": total,
        "ms": pct["mean"],
        "p50_ms": pct["p50"],
        "p95_ms": pct["p95"],
        "p99_ms": pct["p99"],
        "predictions_per_sec": round(total / elapsed, 1),
    }


def _fleet_microbatch_leg(engine, hists, clients: int,
                          per_client: int) -> dict:
    """N concurrent batch-1 clients split round-robin across the fleet's
    cities (``hists`` is ``[(history, city), ...]``), all hammering ONE
    engine — the coalescing a per-city engine cannot do. Reports the
    usual latency/throughput stats plus how many dispatches actually
    mixed cities in one device batch."""
    for h, c in hists:
        engine.predict(h, city=c)
    for st in engine.class_stats.values():
        st.reset()
    cross_before = engine.cross_city_dispatches

    latencies_ms: List[float] = []
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)

    def client(i: int):
        h, c = hists[i % len(hists)]
        mine = []
        barrier.wait()
        for _ in range(per_client):
            t0 = time.perf_counter()
            engine.predict(h, city=c)
            mine.append((time.perf_counter() - t0) * 1e3)
        with lock:
            latencies_ms.extend(mine)

    threads = [
        threading.Thread(target=client, args=(i,)) for i in range(clients)
    ]
    for th in threads:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    # the clients' predict calls return host numpy: joined, they are fenced
    elapsed = time.perf_counter() - t0  # stmgcn: ignore[unfenced-timing]
    total = clients * per_client
    pct = percentiles(latencies_ms)
    return {
        "clients": clients,
        "requests": total,
        "ms": pct["mean"],
        "p50_ms": pct["p50"],
        "p95_ms": pct["p95"],
        "p99_ms": pct["p99"],
        "predictions_per_sec": round(total / elapsed, 1),
        "cross_city_dispatches": engine.cross_city_dispatches - cross_before,
    }


def run_fleet_serve_bench(fc, supports, *, buckets=(1, 4, 16),
                          max_delay_ms: float = 2.0, clients: int = 16,
                          per_client: int = 40, warmup: int = 3,
                          iters: int = 30) -> dict:
    """The fleet serving record: one :class:`FleetServingEngine` over a
    two-city heterogeneous view of the throwaway checkpoint
    (:func:`fleet_forecaster`), measured three ways — per-city naive
    ``Forecaster.predict`` alternating cities (the no-engine floor),
    direct per-city engine dispatch, and mixed-city concurrent clients
    whose requests coalesce across cities within the shape class. A
    per-city parity spot-check rides in the record so the throughput
    claim is pinned to bit-identical outputs."""
    from stmgcn_tpu_torch.config import ServingConfig

    hetero, sups, n_nodes = fleet_forecaster(fc, supports)
    ladder = tuple(sorted(set(buckets)))
    cfg = ServingConfig(
        buckets=ladder, max_delay_ms=max_delay_ms, max_batch=ladder[-1],
    )
    rng = np.random.default_rng(0)
    hists = [
        (
            (rng.random((1, hetero.seq_len, n, fc.derived["input_dim"]))
             * 50).astype(np.float32),
            city,
        )
        for city, n in enumerate(n_nodes)
    ]

    with hetero.fleet_engine(sups, config=cfg, device=hetero.device) as engine:
        parity = all(
            bool(
                np.array_equal(
                    hetero.predict(sups[c], h, city=c),
                    engine.predict_direct(h, city=c),
                )
            )
            for h, c in hists
        )

        legs = {}
        calls = {"i": 0}

        def naive_alternating():
            h, c = hists[calls["i"] % len(hists)]
            calls["i"] += 1
            hetero.predict(sups[c], h, city=c)

        legs["naive/b1-alternating"] = _leg(
            _timed(naive_alternating, warmup, iters), 1
        )

        def direct_alternating():
            h, c = hists[calls["i"] % len(hists)]
            calls["i"] += 1
            engine.predict_direct(h, city=c)

        legs["engine/b1-alternating"] = _leg(
            _timed(direct_alternating, warmup, iters), 1
        )
        legs["engine/microbatch-mixed-city"] = _fleet_microbatch_leg(
            engine, hists, clients, per_client
        )

        stats = {
            str(ci): st.snapshot()
            for ci, st in engine.class_stats.items()
        }
        plan = engine.plan
        record = {
            "cities": {
                "n_nodes": n_nodes,
                "class_of": [engine.class_of(c) for c in range(len(n_nodes))],
                "shape_classes": [
                    {
                        "n_nodes": cls.n_nodes,
                        "cities": list(cls.cities),
                        "node_waste": round(cls.node_waste, 4),
                    }
                    for cls in plan.classes
                ],
            },
            "buckets": list(ladder),
            "max_delay_ms": max_delay_ms,
            "parity": parity,
            "legs": legs,
            "engine_stats": stats,
            "speedup": {
                "microbatch_vs_naive_b1": round(
                    legs["engine/microbatch-mixed-city"][
                        "predictions_per_sec"
                    ]
                    / legs["naive/b1-alternating"]["predictions_per_sec"],
                    2,
                ),
            },
        }
    return record


def run_serve_bench(fc, supports, *, batch: int = 16, buckets=(1, 4, 16),
                    max_delay_ms: float = 2.0, clients: int = 16,
                    per_client: int = 40, warmup: int = 3, iters: int = 30,
                    artifact_path: Optional[str] = None) -> dict:
    """Measure every serving path over one forecaster, on its device: the
    forecaster, its export artifact (written to ``artifact_path``, or to a
    temporary file for the call) and its engine. Returns the record body
    (``legs``/``engine_stats``/``speedup``/shape provenance)."""
    from stmgcn_tpu_torch.config import ServingConfig
    from stmgcn_tpu_torch.export import ExportedForecaster, export_forecaster
    from stmgcn_tpu_torch.serving.engine import ServingEngine

    seq_len, n_nodes, input_dim = (
        fc.seq_len,
        fc.derived["n_nodes"],
        fc.derived["input_dim"],
    )
    rng = np.random.default_rng(0)
    hist = {
        b: (rng.random((b, seq_len, n_nodes, input_dim)) * 50).astype(np.float32)
        for b in (1, batch)
    }

    # an internal artifact dir lives exactly as long as the measurement
    tmp_artifact_dir = None
    if artifact_path is None:
        tmp_artifact_dir = tempfile.mkdtemp(prefix="stmgcn_serve_")
        artifact_path = os.path.join(tmp_artifact_dir, "model.stmgx")
    try:
        export_forecaster(fc, artifact_path)
        ex = ExportedForecaster.load(artifact_path, device=fc.device)

        ladder = tuple(sorted(set(buckets)))
        cfg = ServingConfig(
            buckets=ladder, max_delay_ms=max_delay_ms, max_batch=ladder[-1],
        )
        engine = ServingEngine.from_forecaster(fc, supports, config=cfg, device=fc.device)

        legs = {}
        for b in (1, batch):
            h = hist[b]
            legs[f"forecaster/b{b}"] = _leg(
                _timed(lambda h=h: fc.predict(supports, h), warmup, iters), b
            )
            legs[f"exported/b{b}"] = _leg(
                _timed(lambda h=h: ex.predict(supports, h), warmup, iters), b
            )
            legs[f"engine/b{b}"] = _leg(
                _timed(lambda h=h: engine.predict_direct(h), warmup, iters), b
            )
        legs[f"engine/microbatch{batch}"] = _microbatch_leg(
            engine, hist[1], clients, per_client
        )

        stats = engine.stats.snapshot()
        engine.close()
    finally:
        if tmp_artifact_dir is not None:
            shutil.rmtree(tmp_artifact_dir, ignore_errors=True)
    speedup = {
        # engine batch-N rows/sec over batch-1
        "b16_vs_b1": round(
            legs[f"engine/b{batch}"]["predictions_per_sec"]
            / legs["engine/b1"]["predictions_per_sec"],
            2,
        ),
        # micro-batched concurrent throughput over the naive sequential path
        "microbatch_vs_sequential_b1": round(
            legs[f"engine/microbatch{batch}"]["predictions_per_sec"]
            / legs["forecaster/b1"]["predictions_per_sec"],
            2,
        ),
    }
    return {
        "shapes": {
            "n_nodes": n_nodes,
            "seq_len": seq_len,
            "input_dim": input_dim,
            "batch": batch,
            "buckets": list(cfg.buckets),
            "max_delay_ms": max_delay_ms,
        },
        "legs": legs,
        "engine_stats": stats,
        "speedup": speedup,
    }


def run_soak_leg(fc, supports, *, buckets=(1, 4, 16),
                 max_delay_ms: float = 2.0, soak_seconds: float = 2.0,
                 overload: float = 2.0, seed: int = 0) -> dict:
    """Overload soak: open-loop load above capacity against an SLO engine.

    The operability proof behind ``record["soak"]``:

    1. **calibrate** — measure the host's top-rung dispatch time on a
       throwaway engine; that sets capacity (rows/sec the device can
       actually drain) and derives the SLO from the host instead of a
       wall-clock constant (so the leg is meaningful on any machine).
    2. **soak** — an open-loop arrival schedule at ``overload``x capacity
       for ``soak_seconds``: arrivals fire on the clock whether or not
       earlier requests finished (what a real ingress does; a closed
       loop would politely self-throttle and never overload). Admitted
       requests record latency; sheds are counted by typed reason. No
       caller may hang — that's the zero-hung-callers claim.
    3. **hot-swap mid-soak** — halfway in, ``swap_params`` publishes a
       perturbed checkpoint under full load; responses carry their
       generation, and a bit-parity spot-check pins each generation's
       outputs to ``Forecaster.predict`` with the matching params.
    4. **distribution drift** — a :class:`~stmgcn_tpu_torch.obs.drift
       .DriftMonitor` rides on the engine with a baseline fitted to the
       calibration traffic, while the soak stream is deliberately
       shifted (``x1.6 + 10``): the generation-labeled drift gauges must
       move under the shifted load (``record["drift"]["pre_swap"]``) and
       the mid-soak swap must reset them atomically (``post_swap`` shows
       the bumped generation and a fresh, smaller sample count).

    The record marks ``contended`` via :func:`stmgcn_tpu_torch.utils.
    hostload.is_contended` — on a noisy host, judge ``slo_met``
    accordingly. With tracing on (``--trace-out``) the registry counts add
    ``recompiles_during_soak``: the CUDA-graph captures after the soak's
    warmup, the port's counterpart of a recompile (the swap's own ladder
    captures are counted apart, as swap captures).
    """
    import copy

    from stmgcn_tpu_torch.config import ServingConfig
    from stmgcn_tpu_torch.inference import Forecaster
    from stmgcn_tpu_torch.obs import graphmon
    from stmgcn_tpu_torch.obs import trace as obs_trace
    from stmgcn_tpu_torch.obs.drift import baseline_from_samples
    from stmgcn_tpu_torch.obs.registry import REGISTRY
    from stmgcn_tpu_torch.serving.admission import DeadlineExceeded, Overloaded
    from stmgcn_tpu_torch.serving.engine import ServingEngine
    from stmgcn_tpu_torch.utils.hostload import host_load_snapshot, is_contended

    ladder = tuple(sorted(set(buckets)))
    top = ladder[-1]
    seq_len, n_nodes, input_dim = (
        fc.seq_len, fc.derived["n_nodes"], fc.derived["input_dim"],
    )
    rng = np.random.default_rng(seed)
    h_req = (rng.random((top, seq_len, n_nodes, input_dim)) * 50).astype(
        np.float32
    )

    # -- 1. calibrate: top-rung dispatch time on THIS host --------------
    probe_cfg = ServingConfig(
        buckets=ladder, max_delay_ms=max_delay_ms, max_batch=top,
    )
    with ServingEngine.from_forecaster(fc, supports, config=probe_cfg,
                                       device=fc.device) as pr:
        for _ in range(3):
            pr.predict_direct(h_req)
        out_cal = pr.predict_direct(h_req)  # in-dist predictions for the
        t0 = time.perf_counter()            # drift baseline below
        n_probe = 10
        for _ in range(n_probe):
            pr.predict_direct(h_req)
        per_dispatch_ms = (time.perf_counter() - t0) * 1e3 / n_probe
    capacity_rps = top / (per_dispatch_ms / 1e3)

    # drift baseline fitted to the calibration-distribution traffic; the
    # soak stream below is shifted so the monitor has something to catch
    drift_bins = 32
    drift_baseline = {
        "schema_version": 1,
        "bins": drift_bins,
        "input": {"0": baseline_from_samples(
            h_req.reshape(-1, input_dim), bins=drift_bins
        )},
        "prediction": {"0": baseline_from_samples(
            np.asarray(out_cal, np.float32).reshape(-1, input_dim),
            bins=drift_bins,
        )},
    }
    h_soak = (h_req * 1.6 + 10.0).astype(np.float32)

    # SLO derived from the measured floor: tolerate a queue ~5 dispatches
    # deep (the queue bound sheds Overloaded first at 4), then shed on
    # estimated wait / in-queue expiry. End-to-end target = the deadline
    # an admitted request may burn in queue + its own dispatch, with
    # host-jitter headroom.
    deadline_ms = 6.0 * per_dispatch_ms + 4.0 * max_delay_ms
    queue_bound_rows = 4 * top
    slo_target_ms = deadline_ms + 3.0 * per_dispatch_ms
    cfg = ServingConfig(
        buckets=ladder, max_delay_ms=max_delay_ms, max_batch=top,
        deadline_ms=deadline_ms, queue_bound_rows=queue_bound_rows,
    )

    # open-loop schedule: batch-`top` requests (one dispatch each) at
    # overload x the calibrated dispatch rate, for the wall budget
    interval_s = (per_dispatch_ms / 1e3) / overload
    n_arrivals = min(int(soak_seconds / interval_s), 2000)
    # enough clients that the schedule stays open-loop even when every
    # request rides out the full deadline before returning
    worst_s = (deadline_ms + 2.0 * per_dispatch_ms) / 1e3
    clients = min(64, max(8, int(worst_s / interval_s) + 4))

    load_before = host_load_snapshot()
    admitted_ms: List[float] = []
    gen_counts: dict = {}
    shed_local = {"overloaded": 0, "deadline": 0}
    behind_schedule = [0]
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)
    t_start = [0.0]

    swaps_before = REGISTRY.counter("serving.swaps").value
    engine = ServingEngine.from_forecaster(fc, supports, config=cfg, device=fc.device)
    traced = obs_trace.active_tracer() is not None
    try:
        base = fc.predict(supports, h_req)
        parity_gen0 = bool(np.array_equal(base, engine.predict_direct(h_req)))
        # arm drift AFTER the parity probe so the sketches hold only the
        # (shifted) soak stream; the swap below must reset them
        engine.enable_drift(drift_baseline, city=0)
        drift_pre: List[dict] = []

        new_params = {k: v * 1.001 for k, v in fc.state_dict.items()}
        fc_new = Forecaster(
            copy.deepcopy(fc.model), new_params, fc.normalizer, fc.config, fc.derived,
            getattr(fc, "normalizers", None), device=fc.device,
        )
        if traced:
            # the rungs are captured and probed, and the swap payload is
            # built: a capture DURING the soak (other than the swap's own
            # ladder, counted apart) is a serving incident the gauge shows
            graphmon.mark_warmup_complete()

        def client(i: int):
            my_admitted, my_gens = [], {}
            my_shed = {"overloaded": 0, "deadline": 0}
            my_behind = 0
            barrier.wait()
            for k in range(i, n_arrivals, clients):
                delay = t_start[0] + k * interval_s - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                else:
                    my_behind += 1  # fired late but still fired: open loop
                t0 = time.perf_counter()
                try:
                    _, gen = engine.predict(h_soak, with_generation=True)
                    my_admitted.append((time.perf_counter() - t0) * 1e3)
                    my_gens[gen] = my_gens.get(gen, 0) + 1
                except Overloaded:
                    my_shed["overloaded"] += 1
                except DeadlineExceeded:
                    my_shed["deadline"] += 1
            with lock:
                admitted_ms.extend(my_admitted)
                for g, c in my_gens.items():
                    gen_counts[g] = gen_counts.get(g, 0) + c
                for r in my_shed:
                    shed_local[r] += my_shed[r]
                behind_schedule[0] += my_behind

        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(clients)
        ]
        for th in threads:
            th.start()
        swap_done = threading.Event()
        swap_error: List[str] = []

        def mid_soak_swap():
            try:
                # the drift sketches as the shifted stream left them,
                # captured the instant before the swap resets them
                drift_pre.append(engine.drift_snapshot())
                engine.swap_params(new_params)
                swap_done.set()
            except Exception as e:  # a failed swap must land in the record,
                # not vanish with the timer thread
                swap_error.append(f"{type(e).__name__}: {e}")

        swapper = threading.Timer(
            max(0.05, n_arrivals * interval_s / 2.0), mid_soak_swap
        )
        barrier.wait()
        t_start[0] = time.perf_counter()
        swapper.start()
        deadline_join = time.monotonic() + 60.0
        for th in threads:
            th.join(timeout=max(0.0, deadline_join - time.monotonic()))
        hung = sum(th.is_alive() for th in threads)
        swapper.join()
        recompiles_soak = int(graphmon.freeze_recaptures()) if traced else None
        # post-swap drift state BEFORE the parity probe below feeds the
        # gen-1 sketches in-dist rows: must show the bumped generation
        # and only post-swap soak traffic
        drift_post = engine.drift_snapshot()
        # generation-1 parity after the dust settles: the engine now
        # serves the swapped params and must match a Forecaster built
        # from them bit-exactly
        parity_gen1 = bool(
            np.array_equal(fc_new.predict(supports, h_req),
                           engine.predict_direct(h_req))
        )
        stats = engine.stats.snapshot()
        generation_after = engine.generation
        # shed/degrade/swap counts read back from the process-wide
        # metrics registry (stmgcn_tpu_torch.obs.registry) — the same counters
        # a metrics endpoint would scrape, cross-checkable against the
        # client-side tallies above
        registry_counts = {
            "shed": engine.stats.shed_counts(),
            "swaps": int(
                REGISTRY.counter("serving.swaps").value - swaps_before
            ),
            "generation": int(REGISTRY.gauge("serving.generation").value),
        }
        if recompiles_soak is not None:
            registry_counts["recompiles_during_soak"] = recompiles_soak
    finally:
        engine.close()
    load_after = host_load_snapshot()

    pct = percentiles(admitted_ms)
    host_load = {"before": load_before, "after": load_after}
    return {
        "calibration": {
            "per_dispatch_ms": round(per_dispatch_ms, 3),
            "capacity_rows_per_sec": round(capacity_rps, 1),
        },
        "config": {
            "buckets": list(ladder),
            "max_delay_ms": max_delay_ms,
            "deadline_ms": round(deadline_ms, 3),
            "queue_bound_rows": queue_bound_rows,
            "overload": overload,
            "soak_seconds": soak_seconds,
            "clients": clients,
            "request_rows": top,
            "offered_requests": n_arrivals,
            "offered_rows_per_sec": round(overload * capacity_rps, 1),
        },
        "admitted": len(admitted_ms),
        "shed": shed_local,
        "shed_recorded": stats["totals"]["shed"],
        "registry": registry_counts,
        "behind_schedule": behind_schedule[0],
        "admitted_latency_ms": pct,
        "slo_target_ms": round(slo_target_ms, 3),
        "slo_met": (
            pct["p99"] is not None and pct["p99"] <= slo_target_ms
        ),
        "hung_clients": hung,
        "hot_swap": {
            "swap_applied": swap_done.is_set(),
            "swap_error": swap_error[0] if swap_error else None,
            "generation_after": generation_after,
            "responses_by_generation": {
                str(g): c for g, c in sorted(gen_counts.items())
            },
            "parity_gen0": parity_gen0,
            "parity_gen1": parity_gen1,
        },
        "drift": {
            "bins": drift_bins,
            "stream_shift": "x1.6 + 10",
            "pre_swap": drift_pre[0] if drift_pre else None,
            "post_swap": drift_post,
        },
        "host_load": host_load,
        "contended": is_contended(host_load),
    }


def federation_forecaster(fc, supports, n_cities: int = 8):
    """Lift the throwaway checkpoint into a C-city *homogeneous* fleet
    view for the federation tier: every city is the trained grid, so
    all land in one shape class, any replica can serve any city (ring
    ownership is routing policy, not capability — a re-shard never
    rebuilds an engine), and same-class requests coalesce. Returns
    ``(hetero_fc, per_city_supports, n_nodes)``."""
    from stmgcn_tpu_torch.data import MinMaxNormalizer, synthetic_dataset
    from stmgcn_tpu_torch.inference import Forecaster

    cfg = fc.config
    m = cfg.model.m_graphs
    sup = np.asarray(supports, np.float32)[:m]
    norm = (
        fc.normalizer if fc.normalizer is not None
        else MinMaxNormalizer.fit(
            np.asarray(
                synthetic_dataset(rows=4, n_timesteps=24 * 7 * 2 + 40,
                                  seed=1).demand
            )
        )
    )
    hetero = Forecaster(
        fc.model, fc.state_dict, None, cfg,
        {"input_dim": fc.derived["input_dim"],
         "n_nodes": [sup.shape[-1]] * n_cities},
        [norm] * n_cities, device=fc.device,
    )
    return hetero, [sup] * n_cities, [sup.shape[-1]] * n_cities


def run_federation_soak(fc, supports, *, replicas: int = 4,
                        n_cities: int = 0, buckets=(1, 4, 16),
                        max_delay_ms: float = 2.0,
                        soak_seconds: float = 2.0, overload: float = 2.0,
                        seed: int = 0) -> dict:
    """The federation tier under open-loop load + four fault drills.

    Builds ``replicas`` fleet engines plus one warm spare over a C-city
    homogeneous view (:func:`federation_forecaster`; C defaults to
    ``max(2 * replicas, 4)`` so the ``federation-config`` topology rule
    holds), shares one :class:`GlobalBudget` across every replica's
    admission controller, and routes multi-city scatter/gather requests
    through a :class:`FederationRouter`. The drills, all driven by one
    deterministic :class:`~stmgcn_tpu_torch.resilience.FederationFaultPlan`:

    1. **tier-wide rejection** (pre-soak) — a candidate checkpoint is
       byte-poisoned at rest; the :class:`TierPromotionGate` must
       quarantine it exactly once (one rename, one rejection count),
       with every replica untouched.
    2. **replica-kill mid-traffic** — at a scheduled scatter ordinal a
       replica is hard-killed; its cities re-shard away on the hash
       ring, affected in-flight cities come back as *typed* errors,
       and no caller hangs.
    3. **thundering-herd** — a scheduled burst hammers one city; local
       queue bounds and the tier-wide budget shed typed ``Overloaded``
       (reason ``tier-overloaded`` for global sheds), p99 of admitted
       work stays bounded by the derived SLO.
    4. **drain + re-shard under load** (post-soak, traffic still
       offered) — a replica with a hang-on-drain fault drains within
       its timeout (the hang is *bounded*, not waited out), and the
       warm spare is promoted into the ring mid-burst with a bounded
       handover and zero cross-generation responses.

    Mid-soak, a *good* candidate goes through the tier gate: every live
    replica cuts to the new generation and the router's gather contract
    keeps every multi-city response single-generation
    (``cross_generation`` must be 0). Capacity is reported as measured
    tier throughput over the calibrated single-engine rate
    (``capacity_x``) with ``n_cores`` and host-load provenance.
    """
    from stmgcn_tpu_torch.config import FederationConfig, ServingConfig
    from stmgcn_tpu_torch.models.params import to_jax_params
    from stmgcn_tpu_torch.resilience.faults import (
        FederationFaultPlan,
        FederationFaultSpec,
    )
    from stmgcn_tpu_torch.serving.admission import GlobalBudget, ShedError
    from stmgcn_tpu_torch.serving.federation import (
        FederationRouter,
        ReplicaUnavailable,
    )
    from stmgcn_tpu_torch.serving.fleet import FleetServingEngine
    from stmgcn_tpu_torch.serving.promotion import TierPromotionGate
    from stmgcn_tpu_torch.train.checkpoint import save_checkpoint
    from stmgcn_tpu_torch.utils.hostload import host_load_snapshot, is_contended

    if n_cities <= 0:
        n_cities = max(2 * replicas, 4)
    hetero, sups, n_nodes = federation_forecaster(fc, supports, n_cities)
    ladder = tuple(sorted(set(buckets)))
    top = ladder[-1]
    seq_len = hetero.seq_len
    input_dim = fc.derived["input_dim"]
    rng = np.random.default_rng(seed)
    hists = {
        c: (rng.random((1, seq_len, n_nodes[c], input_dim)) * 50).astype(
            np.float32
        )
        for c in range(n_cities)
    }

    # -- calibrate: single-engine batch-1 rate on THIS host -------------
    probe_cfg = ServingConfig(
        buckets=ladder, max_delay_ms=max_delay_ms, max_batch=top,
    )
    with FleetServingEngine.from_forecaster(
        hetero, sups, config=probe_cfg, device=hetero.device
    ) as probe:
        for _ in range(3):
            probe.predict_direct(hists[0], city=0)
        t0 = time.perf_counter()
        n_probe = 10
        for _ in range(n_probe):
            probe.predict_direct(hists[0], city=0)
        per_dispatch_ms = (time.perf_counter() - t0) * 1e3 / n_probe
    single_rps = 1e3 / per_dispatch_ms  # batch-1 predictions/sec

    # SLO + budgets derived from the measured floor (same discipline as
    # run_soak_leg); the tier budget sits above any single replica's
    # local bound so the federation-config ordering contract holds
    deadline_ms = 6.0 * per_dispatch_ms + 4.0 * max_delay_ms
    queue_bound_rows = 4 * top
    global_bound_rows = 2 * queue_bound_rows
    cities_per_request = min(3, n_cities)
    slo_target_ms = cities_per_request * (deadline_ms + 3.0 * per_dispatch_ms)
    slo_cfg = ServingConfig(
        buckets=ladder, max_delay_ms=max_delay_ms, max_batch=top,
        deadline_ms=deadline_ms, queue_bound_rows=queue_bound_rows,
    )
    fed_cfg = FederationConfig(
        enabled=True, replicas=replicas, spares=1,
        global_queue_bound_rows=global_bound_rows,
    )
    config_findings = fed_cfg.violations(serving=slo_cfg, n_cities=n_cities)

    # open-loop schedule: multi-city requests at overload x the rate one
    # engine could serve them sequentially
    interval_s = cities_per_request * (per_dispatch_ms / 1e3) / overload
    n_arrivals = max(12, min(int(soak_seconds / interval_s), 600))
    clients = min(32, max(6, int(
        (cities_per_request * (deadline_ms + 2.0 * per_dispatch_ms) / 1e3)
        / interval_s
    ) + 4))

    # the drill schedule, all in one deterministic plan
    kill_rid = min(2, replicas - 1)
    drain_rid = 1 if replicas > 1 else 0
    spare_rid = replicas  # the warm spare's id in the router
    kill_ordinal = max(2, n_arrivals // 3)
    herd_city = 0
    herd_burst_n = 4 * clients
    herd_ordinal = max(kill_ordinal + 2, (2 * n_arrivals) // 3)
    plan = FederationFaultPlan(
        FederationFaultSpec(kind="poisoned-candidate",
                            path_glob="candidate-0.ckpt"),
        FederationFaultSpec(kind="replica-kill", replica=kill_rid,
                            dispatch=kill_ordinal),
        FederationFaultSpec(kind="herd-spike", city=herd_city,
                            dispatch=herd_ordinal, burst=herd_burst_n),
        FederationFaultSpec(kind="hang-on-drain", replica=drain_rid,
                            hang_ms=80.0),
    )

    load_before = host_load_snapshot()
    budget = GlobalBudget(global_bound_rows)
    engines = [
        FleetServingEngine.from_forecaster(
            hetero, sups, config=slo_cfg, global_budget=budget, device=hetero.device
        )
        for _ in range(replicas)
    ]
    spare = FleetServingEngine.from_forecaster(
        hetero, sups, config=slo_cfg, global_budget=budget, device=hetero.device
    )
    router = FederationRouter(
        engines, range(n_cities), config=fed_cfg, spare_engines=[spare],
        global_budget=budget, fault_plan=plan,
    )
    record: dict = {}
    with tempfile.TemporaryDirectory(prefix="stmgcn_fed_") as tmp:
        watch_dir = os.path.join(tmp, "watch")
        stage_dir = os.path.join(tmp, "stage")
        os.makedirs(stage_dir)
        gate = TierPromotionGate(router, watch_dir)
        clean_health = {
            "nonfinite": 0, "grad_norm_max": 1.0, "update_ratio_max": 0.01,
        }
        try:
            # -- drill 1: tier-wide rejection of a poisoned candidate --
            poisoned = os.path.join(stage_dir, "candidate-0.ckpt")
            m = fc.config.model.m_graphs
            save_checkpoint(poisoned, to_jax_params(fc.state_dict, m), None,
                            {"drill": "poison"})
            decision_bad = gate.consider(poisoned, clean_health)
            tier_rejection = {
                "reason": decision_bad.reason,
                "accepted": decision_bad.accepted,
                "quarantined_path": os.path.basename(decision_bad.path),
                # the gate ran once for the whole tier: one rejection,
                # one quarantine rename — not one per replica
                "rejections_counted": gate.rejections,
                "generations_untouched": all(
                    e.generation == 0 for e in router.engines().values()
                ),
            }

            # -- soak: open-loop multi-city scatter/gather -------------
            good = os.path.join(stage_dir, "candidate-1.ckpt")
            new_params = {k: v * 1.001 for k, v in fc.state_dict.items()}
            save_checkpoint(good, to_jax_params(new_params, m), None, {"drill": "promote"})

            req_ms: List[float] = []
            outcome_counts = {"ok": 0}
            cross_generation = [0]
            herd_stats = {"extra_ok": 0, "extra_shed": 0}
            behind = [0]
            ok_predictions = [0]
            lock = threading.Lock()
            barrier = threading.Barrier(clients + 1)
            t_start = [0.0]
            promote_result: List[object] = []

            def one_request(k: int):
                cities_k = [
                    (k * cities_per_request + j) % n_cities
                    for j in range(cities_per_request)
                ]
                t0 = time.perf_counter()
                outcomes = router.predict_many(
                    {c: hists[c] for c in cities_k}
                )
                dt_ms = (time.perf_counter() - t0) * 1e3
                gens = set()
                counts: dict = {}
                n_ok = 0
                for o in outcomes.values():
                    if o.ok:
                        n_ok += 1
                        gens.add(o.generation)
                    else:
                        key = type(o.error).__name__
                        counts[key] = counts.get(key, 0) + 1
                mixed = len(gens) > 1
                return dt_ms, n_ok, counts, mixed

            def client(i: int):
                mine_ms, mine_counts = [], {}
                mine_ok = mine_mixed = mine_behind = 0
                herd_ok = herd_shed = 0
                barrier.wait()
                for k in range(i, n_arrivals, clients):
                    delay = t_start[0] + k * interval_s - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    else:
                        mine_behind += 1  # late but fired: open loop
                    for city, burst in plan.herd_burst(k):
                        # the herd drill: a synchronized spike of extra
                        # single-city arrivals on top of the schedule
                        for _ in range(burst // clients + 1):
                            try:
                                router.predict(hists[city], city=city)
                                herd_ok += 1
                            except ShedError:
                                herd_shed += 1
                    dt_ms, n_ok, counts, mixed = one_request(k)
                    mine_ms.append(dt_ms)
                    mine_ok += n_ok
                    mine_mixed += int(mixed)
                    for key, n in counts.items():
                        mine_counts[key] = mine_counts.get(key, 0) + n
                with lock:
                    req_ms.extend(mine_ms)
                    ok_predictions[0] += mine_ok
                    cross_generation[0] += mine_mixed
                    behind[0] += mine_behind
                    herd_stats["extra_ok"] += herd_ok
                    herd_stats["extra_shed"] += herd_shed
                    for key, n in mine_counts.items():
                        outcome_counts[key] = outcome_counts.get(key, 0) + n

            def mid_soak_promotion():
                try:
                    promote_result.append(gate.consider(good, clean_health))
                except Exception as e:  # must land in the record, not die
                    # silently with the timer thread
                    promote_result.append(f"{type(e).__name__}: {e}")

            threads = [
                threading.Thread(target=client, args=(i,))
                for i in range(clients)
            ]
            for th in threads:
                th.start()
            promoter = threading.Timer(
                max(0.05, n_arrivals * interval_s / 2.0), mid_soak_promotion
            )
            barrier.wait()
            t_start[0] = time.perf_counter()
            promoter.start()
            t_soak0 = time.perf_counter()
            deadline_join = time.monotonic() + 60.0
            for th in threads:
                th.join(timeout=max(0.0, deadline_join - time.monotonic()))
            hung = sum(th.is_alive() for th in threads)
            promoter.join()
            # the clients' predict calls return host numpy: joined, fenced
            soak_elapsed = time.perf_counter() - t_soak0  # stmgcn: ignore[unfenced-timing]
            outcome_counts["ok"] = ok_predictions[0]
            tier_rps = ok_predictions[0] / soak_elapsed

            # -- drill 4: hang-on-drain, then warm spare under load ----
            drain_report = router.drain(drain_rid)
            burst_errors = {"ok": 0}
            burst_mixed = [0]

            def reshard_burst(i: int):
                for k in range(6):
                    dt_ms, n_ok, counts, mixed = one_request(
                        n_arrivals + i * 6 + k
                    )
                    with lock:
                        burst_errors["ok"] += n_ok
                        burst_mixed[0] += int(mixed)
                        for key, n in counts.items():
                            burst_errors[key] = burst_errors.get(key, 0) + n

            burst_threads = [
                threading.Thread(target=reshard_burst, args=(i,))
                for i in range(4)
            ]
            for th in burst_threads:
                th.start()
            promote_report = router.promote_spare(spare_rid)
            for th in burst_threads:
                th.join(30.0)
            hung += sum(th.is_alive() for th in burst_threads)

            # recovery: after kill + drain + re-shard, every city must
            # still be served by some live replica
            recovered = 0
            for c in range(n_cities):
                try:
                    router.predict(hists[c], city=c)
                    recovered += 1
                except ReplicaUnavailable:
                    pass  # no live owner: the drill failed to heal
                except ShedError:
                    recovered += 1  # shed on load is still a live owner
            gens_after = {
                str(rid): eng.generation
                for rid, eng in router.engines().items()
            }

            pct = percentiles(req_ms)
            record = {
                "config": {
                    "replicas": replicas,
                    "spares": 1,
                    "cities": n_cities,
                    "vnodes": fed_cfg.vnodes,
                    "buckets": list(ladder),
                    "max_delay_ms": max_delay_ms,
                    "deadline_ms": round(deadline_ms, 3),
                    "queue_bound_rows": queue_bound_rows,
                    "global_queue_bound_rows": global_bound_rows,
                    "overload": overload,
                    "soak_seconds": soak_seconds,
                    "clients": clients,
                    "cities_per_request": cities_per_request,
                    "offered_requests": n_arrivals,
                },
                "config_findings": config_findings,
                "calibration": {
                    "per_dispatch_ms": round(per_dispatch_ms, 3),
                    "single_engine_rps": round(single_rps, 1),
                },
                "capacity": {
                    "tier_rps": round(tier_rps, 1),
                    "capacity_x": round(tier_rps / single_rps, 2),
                    "n_cores": os.cpu_count(),
                },
                "soak": {
                    "offered": n_arrivals,
                    "outcomes": outcome_counts,
                    "cross_generation": cross_generation[0],
                    "hung_clients": hung,
                    "behind_schedule": behind[0],
                    "request_latency_ms": pct,
                    "slo_target_ms": round(slo_target_ms, 3),
                    "slo_met": (
                        pct["p99"] is not None and pct["p99"] <= slo_target_ms
                    ),
                },
                "drills": {
                    "tier_rejection": tier_rejection,
                    "replica_kill": {
                        "replica": kill_rid,
                        "ordinal": kill_ordinal,
                        "kills": router.kills,
                        "cities_moved": router.cities_moved,
                    },
                    "herd": {
                        "city": herd_city,
                        "burst": herd_burst_n,
                        **herd_stats,
                        "tier_shed": budget.snapshot()["refused"],
                    },
                    "drain": drain_report,
                    "reshard_promote": {
                        **promote_report,
                        "burst_outcomes": burst_errors,
                        "burst_cross_generation": burst_mixed[0],
                    },
                },
                "promotion": {
                    "mid_soak": (
                        {
                            "accepted": promote_result[0].accepted,
                            "reason": promote_result[0].reason,
                            "generation": promote_result[0].generation,
                        }
                        if promote_result and not isinstance(
                            promote_result[0], str
                        )
                        else (promote_result[0] if promote_result else None)
                    ),
                    "generations_after": gens_after,
                    "detached_on_cutover": list(gate.detached),
                },
                "recovery": {
                    "cities_serveable": recovered,
                    "cities_total": n_cities,
                },
                "budget": budget.snapshot(),
                "router": router.health(),
            }
        finally:
            router.close()
    load_after = host_load_snapshot()
    record["host_load"] = {"before": load_before, "after": load_after}
    record["contended"] = is_contended(record["host_load"])
    return record


def build_serve_bench_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stmgcn serve-bench",
        description="serving benchmark of the port: naive vs exported vs "
        "captured-rung vs micro-batched prediction throughput",
    )
    p.add_argument("--rows", type=int, default=4,
                   help="synthetic grid rows for the throwaway checkpoint "
                        "(N = rows^2; default 4)")
    p.add_argument("--batch", type=int, default=16,
                   help="the large-batch point to measure (default 16)")
    p.add_argument("--buckets", type=str, default="1,4,16",
                   help="comma-separated bucket ladder (default 1,4,16 — "
                        "size the top rung to peak concurrency)")
    p.add_argument("--full-model", action="store_true",
                   help="bench the full-size default model instead of the "
                        "slim dispatch-dominated operating point")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="micro-batcher coalescing deadline (default 2.0)")
    p.add_argument("--clients", type=int, default=16,
                   help="concurrent batch-1 clients for the micro-batch leg")
    p.add_argument("--per-client", type=int, default=40,
                   help="requests each client issues (default 40)")
    p.add_argument("--iters", type=int, default=30,
                   help="timed iterations per direct leg (default 30)")
    p.add_argument("--warmup", type=int, default=3,
                   help="warmup calls per leg, excluded from stats")
    p.add_argument("--no-fleet", action="store_true",
                   help="skip the two-city fleet-engine leg "
                        "(record['fleet'])")
    p.add_argument("--soak", action="store_true",
                   help="run the overload soak leg (record['soak']): "
                        "open-loop load above calibrated capacity against "
                        "an SLO-configured engine, typed shed counts, "
                        "admitted p50/p95/p99 vs the derived SLO target, "
                        "and a mid-soak param hot-swap with per-generation "
                        "parity")
    p.add_argument("--soak-seconds", type=float, default=2.0,
                   help="soak wall budget in seconds (default 2.0)")
    p.add_argument("--soak-overload", type=float, default=2.0,
                   help="offered load as a multiple of calibrated capacity "
                        "(default 2.0)")
    p.add_argument("--federation", type=int, default=0, metavar="M",
                   help="run the M-replica federation soak "
                        "(record['federation']): a warm spare, a shared "
                        "tier-wide admission budget, open-loop multi-city "
                        "scatter/gather, and the four fault drills — "
                        "replica-kill mid-traffic, thundering-herd, "
                        "tier-wide poisoned-candidate rejection + "
                        "generation-consistent promotion, hang-on-drain + "
                        "warm-spare re-shard under load (default 0: off)")
    p.add_argument("--federation-cities", type=int, default=0,
                   help="cities the federation shards across the hash ring "
                        "(default 0: max(2*M, 4) — at least as many cities "
                        "as replicas, per the federation-config rule)")
    p.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                   help="record per-request spans (admit -> queue -> "
                        "device -> scatter, generation-stamped) plus CUDA-graph "
                        "capture telemetry; writes the JSONL timeline to "
                        "PATH and adds record['obs']")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train, export and serve (default: the GPU; "
                        "there is no fallback to the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry. Prints EXACTLY one JSON line on stdout (the record);
    everything else — training chatter, build logs — goes to stderr."""
    from stmgcn_tpu_torch.obs import graphmon
    from stmgcn_tpu_torch.obs import trace as obs_trace

    args = build_serve_bench_parser().parse_args(argv)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.trace_out:
        obs_trace.configure()

    record_stream = sys.stdout
    sys.stdout = sys.stderr  # anything a dependency prints stays off-record
    try:
        # one temp dir holds the throwaway checkpoint AND the export
        # artifact for exactly the measurement's lifetime
        with tempfile.TemporaryDirectory(prefix="stmgcn_serve_") as tmp:
            def _phase(name):
                # top-level bench phases bound the trace timeline, so the
                # report's wall coverage holds even for legs whose inner
                # spans live on worker/client threads; no-ops without
                # --trace-out
                return obs_trace.span(name)

            sp = _phase("bench.train_throwaway")
            fc, supports = train_throwaway(
                rows=args.rows, slim=not args.full_model,
                out_dir=os.path.join(tmp, "ckpt"), device=args.device,
            )
            sp.end()
            if args.trace_out:
                # pin the training run's recapture reading: every engine the
                # legs below build captures fresh programs (first captures,
                # not recaptures); the soak leg re-marks once its own
                # warmup is done
                graphmon.freeze_recaptures()
            sp = _phase("bench.serve")
            record = run_serve_bench(
                fc, supports, batch=args.batch, buckets=buckets,
                max_delay_ms=args.max_delay_ms, clients=args.clients,
                per_client=args.per_client, warmup=args.warmup,
                iters=args.iters,
                artifact_path=os.path.join(tmp, "model.stmgx"),
            )
            sp.end()
            if not args.no_fleet:
                sp = _phase("bench.fleet")
                record["fleet"] = run_fleet_serve_bench(
                    fc, supports, buckets=buckets,
                    max_delay_ms=args.max_delay_ms, clients=args.clients,
                    per_client=args.per_client, warmup=args.warmup,
                    iters=args.iters,
                )
                sp.end()
            if args.soak:
                sp = _phase("bench.soak")
                record["soak"] = run_soak_leg(
                    fc, supports, buckets=buckets,
                    max_delay_ms=args.max_delay_ms,
                    soak_seconds=args.soak_seconds,
                    overload=args.soak_overload,
                )
                sp.end()
                # the continual-loop drill rides every soak: live ingest
                # into the device ring, a drift-triggered fine-tune, one
                # guarded promotion, and one poisoned candidate rejected
                # at the gate — all while the engine keeps answering
                sp = _phase("bench.continual")
                from stmgcn_tpu_torch.train.continual import closed_loop_smoke

                record["soak"]["continual"] = closed_loop_smoke(
                    os.path.join(tmp, "continual"), device=args.device
                )
                sp.end()
            if args.federation > 0:
                sp = _phase("bench.federation")
                record["federation"] = run_federation_soak(
                    fc, supports, replicas=args.federation,
                    n_cities=args.federation_cities, buckets=buckets,
                    max_delay_ms=args.max_delay_ms,
                    soak_seconds=args.soak_seconds,
                    overload=args.soak_overload,
                )
                sp.end()
        record["captured_at"] = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
        )
        if args.trace_out:
            trc = obs_trace.active_tracer()
            n_spans = trc.export_jsonl(args.trace_out) if trc else 0
            record["obs"] = {
                **graphmon.snapshot(),
                "trace_path": args.trace_out,
                "trace_spans": n_spans,
            }
            print(
                f"trace written to {args.trace_out} ({n_spans} spans) — inspect "
                f"with `python -m stmgcn_tpu_torch.cli obs {args.trace_out}`",
                file=sys.stderr,
            )
    finally:
        sys.stdout = record_stream
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
