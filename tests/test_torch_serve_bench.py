"""The port's ``serve-bench`` (``stmgcn_tpu_torch/serving/bench.py``) on
the CPU, at a 2x2 slim grid.

The record's keys are the JAX record's: the expected sets below are read
off ``stmgcn_tpu/serving/bench.py`` (``run_serve_bench``,
``run_fleet_serve_bench``, ``run_soak_leg``, ``run_federation_soak`` and
``main``), whose slow bench is not run here. Each leg is held to its
contract (throughput, parity, no hung caller, the drills), and ``main``
prints exactly one JSON line.
"""

import json

import numpy as np
import pytest
import torch

from stmgcn_tpu_torch.serving.bench import (
    main,
    run_federation_soak,
    run_fleet_serve_bench,
    run_serve_bench,
    run_soak_leg,
    train_throwaway,
)

torch.set_num_threads(1)

LEG = {"ms", "p50_ms", "p95_ms", "p99_ms", "predictions_per_sec"}
CLIENT_LEG = LEG | {"clients", "requests"}
RECORD = {"shapes", "legs", "engine_stats", "speedup"}
SHAPES = {"n_nodes", "seq_len", "input_dim", "batch", "buckets", "max_delay_ms"}
SPEEDUP = {"b16_vs_b1", "microbatch_vs_sequential_b1"}
FLEET = {"cities", "buckets", "max_delay_ms", "parity", "legs", "engine_stats", "speedup"}
FLEET_LEGS = {"naive/b1-alternating", "engine/b1-alternating", "engine/microbatch-mixed-city"}
SOAK = {"calibration", "config", "admitted", "shed", "shed_recorded", "registry",
        "behind_schedule", "admitted_latency_ms", "slo_target_ms", "slo_met", "hung_clients",
        "hot_swap", "drift", "host_load", "contended"}
SOAK_CONFIG = {"buckets", "max_delay_ms", "deadline_ms", "queue_bound_rows", "overload",
               "soak_seconds", "clients", "request_rows", "offered_requests",
               "offered_rows_per_sec"}
HOT_SWAP = {"swap_applied", "swap_error", "generation_after", "responses_by_generation",
            "parity_gen0", "parity_gen1"}
CONTINUAL = {"schema_version", "promotions", "rejections", "nonfinite", "rejection_reason",
             "generation", "rows_ingested", "ring_len", "predictions", "daemon_down"}
FEDERATION = {"config", "config_findings", "calibration", "capacity", "soak", "drills",
              "promotion", "recovery", "budget", "router", "host_load", "contended"}
FED_CONFIG = {"replicas", "spares", "cities", "vnodes", "buckets", "max_delay_ms",
              "deadline_ms", "queue_bound_rows", "global_queue_bound_rows", "overload",
              "soak_seconds", "clients", "cities_per_request", "offered_requests"}
FED_SOAK = {"offered", "outcomes", "cross_generation", "hung_clients", "behind_schedule",
            "request_latency_ms", "slo_target_ms", "slo_met"}
DRILLS = {"tier_rejection", "replica_kill", "herd", "drain", "reshard_promote"}
SMALL = dict(buckets=(1, 4), max_delay_ms=2.0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_throwaway(rows=2, out_dir=str(tmp_path_factory.mktemp("ckpt")), device="cpu")


def test_throwaway_forecaster(trained):
    fc, supports = trained
    assert fc.device.type == "cpu" and fc.derived["n_nodes"] == 4
    assert supports.shape == (3, 3, 4, 4)
    rows = np.ones((2, fc.seq_len, 4, 1), np.float32)
    assert np.isfinite(fc.predict(supports, rows)).all()


def test_serve_record(trained, tmp_path):
    fc, supports = trained
    record = run_serve_bench(fc, supports, batch=4, clients=4, per_client=3, warmup=1,
                             iters=3, artifact_path=str(tmp_path / "m.stmgx"), **SMALL)
    assert set(record) == RECORD and set(record["shapes"]) == SHAPES
    assert set(record["speedup"]) == SPEEDUP
    legs = record["legs"]
    assert set(legs) == {f"{kind}/b{b}" for kind in ("forecaster", "exported", "engine")
                         for b in (1, 4)} | {"engine/microbatch4"}
    for name, leg in legs.items():
        assert set(leg) == (CLIENT_LEG if "microbatch" in name else LEG)
        assert leg["predictions_per_sec"] > 0
    assert legs["engine/microbatch4"]["requests"] == 12
    assert record["engine_stats"]["totals"]["requests"] >= 12


def test_fleet_record(trained):
    fc, supports = trained
    record = run_fleet_serve_bench(fc, supports, clients=4, per_client=3, warmup=1, iters=3,
                                   **SMALL)
    assert set(record) == FLEET and set(record["legs"]) == FLEET_LEGS
    assert record["parity"] is True
    assert record["cities"]["n_nodes"] == [4, 14]
    assert set(record["speedup"]) == {"microbatch_vs_naive_b1"}
    assert "cross_city_dispatches" in record["legs"]["engine/microbatch-mixed-city"]
    assert all(leg["predictions_per_sec"] > 0 for leg in record["legs"].values())


def test_soak_record(trained):
    fc, supports = trained
    record = run_soak_leg(fc, supports, soak_seconds=0.5, **SMALL)
    assert set(record) == SOAK and set(record["config"]) == SOAK_CONFIG
    assert set(record["hot_swap"]) == HOT_SWAP
    assert set(record["calibration"]) == {"per_dispatch_ms", "capacity_rows_per_sec"}
    assert set(record["shed"]) == {"overloaded", "deadline"}
    assert set(record["drift"]) == {"bins", "stream_shift", "pre_swap", "post_swap"}
    assert set(record["registry"]) == {"shed", "swaps", "generation"}
    assert record["hung_clients"] == 0
    swap = record["hot_swap"]
    assert swap["swap_applied"] and swap["swap_error"] is None
    assert swap["generation_after"] == 1 and swap["parity_gen0"] and swap["parity_gen1"]
    assert record["registry"]["swaps"] == 1
    assert record["drift"]["post_swap"]["generation"] == 1


def test_federation_record(trained):
    fc, supports = trained
    record = run_federation_soak(fc, supports, replicas=2, soak_seconds=0.5, **SMALL)
    assert set(record) == FEDERATION and set(record["config"]) == FED_CONFIG
    assert set(record["soak"]) == FED_SOAK and set(record["drills"]) == DRILLS
    assert set(record["capacity"]) == {"tier_rps", "capacity_x", "n_cores"}
    assert record["config"]["cities"] == 4 and record["config_findings"] == []
    drills = record["drills"]
    assert set(drills["tier_rejection"]) == {"reason", "accepted", "quarantined_path",
                                             "rejections_counted", "generations_untouched"}
    assert not drills["tier_rejection"]["accepted"]
    assert drills["tier_rejection"]["rejections_counted"] == 1
    assert drills["tier_rejection"]["generations_untouched"]
    assert set(drills["replica_kill"]) == {"replica", "ordinal", "kills", "cities_moved"}
    assert drills["replica_kill"]["kills"] == 1
    assert set(drills["herd"]) == {"city", "burst", "extra_ok", "extra_shed", "tier_shed"}
    assert drills["drain"]["flushed"]
    assert drills["reshard_promote"]["burst_cross_generation"] == 0
    assert record["soak"]["hung_clients"] == 0 and record["soak"]["cross_generation"] == 0
    assert record["promotion"]["mid_soak"]["accepted"] is True
    assert set(record["promotion"]) == {"mid_soak", "generations_after", "detached_on_cutover"}
    assert record["recovery"] == {"cities_serveable": 4, "cities_total": 4}


def test_main_prints_one_json_line(capsys, tmp_path):
    trace_out = str(tmp_path / "trace.jsonl")
    assert main(["--device", "cpu", "--rows", "2", "--batch", "4", "--buckets", "1,4",
                 "--clients", "4", "--per-client", "3", "--iters", "3", "--warmup", "1",
                 "--soak", "--soak-seconds", "0.5", "--federation", "2",
                 "--trace-out", trace_out]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert set(record) == RECORD | {"fleet", "soak", "federation", "captured_at", "obs"}
    assert set(record["soak"]) == SOAK | {"continual"}
    loop = record["soak"]["continual"]
    assert set(loop) == CONTINUAL
    assert loop["promotions"] == 1 and loop["rejection_reason"] == "nonfinite"
    assert "recompiles_during_soak" in record["soak"]["registry"]
    obs = record["obs"]
    assert obs["trace_path"] == trace_out and obs["trace_spans"] > 0
    assert {"captures", "recaptures_after_warmup"} <= set(obs)
    with open(trace_out) as f:
        assert sum(1 for _ in f) > 0
