"""The port's serving federation (``stmgcn_tpu_torch/serving/federation.py``)
and tier gate against the JAX package's (mirroring ``tests/test_federation.py``).

- ``ring_hash`` and ``HashRing`` (assignment, minimal movement, imbalance)
  equal the JAX ring's for the same replica ids and cities;
- ``GlobalBudget`` accounting and the admission controller's tier shed
  equal the JAX ones under the same calls;
- every router drill (routing, typed partial failure, kill and heal, the
  fault plan's kill at scatter, a generation split, hang-on-drain, spare
  promotion, concurrent scatters under a budget, the drift rollup, close)
  and every tier-gate drill (cutover everywhere, poisoned candidate
  quarantined once, a missed cutover detached) on the JAX test's fake
  replicas gives the JAX router's outcomes, each drill run on both;
- with real port fleet engines on the CPU (three replicas and a warm spare
  over one shared ``GlobalBudget``): answers through the router bitwise the
  owning engine's direct answers, a kill and a drain keeping every city
  served, the spare joining, a tier promotion cutting every live replica
  over to the new weights (equal to a ``Forecaster`` over them), and
  ``close()`` releasing every engine's programs.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import stmgcn_tpu.config as jax_config
import stmgcn_tpu.resilience as jax_resilience
import stmgcn_tpu.serving as jax_serving
import stmgcn_tpu.serving.metrics as jax_metrics
import stmgcn_tpu.train.checkpoint as jax_checkpoint
import stmgcn_tpu_torch.config as port_config
import stmgcn_tpu_torch.resilience as port_resilience
import stmgcn_tpu_torch.serving as port_serving
import stmgcn_tpu_torch.serving.metrics as port_metrics
import stmgcn_tpu_torch.train.checkpoint as port_checkpoint
from stmgcn_tpu_torch import Forecaster, ServingConfig, to_jax_params
from stmgcn_tpu_torch.experiment import build_model
from test_torch_fleet_serving import LADDER, _history, fleet_setup  # noqa: F401

torch.set_num_threads(1)

PKGS = {
    "port": (port_config, port_resilience, port_serving, port_metrics, port_checkpoint),
    "jax": (jax_config, jax_resilience, jax_serving, jax_metrics, jax_checkpoint),
}
HIST = np.zeros((1, 3), np.float32)


class _Pkg:
    def __init__(self, name):
        self.config, self.resilience, self.serving, self.metrics, self.checkpoint = PKGS[name]


def both(drill):
    """``drill(pkg)`` on the port and on the JAX package: equal summaries."""
    ours, theirs = drill(_Pkg("port")), drill(_Pkg("jax"))
    assert ours == theirs
    return ours


# -- fakes: the router needs predict/close/generation/drift_snapshot ------------

class FakeWatcher:
    def __init__(self, engine, fail=False):
        self._engine = engine
        self.fail = fail
        self.polls = 0

    def poll(self):
        self.polls += 1
        if self.fail:
            return False
        self._engine.generation += 1
        return True

    def stop(self, timeout_s=None):
        return True


class FakeEngine:
    def __init__(self, pkg, *, delay_s=0.0, watcher_fails=False):
        self.pkg = pkg
        self.generation = 0
        self.shed_cities = set()
        self.delay_s = delay_s
        self.watcher_fails = watcher_fails
        self.closed = False
        self.calls = []
        self._watcher = None

    def predict(self, history, *, city, with_generation=False):
        if self.delay_s:
            time.sleep(self.delay_s)
        if city in self.shed_cities:
            raise self.pkg.serving.Overloaded(f"fake shed for city {city}")
        self.calls.append(city)
        out = np.full((1, 2), float(city), np.float32)
        return (out, self.generation) if with_generation else out

    def drift_snapshot(self):
        return {"cities": {"0": {"input": {"z_max": 0.5 + self.generation, "psi": 0.1}}}}

    def watch_checkpoints(self, out_dir, **kwargs):
        self._watcher = FakeWatcher(self, fail=self.watcher_fails)
        return self._watcher

    def close(self):
        self.closed = True


def make_router(pkg, n_replicas=3, n_cities=9, *, spares=0, fault_plan=None, budget=None,
                **engine_kw):
    engines = [FakeEngine(pkg, **engine_kw) for _ in range(n_replicas)]
    spare_engines = [FakeEngine(pkg) for _ in range(spares)]
    cfg = pkg.config.FederationConfig(enabled=True, replicas=n_replicas, spares=spares)
    router = pkg.serving.FederationRouter(engines, range(n_cities), config=cfg,
                                          spare_engines=spare_engines, global_budget=budget,
                                          fault_plan=fault_plan)
    return router, engines, spare_engines


def _outcomes(outcomes) -> dict:
    return {c: (o.ok, None if o.ok else type(o.error).__name__, o.replica, o.generation,
                None if o.prediction is None else float(o.prediction[0, 0]))
            for c, o in sorted(outcomes.items())}


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# -- the hash ring ----------------------------------------------------------------

def test_ring_hash_is_the_jax_hash():
    assert port_serving.ring_hash("replica:0#0") == 0xC92D06DA2EFA9FE3
    for key in ("city:0", "city:17", "replica:3#63", "x"):
        assert port_serving.ring_hash(key) == jax_serving.ring_hash(key)


@pytest.mark.parametrize("replicas,vnodes,cities", [
    ((0, 1, 2), 64, 50), ((2, 0, 1), 64, 50), ((0, 2), 64, 64), ((0, 1, 2, 3, 5), 16, 200),
    ((7,), 4, 10)])
def test_hash_ring_assignment_equals_jax(replicas, vnodes, cities):
    ours = port_serving.HashRing(replicas, vnodes=vnodes)
    theirs = jax_serving.HashRing(replicas, vnodes=vnodes)
    assert ours.assignment(range(cities)) == theirs.assignment(range(cities))
    assert ours.imbalance(range(cities)) == theirs.imbalance(range(cities))


def test_hash_ring_minimal_movement_and_validation():
    cities = range(64)
    before = port_serving.HashRing([0, 1, 2]).assignment(cities)
    after = port_serving.HashRing([0, 2]).assignment(cities)
    assert all(after[c] == before[c] for c in cities if before[c] != 1)
    grown = port_serving.HashRing([0, 1, 2, 3]).assignment(cities)
    assert all(grown[c] in (before[c], 3) for c in cities)
    with pytest.raises(ValueError):
        port_serving.HashRing([], vnodes=4)
    with pytest.raises(ValueError):
        port_serving.HashRing([0], vnodes=0)


# -- the global budget ------------------------------------------------------------

def test_global_budget_accounting_equals_jax():
    def drill(pkg):
        b = pkg.serving.GlobalBudget(10)
        trace = [b.try_draw(6), b.try_draw(4), b.try_draw(1)]
        b.release(4)
        trace.append(b.try_draw(3))
        b.release(9)
        b.release(9)  # a double pay-back is clamped, not banked
        trace += [b.try_draw(10), b.try_draw(1)]
        with pytest.raises(ValueError):
            pkg.serving.GlobalBudget(0)
        return trace, b.snapshot()

    trace, snap = both(drill)
    assert trace == [True, True, False, True, True, False]
    assert snap == {"total_rows": 10, "outstanding": 10, "peak": 10, "refused": 2}


def test_global_budget_concurrent_accounting_is_exact():
    b = port_serving.GlobalBudget(8)

    def worker():
        for _ in range(200):
            if b.try_draw(1):
                b.release(1)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    snap = b.snapshot()
    assert snap["outstanding"] == 0 and snap["peak"] <= 8


def test_admission_sheds_tier_overloaded_after_local_checks():
    def drill(pkg):
        cfg = pkg.config.ServingConfig(buckets=(1, 4), max_batch=4, queue_bound_rows=100)
        stats = pkg.metrics.EngineStats()
        budget = pkg.serving.GlobalBudget(4)
        ctl = pkg.serving.AdmissionController(cfg, stats, (1, 4), global_budget=budget)
        ctl.admit(4, 0)
        with pytest.raises(pkg.serving.Overloaded, match="tier-wide"):
            ctl.admit(1, 4)
        with pytest.raises(pkg.serving.Overloaded, match="queue holds"):
            ctl.admit(200, 0)  # a locally shed request never draws the tier budget
        held = budget.snapshot()["outstanding"]
        ctl.release_rows(4)
        return held, budget.snapshot(), stats.shed_counts()

    held, snap, sheds = both(drill)
    assert held == 4 and snap["outstanding"] == 0 and sheds.get("tier-overloaded") == 1


# -- router drills on fakes, both packages ---------------------------------------

def test_predict_routes_to_the_ring_owner():
    def drill(pkg):
        router, engines, _ = make_router(pkg)
        try:
            out = {}
            for c in range(9):
                rid = router.replica_for(c)
                out[c] = (float(router.predict(HIST, city=c)[0, 0]), rid,
                          c in engines[rid].calls)
            with pytest.raises(ValueError, match="city must be one of"):
                router.predict(HIST, city=99)
            return out
        finally:
            router.close()

    assert all(owned for _, _, owned in both(drill).values())


def test_predict_many_single_generation_all_ok():
    def drill(pkg):
        router, _, _ = make_router(pkg)
        try:
            return _outcomes(router.predict_many({c: HIST for c in range(9)}))
        finally:
            router.close()

    assert all(o[0] and o[3] == 0 for o in both(drill).values())


def test_partial_failure_is_typed_per_city():
    def drill(pkg):
        router, engines, _ = make_router(pkg, n_cities=12)
        try:
            victim = router.replica_for(0)
            engines[victim].shed_cities = set(range(12))
            return victim, _outcomes(router.predict_many({c: HIST for c in range(12)}))
        finally:
            router.close()

    victim, out = both(drill)
    assert {o[1] for o in out.values() if not o[0]} == {"Overloaded"}
    assert all(o[2] == victim for o in out.values() if not o[0])


def test_kill_heals_the_ring_and_keeps_every_city_served():
    def drill(pkg):
        router, engines, _ = make_router(pkg, n_cities=12)
        try:
            before = router.assignment()
            victim = before[0]
            router.kill(victim)
            after = router.assignment()
            served = [float(router.predict(HIST, city=c)[0, 0]) for c in range(12)]
            return before, after, router.cities_moved, served, _wait(
                lambda: engines[victim].closed)
        finally:
            router.close()

    before, after, moved, served, closed = both(drill)
    victim = before[0]
    assert victim not in after.values() and closed
    assert all(after[c] == r for c, r in before.items() if r != victim)
    assert moved == sum(r == victim for r in before.values()) and served == list(range(12))


def test_fault_plan_kill_at_scatter_never_hangs_a_caller():
    def drill(pkg):
        plan = pkg.resilience.FederationFaultPlan(
            pkg.resilience.FederationFaultSpec(kind="replica-kill", replica=0, dispatch=0))
        router, _, _ = make_router(pkg, n_cities=12, fault_plan=plan)
        try:
            out = _outcomes(router.predict_many({c: HIST for c in range(12)}))
            kills = router.kills
            router.predict_many({0: HIST})  # one-shot: the next scatter kills nobody
            return out, kills, router.kills, router.assignment()
        finally:
            router.close()

    out, kills, kills_after, assignment = both(drill)
    assert set(out) == set(range(12)) and kills == kills_after == 1
    assert 0 not in assignment.values()


def test_generation_split_never_yields_mixed_success():
    def drill(pkg):
        router, engines, _ = make_router(pkg, n_replicas=2, n_cities=8)
        try:
            laggard = router.replica_for(0)
            for i, e in enumerate(engines):
                if i != laggard:
                    e.generation = 1
            out = _outcomes(router.predict_many({c: HIST for c in range(8)}))
            return laggard, out, router.generation_retries
        finally:
            router.close()

    laggard, out, retries = both(drill)
    assert {o[3] for o in out.values() if o[0]} == {1} and retries > 0
    assert all(o[1] == "ReplicaUnavailable" for o in out.values() if o[2] == laggard)


def test_drain_with_a_hang_is_bounded_and_reassigns():
    def drill(pkg):
        plan = pkg.resilience.FederationFaultPlan(
            pkg.resilience.FederationFaultSpec(kind="hang-on-drain", replica=1, hang_ms=30.0))
        router, _, _ = make_router(pkg, n_cities=12, fault_plan=plan)
        try:
            owned = sum(r == 1 for r in router.assignment().values())
            t0 = time.perf_counter()
            report = router.drain(1)
            bounded = time.perf_counter() - t0 < router.config.drain_timeout_s + 1.0
            report.pop("drain_ms")
            served = [float(router.predict(HIST, city=c)[0, 0]) for c in range(12)]
            return owned, report, bounded, served, router.assignment()
        finally:
            router.close()

    owned, report, bounded, served, assignment = both(drill)
    assert report["flushed"] and not report["watcher_wedged"] and bounded
    assert report["moved_cities"] == owned and 1 not in assignment.values()


def test_promote_spare_joins_the_ring_with_a_bounded_handover():
    def drill(pkg):
        router, _, _ = make_router(pkg, n_replicas=2, n_cities=8, spares=1)
        try:
            with pytest.raises(ValueError, match="not a spare"):
                router.promote_spare(0)
            report = router.promote_spare(2)
            report.pop("handover_ms")
            return report, router.assignment(), router.health()["replicas"]
        finally:
            router.close()

    report, assignment, _ = both(drill)
    assert report["promoted"] == 2 and report["handover_flushed"]
    assert report["moved_cities"] == sum(r == 2 for r in assignment.values()) > 0


def test_concurrent_scatters_account_globally():
    def drill(pkg):
        budget = pkg.serving.GlobalBudget(1000)
        router, _, _ = make_router(pkg, budget=budget)
        errs, oks = [], []

        def caller():
            try:
                oks.append(all(o.ok for o in router.predict_many(
                    {c: HIST for c in range(9)}).values()))
            except Exception as e:  # surfaced below, not swallowed
                errs.append(e)

        try:
            threads = [threading.Thread(target=caller) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            health = router.health()
            return errs, oks, health["scatters"], health["budget"]
        finally:
            router.close()

    errs, oks, scatters, budget = both(drill)
    assert errs == [] and oks == [True] * 8 and scatters == 8 and budget["outstanding"] == 0


def test_drift_rollup_labels_replicas_and_takes_the_fleet_max():
    def drill(pkg):
        router, engines, _ = make_router(pkg, n_replicas=2, n_cities=4)
        try:
            engines[1].generation = 2
            return router.drift_rollup()
        finally:
            router.close()

    roll = both(drill)
    assert set(roll["replicas"]) == {"0", "1"} and roll["fleet"]["z_max"] == 2.5


def test_close_is_idempotent_and_closes_all():
    def drill(pkg):
        router, engines, spares = make_router(pkg, n_replicas=2, n_cities=4, spares=1)
        router.close()
        router.close()
        return _wait(lambda: all(e.closed for e in engines + spares))

    assert both(drill)


def test_router_rejects_an_invalid_config():
    def drill(pkg):
        cfg = pkg.config.FederationConfig(enabled=True, replicas=2, drain_timeout_s=1.0,
                                          handover_timeout_s=9.0)
        with pytest.raises(ValueError, match="invalid federation config") as e:
            pkg.serving.FederationRouter([FakeEngine(pkg), FakeEngine(pkg)], range(4),
                                         config=cfg)
        return str(e.value)

    both(drill)


# -- the tier gate on fakes, both packages ----------------------------------------

CLEAN = {"nonfinite": 0, "grad_norm_max": 1.0, "update_ratio_max": 0.01}


def _tier(pkg, tmp_path, watcher_fails_on=(), fault_plan=None):
    engines = [FakeEngine(pkg, watcher_fails=i in watcher_fails_on) for i in range(3)]
    router = pkg.serving.FederationRouter(
        engines, range(6), config=pkg.config.FederationConfig(enabled=True, replicas=3),
        fault_plan=fault_plan)
    gate = pkg.serving.TierPromotionGate(router, str(tmp_path / "watch"))
    path = str(tmp_path / "candidate-0.ckpt")
    pkg.checkpoint.save_checkpoint(path, {"w": np.ones((2,), np.float32)}, {}, {})
    return gate, router, engines, path


def _decision(d) -> tuple:
    return d.accepted, d.reason, os.path.basename(d.path), d.generation, d.checks.get("tier")


@pytest.mark.parametrize("drill", ["cutover", "poisoned", "missed-cutover"])
def test_tier_gate_drills_equal_jax(tmp_path, drill):
    def run(pkg):
        plan = None
        if drill == "poisoned":
            plan = pkg.resilience.FederationFaultPlan(
                pkg.resilience.FederationFaultSpec(kind="poisoned-candidate"))
        root = tmp_path / pkg.serving.__name__.split(".")[0]
        gate, router, engines, path = _tier(
            pkg, root, watcher_fails_on={1} if drill == "missed-cutover" else (),
            fault_plan=plan)
        try:
            d = gate.consider(path, CLEAN)
            return (_decision(d), [e.generation for e in engines],
                    [w.polls for w in gate.watchers.values()], gate.rejections, gate.detached,
                    os.path.exists(path), router.assignment())
        finally:
            router.close()

    decision, gens, polls, rejections, detached, left, assignment = both(run)
    if drill == "cutover":
        assert decision[:2] == (True, "promoted") and gens == [1, 1, 1] and polls == [1, 1, 1]
    elif drill == "poisoned":
        assert decision[:2] == (False, "corrupt") and rejections == 1 and not left
        assert gens == [0, 0, 0] and polls == [0, 0, 0]
    else:
        assert decision[0] and detached == [1] and 1 not in assignment.values()


# -- real fleet engines on the CPU ------------------------------------------------

def test_real_engines_behind_the_router(fleet_setup, tmp_path):
    fc, _, sups, n_nodes = fleet_setup
    cfg = ServingConfig(**LADDER)
    budget = port_serving.GlobalBudget(2 * 8)
    engines = [port_serving.FleetServingEngine.from_forecaster(
        fc, sups, config=cfg, device="cpu", global_budget=budget) for _ in range(4)]
    assert all(c._global is budget for e in engines for c in e.class_admission.values())
    fed = port_config.FederationConfig(enabled=True, replicas=3, spares=1)
    router = port_serving.FederationRouter(engines[:3], range(3), config=fed,
                                           spare_engines=engines[3:], global_budget=budget)
    rng = np.random.default_rng(0)
    hs = {c: _history(rng, 1, fc.seq_len, n_nodes[c]) for c in range(3)}
    try:
        outs = router.predict_many(hs)
        for c, o in outs.items():
            direct = engines[router.replica_for(c)].predict(hs[c], city=c)
            assert o.ok and o.generation == 0 and np.array_equal(o.prediction, direct)
        victim = router.replica_for(0)
        router.kill(victim)
        assert all(o.ok for o in router.predict_many(hs).values())
        assert _wait(lambda: engines[victim]._closed)
        assert engines[victim]._current.programs == {}  # released by close()
        live = [r for r in range(3) if r != victim]
        report = router.drain(live[0])
        assert report["flushed"] and report["moved_cities"] >= 1
        assert router.promote_spare(3)["promoted"] == 3
        assert all(o.ok for o in router.predict_many(hs).values())
        gate = port_serving.TierPromotionGate(router, str(tmp_path / "watch"))
        new = {k: v * 1.05 for k, v in fc.model.state_dict().items()}
        path = str(tmp_path / "candidate-0000.ckpt")
        port_checkpoint.save_checkpoint(path, to_jax_params(new, fc.model.m_graphs), None,
                                        {"kind": "continual"})
        d = gate.consider(path, CLEAN)
        assert d.accepted and d.checks["tier"]["swapped"] == sorted(router.engines())
        ref = Forecaster(build_model(fc.config, 1, device="cpu"), new, None, fc.config,
                         fc.derived, fc.normalizers, device="cpu")
        for c, o in router.predict_many(hs).items():
            assert o.ok and o.generation == 1
            np.testing.assert_allclose(o.prediction, ref.predict(sups[c], hs[c], city=c),
                                       rtol=1e-5, atol=1e-4)
        assert budget.snapshot()["outstanding"] == 0
    finally:
        router.close()
    assert all(e._closed and e._current.programs == {} for e in engines)
