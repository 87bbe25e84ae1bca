"""The port's closed continual loop against the JAX package's (mirroring
``tests/test_continual.py``), at the JAX test's CPU size (the ``smoke``
model on a 2x2 grid, serial-only windows, one ring of 64 rows).

- one fine-tune from the same converted parameters over the same ring
  contents (unwrapped and wrapped) against the JAX ``ContinualTrainer``:
  candidate parameters at atol 2e-5 (``tests/test_torch_train.py``'s bound
  for Adam steps), the health summary at rtol 1e-4 (counts exact), the
  candidate file read by the JAX package's ``load_checkpoint``; and bitwise
  the port's own step over ``ring.series()`` driven by hand (the slot
  gather adds no numerics);
- ``make_holdout_eval`` against the JAX one at rtol 1e-6;
- every gate drill (promotion, each typed rejection, the injected gate
  crash) with the JAX gate's reason, generation move and quarantine;
- a fine-tune after a discard bitwise the first, eager and through
  ``tests/test_torch_graphs.py``'s stand-in capture (one capture across
  fine-tunes on a wrapping ring, the same tensors throughout);
- the daemon's triggers, backoff sleeps (equal to the JAX daemon's under
  the same seed), restart budget, torn-write and hang drills and bounded
  thread;
- ``closed_loop_smoke``'s verdict equal to the JAX function's.
"""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stmgcn_tpu.config import ContinualConfig as JaxContinualConfig
from stmgcn_tpu.config import ServingConfig as JaxServingConfig
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.data import DemandDataset as JaxDemandDataset
from stmgcn_tpu.data import MinMaxNormalizer as JaxMinMax
from stmgcn_tpu.data import SeriesRing as JaxRing
from stmgcn_tpu.data import WindowSpec as JaxWindowSpec
from stmgcn_tpu.data import synthetic_dataset as jax_synthetic
from stmgcn_tpu.experiment import build_model as jax_build_model
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu.ops import SupportConfig as JaxSupportConfig
from stmgcn_tpu.resilience import ServeFaultPlan as JaxServeFaultPlan
from stmgcn_tpu.resilience import ServeFaultSpec as JaxServeFaultSpec
from stmgcn_tpu.serving import PromotionGate as JaxGate
from stmgcn_tpu.train import ContinualDaemon as JaxDaemon
from stmgcn_tpu.train import ContinualTrainer as JaxTrainer
from stmgcn_tpu.train import closed_loop_smoke as jax_closed_loop_smoke
from stmgcn_tpu.train import load_checkpoint as jax_load_checkpoint
from stmgcn_tpu.train import save_checkpoint as jax_save_checkpoint
from stmgcn_tpu.train.continual import make_holdout_eval as jax_holdout_eval
from stmgcn_tpu_torch import Forecaster, ServingConfig, from_jax_params, preset, to_jax_params
from stmgcn_tpu_torch.config import ContinualConfig
from stmgcn_tpu_torch.data import SeriesRing, WindowSpec
from stmgcn_tpu_torch.experiment import build_model
from stmgcn_tpu_torch.obs import graphmon
from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec, ServeFaultPlan, ServeFaultSpec
from stmgcn_tpu_torch.serving import PromotionGate
from stmgcn_tpu_torch.train import (
    ContinualDaemon,
    ContinualTrainer,
    closed_loop_smoke,
    gather_window_batch,
    make_holdout_eval,
    make_optimizer,
    save_checkpoint,
    train_step,
)
from test_torch_graphs import StandInPool

torch.set_num_threads(1)

CCFG = dict(enabled=True, ring_capacity=64, reorder_window=2, finetune_steps=2,
            finetune_batch=2, max_restarts=2, backoff_s=0.001, backoff_max_s=0.002,
            promote_grad_norm_max=1e6, promote_update_ratio_max=100.0, promote_eval_margin=0.05)
SPEC = dict(serial_len=3, daily_len=0, weekly_len=0, day_timesteps=24, horizon=1)
CLEAN = {"nonfinite": 0, "grad_norm_max": 1.0, "update_ratio_max": 1e-3, "loss_last": 0.5}
PARAM_ATOL, HEALTH_RTOL, EVAL_RTOL = 2e-5, 1e-4, 1e-6
ADAM = functools.partial(make_optimizer, lr=1e-3)
LADDER = dict(buckets=(1, 2), max_batch=2, max_delay_ms=2.0)


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset("smoke")
    jcfg.data.override(rows=2, n_timesteps=64, serial_len=3, daily_len=0, weekly_len=0)
    data = jax_synthetic(rows=2, n_timesteps=64, seed=0)
    ds = JaxDemandDataset(data, JaxWindowSpec(**SPEC))
    supports = np.asarray(JaxSupportConfig(jcfg.model.kernel_type, jcfg.model.K).build_all(
        ds.adjs.values()), np.float32)[: jcfg.model.m_graphs]
    jmodel = jax_build_model(jcfg, ds.n_feats)
    x0 = jnp.zeros((1, 3, ds.n_nodes, ds.n_feats), jnp.float32)
    jparams = jmodel.init(jax.random.key(0), jnp.asarray(supports), x0)
    norm = JaxMinMax.fit(np.asarray(data.demand))
    series = np.asarray(norm.transform(np.asarray(data.demand)), np.float32)
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 2, 64
    cfg.data.serial_len, cfg.data.daily_len, cfg.data.weekly_len = 3, 0, 0
    model = build_model(cfg, ds.n_feats, device="cpu")
    state = from_jax_params(jax.tree.map(np.asarray, jparams), cfg.model.m_graphs)
    model.load_state_dict(state)
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    from stmgcn_tpu_torch.data import MinMaxNormalizer

    pnorm = MinMaxNormalizer.fit(np.asarray(data.demand))
    return _NS(jcfg=jcfg, cfg=cfg, supports=supports, jmodel=jmodel, jparams=jparams,
               model=model, state=state, series=series, norm=norm, pnorm=pnorm,
               derived=derived, n_nodes=ds.n_nodes, n_feats=ds.n_feats)


@pytest.fixture(scope="module")
def engines(setup):
    jfc = JaxForecaster(setup.jmodel, setup.jparams, setup.norm, setup.jcfg, setup.derived)
    jeng = jfc.serving_engine(setup.supports, config=JaxServingConfig(**LADDER))
    fc = Forecaster(setup.model, setup.state, setup.pnorm, setup.cfg, setup.derived,
                    device="cpu")
    eng = fc.serving_engine(setup.supports, config=ServingConfig(**LADDER), device="cpu")
    yield eng, jeng
    eng.close()
    jeng.close()


def _rings(setup, capacity=64):
    return (SeriesRing.from_series(setup.series, capacity=capacity, reorder_window=2,
                                   device="cpu"),
            JaxRing.from_series(setup.series, capacity=capacity, reorder_window=2))


def _trainer(setup, ring, out_dir, fault_plan=None, cfg=None, **kw):
    return ContinualTrainer(setup.model, ADAM, setup.supports, ring, WindowSpec(**SPEC),
                            cfg or ContinualConfig(**CCFG), str(out_dir), params=setup.state,
                            holdout=2, fault_plan=fault_plan, device="cpu", **kw)


def _jax_trainer(setup, ring, out_dir):
    return JaxTrainer(setup.jmodel, optax.adam(1e-3), setup.supports, ring,
                      JaxWindowSpec(**SPEC), JaxContinualConfig(**CCFG), str(out_dir),
                      params=setup.jparams, holdout=2)


def _state_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# -- the fine-tune ---------------------------------------------------------------

@pytest.mark.parametrize("capacity", [64, 40], ids=["unwrapped", "wrapped"])
def test_finetune_matches_the_jax_trainer(setup, tmp_path, capacity):
    ring, jring = _rings(setup, capacity)
    trainer = _trainer(setup, ring, tmp_path / "port")
    jtrainer = _jax_trainer(setup, jring, tmp_path / "jax")
    path, health = trainer.finetune()
    jpath, jhealth = jtrainer.finetune()
    trainer.commit()
    jtrainer.commit()
    assert health["nonfinite"] == jhealth["nonfinite"] == 0
    for key in ("grad_norm_max", "update_ratio_max", "loss_last"):
        np.testing.assert_allclose(health[key], jhealth[key], rtol=HEALTH_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jtrainer.params), setup.cfg.model.m_graphs)
    for name, value in trainer.params.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=PARAM_ATOL)
    assert not _state_equal(trainer.params, setup.state)  # the fine-tune moved them
    # the candidate is a file the JAX package reads, into its own trees
    opt_template = optax.adam(1e-3).init(setup.jparams)
    meta, cparams, copt = jax_load_checkpoint(path, setup.jparams, opt_template)
    jmeta = jax_load_checkpoint(jpath, setup.jparams, opt_template)[0]
    assert set(meta) == set(jmeta) and meta["kind"] == "continual"
    assert meta["next_ts"] == jmeta["next_ts"] and meta["ordinal"] == 0
    got = from_jax_params(jax.tree.map(np.asarray, cparams), setup.cfg.model.m_graphs)
    assert _state_equal(got, trainer.params)
    assert int(copt[0].count) == int(jax.tree.leaves(jtrainer._opt_state)[0]) == 2


def test_finetune_equals_the_step_driven_by_hand_bitwise(setup, tmp_path):
    """The trainer's slot gather from the ring buffer against the port's
    ``train_step`` over ``ring.series()`` and ``gather_window_batch``, the
    trainer's block arithmetic replicated (a wrapped ring)."""
    ring, _ = _rings(setup, 40)
    trainer = _trainer(setup, ring, tmp_path)
    trainer.finetune()
    trainer.commit()
    model = build_model(setup.cfg, setup.n_feats, device="cpu")
    model.load_state_dict(setup.state)
    opt = ADAM(list(model.parameters()))
    spec = WindowSpec(**SPEC)
    targets = spec.target_indices(len(ring))[:-2].astype(np.int32)  # holdout=2
    n, s, b = len(targets), CCFG["finetune_steps"], CCFG["finetune_batch"]
    idx = ((np.arange(s * b) + max(0, n - s * b)) % n).reshape(s, b)
    series = ring.series()
    for k in range(s):
        x, y = gather_window_batch(series, torch.as_tensor(targets),
                                   torch.as_tensor(spec.offsets), torch.as_tensor(idx[k]))
        train_step(model, opt, torch.as_tensor(setup.supports), x, y, torch.ones(b))
    assert _state_equal(trainer.params, model.state_dict())


def test_holdout_eval_matches_jax(setup):
    ring, jring = _rings(setup)
    ours = make_holdout_eval(setup.model, setup.supports, ring, WindowSpec(**SPEC),
                             holdout=2, device="cpu")
    theirs = jax_holdout_eval(setup.jmodel, setup.supports, jring, JaxWindowSpec(**SPEC),
                              holdout=2)
    scaled = {k: v * 1.1 for k, v in setup.state.items()}
    jscaled = jax.tree.map(lambda a: np.asarray(a) * np.float32(1.1), setup.jparams)
    for params, jparams in ((setup.state, setup.jparams), (scaled, jscaled)):
        np.testing.assert_allclose(ours(params), theirs(jparams), rtol=EVAL_RTOL)
    ring.ingest(64, setup.series[-1] * 0.5)  # each call re-reads the ring
    jring.ingest(64, setup.series[-1] * 0.5)
    np.testing.assert_allclose(ours(setup.state), theirs(setup.jparams), rtol=EVAL_RTOL)


def test_discard_then_finetune_is_bitwise_the_first(setup, tmp_path):
    ring, _ = _rings(setup)
    trainer = _trainer(setup, ring, tmp_path)
    before = {k: v.clone() for k, v in trainer.params.items()}
    trainer.finetune()
    first = trainer._pending
    trainer.discard()
    assert _state_equal(trainer.params, before)
    trainer.finetune()
    second = trainer._pending
    assert _state_equal(first[0], second[0]) and first[1][0] == second[1][0]
    assert all(torch.equal(a, b) for a, b in zip(first[1][1] + first[1][2],
                                                  second[1][1] + second[1][2]))


def test_captured_finetune_equals_eager_and_never_recaptures(setup, tmp_path):
    """Through the stand-in capture: the program reads the same parameter
    and moment tensors across fine-tunes (staged in place), so a fine-tune
    after a discard, and after rows wrapped the ring, equals the eager
    trainer bitwise, with one capture in all."""
    runs = []
    for graphed in (False, True):
        ring, _ = _rings(setup)
        trainer = _trainer(setup, ring, tmp_path / str(graphed))
        opt = trainer.optimizer
        tensors = list(opt.params) + [p.grad for p in opt.params] + opt.exp_avg + opt.exp_avg_sq
        addresses = [t.data_ptr() for t in tensors]
        if graphed:
            trainer.graphs = True
            trainer.graph_pool = StandInPool(preserve=tensors)
        out = []
        for cycle in range(3):
            trainer.finetune()
            out.append(trainer._pending)
            trainer.commit() if cycle != 1 else trainer.discard()
            for t in range(64 + 10 * cycle, 74 + 10 * cycle):  # wraps the 64-row ring
                ring.ingest(t, setup.series[t % 64] * 0.9)
        assert [t.data_ptr() for t in tensors] == addresses
        runs.append((out, trainer))
    (eager, _), (graphed, trainer) = runs
    for a, b in zip(eager, graphed):
        assert _state_equal(a[0], b[0])
    assert trainer._program.captured and trainer.graph_pool.captures == 1


# -- the promotion gate ------------------------------------------------------------

def _candidates(setup, dirpath, scale=1.0, name="candidate-0000.ckpt"):
    os.makedirs(dirpath, exist_ok=True)
    path, jpath = os.path.join(dirpath, name), os.path.join(dirpath, "jax-" + name)
    m = setup.cfg.model.m_graphs
    save_checkpoint(path, to_jax_params({k: v * scale for k, v in setup.state.items()}, m),
                    None, {"kind": "continual"})
    jax_save_checkpoint(jpath, jax.tree.map(lambda a: np.asarray(a) * scale, setup.jparams),
                        None, {"kind": "continual"})
    return path, jpath


def _eval_regression():
    calls = []

    def fake(params):  # the candidate scored first, then live
        calls.append(1)
        return 5.0 if len(calls) == 1 else 1.0

    return fake


DRILLS = {
    "promoted": (CLEAN, None),
    "nonfinite": ({**CLEAN, "nonfinite": 3}, None),
    "grad-norm-nan": ({**CLEAN, "grad_norm_max": float("nan")}, None),
    "grad-norm": ({**CLEAN, "grad_norm_max": 1e9}, None),
    "update-ratio": ({**CLEAN, "update_ratio_max": 500.0}, None),
    "corrupt": (CLEAN, "corrupt"),
    "eval-regression": (CLEAN, "eval"),
    "gate-error": (CLEAN, "raise"),
}


@pytest.mark.parametrize("drill", list(DRILLS))
def test_gate_drills_match_the_jax_gate(setup, engines, tmp_path, drill):
    health, how = DRILLS[drill]
    cfg, jcfg = ContinualConfig(**CCFG), JaxContinualConfig(**CCFG)
    decisions = []
    for eng, gate_cls, conf, plan, pkg in (
            (engines[0], PromotionGate, cfg, ServeFaultPlan, ServeFaultSpec),
            (engines[1], JaxGate, jcfg, JaxServeFaultPlan, JaxServeFaultSpec)):
        out = tmp_path / gate_cls.__module__.split(".")[0]
        kw = {}
        if how == "eval":
            kw = dict(holdout_eval=_eval_regression(),
                      live_params=setup.state if gate_cls is PromotionGate else setup.jparams)
        gate = gate_cls.from_config(eng, str(out), conf, **kw)
        cand = _candidates(setup, out)[0 if gate_cls is PromotionGate else 1]
        if how == "corrupt":
            with open(cand, "wb") as f:
                f.write(b"not a checkpoint at all")
        registry = REGISTRY if gate_cls is PromotionGate else gate._reg
        before = registry.counter("continual.rejections", {"reason": drill.split("-nan")[0]})
        before = before.value
        prior, gen0 = eng._fault_plan, eng.generation
        if how == "raise":
            eng._fault_plan = plan(pkg(kind="promotion-raise", dispatch=0))
        try:
            d = gate.consider(cand, health)
        finally:
            eng._fault_plan = prior
        after = registry.counter("continual.rejections", {"reason": d.reason}).value
        decisions.append((d.accepted, d.reason, eng.generation - gen0, d.ordinal,
                          os.path.basename(d.path).replace("jax-", ""), os.path.exists(cand),
                          after - before if not d.accepted else None))
    assert decisions[0] == decisions[1]
    assert decisions[0][1] == ("promoted" if drill == "promoted" else drill.split("-nan")[0])


def test_gate_with_a_real_holdout_promotes_and_moves_its_baseline(setup, engines, tmp_path):
    eng = engines[0]
    ring, _ = _rings(setup)
    evaluate = make_holdout_eval(setup.model, setup.supports, ring, WindowSpec(**SPEC),
                                 holdout=2, device="cpu")
    gate = PromotionGate.from_config(eng, str(tmp_path), ContinualConfig(**CCFG),
                                     holdout_eval=evaluate, live_params=setup.state)
    path, _ = _candidates(setup, tmp_path, scale=1.0)
    gen0 = eng.generation
    d = gate.consider(path, CLEAN)
    assert d.accepted and eng.generation == gen0 + 1
    cand, live, bound = d.checks["eval"]
    assert cand == live and bound == pytest.approx(live * 1.05)
    assert os.path.exists(tmp_path / "latest.ckpt")
    path, _ = _candidates(setup, tmp_path, scale=3.0, name="candidate-0001.ckpt")
    d = gate.consider(path, CLEAN)
    assert not d.accepted and d.reason == "eval-regression"
    assert eng.generation == gen0 + 1


# -- the daemon -----------------------------------------------------------------

class _StubEngine:
    def __init__(self, snap=None):
        self._snap = snap

    def drift_snapshot(self):
        return self._snap


class _StubGate:
    def __init__(self, snap=None):
        self._engine = _StubEngine(snap)


class _FailingTrainer:
    def __init__(self):
        self.discards = 0

    def finetune(self):
        raise RuntimeError("fine-tune crashed")

    def discard(self):
        self.discards += 1


def test_cadence_trigger_and_down_daemon():
    for daemon_cls, conf in ((ContinualDaemon, ContinualConfig),
                             (JaxDaemon, JaxContinualConfig)):
        clock = [0.0]
        d = daemon_cls(None, _StubGate(), config=conf(enabled=True, cadence_s=10.0),
                       time_fn=lambda: clock[0])
        clock[0] = 5.0
        assert d.should_retrain() is None
        clock[0] = 11.0
        assert d.should_retrain() == "cadence"
        d.down = True
        assert d.should_retrain() is None and d.poll() is None


@pytest.mark.parametrize("gauges,want", [
    ({"n": 10, "z_max": 9.0, "psi": 0.1}, "drift"),
    ({"n": 10, "z_max": 1.0, "psi": 0.9}, "drift"),
    ({"n": 10, "z_max": 1.0, "psi": 0.1}, None)])
def test_drift_trigger(gauges, want):
    snap = {"schema_version": 1, "generation": 0, "cities": {"0": {"commute": gauges}}}
    assert ContinualDaemon(None, _StubGate(snap), config=ContinualConfig(**CCFG)) \
        .should_retrain() == want
    assert JaxDaemon(None, _StubGate(snap), config=JaxContinualConfig(**CCFG)) \
        .should_retrain() == want


def test_backoff_and_restart_budget_equal_the_jax_daemon():
    runs = []
    for daemon_cls, conf in ((ContinualDaemon, ContinualConfig),
                             (JaxDaemon, JaxContinualConfig)):
        sleeps, trainer = [], _FailingTrainer()
        cfg = conf(enabled=True, max_restarts=3, backoff_s=0.01, backoff_max_s=0.03)
        d = daemon_cls(trainer, _StubGate(), config=cfg, sleep_fn=sleeps.append, rng_seed=7,
                       replica="2")
        assert d.retrain("drift") is None and d.down and d.poll() is None
        runs.append((sleeps, d.restarts, trainer.discards))
    assert runs[0] == runs[1]
    sleeps, restarts, discards = runs[0]
    assert restarts == discards == 4 and len(sleeps) == 3
    assert sleeps[0] >= 0.01 and sleeps[-1] <= 0.03 * 1.1
    assert REGISTRY.gauge("continual.daemon_up", {"replica": "2"}).value == 0


def test_injected_crash_retried_then_promoted(setup, engines, tmp_path):
    eng = engines[0]
    trainer = _trainer(setup, _rings(setup)[0], tmp_path,
                       fault_plan=FaultPlan(FaultSpec(kind="raise", epoch=0, step=0)))
    gate = PromotionGate.from_config(eng, str(tmp_path), ContinualConfig(**CCFG))
    sleeps = []
    daemon = ContinualDaemon(trainer, gate, config=ContinualConfig(**CCFG),
                             sleep_fn=sleeps.append)
    gen0 = eng.generation
    d = daemon.retrain("cadence")
    assert d is not None and d.accepted and eng.generation == gen0 + 1
    assert daemon.restarts == 1 and len(sleeps) == 1 and 0.001 <= sleeps[0] <= 0.002 * 1.1
    assert not daemon.down


def test_restart_budget_exhausts_into_down_serving_untouched(setup, engines, tmp_path):
    eng = engines[0]
    plan = FaultPlan(*[FaultSpec(kind="raise", epoch=e, step=0) for e in range(5)])
    cfg = ContinualConfig(enabled=True, finetune_steps=2, finetune_batch=2, max_restarts=1,
                          backoff_s=0.001, backoff_max_s=0.002)
    trainer = _trainer(setup, _rings(setup)[0], tmp_path, fault_plan=plan, cfg=cfg)
    gate = PromotionGate.from_config(eng, str(tmp_path), cfg)
    daemon = ContinualDaemon(trainer, gate, config=cfg, sleep_fn=lambda s: None)
    gen0 = eng.generation
    assert daemon.retrain("drift") is None and daemon.down
    assert gate.ordinal == 0 and eng.generation == gen0
    assert REGISTRY.gauge("continual.daemon_up").value == 0


@pytest.mark.parametrize("kind", ["torn-write", "corrupt-write", "hang"])
def test_write_and_hang_drills(setup, engines, tmp_path, kind):
    """A torn candidate write is retried through supervision; a corrupt one
    lands and the gate rejects it as corrupt; a hang delays, then the
    candidate promotes."""
    eng = engines[0]
    spec = (FaultSpec(kind="hang", hang_ms=20, epoch=0) if kind == "hang"
            else FaultSpec(kind=kind, path_glob="candidate-*.ckpt"))
    trainer = _trainer(setup, _rings(setup)[0], tmp_path, fault_plan=FaultPlan(spec))
    gate = PromotionGate.from_config(eng, str(tmp_path), ContinualConfig(**CCFG))
    daemon = ContinualDaemon(trainer, gate, config=ContinualConfig(**CCFG),
                             sleep_fn=lambda s: None)
    t0 = time.perf_counter()
    d = daemon.retrain("cadence")
    if kind == "torn-write":
        assert d.accepted and daemon.restarts == 1
        assert [p for p in os.listdir(tmp_path / "candidates") if ".tmp." in p]
    elif kind == "corrupt-write":
        assert not d.accepted and d.reason == "corrupt" and daemon.restarts == 0
        assert d.path.endswith(".rejected-corrupt")
    else:
        assert time.perf_counter() - t0 >= 0.02 and d.accepted and daemon.restarts == 0


def test_background_thread_starts_and_stops_bounded():
    daemon = ContinualDaemon(None, _StubGate(), config=ContinualConfig(enabled=True))
    daemon.start(poll_s=0.01)
    time.sleep(0.05)
    assert daemon.stop() is True
    assert daemon.stop() is True  # idempotent


# -- the whole loop -----------------------------------------------------------

@pytest.mark.parametrize("poison", [True, False])
def test_closed_loop_smoke_verdict_equals_jax(tmp_path, poison):
    ours = closed_loop_smoke(str(tmp_path / "port"), poison=poison, seed=0, device="cpu")
    theirs = jax_closed_loop_smoke(str(tmp_path / "jax"), poison=poison, seed=0)
    assert ours == theirs
    if poison:
        assert ours["promotions"] == 1 and ours["rejections"] == 1
        assert ours["rejection_reason"] == "nonfinite" and ours["generation"] == 1
        rejected = [p for p in os.listdir(tmp_path / "port" / "candidates")
                    if p.endswith(".rejected-nonfinite")]
        assert len(rejected) == 1


def test_recaptures_stay_zero_across_finetunes(setup, tmp_path):
    """The graphmon view of the captured fine-tune (stand-in pool): after
    the first capture is marked as warmup, later fine-tunes on a growing
    and wrapping ring add none."""
    ring = SeriesRing(32, setup.n_nodes, setup.n_feats, reorder_window=2, device="cpu")
    for t in range(20):
        ring.ingest(t, setup.series[t])
    trainer = _trainer(setup, ring, tmp_path)
    opt = trainer.optimizer
    trainer.graphs = True
    trainer.graph_pool = StandInPool(preserve=list(opt.params) + [p.grad for p in opt.params]
                                     + opt.exp_avg + opt.exp_avg_sq)
    trainer.finetune()
    graphmon.mark_warmup_complete()
    for t in range(20, 64):
        ring.ingest(t, setup.series[t])
        if t % 11 == 0:
            trainer.finetune()
            trainer.commit()
    assert graphmon.snapshot()["recaptures_after_warmup"] == 0
