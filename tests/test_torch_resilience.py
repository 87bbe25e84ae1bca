"""The port's training resilience against the JAX package's.

- ``stmgcn_tpu_torch/resilience`` is a copy of ``stmgcn_tpu/resilience``:
  the same calls on both packages' ``FaultPlan``, ``ServeFaultPlan`` and
  ``DivergenceGuard`` fire, raise and count alike;
- the trainer's fault hooks and guard, on the CPU: a poisoned step that the
  guard skips ends bitwise equal to a run that drops the same batch, per
  step and inside a block of S (rolled back and replayed step by step);
  ``defer`` retries at the epoch's end and survives a mid-epoch resume; a
  ``sigterm`` fault writes an emergency checkpoint, raises ``Preempted``,
  and a fresh trainer resumes bitwise to the uninterrupted run's end;
  three poisons in a row abort with the JAX hint; the write faults are
  caught by the verified recovery chain;
- under the same poison plan from the same converted weights, the guard's
  trip count, the ``lr_scale`` meta and the epoch losses match the JAX
  trainer's (losses rtol 2e-5, as ``tests/test_torch_train.py``'s trainer
  comparison), and checkpoints carrying guard meta load in either package;
- the CLI's guard flags, ``Preempted`` -> exit 143, and the serving fault
  drills (``batcher-die``, ``dispatch-slow``, ``corrupt-checkpoint``) on
  the engine, its rungs captured through the stand-in pool of
  ``tests/test_torch_graphs.py``.
"""

import copy
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.resilience import DivergenceError as JaxDivergenceError
from stmgcn_tpu.resilience import DivergenceGuard as JaxGuard
from stmgcn_tpu.resilience import FaultPlan as JaxFaultPlan
from stmgcn_tpu.resilience import FaultSpec as JaxFaultSpec
from stmgcn_tpu.resilience import Preempted as JaxPreempted
from stmgcn_tpu.resilience import ServeFaultPlan as JaxServeFaultPlan
from stmgcn_tpu.resilience import ServeFaultSpec as JaxServeFaultSpec
from stmgcn_tpu.train.checkpoint import verify_checkpoint as jax_verify_checkpoint
from stmgcn_tpu_torch import ExperimentConfig, ServingConfig, build_trainer, from_jax_params
from stmgcn_tpu_torch import cli, preset
from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.resilience import (
    BatcherKilled,
    DivergenceError,
    DivergenceGuard,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    Preempted,
    ServeFaultPlan,
    ServeFaultSpec,
)
from stmgcn_tpu_torch.serving import engine as engine_module
from stmgcn_tpu_torch.serving.admission import DeadlineExceeded
from stmgcn_tpu_torch.train.checkpoint import verify_checkpoint
from test_torch_graphs import StandInPool, _small_forecaster

torch.set_num_threads(1)

#: the trainer comparison's tolerance (tests/test_torch_train.py)
LOSS_RTOL = 2e-5


def _cfg(out_dir, steps=1, epochs=2, **train):
    """A smoke-sized dense trainer config: 7 batches an epoch, so blocks of
    3 hold steps 0-2 and 3-5, and step 6 is a one-step tail."""
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 + 80
    cfg.train.epochs, cfg.train.batch_size = epochs, 8
    cfg.train.steps_per_superstep = steps
    cfg.train.out_dir = str(out_dir)
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg


def _trainer(out_dir, plan=None, steps=1, **train):
    return build_trainer(_cfg(out_dir, steps, **train), device="cpu", verbose=False,
                         fault_plan=plan)


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for name, value in sa.items():
        assert torch.equal(value, sb[name]), name
    for x, y in zip(a.optimizer.exp_avg + a.optimizer.exp_avg_sq,
                    b.optimizer.exp_avg + b.optimizer.exp_avg_sq):
        assert torch.equal(x, y)
    assert a.optimizer.count == b.optimizer.count and a.global_step == b.global_step


# -- the copied modules against the JAX ones ---------------------------------

def _fault_calls(fault_plan, fault_spec):
    """Drive one plan through the trainer's hooks and record what fires."""
    plan = fault_plan(
        fault_spec("raise", epoch=1, step=2),
        fault_spec("poison", epoch=1, step=4, payload=float("inf")),
        fault_spec("drop", epoch=2, step=1),
        fault_spec("truncate-write", path_glob="latest.ckpt", write_index=1),
        fault_spec("corrupt-write", path_glob="best*.ckpt", flip_byte=3),
    )
    log = []
    for epoch in (1, 2):
        for start, stop in ((0, 3), (3, 6)):
            try:
                plan.before_step(epoch, start, stop)
                log.append(("ok", epoch, start))
            except Exception as e:  # noqa: BLE001 - the message is compared
                log.append((type(e).__name__, str(e)))
        for step in range(6):
            log.append((epoch, step, plan.poison_value(epoch, step),
                        plan.should_drop(epoch, step), plan.any_drop(epoch, step, step + 3)))
    data = bytes(range(40))
    for name in ("latest.ckpt", "latest.ckpt", "best.ckpt", "latest.ckpt", "best_e2.ckpt"):
        log.append((name, plan.mutate_write(name, data)))
    return log


def test_fault_plans_fire_as_the_jax_ones():
    assert _fault_calls(FaultPlan, FaultSpec) == _fault_calls(JaxFaultPlan, JaxFaultSpec)
    for spec in (FaultSpec, JaxFaultSpec):
        with pytest.raises(ValueError, match="explicit step"):
            spec("poison")
        with pytest.raises(ValueError, match="hang_ms"):
            spec("hang", step=1)
    assert not FaultPlan().active and FaultPlan().poison_value(1, 0) is None

    def serve_calls(plan_cls, spec_cls):
        plan = plan_cls(spec_cls("dispatch-raise", dispatch=1),
                        spec_cls("batcher-die", dispatch=3))
        log = []
        for ordinal in range(5):
            try:
                plan.before_dispatch(ordinal)
                log.append(ordinal)
            except BaseException as e:  # noqa: BLE001 - BatcherKilled included
                log.append((type(e).__name__, str(e)))
        return log

    assert serve_calls(ServeFaultPlan, ServeFaultSpec) == serve_calls(JaxServeFaultPlan,
                                                                       JaxServeFaultSpec)
    assert issubclass(BatcherKilled, BaseException) and issubclass(Preempted, BaseException)


def test_divergence_guard_accounts_as_the_jax_one():
    log = []
    for guard_cls, error in ((DivergenceGuard, DivergenceError),
                             (JaxGuard, JaxDivergenceError)):
        for bad in (dict(action="explode"), dict(patience=0), dict(lr_cut=1.5)):
            with pytest.raises(ValueError, match=next(iter(bad))):
                guard_cls(**bad)
        guard = guard_cls(patience=2, lr_cut=0.5)
        guard.trip(float("nan"), 1, 0)
        guard.ok()
        guard.trip(float("inf"), 1, 2)
        with pytest.raises(error, match="--checkify nan") as raised:
            guard.trip(float("nan"), 1, 3)
        log.append((guard.total, guard.consecutive, guard.lr_cut, str(raised.value)))
    assert log[0] == log[1]


# -- the trainer's drills -------------------------------------------------------

@pytest.mark.parametrize("steps,ordinal", [(1, 3), (3, 1), (3, 4)],
                         ids=["per-step", "block-start", "block-middle"])
def test_guard_skip_equals_drop_bitwise(tmp_path, steps, ordinal):
    """A NaN-poisoned batch trips the guard, is rolled back and skipped
    (inside a block: the block is rolled back and replayed step by step),
    and the run ends bitwise equal to one that dropped the batch."""
    poisoned = _trainer(tmp_path / "poisoned", FaultPlan(FaultSpec("poison", epoch=2,
                                                                   step=ordinal)),
                        steps, divergence_guard=True)
    h_poisoned = poisoned.train()
    assert poisoned._guard.total == 1
    dropped = _trainer(tmp_path / "dropped", FaultPlan(FaultSpec("drop", epoch=2,
                                                                 step=ordinal)), steps)
    assert dropped.train() == h_poisoned
    _assert_same_state(poisoned, dropped)
    steps_per_epoch = poisoned.train_steps_per_epoch
    assert poisoned.global_step == 2 * steps_per_epoch - 1


def test_poison_without_the_guard_trains_on_nan(tmp_path):
    trainer = _trainer(tmp_path, FaultPlan(FaultSpec("poison", epoch=1, step=1)), 3,
                       epochs=1)
    trainer.train()
    assert not all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_persistent_divergence_aborts_with_the_hint(tmp_path):
    plan = FaultPlan(*(FaultSpec("poison", epoch=1, step=s) for s in (1, 2, 3)))
    trainer = _trainer(tmp_path, plan, 3, divergence_guard=True, divergence_patience=3)
    with pytest.raises(DivergenceError, match="--checkify nan"):
        trainer.train()
    # rolled back before the raise: the live state is the last finite one
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


@pytest.mark.parametrize("steps", [1, 3])
def test_deferred_batches_survive_a_midepoch_resume(tmp_path, steps):
    """SIGTERM between a defer and its end-of-epoch retry: the ordinal goes
    into the emergency checkpoint and the resumed run retries it in the
    same slot, ending bitwise equal to the uninterrupted run."""
    guard = dict(divergence_guard=True, divergence_action="defer")
    ref = _trainer(tmp_path / "ref", FaultPlan(FaultSpec("poison", epoch=1, step=1)), steps,
                   **guard)
    h_ref = ref.train()
    assert ref._guard.total == 1
    plan = FaultPlan(FaultSpec("poison", epoch=1, step=1), FaultSpec("sigterm", epoch=1,
                                                                     step=3))
    run = _trainer(tmp_path / "run", plan, steps, **guard)
    with pytest.raises(Preempted, match="--resume auto"):
        run.train()
    meta = verify_checkpoint(run.latest_path)
    # the signal lands before step 3; the checkpoint at the boundary after it
    assert meta["epoch"] == 1 and meta["batch_in_epoch"] == (4 if steps == 1 else 6)
    assert meta["deferred"] == [1]
    resumed = _trainer(tmp_path / "run", None, steps, **guard)
    assert resumed.restore_auto() is not None
    assert resumed.train() == h_ref  # the interrupted epoch 1, then epoch 2
    _assert_same_state(ref, resumed)


@pytest.mark.parametrize("steps,shuffle", [(1, False), (3, True)])
def test_sigterm_resume_is_bit_exact(tmp_path, steps, shuffle):
    ref = _trainer(tmp_path / "ref", None, steps, shuffle=shuffle)
    h_ref = ref.train()
    run = _trainer(tmp_path / "run", FaultPlan(FaultSpec("sigterm", epoch=2, step=4)), steps,
                   shuffle=shuffle)
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Preempted, match="--resume auto"):
        run.train()
    assert signal.getsignal(signal.SIGTERM) is handler
    meta = verify_checkpoint(run.latest_path)
    assert meta["epoch"] == 2 and 0 < meta["batch_in_epoch"] < run.train_steps_per_epoch
    resumed = _trainer(tmp_path / "run", None, steps, shuffle=shuffle)
    assert resumed.restore_auto()["batch_in_epoch"] == meta["batch_in_epoch"]
    h = resumed.train()
    _assert_same_state(ref, resumed)
    assert h["train"] == h_ref["train"][-1:] and h["validate"] == h_ref["validate"][-1:]


def test_raise_fault_with_step_cadence_resumes(tmp_path):
    ref = _trainer(tmp_path / "ref")
    ref.train()
    run = _trainer(tmp_path / "run", FaultPlan(FaultSpec("raise", epoch=2, step=3)),
                   checkpoint_every_steps=1)
    with pytest.raises(InjectedFault):
        run.train()
    meta = verify_checkpoint(run.latest_path)
    assert meta["epoch"] == 2 and meta["batch_in_epoch"] == 3
    resumed = _trainer(tmp_path / "run", checkpoint_every_steps=1)
    assert resumed.restore_auto() is not None
    resumed.train()
    _assert_same_state(ref, resumed)


@pytest.mark.parametrize("kind", ["truncate-write", "corrupt-write", "torn-write"])
@pytest.mark.parametrize("async_checkpoint", [True, False], ids=["async", "sync"])
def test_write_faults_fall_back_and_quarantine(tmp_path, kind, async_checkpoint):
    """Epoch 2's latest write lands truncated or bit-flipped (quarantined,
    the chain falls back to latest.prev, epoch 1), or tears before its
    rename (latest stays epoch 1's file and a partial tmp file is left)."""
    plan = FaultPlan(FaultSpec(kind, path_glob="latest.ckpt", write_index=1))
    trainer = _trainer(tmp_path, plan, async_checkpoint=async_checkpoint)
    if kind == "torn-write":
        with pytest.raises((InjectedFault, RuntimeError)):
            trainer.train()
        assert any(".tmp." in name for name in os.listdir(tmp_path))
    else:
        trainer.train()
    restarted = _trainer(tmp_path)
    meta = restarted.restore_auto()
    assert meta is not None and meta["epoch"] == 1
    if kind != "torn-write":
        assert os.path.exists(tmp_path / "latest.ckpt.corrupt")


def test_lr_cut_scales_the_scalars_and_persists(tmp_path):
    trainer = _trainer(tmp_path, FaultPlan(FaultSpec("poison", epoch=1, step=2)), 3,
                       divergence_guard=True, divergence_lr_cut=0.5)
    trainer.train()
    assert trainer._lr_scale == trainer.optimizer.lr_scale == 0.5
    assert verify_checkpoint(trainer.latest_path)["lr_scale"] == 0.5
    full = trainer.optimizer.scalars(3)
    trainer.optimizer.lr_scale = 1.0
    assert full[0] == pytest.approx(0.5 * trainer.optimizer.scalars(3)[0], rel=1e-12)
    assert sorted(k[1] for k in trainer._programs) == [1, 3]  # the cut made no program
    resumed = _trainer(tmp_path, None, 3, divergence_guard=True, divergence_lr_cut=0.5)
    resumed.restore_auto()
    assert resumed.optimizer.lr_scale == 0.5


def test_divergence_fields_are_live_and_validated(tmp_path):
    for bad, match in ((dict(divergence_action="explode"), "action"),
                       (dict(divergence_patience=0), "patience"),
                       (dict(divergence_lr_cut=1.5), "lr_cut")):
        with pytest.raises(ValueError, match=match):
            _trainer(tmp_path, None, divergence_guard=True, **bad)
        _trainer(tmp_path, None, **bad)  # off, as the JAX trainer: not consulted


# -- against the JAX trainer --------------------------------------------------

def _jax_configs(tmp_path, **train):
    cfg = jax_preset("default")
    cfg.data.rows = 4
    cfg.data.n_timesteps = 24 * 7 + 80
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 1
    cfg.train.epochs, cfg.train.batch_size = 2, 8
    cfg.train.steps_per_superstep = 3
    cfg.train.out_dir = str(tmp_path / "jax")
    for key, value in train.items():
        setattr(cfg.train, key, value)
    port = cfg.to_dict()
    port["train"]["out_dir"] = str(tmp_path / "port")
    return cfg, ExperimentConfig.from_dict(port)


def test_guard_matches_the_jax_trainer_and_meta_crosses(tmp_path):
    """The same poison plans (one inside a block at epoch 1, one a tail step
    at epoch 2), the guard with lr_cut: the same trips, epoch losses and
    lr_scale; then each package restores the other's latest.ckpt."""
    def plan(cls, spec):
        return cls(spec("poison", epoch=1, step=4), spec("poison", epoch=2, step=6))

    jax_cfg, cfg = _jax_configs(tmp_path, divergence_guard=True, divergence_lr_cut=0.5,
                                checkpoint_every_steps=5)
    jt = jax_build_trainer(jax_cfg, verbose=False, fault_plan=plan(JaxFaultPlan,
                                                                   JaxFaultSpec))
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    h_jax = jt.train()
    pt = build_trainer(cfg, device="cpu", initial_state=init, verbose=False,
                       fault_plan=plan(FaultPlan, FaultSpec))
    h = pt.train()
    assert pt._guard.total == jt._guard.total == 2
    assert pt.global_step == jt.global_step
    for mode in ("train", "validate"):
        np.testing.assert_allclose(h[mode], h_jax[mode], rtol=LOSS_RTOL)
    jax_meta = jax_verify_checkpoint(jt.latest_path)
    meta = verify_checkpoint(pt.latest_path)
    assert meta["lr_scale"] == jax_meta["lr_scale"] == 0.25
    # each package resumes the other's file, guard meta included
    cross = jax_build_trainer(jax_cfg, verbose=False)
    assert cross.restore(pt.latest_path)["lr_scale"] == 0.25 and cross._lr_scale == 0.25
    back = build_trainer(cfg, device="cpu", verbose=False)
    back.restore(jt.latest_path)
    assert back.optimizer.lr_scale == 0.25 and back.global_step == jt.global_step


def test_deferred_meta_crosses_both_ways(tmp_path):
    """A mid-epoch emergency checkpoint that defers a batch, written by
    either package, resumes in the other with the same pending ordinal."""
    jax_cfg, cfg = _jax_configs(tmp_path, divergence_guard=True, divergence_action="defer",
                                steps_per_superstep=1)

    def plan(cls, spec):
        return cls(spec("poison", epoch=1, step=1), spec("sigterm", epoch=1, step=3))

    pt = build_trainer(cfg, device="cpu", verbose=False, fault_plan=plan(FaultPlan, FaultSpec))
    with pytest.raises(Preempted):
        pt.train()
    jt = jax_build_trainer(jax_cfg, verbose=False, fault_plan=plan(JaxFaultPlan, JaxFaultSpec))
    with pytest.raises(JaxPreempted):
        jt.train()
    cross = jax_build_trainer(jax_cfg, verbose=False)
    assert cross.restore(pt.latest_path)["deferred"] == [1] and cross._resume_deferred == [1]
    back = build_trainer(cfg, device="cpu", verbose=False)
    assert back.restore(jt.latest_path)["deferred"] == [1] and back._resume_deferred == [1]
    assert back._batch_in_epoch == pt._batch_in_epoch == 4


# -- the CLI --------------------------------------------------------------------

def test_cli_guard_and_health_flags_reach_the_config():
    args = cli.build_parser().parse_args([
        "--divergence-guard", "--divergence-action", "defer", "--divergence-patience", "5",
        "--divergence-lr-cut", "0.5", "--health-out", "/h.jsonl", "--health-every-k", "2"])
    cfg = cli.config_from_args(args)
    t = cfg.train
    assert (t.divergence_guard, t.divergence_action, t.divergence_patience,
            t.divergence_lr_cut) == (True, "defer", 5, 0.5)
    assert (cfg.health.enabled, cfg.health.out, cfg.health.every_k) == (True, "/h.jsonl", 2)
    cfg = cli.config_from_args(cli.build_parser().parse_args(["--health-every-k", "3"]))
    assert cfg.health.enabled and cfg.health.out is None


def test_cli_exits_143_on_preemption_and_resumes(tmp_path, monkeypatch, capsys):
    from stmgcn_tpu_torch import experiment

    real = experiment.build_trainer
    plans = [FaultPlan(FaultSpec("sigterm", epoch=1, step=2))]

    def with_plan(cfg, **kw):
        return real(cfg, fault_plan=plans.pop() if plans else None, **kw)

    monkeypatch.setattr(experiment, "build_trainer", with_plan)
    argv = ["--preset", "smoke", "--device", "cpu", "--rows", "4", "--timesteps", "248",
            "--epochs", "1", "--batch-size", "8", "--out-dir", str(tmp_path)]
    assert cli.main(argv) == 143
    assert "preempted" in capsys.readouterr().err
    # the signal lands before step 2, the checkpoint at the boundary after it
    assert verify_checkpoint(str(tmp_path / "latest.ckpt"))["batch_in_epoch"] == 3
    assert cli.main(argv + ["--resume"]) == 0


# -- serving fault drills ---------------------------------------------------------

def _engine(monkeypatch, plan, **config):
    """The small forecaster's engine, its rungs captured through the
    stand-in pool."""
    monkeypatch.setattr(engine_module, "GraphPool", lambda device: StandInPool())
    fc, supports, ds = _small_forecaster()
    cfg = ServingConfig(buckets=(1, 2, 4), max_batch=4, **config)
    sup = torch.as_tensor(supports)
    engine = engine_module.ServingEngine(
        {b: engine_module._bucket_program(sup, torch.device("cpu")) for b in cfg.buckets},
        copy.deepcopy(fc.model).eval(), fc.normalizer, fc.expected, cfg,
        torch.device("cpu"), graphs=True, fault_plan=plan)
    return engine, fc, supports, ds


def test_batcher_death_degrades_to_the_inline_path(monkeypatch):
    engine, fc, supports, ds = _engine(monkeypatch,
                                       ServeFaultPlan(ServeFaultSpec("batcher-die", dispatch=1)))
    rows = ds.denormalize(ds.arrays("test")[0])[:3]
    with engine:
        want = fc.predict(supports, rows)
        np.testing.assert_allclose(engine.predict(rows), want, rtol=1e-5, atol=1e-4)
        for _ in range(2):  # the dying dispatch, then the wedged batcher: inline
            np.testing.assert_allclose(engine.predict(rows), want, rtol=1e-5, atol=1e-4)


def test_dispatch_slow_sheds_under_the_deadline(monkeypatch):
    engine, fc, supports, ds = _engine(
        monkeypatch, ServeFaultPlan(ServeFaultSpec("dispatch-slow", slow_ms=60.0)),
        deadline_ms=20.0, max_delay_ms=1.0)
    rows = ds.denormalize(ds.arrays("test")[0])[:1]
    errors = []

    def call():
        try:
            engine.predict(rows)
        except DeadlineExceeded as e:
            errors.append(e)

    with engine:
        threads = [threading.Thread(target=call) for _ in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.005)
        for t in threads:
            t.join(timeout=30)
    assert errors, "requests queued behind a slow dispatch must shed at the deadline"


def test_watcher_corrupt_checkpoint_hook_rejects_and_counts(tmp_path, monkeypatch):
    trainer = _trainer(tmp_path / "run", epochs=1)
    trainer.train()
    engine, fc, _, _ = _engine(monkeypatch, ServeFaultPlan(
        ServeFaultSpec("corrupt-checkpoint", path_glob="latest.ckpt")))
    rejected = REGISTRY.counter("serving.ckpt_rejected").value
    with engine:
        watcher = engine.watch_checkpoints(str(tmp_path / "run"))
        trainer.n_epochs = 2
        trainer.train()  # a newer latest.ckpt, which the hook flips at rest
        assert watcher.poll() is False  # the chain falls back to the live generation's
        assert watcher.rejected == 1 and engine.generation == 0
    assert REGISTRY.counter("serving.ckpt_rejected").value == rejected + 1
    assert os.path.exists(tmp_path / "run" / "latest.ckpt.corrupt")
