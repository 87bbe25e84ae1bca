"""The port's numeric health and serving drift against the JAX package's.

- ``stmgcn_tpu_torch/obs/{health,drift}.py`` are copies: the same inputs
  give the JAX modules' results (``baseline_from_samples`` array-equal,
  the sketches' moments, PSI and the monitor's reset exact);
- one step's health stats (``train/step.py`` ``health_row``) against the
  JAX ``_health_stats`` of the same step from the same converted weights,
  the group names and their order equal: norms rtol 1e-4 (the gradients
  agree to 1e-4 elementwise, ``tests/test_torch_train.py``; their norms
  tighter), counts exact; the looped layout's groups too;
- a two-epoch series-superstep run and a fleet run with ``health`` write
  ``health.jsonl`` records that match the JAX trainer's (losses rtol 2e-5,
  norms and ratios rtol 1e-3 after 14 Adam steps; counts, steps and epochs
  exact), the health run's parameters are bitwise the plain run's, the
  fleet's ``city_loss`` columns sum to each step's loss exactly, and
  ``every_k=2`` halves the stream;
- the ``health_baseline`` the port writes equals the JAX trainer's and the
  checkpoints carrying it load in either package's ``Forecaster``;
- the serving engines' drift lifecycle (dense and fleet) with the rungs
  captured through ``tests/test_torch_graphs.py``'s stand-in pool: a
  held-out city silent, a shifted one firing, the reset on
  ``swap_params``, and the wiring from a ``health.drift`` checkpoint;
- the ``health``/``obs`` report subcommands, and the config's ``health``,
  ``continual`` and ``federation`` sections and the ``obs`` refusals.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stmgcn_tpu.config as jax_config
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu.obs import drift as jax_drift
from stmgcn_tpu.obs import health as jax_health
from stmgcn_tpu.obs import trace as jax_trace
from stmgcn_tpu.train.step import health_group_names, make_step_fns
from stmgcn_tpu_torch import ExperimentConfig, Forecaster, ServingConfig, build_trainer, cli
from stmgcn_tpu_torch import from_jax_params, preset
from stmgcn_tpu_torch.config import HealthConfig, MeshConfig
from stmgcn_tpu_torch.experiment import build_supports
from stmgcn_tpu_torch.models.params import health_groups, to_jax_params
from stmgcn_tpu_torch.obs import drift, health
from stmgcn_tpu_torch.obs.registry import MetricsRegistry
from stmgcn_tpu_torch.serving import engine as engine_module
from stmgcn_tpu_torch.serving import fleet as fleet_module
from stmgcn_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_graphs import StandInPool, _small_forecaster

torch.set_num_threads(1)

LOSS_RTOL = 2e-5
STEP_NORM_RTOL = 1e-4
RUN_NORM_RTOL = 1e-3


# -- the copied modules ---------------------------------------------------------

def test_sketches_and_baselines_equal_the_jax_modules():
    rng = np.random.default_rng(0)
    samples = rng.normal(5.0, 3.0, (4000, 2))
    for bins in (1, 16, 64):
        ours = drift.baseline_from_samples(samples, bins=bins)
        theirs = jax_drift.baseline_from_samples(samples, bins=bins)
        assert set(ours) == set(theirs) and ours["n"] == theirs["n"]
        for key in ("mean", "std", "hist"):
            np.testing.assert_array_equal(ours[key], theirs[key])
    chunks = [rng.normal(8.0, 2.0, (n, 2)) for n in (1, 17, 300)]
    sketches = [mod.MomentSketch(2, bins=16, norm=(np.full(2, 5.0), np.full(2, 3.0)))
                for mod in (drift, jax_drift)]
    for sk in sketches:
        for c in chunks:
            sk.update(c)
    a, b = sketches
    np.testing.assert_array_equal(a.mean, b.mean)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.probs(), b.probs())
    blob = drift.baseline_from_samples(samples, bins=16)
    assert drift.psi(blob["hist"], a.probs()) == jax_drift.psi(blob["hist"], b.probs())
    assert drift.drift_metrics(blob, a) == jax_drift.drift_metrics(blob, b)


def test_drift_monitor_observes_and_resets_as_the_jax_one():
    rng = np.random.default_rng(1)
    base = {"bins": 16, "input": {"0": drift.baseline_from_samples(
        rng.normal(10.0, 2.0, (4000, 1)), bins=16)}}
    calm, hot = rng.normal(10.0, 2.0, (2000, 1)), rng.normal(26.0, 2.0, (2000, 1))
    snaps = []
    for mod in (drift, jax_drift):
        reg = MetricsRegistry()
        mon = mod.DriftMonitor(copy.deepcopy(base), registry=reg)
        mon.observe_input(0, calm)
        mon.observe_input(1, hot)  # a held-out city without a baseline: ignored
        first = mon.snapshot()
        mon.observe_input(0, hot)
        second = mon.snapshot()
        mon.reset(1)
        snaps.append((first, second, mon.snapshot(), reg.gauge("serving.drift.generation").value))
    assert snaps[0] == snaps[1]
    first, second, after, _ = snaps[0]
    assert "1" not in first["cities"] and first["cities"]["0"]["input"]["psi"] < 0.1
    assert second["cities"]["0"]["input"]["z_max"] > 10
    assert after == {"schema_version": 1, "generation": 1, "cities": {}}


def test_health_stream_and_report_equal_the_jax_module(tmp_path):
    records = [{"kind": "train", "step": 2, "loss": 0.5, "grad_norm": 1.0,
                "update_ratio": 1e-3, "nonfinite_grads": 0, "nonfinite_loss": 0,
                "group_norms": {"branches": 0.7}, "city_loss": {"0": 0.4}},
               {"kind": "drift", "city": "0", "phase": "input", "z_max": 12.5, "psi": 0.4,
                "n": 100, "generation": 1}]
    for mod, name in ((health, "ours"), (jax_health, "theirs")):
        w = mod.HealthWriter(str(tmp_path / f"{name}.jsonl"), {"every_k": 2})
        for r in records:
            w.write(r)
        w.close()
    assert (tmp_path / "ours.jsonl").read_text() == (tmp_path / "theirs.jsonl").read_text()
    meta, got = health.load_health(str(tmp_path / "ours.jsonl"))
    assert health.summarize_health(got) == jax_health.summarize_health(got)
    assert (health.render_health_table(health.summarize_health(got), meta)
            == jax_health.render_health_table(jax_health.summarize_health(got), meta))


# -- one step's stats against the JAX step ----------------------------------------

def _jax_configs(tmp_path, steps=3, **health_kw):
    cfg = jax_preset("default")
    cfg.data.rows = 4
    cfg.data.n_timesteps = 24 * 7 + 80
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 1
    cfg.train.epochs, cfg.train.batch_size = 2, 8
    cfg.train.grad_clip_norm = 1.0
    cfg.train.steps_per_superstep = steps
    cfg.train.out_dir = str(tmp_path / "jax")
    for key, value in health_kw.items():
        setattr(cfg.health, key, value)
    port = cfg.to_dict()
    port["train"]["out_dir"] = str(tmp_path / "port")
    if cfg.health.out is not None:
        port["health"]["out"] = str(tmp_path / "port.jsonl")
    return cfg, ExperimentConfig.from_dict(port)


def test_one_step_health_stats_equal_jax_health_stats(tmp_path):
    jax_cfg, cfg = _jax_configs(tmp_path)
    jt = jax_build_trainer(jax_cfg, verbose=False)
    pt = build_trainer(cfg, device="cpu", verbose=False,
                       initial_state=from_jax_params(jax.tree.map(np.asarray, jt.params), 3))
    fns = make_step_fns(jt.model, jt._optimizer, "mse", health=True)
    batch = next(iter(pt.batches("train")))
    x, y, mask = jt._place_batch(batch, "train")

    def jax_step(mask):  # the step donates its state: hand it copies
        state = jax.tree.map(jnp.copy, (jt.params, jt.opt_state))
        return fns.train_step(*state, jt.supports, x, y, mask)

    _, _, loss, stats = jax_step(mask)
    pt._take_snapshot()  # the poisoned step below starts from the same state
    losses, rows = pt._dispatch([batch], "train", health=True)
    names = [g for g, _ in pt._health_groups]
    assert tuple(names) == health_group_names(jt.params) == ("branches", "head")
    row = rows[0]
    np.testing.assert_allclose(losses[0], float(loss), rtol=LOSS_RTOL)
    for col, key in ((1, "grad_norm"), (2, "update_ratio")):
        np.testing.assert_allclose(row[col], float(stats[key]), rtol=STEP_NORM_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(row[5:], np.asarray(stats["group_norms"]), rtol=STEP_NORM_RTOL)
    assert row[3] == int(stats["nonfinite_grads"]) == 0
    assert row[4] == int(stats["nonfinite_loss"]) == 0
    # a poisoned mask: the counts are exact, NaN through every gradient
    poisoned = mask.at[0].set(jnp.nan)
    _, _, _, bad = jax_step(poisoned)
    pt._rollback()
    _, bad_rows = pt._dispatch([batch], "train", health=True, poisons={0: float("nan")})
    total = sum(p.numel() for p in pt.model.parameters())
    # the units the ReLU zeroes on every row keep finite gradients
    assert bad_rows[0][3] == int(bad["nonfinite_grads"]) < total
    assert bad_rows[0][4] == int(bad["nonfinite_loss"]) == 1


def test_looped_layout_groups_are_the_jax_tree_keys():
    cfg = preset("default")
    from stmgcn_tpu_torch.experiment import build_model

    model = build_model(cfg, 1, device="cpu", generator=torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    for layout in ("vmapped", "looped"):
        tree = to_jax_params(model.state_dict(), 3, layout=layout)
        groups = health_groups(names, 3, layout=layout)
        assert tuple(g for g, _ in groups) == health_group_names(tree)
        # every parameter entry belongs to exactly one group member
        members = [(i, m) for _, g in groups for i, m in g]
        assert len(members) == len(set(members))
    assert [g for g, _ in health_groups(names, 3, layout="looped")] == [
        "branch_0", "branch_1", "branch_2", "head"]


# -- training runs against the JAX trainer -----------------------------------------

def _records(path):
    meta, records = health.load_health(str(path))
    return meta, records


def _assert_records_match(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for key in ("kind", "epoch", "step", "steps", "nonfinite_grads", "nonfinite_loss"):
            assert a[key] == b[key], key
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        for key in ("grad_norm", "update_ratio"):
            np.testing.assert_allclose(a[key], b[key], rtol=RUN_NORM_RTOL, err_msg=key)
        assert list(a["group_norms"]) == list(b["group_norms"])
        np.testing.assert_allclose(list(a["group_norms"].values()),
                                   list(b["group_norms"].values()), rtol=RUN_NORM_RTOL)
        assert set(a.get("city_loss", {})) == set(b.get("city_loss", {}))
        for city, value in b.get("city_loss", {}).items():
            np.testing.assert_allclose(a["city_loss"][city], value, rtol=LOSS_RTOL)


def test_series_run_health_matches_jax_and_the_plain_run(tmp_path):
    jax_cfg, cfg = _jax_configs(tmp_path, enabled=True, out=str(tmp_path / "jax.jsonl"),
                                sketch_size=16)
    jt = jax_build_trainer(jax_cfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    jt.train()
    pt = build_trainer(cfg, device="cpu", initial_state=init, verbose=False)
    h = pt.train()
    meta, ours = _records(tmp_path / "port.jsonl")
    jax_meta, theirs = _records(tmp_path / "jax.jsonl")
    assert meta == jax_meta == {"schema_version": 1, "kind": "meta", "every_k": 1,
                                "groups": ["branches", "head"]}
    _assert_records_match(ours, theirs)
    assert [r["steps"] for r in ours[:3]] == [3, 3, 1]  # two blocks and the tail
    # the health twins update bit for bit as the plain programs
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.health.enabled = False
    plain_cfg.train.out_dir = str(tmp_path / "plain")
    plain = build_trainer(plain_cfg, device="cpu", initial_state=init, verbose=False)
    assert plain.train() == h
    for name, value in plain.model.state_dict().items():
        assert torch.equal(value, pt.model.state_dict()[name]), name
    assert {k[3] for k in pt._programs} == {True} and {k[3] for k in plain._programs} == {False}
    # the baseline in checkpoint meta is the JAX trainer's, and each package's
    # Forecaster reads the other's
    ours = load_checkpoint(pt.best_path, load_opt_state=False)[0]["health_baseline"]
    theirs = load_checkpoint(jt.best_path, load_opt_state=False)[0]["health_baseline"]
    assert ours == theirs and ours["bins"] == 16 and set(ours["input"]) == {"0"}
    assert JaxForecaster.from_checkpoint(pt.best_path).health_baseline == theirs
    assert Forecaster.from_checkpoint(jt.best_path, device="cpu").health_baseline == theirs


def test_every_k_two_halves_the_stream(tmp_path):
    counts = {}
    for k in (1, 2):
        cfg = preset("smoke")
        cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 + 80
        cfg.train.epochs, cfg.train.batch_size, cfg.train.steps_per_superstep = 2, 8, 3
        cfg.train.out_dir = str(tmp_path / f"k{k}")
        cfg.health.enabled, cfg.health.every_k = True, k
        trainer = build_trainer(cfg, device="cpu", verbose=False)
        trainer.train()
        meta, records = _records(tmp_path / f"k{k}" / "health.jsonl")
        assert meta["every_k"] == k
        counts[k] = len(records)
    assert counts[1] == 6 and counts[2] == 3  # three dispatches an epoch
    with pytest.raises(ValueError, match="health_every_k"):
        from stmgcn_tpu_torch.train import Trainer

        Trainer(trainer.model, trainer.dataset, trainer.supports, device="cpu",
                health=True, health_every_k=0)


def _multicity(tmp_path, **health_kw):
    cfg = preset("multicity")
    cfg.mesh = MeshConfig()
    cfg.data.city_rows, cfg.data.city_timesteps = (5, 4), (24 * 7 * 2, 24 * 7 * 2 + 24)
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 1
    cfg.train.epochs, cfg.train.batch_size = 2, 8
    cfg.train.fleet, cfg.train.steps_per_superstep = True, 4
    cfg.train.out_dir = str(tmp_path / "port")
    for key, value in health_kw.items():
        setattr(cfg.health, key, value)
    return cfg


def test_fleet_run_health_matches_jax_and_city_loss_sums(tmp_path):
    cfg = _multicity(tmp_path, enabled=True, out=str(tmp_path / "port.jsonl"))
    jax_cfg = type(jax_preset("multicity")).from_dict(cfg.to_dict())
    jax_cfg.train.out_dir = str(tmp_path / "jax")
    jax_cfg.health.out = str(tmp_path / "jax.jsonl")
    jt = jax_build_trainer(jax_cfg, verbose=False)
    pt = build_trainer(cfg, device="cpu", verbose=False,
                       initial_state=from_jax_params(jax.tree.map(np.asarray, jt.params), 3))
    emitted = []
    emit = pt._health_emit

    def spy(stats, cities=None):
        emitted.append((stats.copy(), cities))
        return emit(stats, cities=cities)

    pt._health_emit = spy
    jt.train()
    pt.train()
    assert pt.train_path == "fleet_superstep"
    _, ours = _records(tmp_path / "port.jsonl")
    _, theirs = _records(tmp_path / "jax.jsonl")
    _assert_records_match(ours, theirs)
    fleet = [(s, c) for s, c in emitted if c is not None]
    assert fleet and any("city_loss" in r for r in ours)
    groups = len(pt._health_groups)
    for stats, cities in fleet:
        city_loss = stats[:, 5 + groups:]
        assert city_loss.shape[1] == len(cities)
        np.testing.assert_array_equal(city_loss.sum(axis=1), stats[:, 0])
        assert ((city_loss != 0).sum(axis=1) <= 1).all()
    meta, _, _ = load_checkpoint(pt.best_path, load_opt_state=False)
    assert set(meta["health_baseline"]["input"]) == {"0", "1"}


# -- serving drift ----------------------------------------------------------------

def _drift_engine(monkeypatch, fc, supports, buckets=(1, 2, 4)):
    monkeypatch.setattr(engine_module, "GraphPool", lambda device: StandInPool())
    cfg = ServingConfig(buckets=buckets, max_batch=buckets[-1], max_delay_ms=5.0)
    sup = torch.as_tensor(supports)
    return engine_module.ServingEngine(
        {b: engine_module._bucket_program(sup, torch.device("cpu")) for b in cfg.buckets},
        copy.deepcopy(fc.model).eval(), fc.normalizer, fc.expected, cfg,
        torch.device("cpu"), graphs=True)


def _history(fc, n_nodes, b, lo=0.0, hi=50.0, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (b, fc.seq_len, n_nodes, 1)).astype(np.float32)


def test_engine_drift_lifecycle(monkeypatch):
    fc, supports, ds = _small_forecaster()
    cal = _history(fc, ds.n_nodes, 4)
    baseline = {
        "schema_version": 1, "bins": 16,
        "input": {"0": drift.baseline_from_samples(
            fc.normalizer.transform(cal).reshape(-1, 1), bins=16)},
        "prediction": {"0": drift.baseline_from_samples(
            fc.predict(supports, cal).reshape(-1, 1), bins=16)},
    }
    with _drift_engine(monkeypatch, fc, supports) as eng:
        assert eng.drift_snapshot() is None
        eng.enable_drift(baseline, city=0)
        eng.predict(_history(fc, ds.n_nodes, 3, seed=2))
        calm = eng.drift_snapshot()["cities"]["0"]
        assert set(calm) == {"input", "prediction"} and calm["input"]["n"] == 3 * 5 * 9
        assert calm["input"]["psi"] < 0.25
        eng.predict_direct(_history(fc, ds.n_nodes, 4, lo=300, hi=400, seed=3))
        hot = eng.drift_snapshot()["cities"]["0"]["input"]
        assert hot["z_max"] > 10 and hot["psi"] > 0.25
        new_base = {"bins": 4, "input": {"0": drift.baseline_from_samples(
            np.zeros((10, 1)), bins=4)}}
        assert eng.swap_params(fc.model.state_dict(), health_baseline=new_base) == 1
        snap = eng.drift_snapshot()
        assert snap == {"schema_version": 1, "generation": 1, "cities": {}}
        assert eng.drift.bins == 4
        eng.predict(_history(fc, ds.n_nodes, 2, seed=4))
        assert eng.drift_snapshot()["cities"]["0"]["input"]["n"] == 2 * 5 * 9


def test_checkpoint_with_drift_wires_the_engine(tmp_path):
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 + 40
    cfg.train.epochs, cfg.train.batch_size = 1, 8
    cfg.train.out_dir = str(tmp_path)
    cfg.health.enabled, cfg.health.drift, cfg.health.sketch_size = True, True, 8
    trainer = build_trainer(cfg, device="cpu", verbose=False)
    trainer.train()
    fc = Forecaster.from_checkpoint(trainer.best_path, device="cpu")
    assert fc.config.health.drift and fc.health_baseline["bins"] == 8
    supports = build_supports(cfg, trainer.dataset)
    with fc.serving_engine(supports, device="cpu",
                           config=ServingConfig(buckets=(1, 2), max_batch=2)) as eng:
        assert eng.drift is not None and eng.drift.bins == 8
        rows = trainer.dataset.denormalize(trainer.dataset.arrays("test")[0])[:2]
        eng.predict_direct(rows)
        assert eng.drift_snapshot()["cities"]["0"]["input"]["n"] == rows.size
        watcher = eng.watch_checkpoints(str(tmp_path))
        trainer.n_epochs = 2
        trainer.train()
        assert watcher.poll() and eng.drift.generation == eng.generation == 1
        assert eng.drift_snapshot()["cities"] == {}


def test_fleet_engine_drift_over_both_cities(tmp_path, monkeypatch):
    cfg = _multicity(tmp_path, enabled=True, drift=True, sketch_size=16)
    cfg.train.epochs = 1
    trainer = build_trainer(cfg, device="cpu", verbose=False)
    trainer.train()
    fc = Forecaster.from_checkpoint(trainer.best_path, device="cpu")
    monkeypatch.setattr(fleet_module, "GraphPool", lambda device: StandInPool())
    monkeypatch.setattr(fleet_module, "resolve_graphs", lambda graphs, device: True)
    ds = trainer.dataset
    with fc.fleet_engine(build_supports(fc.config, ds), device="cpu", graphs=True,
                         config=ServingConfig(buckets=(1, 2), max_batch=2)) as eng:
        assert eng.drift is not None
        n = fc.derived["n_nodes"]
        calm = ds.denormalize(ds.city_arrays("test", 0)[0][:2], city=0)
        eng.predict(calm, city=0)
        eng.predict(_history(fc, n[1], 2, lo=1e4, hi=2e4), city=1)
        snap = eng.drift_snapshot()["cities"]
        assert set(snap) == {"0", "1"}
        assert snap["0"]["input"]["n"] == calm.size
        assert snap["1"]["input"]["z_max"] > 10 > snap["0"]["input"]["z_max"]
        eng.swap_params(fc.model.state_dict())
        assert eng.drift_snapshot() == {"schema_version": 1, "generation": 1, "cities": {}}


# -- the CLI and the config ---------------------------------------------------------

def test_health_and_obs_subcommands(tmp_path, capsys):
    path = tmp_path / "health.jsonl"
    w = health.HealthWriter(str(path), {"every_k": 1, "groups": ["branches"]})
    w.write({"kind": "train", "epoch": 1, "step": 3, "steps": 3, "loss": 0.5,
             "grad_norm": 1.0, "update_ratio": 1e-3, "nonfinite_grads": 0,
             "nonfinite_loss": 0, "group_norms": {"branches": 0.7}})
    w.close()
    assert cli.main(["health", str(path), "--format", "json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["summary"]["train"]["count"] == 1
    tracer = jax_trace.Tracer()  # a trace the JAX package wrote
    with tracer.span("train.superstep"):
        pass
    trace = tmp_path / "trace.jsonl"
    tracer.export_jsonl(str(trace))
    assert cli.main(["obs", str(trace)]) == 0
    assert "train.superstep" in capsys.readouterr().out


def test_health_section_reads():
    d = jax_preset("default").to_dict()
    d["health"].update(enabled=True, every_k=3, drift=True, out="h.jsonl")
    cfg = ExperimentConfig.from_dict(d)
    assert cfg.health == HealthConfig(enabled=True, every_k=3, drift=True, out="h.jsonl")
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg
    assert HealthConfig(drift=True, baseline=False).violations()
    assert HealthConfig(enabled=True, every_k=0).violations()
    assert not HealthConfig().violations()


@pytest.mark.parametrize("section,field,value,match", [
    ("continual", "cadence_s", 1.0, None),
    ("continual", "enabled", True, "daemon would never fire"),
    ("federation", "replicas", 5, None)])
def test_unported_section_set_away_from_its_defaults_raises(section, field, value, match):
    """The ``continual`` and ``federation`` sections (ported since the
    closed loop and the federation were): a field set away from its default
    reads as the JAX package reads it and round-trips, and a section that
    breaks its ``violations()`` raises, in the JAX contract's words."""
    d = jax_preset("default").to_dict()
    ExperimentConfig.from_dict(d)  # the JAX defaults read as they are
    d[section][field] = value
    if match is not None:  # the loop on without drift gauges to fire it
        with pytest.raises(ValueError, match=f"{section} section: .*{match}"):
            ExperimentConfig.from_dict(d)
        d["health"].update(enabled=True, drift=True)
    cfg = ExperimentConfig.from_dict(d)
    assert getattr(getattr(cfg, section), field) == value
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg
    want = getattr(jax_config, f"{section.capitalize()}Config")(**d[section])
    assert dataclasses.asdict(getattr(cfg, section)) == dataclasses.asdict(want)
    bad = dict(d, **{section: dict(d[section], **(
        {"ring_capacity": 0} if section == "continual" else {"vnodes": 0}))})
    with pytest.raises(ValueError, match=f"{section} section: "):
        ExperimentConfig.from_dict(bad)


@pytest.mark.parametrize("fields,match", [
    ({"drift": True, "enabled": True, "baseline": False}, "baseline capture is off"),
    ({"drift": True}, "training health is off"),
    ({"enabled": True, "every_k": 0}, "every_k must be >= 1"),
    ({"reservoir": -1}, "reservoir must be >= 0")])
def test_build_trainer_refuses_a_broken_health_section(fields, match):
    """Drift gauges that could never fire (no baseline written) and the
    rest of the section's contract raise instead of training."""
    cfg = preset("smoke")
    for name, value in fields.items():
        setattr(cfg.health, name, value)
    with pytest.raises(ValueError, match=match):
        build_trainer(cfg, device="cpu")
