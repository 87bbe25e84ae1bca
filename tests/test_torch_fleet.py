"""The port's fleet training against the JAX package's fleet trainer.

``tests/test_fleet.py``'s three cities (N = 9, 8, 4: two shape classes,
city 1 padded by one node) at narrow widths, the same initial weights
through the flax -> ``state_dict`` converter:

- two epochs at S = 4 (``train_path == "fleet_superstep"``), shuffle off
  and on: per-epoch losses rtol 2e-5, final parameters atol 2e-5 (the
  tolerances ``tests/test_torch_tiling.py`` holds two tiled epochs to);
  ``test()``'s per-city reports rtol 1e-4;
- unassigned cities (one class, waste 0.05) take the per-step loop at
  their own shape, at the same tolerances;
- fleet checkpoints: either package's ``best.ckpt`` read by the other's
  ``Forecaster.from_checkpoint``, per-city predictions rtol 1e-5 / atol
  1e-4 in raw demand units, and the meta's trees (``normalizers``,
  ``derived``) equal;
- a mid-epoch resume on the fleet path ends where the uninterrupted run
  ended (rtol 1e-6, as ``tests/test_torch_checkpoint.py``'s);
- the blockers and knobs: ``fleet=True`` on a homogeneous dataset, on
  block-sparse supports, invalid knobs, ``fleet=False``; the CLI flags and
  presets against the JAX CLI's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from stmgcn_tpu.cli import build_parser as jax_build_parser
from stmgcn_tpu.cli import config_from_args as jax_config_from_args
from stmgcn_tpu.config import MeshConfig as JaxMeshConfig
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.data import HeteroCityDataset as JaxHetero
from stmgcn_tpu.data import WindowSpec as JaxWindowSpec
from stmgcn_tpu.data import synthetic_dataset as jax_synthetic
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.ops import SupportConfig as JaxSupportConfig
from stmgcn_tpu.train import CitySupports as JaxCitySupports
from stmgcn_tpu.train import Trainer as JaxTrainer
from stmgcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from stmgcn_tpu_torch import (
    CitySupports,
    ExperimentConfig,
    Forecaster,
    Trainer,
    build_trainer,
    from_jax_params,
)
from stmgcn_tpu_torch.cli import build_parser, config_from_args, main
from stmgcn_tpu_torch.data import DemandDataset, HeteroCityDataset, WindowSpec, synthetic_dataset
from stmgcn_tpu_torch.models import STMGCN
from stmgcn_tpu_torch.ops import SupportConfig
from stmgcn_tpu_torch.ops.spmm import stack_from_dense
from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

BATCH, S = 8, 4
CITY_DIMS = ((3, 3), (2, 4), (2, 2))
MODEL = dict(m_graphs=3, n_supports=3, seq_len=5, input_dim=1, lstm_hidden_dim=8,
             lstm_num_layers=1, gcn_hidden_dim=8)
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
PRED = dict(rtol=1e-5, atol=1e-4)


def _datas(synthetic):
    return [synthetic(rows=r, cols=c, n_timesteps=24 * 7 * 2 + 12 * i, seed=i + 1)
            for i, (r, c) in enumerate(CITY_DIMS)]


def _jax_fleet(out_dir, **kw):
    datas = _datas(jax_synthetic)
    return JaxTrainer(
        JaxSTMGCN(horizon=1, **MODEL), JaxHetero(datas, JaxWindowSpec(3, 1, 1, 24)),
        JaxCitySupports(JaxSupportConfig("chebyshev", 2).build_all(d.adjs.values())
                        for d in datas),
        n_epochs=2, batch_size=BATCH, out_dir=str(out_dir), verbose=False, **kw)


def _port_fleet(out_dir, initial_state=None, supports=None, **kw):
    datas = _datas(synthetic_dataset)
    if supports is None:
        supports = CitySupports(SupportConfig("chebyshev", 2).build_all(d.adjs.values())
                                for d in datas)
    return Trainer(STMGCN(**MODEL, device="cpu"), HeteroCityDataset(datas, WindowSpec(3, 1, 1, 24)),
                   supports, n_epochs=2, batch_size=BATCH, out_dir=str(out_dir),
                   initial_state=initial_state, device="cpu", verbose=False, **kw)


def _state(jax_trainer) -> dict:
    return from_jax_params(jax.tree.map(np.asarray, jax_trainer.params), 3)


def _assert_runs_agree(port, port_hist, jax_trainer, jax_hist):
    for mode in ("train", "validate"):
        np.testing.assert_allclose(port_hist[mode], jax_hist[mode], rtol=LOSS_RTOL)
    want = _state(jax_trainer)
    for name, value in port.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """One two-epoch shuffled fleet run in each package from the same
    weights."""
    root = tmp_path_factory.mktemp("fleet")
    jt = _jax_fleet(root / "jax", steps_per_superstep=S, shuffle=True)
    init = _state(jt)
    jax_hist = jt.train()
    pt = _port_fleet(root / "port", init, steps_per_superstep=S, shuffle=True)
    return jt, jax_hist, pt, pt.train(), init


def test_fleet_training_matches_jax(fleet_runs):
    jt, jax_hist, pt, port_hist, _ = fleet_runs
    assert pt.train_path == jt.train_path == "fleet_superstep"
    assert pt.fallback_reason is None
    assert [(c.n_nodes, c.cities) for c in pt.fleet_plan.classes] == [(4, (2,)), (9, (0, 1))]
    assert [pt._fleet_cities[c].pad for c in range(3)] == [0, 1, 0]
    _assert_runs_agree(pt, port_hist, jt, jax_hist)
    assert pt.global_step == pt.optimizer.count == 2 * pt.train_steps_per_epoch


def test_fleet_test_reports_per_city(fleet_runs):
    jt, _, pt, _, _ = fleet_runs
    got, want = pt.test(checkpoint=None), jt.test(checkpoint=None)
    for mode in ("train", "test"):
        assert set(got[mode]["per_city"]) == {"city0", "city1", "city2"}
        for key in ("mse", "mae", "rmse"):
            np.testing.assert_allclose(got[mode][key], want[mode][key], rtol=1e-4)
            for city, rep in got[mode]["per_city"].items():
                np.testing.assert_allclose(rep[key], want[mode]["per_city"][city][key],
                                           rtol=1e-4, err_msg=city)


def test_fleet_blocks_group_each_city_run(fleet_runs):
    """Blocks of S within each fleet city's run of batches; its tail one
    batch at a time; a resume cursor off a block boundary steps singly."""
    _, _, pt, _, _ = fleet_runs
    batches = list(pt.batches("train", shuffle=pt.shuffle))
    blocks = pt._blocks(batches, 0)
    assert [b for block in blocks for b in block] == batches
    for block in blocks:
        assert len({b.city for b in block}) == 1 and len(block) in (1, S)
    runs = {c: sum(b.city == c for b in batches) for c in range(3)}
    for c, n in runs.items():
        sizes = [len(block) for block in blocks if block[0].city == c]
        assert sizes == [S] * (n // S) + [1] * (n % S)
    assert all(len(block) == 1 for block in pt._blocks(batches, 1))


def test_unassigned_cities_step_at_their_own_shape(tmp_path):
    knobs = dict(fleet_max_classes=1, fleet_max_pad_waste=0.05, steps_per_superstep=S)
    jt = _jax_fleet(tmp_path / "jax", **knobs)
    init = _state(jt)
    jax_hist = jt.train()
    pt = _port_fleet(tmp_path / "port", init, **knobs)
    assert pt.train_path == "fleet_superstep"
    assert "no-class-fit" in pt.fallback_reason and "[1, 2]" in pt.fallback_reason
    assert sorted(pt._fleet_cities) == [0] and pt.fleet_plan.unassigned == (1, 2)
    assert pt._cities[1].n_real is None and pt._cities[1].series.shape[1] == 8
    _assert_runs_agree(pt, pt.train(), jt, jax_hist)


def _fleet_cfg(out_dir):
    """The ``multicity`` preset on one device with three narrow cities
    (N = 9, 9, 4: two classes), fleet blocks of S."""
    cfg = jax_preset("multicity")
    cfg.mesh = JaxMeshConfig()
    cfg.data.n_cities, cfg.data.city_rows = 3, (3, 3, 2)
    cfg.data.city_timesteps = (24 * 7 * 2, 24 * 7 * 2 + 12, 24 * 7 * 2)
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 1
    cfg.train.epochs, cfg.train.batch_size, cfg.train.steps_per_superstep = 1, BATCH, S
    cfg.train.out_dir = str(out_dir)
    return cfg


def test_fleet_checkpoints_cross_packages(tmp_path):
    """Either package's fleet best.ckpt serves in the other's Forecaster
    with the same per-city predictions, and the two files' meta trees
    (``normalizers``, ``derived``) are equal."""
    jcfg = _fleet_cfg(tmp_path / "jax")
    d = jcfg.to_dict()
    d["train"]["out_dir"] = str(tmp_path / "port")
    jt = jax_build_trainer(jcfg, verbose=False)
    init = _state(jt)
    jt.train()
    pt = build_trainer(ExperimentConfig.from_dict(d), device="cpu", initial_state=init,
                       verbose=False)
    assert pt.train_path == jt.train_path == "fleet_superstep"
    pt.train()
    jax_path, port_path = str(tmp_path / "jax" / "best.ckpt"), str(tmp_path / "port" / "best.ckpt")
    jmeta, _, _ = jax_load_checkpoint(jax_path, load_opt_state=False)
    pmeta, _, _ = load_checkpoint(port_path, load_opt_state=False)
    assert pmeta["normalizers"] == jmeta["normalizers"] and len(pmeta["normalizers"]) == 3
    assert pmeta["derived"] == jmeta["derived"] == {"input_dim": 1, "n_nodes": [9, 9, 4]}
    assert "normalizer" not in pmeta and "normalizer" not in jmeta
    ds = pt.dataset
    sups = [SupportConfig("chebyshev", 2).build_all(adjs.values()) for adjs in ds.city_adjs]
    rng = np.random.default_rng(0)
    for path in (jax_path, port_path):
        jfc = JaxForecaster.from_checkpoint(path)
        fc = Forecaster.from_checkpoint(path, device="cpu")
        assert len(fc.normalizers) == 3
        for c, n in enumerate(ds.city_n_nodes):
            h = rng.gamma(2.0, 20.0, size=(3, 5, n, 1)).astype(np.float32)
            np.testing.assert_allclose(fc.predict(sups[c], h, city=c),
                                       jfc.predict(sups[c], h, city=c), **PRED)
        with pytest.raises(ValueError, match="pass city="):
            fc.predict(sups[0], h)
        with pytest.raises(ValueError, match=r"city must be in \[0, 3\)"):
            fc.predict(sups[0], h, city=3)


def test_forecaster_city_errors_on_a_homogeneous_checkpoint(tmp_path):
    cfg = ExperimentConfig.from_dict(jax_preset("smoke").to_dict())
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 + 60
    cfg.train.epochs, cfg.train.out_dir = 1, str(tmp_path)
    build_trainer(cfg, device="cpu", verbose=False).train()
    fc = Forecaster.from_checkpoint(str(tmp_path / "best.ckpt"), device="cpu")
    assert fc.normalizers is None
    with pytest.raises(ValueError, match="only applies to heterogeneous"):
        fc.predict(np.zeros((1, 3, 9, 9), np.float32), np.zeros((1, 5, 9, 1)), city=1)


def test_fleet_mid_epoch_resume_ends_with_the_uninterrupted_run(fleet_runs, tmp_path):
    """A fleet run writing latest every 3 steps keeps its first mid-epoch
    file; a fresh trainer restores it, re-enters the epoch (off a block
    boundary: one batch at a time) and ends where the first run ended."""
    _, _, _, _, init = fleet_runs
    kw = dict(steps_per_superstep=S, checkpoint_every_steps=3, shuffle=True)
    a = _port_fleet(tmp_path / "a", init, **kw)
    kept = []
    save = a._save

    def save_and_keep(path):
        data = save(path)
        if path == a.latest_path and a._batch_in_epoch and not kept:
            kept.append(a._batch_in_epoch)
            with open(tmp_path / "mid.ckpt", "wb") as f:
                f.write(data)
        return data

    a._save = save_and_keep
    history = a.train()
    assert kept and 0 < kept[0] < a.train_steps_per_epoch
    b = _port_fleet(tmp_path / "b", init, **kw)
    meta = b.restore(str(tmp_path / "mid.ckpt"))
    assert meta["batch_in_epoch"] == kept[0] and "normalizers" in meta
    resumed = b.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(resumed[mode], history[mode], rtol=1e-6)
    for name, value in b.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), a.model.state_dict()[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# -- paths, blockers and knobs -----------------------------------------------

def test_fleet_paths_and_blockers(tmp_path):
    off = _port_fleet(tmp_path, steps_per_superstep=S, fleet=False)
    assert off.train_path == "per_step" and "fleet=False" in off.fallback_reason
    assert off.fleet_plan is None and all(d.n_real is None for d in off._cities.values())
    on = _port_fleet(tmp_path, fleet=True)  # S = 1: engaged, stepping one batch at a time
    assert on.train_path == "per_step" and on.fallback_reason is None and on.fleet_plan
    assert on._cities[1].series is on._cities[0].series  # one resident class series
    data = synthetic_dataset(rows=3, n_timesteps=24 * 7 * 2, seed=1)
    homogeneous = DemandDataset(data, WindowSpec(3, 1, 1, 24))
    sup = SupportConfig("chebyshev", 2).build_all(homogeneous.adjs.values())
    with pytest.raises(ValueError, match="fleet=True cannot engage: the dataset is homogeneous"):
        Trainer(STMGCN(**MODEL, device="cpu"), homogeneous, sup, batch_size=BATCH, fleet=True,
                out_dir=str(tmp_path), device="cpu", verbose=False)
    datas = _datas(synthetic_dataset)
    sparse = CitySupports(
        tuple(stack_from_dense(m) for m in SupportConfig("chebyshev", 2).build_all(
            d.adjs.values())) for d in datas)
    with pytest.raises(ValueError, match="neither dense"):
        _port_fleet(tmp_path, supports=sparse, fleet=True)
    for knob, match in ((dict(fleet_max_classes=0), "fleet_max_classes"),
                        (dict(fleet_max_pad_waste=1.0), "fleet_max_pad_waste")):
        with pytest.raises(ValueError, match=match):
            _port_fleet(tmp_path, **knob)


def test_build_trainer_engages_the_fleet_and_refuses_the_mesh(tmp_path):
    cfg = ExperimentConfig.from_dict(jax_preset("multicity").to_dict())
    with pytest.raises(ValueError, match="needs 8 ranks, but this job has 1"):
        build_trainer(cfg, device="cpu", verbose=False)
    cfg.mesh.dp = 1
    cfg.data.n_cities, cfg.data.city_rows = 3, (3, 3, 2)
    cfg.data.city_timesteps = (24 * 7 * 2, 24 * 7 * 2 + 12, 24 * 7 * 2)
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.train.steps_per_superstep, cfg.train.epochs, cfg.train.out_dir = 3, 1, str(tmp_path)
    t = build_trainer(cfg, device="cpu", verbose=False)
    assert t.train_path == "fleet_superstep" and t.fleet_plan is not None
    assert t.extra_meta["derived"]["n_nodes"] == [9, 9, 4]


# -- the CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--fleet"], ["--no-fleet"],
    ["--fleet-max-classes", "3", "--fleet-max-pad-waste", "0.25"],
    ["--preset", "multicity", "--fleet", "--steps-per-superstep", "4"],
    ["--preset", "longhorizon"],
])
def test_cli_fleet_flags_match_jax(argv):
    port = config_from_args(build_parser().parse_args(argv))
    want = jax_config_from_args(jax_build_parser().parse_args(argv))
    assert port == ExperimentConfig.from_dict(want.to_dict())


def test_cli_refuses_the_multicity_mesh_by_name(tmp_path, capsys):
    out = str(tmp_path)
    argv = ["--preset", "multicity", "--device", "cpu", "--epochs", "1", "--batch-size", "16",
            "--fleet", "--steps-per-superstep", "2", "--out-dir", out]
    assert main(argv) == 1 and "needs 8 ranks, but this job has 1" in capsys.readouterr().err
    assert main(argv + ["--print-config"]) == 0
    assert not os.listdir(out)


def test_bf16_fleet_steps_track_fp32(tmp_path):
    """``precision="bf16"`` on the fleet path (the gate's masked pool in
    float32 over bf16 features): steps over the padded and the exact-fit
    cities from one state stay within the twin drill's 1e-3 of fp32's
    losses (``tests/test_mixed_precision.py:84-116``)."""
    fp32 = _port_fleet(tmp_path / "a", fleet=True)
    state = {k: v.clone() for k, v in fp32.model.state_dict().items()}
    bf16 = _port_fleet(tmp_path / "b", state, fleet=True, precision="bf16")
    batches = list(fp32.batches("train"))
    pick = [b for b in batches if b.city == 1][:3] + [b for b in batches if b.city == 0][:2]
    for batch in pick:
        want, got = fp32.train_batch(batch).item(), bf16.train_batch(batch).item()
        assert np.isfinite(got) and abs(got - want) <= 1e-3, (batch.city, got, want)
    assert all(p.dtype == torch.float32 for p in bf16.model.parameters())


def test_chip_smoke_bench_fleet_point_equals_bench():
    """``chip_smoke.py``'s copy of ``bench.py``'s 8-city fleet point."""
    import bench
    import chip_smoke

    assert chip_smoke.BENCH_FLEET_DIMS == bench.FLEET_CITY_DIMS
    assert chip_smoke.BENCH_FLEET_SERIAL == bench.FLEET_SERIAL
    assert (bench.DAILY, bench.WEEKLY) == (1, 1)
