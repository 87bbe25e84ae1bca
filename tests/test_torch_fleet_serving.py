"""The port's ``FleetServingEngine`` and its tiled fleet against the JAX
package's.

Dense classes (mirroring ``tests/test_fleet.py:289-387``): a train-free
heterogeneous ``Forecaster`` over ``tests/test_fleet.py``'s three cities
(N = 9, 8, 4; two classes, city 1 padded by a node) with the ``smoke``
model's JAX-initialized weights and per-city normalizers. The engine's
predictions (micro-batched and direct) equal the port's per-city
``Forecaster.predict`` and the JAX engine's at rtol 1e-5 / atol 1e-4 in raw
demand units (a normalizer range of ~1e2; the port's padded rung sums in
another order than each city's own shape); routing, buckets, cross-city
coalescing, the oversized split, private classes for unassigned cities,
validation errors, a homogeneous checkpoint refused, support-shape
mismatches, a ``GlobalBudget`` shared by every class, and a fleet-wide
``swap_params`` and ``watch_checkpoints``.

Tiled cities (``tests/test_tiling.py:265-287``'s fleet, narrow widths): the
plans are grown by ``pad_to`` and widened by ``with_block_cols`` to JAX's
arrays, two fleet epochs match the JAX trainer (losses rtol 2e-5,
parameters atol 2e-5), and each tiled city serves in a private exact-fit
class, equal to ``Forecaster.predict`` and to the JAX engine.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.config import MeshConfig as JaxMeshConfig
from stmgcn_tpu.config import ServingConfig as JaxServingConfig
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.data import MinMaxNormalizer as JaxMinMax
from stmgcn_tpu.data import synthetic_dataset as jax_synthetic
from stmgcn_tpu.experiment import build_model as jax_build_model
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu_torch import (
    ExperimentConfig,
    FleetServingEngine,
    Forecaster,
    ServingConfig,
    build_trainer,
    from_jax_params,
    preset,
)
from stmgcn_tpu_torch.data import MinMaxNormalizer
from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
from stmgcn_tpu_torch.ops import SupportConfig
from stmgcn_tpu_torch.models import to_jax_params
from stmgcn_tpu_torch.ops.tiling import TiledSupports
from stmgcn_tpu_torch.serving import GlobalBudget
from stmgcn_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)

CITY_DIMS = ((3, 3), (2, 4), (2, 2))
LADDER = dict(buckets=(1, 2, 4), max_batch=4, max_delay_ms=5.0)
PRED = dict(rtol=1e-5, atol=1e-4)


def _history(rng, rows, seq_len, n):
    return rng.gamma(2.0, 20.0, size=(rows, seq_len, n, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def fleet_setup():
    """The port's and the JAX package's train-free heterogeneous forecasters
    over one set of weights (``tests/test_fleet.py``'s recipe)."""
    cfg = jax_preset("smoke")
    datas = [jax_synthetic(rows=r, cols=c, n_timesteps=24 * 7 * 2 + 12 * i, seed=i + 1)
             for i, (r, c) in enumerate(CITY_DIMS)]
    n_nodes = [d.demand.shape[1] for d in datas]
    sups = [np.asarray(SupportConfig(cfg.model.kernel_type, cfg.model.K).build_all(
        d.adjs.values()), np.float32)[: cfg.model.m_graphs] for d in datas]
    jmodel = jax_build_model(cfg, 1)
    x = jnp.zeros((2, cfg.data.seq_len, n_nodes[0], 1), jnp.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(sups[0]), x)
    derived = {"input_dim": 1, "n_nodes": n_nodes}
    jfc = JaxForecaster(jmodel, params, None, cfg, derived,
                        [JaxMinMax.fit(np.asarray(d.demand)) for d in datas])
    pcfg = ExperimentConfig.from_dict(cfg.to_dict())
    state = from_jax_params(jax.tree.map(np.asarray, params), cfg.model.m_graphs)
    fc = Forecaster(build_model(pcfg, 1, device="cpu"), state, None, pcfg, derived,
                    [MinMaxNormalizer.fit(np.asarray(d.demand)) for d in datas], device="cpu")
    return fc, jfc, sups, n_nodes


@pytest.fixture(scope="module")
def engines(fleet_setup):
    fc, jfc, sups, _ = fleet_setup
    eng = fc.fleet_engine(sups, config=ServingConfig(**LADDER), device="cpu")
    jeng = jfc.fleet_engine(sups, config=JaxServingConfig(**LADDER))
    yield eng, jeng
    eng.close()
    jeng.close()


def test_routing_and_buckets(engines):
    eng, jeng = engines
    assert eng.n_cities == 3 and eng.buckets == (1, 2, 4)
    assert eng.class_of(0) == eng.class_of(1) != eng.class_of(2)
    assert eng._groups == jeng._groups and eng.plan.unassigned == ()


@pytest.mark.parametrize("city", [0, 1, 2])
def test_predictions_match_forecaster_and_the_jax_engine(fleet_setup, engines, city):
    fc, jfc, sups, n_nodes = fleet_setup
    eng, jeng = engines
    h = _history(np.random.default_rng(city), 3, fc.seq_len, n_nodes[city])
    ref = fc.predict(sups[city], h, city=city)
    np.testing.assert_allclose(ref, jfc.predict(sups[city], h, city=city), **PRED)
    for got in (eng.predict(h, city=city), eng.predict_direct(h, city=city)):
        assert got.shape == ref.shape == (3, n_nodes[city], 1)
        np.testing.assert_allclose(got, ref, **PRED)
        np.testing.assert_allclose(got, jeng.predict_direct(h, city=city), **PRED)


def test_oversized_batch_splits(fleet_setup, engines):
    fc, _, sups, n_nodes = fleet_setup
    eng, _ = engines
    h = _history(np.random.default_rng(7), 9, fc.seq_len, n_nodes[0])
    out = eng.predict(h, city=0)
    assert out.shape[0] == 9
    np.testing.assert_allclose(out, fc.predict(sups[0], h, city=0), **PRED)


def test_cross_city_dispatch_coalesces(fleet_setup, engines):
    """Concurrent requests for the two same-class cities share a dispatch,
    each answered with its own city's forecast."""
    fc, _, sups, n_nodes = fleet_setup
    eng, _ = engines
    before = eng.cross_city_dispatches
    rng = np.random.default_rng(11)
    hs = {c: _history(rng, 2, fc.seq_len, n_nodes[c]) for c in (0, 1)}
    outs = {}
    barrier = threading.Barrier(2)

    def worker(c):
        barrier.wait()
        outs[c] = eng.predict(hs[c], city=c)

    for _ in range(5):  # a dispatch may catch one caller alone; retry a few times
        threads = [threading.Thread(target=worker, args=(c,)) for c in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for c in (0, 1):
            np.testing.assert_allclose(outs[c], fc.predict(sups[c], hs[c], city=c), **PRED)
        if eng.cross_city_dispatches > before:
            break
    assert eng.cross_city_dispatches > before


def test_unassigned_city_gets_private_class(fleet_setup):
    fc, _, sups, n_nodes = fleet_setup
    with fc.fleet_engine(sups, config=ServingConfig(**LADDER), max_classes=1,
                         max_pad_waste=0.05, device="cpu") as eng:
        assert eng.plan.unassigned == (1, 2)
        assert len({eng.class_of(c) for c in range(3)}) == 3
        rng = np.random.default_rng(3)
        for c in range(3):
            h = _history(rng, 2, fc.seq_len, n_nodes[c])
            np.testing.assert_allclose(eng.predict(h, city=c), fc.predict(sups[c], h, city=c),
                                       **PRED)


def test_validation_errors(fleet_setup, engines):
    fc, _, sups, n_nodes = fleet_setup
    eng, _ = engines
    with pytest.raises(ValueError, match="city"):
        eng.predict(np.zeros((1, fc.seq_len, 9, 1), np.float32), city=9)
    with pytest.raises(ValueError, match="history"):
        eng.predict(np.zeros((1, fc.seq_len, 7, 1), np.float32), city=0)
    flat = Forecaster(fc.model, fc.state_dict, fc.normalizers[0], fc.config,
                      {"input_dim": 1, "n_nodes": n_nodes[0]}, device="cpu")
    with pytest.raises(ValueError, match="ServingEngine"):
        FleetServingEngine.from_forecaster(flat, [sups[0]], device="cpu")
    with pytest.raises(ValueError, match="support"):
        FleetServingEngine.from_forecaster(fc, sups[:2], device="cpu")
    with pytest.raises(ValueError, match="city 1"):
        FleetServingEngine.from_forecaster(fc, [sups[0], sups[0], sups[2]], device="cpu")
    budget = GlobalBudget(8)  # one tier budget, drawn down by every class
    with FleetServingEngine.from_forecaster(fc, sups, config=ServingConfig(**LADDER),
                                            device="cpu", global_budget=budget) as shared:
        controllers = list(shared.class_admission.values())
        assert len(controllers) == 2 and all(c._global is budget for c in controllers)
        shared.predict(np.zeros((4, fc.seq_len, n_nodes[0], 1), np.float32), city=0)
        assert budget.snapshot()["peak"] == 4 and budget.snapshot()["outstanding"] == 0
    with pytest.raises(ValueError, match="pass city="):
        fc.serving_engine(sups[0], device="cpu")


def test_serving_engine_serves_one_city(fleet_setup):
    fc, _, sups, n_nodes = fleet_setup
    h = _history(np.random.default_rng(5), 3, fc.seq_len, n_nodes[1])
    with fc.serving_engine(sups[1], config=ServingConfig(**LADDER), city=1,
                           device="cpu") as eng:
        np.testing.assert_allclose(eng.predict(h), fc.predict(sups[1], h, city=1), **PRED)


def test_swap_and_watch_are_fleet_wide(fleet_setup, tmp_path):
    """One swap re-points every class; a checkpoint landing in a watched
    directory swaps in through the same path."""
    fc, _, sups, n_nodes = fleet_setup
    rng = np.random.default_rng(9)
    hs = [_history(rng, 2, fc.seq_len, n) for n in n_nodes]
    new = {k: v * 0.5 for k, v in fc.state_dict.items()}
    scaled = Forecaster(build_model(fc.config, 1, device="cpu"), new, None, fc.config,
                        fc.derived, fc.normalizers, device="cpu")
    with fc.fleet_engine(sups, config=ServingConfig(**LADDER), device="cpu") as eng:
        watcher = eng.watch_checkpoints(str(tmp_path))
        assert eng.swap_params(new) == 1
        for c in range(3):
            out, gen = eng.predict(hs[c], city=c, with_generation=True)
            assert gen == 1
            np.testing.assert_allclose(out, scaled.predict(sups[c], hs[c], city=c), **PRED)
        with pytest.raises(ValueError, match="different keys"):
            eng.swap_params({})
        params = to_jax_params(fc.state_dict, fc.model.m_graphs)
        save_checkpoint(str(tmp_path / "best.ckpt"), params, None, {"epoch": 1})
        assert watcher.poll() and eng.generation == 2
        for c in range(3):
            np.testing.assert_allclose(eng.predict(hs[c], city=c),
                                       fc.predict(sups[c], hs[c], city=c), **PRED)


def test_bf16_fleet_engine_matches_the_bf16_forecaster(fleet_setup):
    """A ``model.dtype="bfloat16"`` checkpoint serves its fleet in bf16:
    every city's answers within 2^-9 of the largest prediction of the bf16
    ``Forecaster``'s (``chip_smoke.py``'s bf16 serving limit)."""
    import dataclasses

    fc, _, sups, n_nodes = fleet_setup
    cfg16 = dataclasses.replace(fc.config,
                                model=dataclasses.replace(fc.config.model, dtype="bfloat16"))
    fc16 = Forecaster(build_model(cfg16, 1, device="cpu"), fc.state_dict, None, cfg16,
                      fc.derived, fc.normalizers, device="cpu")
    with fc16.fleet_engine(sups, config=ServingConfig(**LADDER), device="cpu") as eng:
        for c in range(3):
            h = _history(np.random.default_rng(c), 3, fc.seq_len, n_nodes[c])
            want = fc16.predict(sups[c], h, city=c)
            got = eng.predict(h, city=c)
            assert got.dtype == np.float32
            assert np.abs(got - want).max() <= 2.0**-9 * np.abs(want).max()


# -- tiled cities -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiled_fleet(tmp_path_factory):
    """``tests/test_tiling.py:265-287``'s tiled fleet (5x5 and 4x5 cities,
    tile 8: the rung of 25 grows city 1's plan by a block row) at narrow
    widths, two fleet epochs in each package from one set of weights."""
    root = tmp_path_factory.mktemp("tiled_fleet")
    jcfg = jax_preset("multicity")
    jcfg.mesh = JaxMeshConfig()
    jcfg.data.city_rows, jcfg.data.cols, jcfg.data.city_timesteps = (5, 4), 5, None
    jcfg.data.n_timesteps = 24 * 7 * 2 + 48
    jcfg.model.tiled, jcfg.model.tile_size = True, 8
    jcfg.model.lstm_hidden_dim = jcfg.model.gcn_hidden_dim = 8
    jcfg.model.lstm_num_layers = 1
    jcfg.train.epochs, jcfg.train.steps_per_superstep, jcfg.train.fleet = 2, 4, True
    jcfg.train.batch_size, jcfg.train.out_dir = 16, str(root / "jax")
    d = jcfg.to_dict()
    d["train"]["out_dir"] = str(root / "port")
    jt = jax_build_trainer(jcfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    jax_hist = jt.train()
    pt = build_trainer(ExperimentConfig.from_dict(d), device="cpu", initial_state=init,
                       verbose=False)
    return jt, jax_hist, pt, pt.train(), root


def test_tiled_fleet_trains_as_jax(tiled_fleet):
    jt, jax_hist, pt, port_hist, _ = tiled_fleet
    assert pt.train_path == jt.train_path == "fleet_superstep"
    for c in range(2):
        got, want = pt.supports.for_city(c), jt.supports.for_city(c)
        assert isinstance(got, TiledSupports) and got.n == 25 and got.block_rows == 4
        for key in ("perm", "inv", "data", "idx", "data_t", "idx_t"):
            np.testing.assert_array_equal(getattr(got, key).numpy(),
                                          np.asarray(getattr(want, key)), err_msg=key)
    grown = pt.supports.for_city(1)
    assert not grown.nblk[:, :, 3].any() and (grown.nblk < grown.block_cols).any()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(port_hist[mode], jax_hist[mode], rtol=2e-5)
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    for name, value in pt.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


def test_tiled_cities_serve_in_private_exact_fit_classes(tiled_fleet):
    _, _, _, _, root = tiled_fleet
    fc = Forecaster.from_checkpoint(str(root / "port" / "best.ckpt"), device="cpu")
    jfc = JaxForecaster.from_checkpoint(str(root / "port" / "best.ckpt"))
    cfg = fc.config
    plans = build_supports(cfg, build_dataset(cfg))
    ladder = dict(buckets=(4,), max_batch=4)
    eng = fc.fleet_engine(plans, config=ServingConfig(**ladder), device="cpu")
    jeng = jfc.fleet_engine(_jax_plans(cfg), config=JaxServingConfig(**ladder))
    with eng, jeng:
        assert sorted(eng._groups) == sorted((p.n, (c,)) for c, p in enumerate(plans.per_city))
        for c, plan in enumerate(plans.per_city):
            hist = np.random.default_rng(c).standard_normal(
                (2, fc.seq_len, plan.n, 1)).astype(np.float32)
            want = fc.predict(plan, hist, city=c)
            np.testing.assert_allclose(eng.predict_direct(hist, city=c), want, **PRED)
            np.testing.assert_allclose(eng.predict(hist, city=c), want, **PRED)
            np.testing.assert_allclose(jeng.predict_direct(hist, city=c), want, **PRED)
        assert eng.swap_params(fc.state_dict) == 1


def _jax_plans(cfg):
    from stmgcn_tpu.config import ExperimentConfig as JaxExperimentConfig
    from stmgcn_tpu.experiment import build_dataset as jbd
    from stmgcn_tpu.experiment import build_supports as jbs

    jcfg = JaxExperimentConfig.from_dict(preset("multicity").to_dict())
    jcfg.mesh = JaxMeshConfig()
    for section in ("data", "model"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    return jbs(jcfg, jbd(jcfg))
