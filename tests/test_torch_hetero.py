"""The port's heterogeneous cities, fleet planner, presets, the gate's
traced real-node count and the long-horizon model against the JAX
package's.

- ``HeteroCityDataset``: series, windows, normalizers, split calendars,
  target vectors and the batch order (city-sequential; ``shuffle``,
  ``seed``, ``epoch``, ``pad_last``) equal to the JAX dataset's, array for
  array; ``build_dataset`` and ``build_supports`` on heterogeneous configs
  (dense, block-sparse and tiled ``CitySupports``) equal to JAX's, with
  its refusals; same-shape cities with their own graphs (a
  ``DemandDataset`` with a ``CitySupports``) train as the JAX trainer.
- ``plan_shape_classes`` on ``tests/test_fleet.py`` ``TestPlanner``'s
  cases, classes equal to JAX's.
- The ``multicity`` and ``longhorizon`` presets read from and equal the
  JAX presets' dicts; one ``longhorizon`` forward and backward (T = 26,
  horizon 24, narrow) against JAX ``apply``/``grad``: outputs rtol/atol
  1e-5, gradients rtol 1e-4 / atol 1e-6 (``tests/test_torch_model.py`` and
  ``tests/test_torch_train.py``'s tolerances).
- The gate's traced ``n_real``: both arms (exact fit, padded), output and
  gradients against the JAX gate at those tolerances; a ``(B,)`` count
  against the JAX gate row by row; padded rows get no gradient, and an
  inf in a padded row stays out of the output and of every gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.data import HeteroCityDataset as JaxHetero
from stmgcn_tpu.data import WindowSpec as JaxWindowSpec
from stmgcn_tpu.data import synthetic_dataset as jax_synthetic
from stmgcn_tpu.data.fleet import plan_shape_classes as jax_plan
from stmgcn_tpu.experiment import build_dataset as jax_build_dataset
from stmgcn_tpu.experiment import build_supports as jax_build_supports
from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.models.cg_lstm import ContextualGate as JaxContextualGate
from stmgcn_tpu_torch import CitySupports, ExperimentConfig, preset
from stmgcn_tpu_torch.config import MeshConfig
from stmgcn_tpu_torch.data import (
    FleetPlan,
    HeteroCityDataset,
    ShapeClass,
    WindowSpec,
    plan_shape_classes,
    synthetic_dataset,
)
from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
from stmgcn_tpu_torch.models import STMGCN, from_jax_params
from stmgcn_tpu_torch.models.cg_lstm import ContextualGate
from stmgcn_tpu_torch.ops.spmm import BlockSparseStack
from stmgcn_tpu_torch.ops.tiling import TiledSupports
from test_torch_model import _state

torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
#: tests/test_fleet.py's three cities: N = 9, 8, 4, series of differing length
CITY_DIMS = ((3, 3), (2, 4), (2, 2))


def _datas(synthetic):
    return [synthetic(rows=r, cols=c, n_timesteps=24 * 7 * 2 + 12 * i, seed=i + 1)
            for i, (r, c) in enumerate(CITY_DIMS)]


@pytest.fixture(scope="module")
def hetero_pair():
    return (JaxHetero(_datas(jax_synthetic), JaxWindowSpec(3, 1, 1, 24)),
            HeteroCityDataset(_datas(synthetic_dataset), WindowSpec(3, 1, 1, 24)))


# -- the dataset ------------------------------------------------------------

def test_structure_equals_jax(hetero_pair):
    jds, pds = hetero_pair
    assert pds.heterogeneous and not pds.shared_graphs and pds.normalizer is None
    assert pds.n_cities == jds.n_cities == 3
    assert pds.city_n_nodes == jds.city_n_nodes == [9, 8, 4]
    assert (pds.n_feats, pds.n_samples, pds.nbytes, pds.resident_nbytes) == (
        jds.n_feats, jds.n_samples, jds.nbytes, jds.resident_nbytes)
    for c in range(3):
        assert pds.normalizers[c].to_dict() == jds.normalizers[c].to_dict()
        assert np.array_equal(pds.series(c), jds.series(c))
        assert vars(pds.cities[c].split) == vars(jds.cities[c].split)
        for key in jds.city_adjs[c]:
            np.testing.assert_array_equal(pds.city_adjs[c][key], jds.city_adjs[c][key])


@pytest.mark.parametrize("mode", ["train", "validate", "test"])
def test_windows_targets_and_sizes_equal_jax(hetero_pair, mode):
    jds, pds = hetero_pair
    assert pds.mode_size(mode) == jds.mode_size(mode)
    assert pds.num_batches(mode, 8) == jds.num_batches(mode, 8)
    for c in range(3):
        np.testing.assert_array_equal(pds.mode_targets(mode, c), jds.mode_targets(mode, c))
        for got, want in zip(pds.city_arrays(mode, c), jds.city_arrays(mode, c)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        raw = pds.city_arrays(mode, c)[1]
        np.testing.assert_array_equal(pds.denormalize(raw, city=c), jds.denormalize(raw, city=c))


@pytest.mark.parametrize("shuffle,epoch,pad_last", [
    (False, 0, True), (True, 0, True), (True, 3, False), (True, 1, True),
])
def test_batch_order_equals_jax(hetero_pair, shuffle, epoch, pad_last):
    jds, pds = hetero_pair
    kw = dict(shuffle=shuffle, seed=5, epoch=epoch, pad_last=pad_last)
    got = list(pds.batches("train", 8, with_arrays=False, **kw))
    want = list(jds.batches("train", 8, with_arrays=False, **kw))
    assert [(b.city, b.n_real) for b in got] == [(b.city, b.n_real) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
    for g, w in zip(pds.batches("validate", 8, **kw), jds.batches("validate", 8, **kw)):
        assert g.city == w.city
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)


def test_dataset_refusals_match_jax(hetero_pair):
    _, pds = hetero_pair
    for call, match in ((lambda: pds.n_nodes, "city_n_nodes"),
                        (lambda: pds.arrays("train"), "city_arrays"),
                        (lambda: pds.denormalize(np.zeros(3)), "city=")):
        with pytest.raises(ValueError, match=match):
            call()
    datas = _datas(synthetic_dataset)
    with pytest.raises(ValueError, match="one SplitSpec"):
        HeteroCityDataset(datas, WindowSpec(3, 1, 1, 24), splits=[None])
    with pytest.raises(ValueError, match="at least one city"):
        HeteroCityDataset([], WindowSpec(3, 1, 1, 24))


# -- the planner --------------------------------------------------------------

@pytest.mark.parametrize("sizes,kwargs", [
    ([9, 8, 4], {}),
    ([10, 9], dict(max_classes=1, max_pad_waste=0.0)),
    ([144, 100], dict(max_classes=1, max_pad_waste=44 / 144)),
    ([144, 100], dict(max_classes=1, max_pad_waste=44 / 144 - 1e-9)),
    ([10], dict(node_multiple=8)),
    ([144, 100, 1024, 960, 896, 81, 36, 400], {}),
    ([1024, 960, 896], dict(max_classes=2, max_pad_waste=0.05)),
])
def test_planner_equals_jax(sizes, kwargs):
    got, want = plan_shape_classes(sizes, **kwargs), jax_plan(sizes, **kwargs)
    assert got.unassigned == want.unassigned
    assert [dataclasses.astuple(c) for c in got.classes] == [
        dataclasses.astuple(c) for c in want.classes]
    assert got.class_of == want.class_of and got.slot_of == want.slot_of
    assert [got.pad_for(c) for c in range(len(sizes))] == [
        want.pad_for(c) for c in range(len(sizes))]
    assert got.node_waste == want.node_waste


def test_planner_properties_and_validation():
    plan = plan_shape_classes([9, 8, 4])
    assert [(c.n_nodes, c.cities) for c in plan.classes] == [(4, (2,)), (9, (0, 1))]
    assert plan.pad_for(1) == 1 and plan.pad_for(0) == 0
    cls = ShapeClass(n_nodes=10, cities=(0, 1), city_n_nodes=(10, 8), nnz=100,
                     city_nnz=(100, 64))
    assert cls.node_waste == pytest.approx(0.2) and cls.nnz_waste == pytest.approx(0.36)
    assert FleetPlan(classes=(cls,), unassigned=()).node_waste == pytest.approx(0.2)
    for kwargs, match in ((dict(max_classes=0), "max_classes"),
                          (dict(max_pad_waste=1.0), "max_pad_waste"),
                          (dict(max_pad_waste=-0.1), "max_pad_waste"),
                          (dict(city_nnz=[16]), "align")):
        with pytest.raises(ValueError, match=match):
            plan_shape_classes([4, 9], **kwargs)
    with pytest.raises(ValueError, match="positive"):
        plan_shape_classes([4, 0])


# -- config, presets and the experiment functions ----------------------------

@pytest.mark.parametrize("name", ["multicity", "longhorizon"])
def test_preset_equals_jax(name):
    jcfg, pcfg = jax_preset(name), preset(name)
    assert ExperimentConfig.from_dict(jcfg.to_dict()) == pcfg
    jd, pd = jcfg.to_dict(), pcfg.to_dict()
    for section, fields in pd.items():
        if section == "name":
            assert fields == jd["name"]
            continue
        for key, value in fields.items():
            want = jd[section][key]
            assert value == (tuple(want) if isinstance(value, tuple) else want), (section, key)


def _hetero_cfg(**model):
    cfg = preset("multicity")
    cfg.mesh = MeshConfig()
    cfg.data.city_rows, cfg.data.cols = (3, 2), 3
    cfg.data.city_timesteps = (24 * 7 + 60, 24 * 7 + 40)
    cfg.model.tile_size = 4
    for key, value in model.items():
        setattr(cfg.model, key, value)
    return cfg


def _jax_cfg(cfg):
    from stmgcn_tpu.config import ExperimentConfig as JaxExperimentConfig

    jcfg = JaxExperimentConfig.from_dict(jax_preset("multicity").to_dict())
    jcfg.mesh.dp = 1
    for section in ("data", "model"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    return jcfg


def test_build_dataset_is_hetero_and_equals_jax():
    cfg = _hetero_cfg()
    pds, jds = build_dataset(cfg), jax_build_dataset(_jax_cfg(cfg))
    assert isinstance(pds, HeteroCityDataset) and pds.city_n_nodes == [9, 6]
    for c in range(2):
        assert vars(pds.cities[c].split) == vars(jds.cities[c].split)
        np.testing.assert_array_equal(pds.series(c), jds.series(c))
    same_shape = _hetero_cfg()
    same_shape.data.city_rows, same_shape.data.city_timesteps = None, None
    assert not build_dataset(same_shape).heterogeneous
    same_shape.data.hetero = True  # forces per-city treatment at one shape
    assert build_dataset(same_shape).heterogeneous


@pytest.mark.parametrize("edit,match", [
    (dict(city_rows=(3,)), "city_rows must list one value per city"),
    (dict(city_timesteps=(400, 400, 400)), "city_timesteps must list"),
    (dict(shared_graphs=True), "shared_graphs needs cities with one region count"),
])
def test_build_dataset_refusals_match_jax(edit, match):
    cfg = _hetero_cfg()
    for key, value in edit.items():
        setattr(cfg.data, key, value)
    for build, c in ((build_dataset, cfg), (jax_build_dataset, _jax_cfg(cfg))):
        with pytest.raises(ValueError, match=match):
            build(c)


@pytest.mark.parametrize("mode", ["dense", "sparse", "tiled"])
def test_build_supports_per_city_equals_jax(mode):
    cfg = _hetero_cfg(**({mode: True} if mode != "dense" else {}))
    got = build_supports(cfg, build_dataset(cfg))
    jcfg = _jax_cfg(cfg)
    want = jax_build_supports(jcfg, jax_build_dataset(jcfg))
    assert isinstance(got, CitySupports) and len(got) == len(want.per_city) == 2
    for c in range(2):
        g, w = got.for_city(c), want.for_city(c)
        if mode == "dense":
            assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))
        elif mode == "sparse":
            assert all(isinstance(s, BlockSparseStack) for s in g)
            for gs, ws in zip(g, w):
                np.testing.assert_array_equal(gs.data.numpy(), np.asarray(ws.data))
                np.testing.assert_array_equal(gs.idx.numpy(), np.asarray(ws.idx))
        else:
            assert isinstance(g, TiledSupports)
            for key in ("perm", "inv", "data", "idx", "data_t", "idx_t"):
                np.testing.assert_array_equal(getattr(g, key).numpy(),
                                              np.asarray(getattr(w, key)))
    placed = got.to("cpu")
    assert isinstance(placed, CitySupports) and len(placed) == 2


# -- the gate's traced real-node count ------------------------------------------

K, T, B, C = 3, 5, 3, 1


def _gate_case(n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    supports = (rng.normal(size=(K, n_nodes, n_nodes)) * 0.3).astype(np.float32)
    obs = rng.uniform(size=(B, T, n_nodes, C)).astype(np.float32)
    jmod = JaxContextualGate(n_supports=K, seq_len=T)
    params = jmod.init(jax.random.key(seed), jnp.asarray(supports), jnp.asarray(obs))
    gate = ContextualGate(K, T, device="cpu")
    gate.load_state_dict(_state(params["params"]))
    return jmod, params, gate, supports, obs


def _port_gate_grads(gate, supports, obs, n_real, cot):
    x = torch.from_numpy(obs).requires_grad_(True)
    out = gate(torch.from_numpy(supports), x, n_real)
    (out * torch.from_numpy(cot)).sum().backward()
    return out, x.grad, {k: p.grad for k, p in gate.named_parameters()}


@pytest.mark.parametrize("n_real", [9, 6])
def test_gate_n_real_arms_match_jax(n_real):
    """n_real == N takes the plain mean, n_real < N the masked sum over the
    real rows; outputs and gradients as the JAX gate's."""
    jmod, params, gate, supports, obs = _gate_case(9)
    cot = np.random.default_rng(7).normal(size=obs.shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jmod.apply(p, jnp.asarray(supports), x, jnp.int32(n_real)) * cot)

    want = jmod.apply(params, jnp.asarray(supports), jnp.asarray(obs), jnp.int32(n_real))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(obs))
    out, gx, gp = _port_gate_grads(gate, supports, obs, torch.tensor(n_real), cot)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD)
    for name, value in _state(jgp["params"]).items():
        np.testing.assert_allclose(gp[name].numpy(), value.numpy(), **GRAD, err_msg=name)
    if n_real == 9:  # the exact fit is the unpadded gate, bit for bit
        plain = gate(torch.from_numpy(supports), torch.from_numpy(obs))
        assert torch.equal(out, plain)


def test_gate_per_row_counts_match_jax_row_by_row():
    jmod, params, gate, supports, obs = _gate_case(9, seed=1)
    counts = [9, 5, 7]
    got = gate(torch.from_numpy(supports), torch.from_numpy(obs),
               torch.tensor(counts, dtype=torch.int32))
    for b, n in enumerate(counts):
        want = jmod.apply(params, jnp.asarray(supports), jnp.asarray(obs[b:b + 1]),
                          jnp.int32(n))
        np.testing.assert_allclose(got[b:b + 1].detach().numpy(), np.asarray(want), **FWD)


def test_gate_padded_rows_stay_out_of_output_and_gradient():
    """Zero-padded nodes (zero supports and inputs) change nothing real; a
    non-finite value in a padded row of the pooled features (put there by
    a hook on the gate's conv) reaches neither the gate nor any gradient:
    the masked arm excludes the row, and the unchosen mean arm's gradient
    is zero."""
    _, _, gate, supports, obs = _gate_case(6, seed=2)
    pad_sup = np.zeros((K, 9, 9), np.float32)
    pad_sup[:, :6, :6] = supports
    pad_obs = np.zeros((B, T, 9, C), np.float32)
    pad_obs[:, :, :6] = obs
    cot = np.random.default_rng(3).normal(size=pad_obs.shape).astype(np.float32)
    cot[:, :, 6:] = 0.0
    ref, ref_gx, ref_gp = _port_gate_grads(gate, supports, obs, None, cot[:, :, :6])

    def poison(module, args, out):
        out = out.clone()
        out[..., 7, :] = float("inf")
        out[..., 8, :] = float("nan")
        return out

    for hooked in (False, True):
        gate.zero_grad()
        handle = gate.temporal_gconv.register_forward_hook(poison) if hooked else None
        out, gx, gp = _port_gate_grads(gate, pad_sup, pad_obs, torch.tensor(6), cot)
        if handle is not None:
            handle.remove()
        np.testing.assert_allclose(out[:, :, :6].detach().numpy(), ref.detach().numpy(), **FWD)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(gx[:, :, :6].numpy(), ref_gx.numpy(), **GRAD)
        assert torch.isfinite(gx).all()
        for name, value in ref_gp.items():
            assert torch.isfinite(gp[name]).all(), name
            np.testing.assert_allclose(gp[name].numpy(), value.numpy(), **GRAD, err_msg=name)
    gate.zero_grad()


# -- the long-horizon preset -------------------------------------------------

def test_longhorizon_forward_and_backward_match_jax():
    """The ``longhorizon`` shape (T = 26, horizon 24) at narrow widths:
    ``remat`` is the JAX model's and changes nothing in the port."""
    cfg = preset("longhorizon")
    assert cfg.model.remat and cfg.data.seq_len == 26 and cfg.data.horizon == 24
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 2
    rng = np.random.default_rng(0)
    n = 9
    supports = (rng.normal(size=(3, cfg.model.n_supports, n, n)) * 0.3).astype(np.float32)
    obs = rng.uniform(size=(2, cfg.data.seq_len, n, 1)).astype(np.float32)
    jmod = JaxSTMGCN(m_graphs=3, n_supports=cfg.model.n_supports, seq_len=26, input_dim=1,
                     horizon=24, lstm_hidden_dim=8, lstm_num_layers=2, gcn_hidden_dim=8,
                     remat=True)
    params = jmod.init(jax.random.key(0), jnp.asarray(supports), jnp.asarray(obs))
    want = jmod.apply(params, jnp.asarray(supports), jnp.asarray(obs))
    cot = rng.normal(size=want.shape).astype(np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(jmod.apply(p, jnp.asarray(supports),
                                                  jnp.asarray(obs)) * cot))(params)
    model = build_model(cfg, 1, device="cpu")
    assert isinstance(model, STMGCN)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), 3))
    got = model(torch.from_numpy(supports), torch.from_numpy(obs))
    assert got.shape == want.shape == (2, 24, n, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    (got * torch.from_numpy(cot)).sum().backward()
    grads = from_jax_params(jax.tree.map(np.asarray, jgrad), 3)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **GRAD, err_msg=name)


def test_per_city_graphs_on_a_homogeneous_dataset_train_as_jax(tmp_path):
    """Same-shape cities with their own graphs: a ``DemandDataset`` with a
    ``CitySupports``, each city's batches against its own supports and its
    own slice of the series, one epoch against the JAX trainer (losses rtol
    2e-5, parameters atol 2e-5, as ``tests/test_torch_tiling.py``'s)."""
    from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
    from stmgcn_tpu_torch import build_trainer

    jcfg = jax_preset("default")  # the transit and similarity graphs differ per city
    jcfg.data.rows, jcfg.data.n_timesteps, jcfg.data.n_cities = 3, 24 * 7 + 60, 2
    jcfg.model.lstm_hidden_dim = jcfg.model.gcn_hidden_dim = 8
    jcfg.model.lstm_num_layers = 1
    jcfg.train.epochs, jcfg.train.batch_size, jcfg.train.shuffle = 1, 8, True
    jcfg.train.steps_per_superstep, jcfg.train.out_dir = 2, str(tmp_path / "jax")
    d = jcfg.to_dict()
    d["train"]["out_dir"] = str(tmp_path / "port")
    jt = jax_build_trainer(jcfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    jax_hist = jt.train()
    pt = build_trainer(ExperimentConfig.from_dict(d), device="cpu", initial_state=init,
                       verbose=False)
    assert isinstance(pt.supports, CitySupports) and not pt.hetero
    assert pt.train_path == "per_step" and "CitySupports" in pt.fallback_reason
    hist = pt.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(hist[mode], jax_hist[mode], rtol=2e-5)
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    for name, value in pt.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)
