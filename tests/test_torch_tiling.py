"""The port's tiled plan, block-sparse and tiled convolutions, models and
entry points against the JAX package's.

- Host plan: ``rcm_permutation`` and ``plan_tiling`` (``perm``, ``inv`` and
  the four block arrays) array-equal to the JAX ones on scrambled grids
  with noise, at tiles 4 and 8; ``tile_stats`` equal. The counts of real
  slots (``nblk``, ``nblk_t``) at the kernel tiles 64 and 128 on a ragged
  N: they mark each block row's nonzero slots, survive ``as_stack``,
  ``plan[m]`` and ``.to``, and the plain versions agree on the plan cut to
  them.
- Ops: the gathered-tiles apply, ``SparseChebGraphConv`` (stack and K-tuple
  forms) and ``TiledChebGraphConv`` (one branch; all branches in one call)
  against the JAX layers with the same parameters: forward rtol/atol 1e-5,
  gradients 2e-4, as ``tests/test_tiling.py`` holds the JAX layers.
- Models: a tiled and a block-sparse ``STMGCN`` (``smoke`` and ``default``
  widths at a small grid) against JAX ``model.apply`` / ``jax.grad`` on the
  looped layout, weights through ``from_jax_params``: outputs 1e-5 (as
  ``tests/test_torch_model.py``), gradients rtol 1e-4 / atol 1e-6 (as
  ``tests/test_torch_train.py``).
- Entry points: ``build_supports``/``build_model`` routing and refusals,
  a JAX config dict keeping ``tile_size``, two tiled ``smoke`` epochs
  against the JAX ``Trainer``, the engine on a plan against
  ``Forecaster.predict``, and ``chip_smoke.py``'s metro-city copy against
  ``bench.py``'s builder.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.ops.chebconv import SparseChebGraphConv as JaxSparseConv
from stmgcn_tpu.ops.chebconv import TiledChebGraphConv as JaxTiledConv
from stmgcn_tpu.ops.spmm import from_dense as jax_from_dense
from stmgcn_tpu.ops.spmm import stack_from_dense as jax_stack_from_dense
from stmgcn_tpu.ops.tiling import gathered_tiles_apply as jax_gathered_tiles_apply
from stmgcn_tpu.ops.tiling import plan_tiling as jax_plan_tiling
from stmgcn_tpu.ops.tiling import rcm_permutation as jax_rcm_permutation
from stmgcn_tpu_torch import (
    ExperimentConfig,
    Forecaster,
    ServingConfig,
    ServingEngine,
    build_trainer,
    from_jax_params,
    preset,
)
from stmgcn_tpu_torch.data import DemandDataset, WindowSpec, grid_adjacency
from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
from stmgcn_tpu_torch.models import STMGCN
from stmgcn_tpu_torch.ops import SupportConfig
from stmgcn_tpu_torch.ops.chebconv import (
    BandedChebGraphConv,
    ChebGraphConv,
    SparseChebGraphConv,
    TiledChebGraphConv,
    conv_cls,
)
from stmgcn_tpu_torch.ops.spmm import (
    KERNEL_TILES,
    BlockSparseStack,
    from_dense,
    spmm_reference,
    spmm_stack_bwd_reference,
    spmm_stack_reference,
    stack_from_dense,
)
from stmgcn_tpu_torch.ops.tiling import (
    TiledSupports,
    gathered_tiles_apply,
    plan_tiling,
    rcm_permutation,
)
from test_torch_spmm import check_counts, truncated

torch.set_num_threads(1)

M, TILE = 3, 8
FWD, GRAD = dict(rtol=1e-5, atol=1e-5), dict(rtol=2e-4, atol=2e-4)


def scrambled_supports(side=8, m_graphs=M, order=2, seed=0, noise=0.0):
    """Dense Chebyshev supports over M scrambled grids (the JAX tests'
    fixture): the scramble destroys the grid's banded order, which the
    reorder must recover; ``noise`` adds uniform random links."""
    rng = np.random.default_rng(seed)
    n = side * side
    shuffle = rng.permutation(n)
    adjs = []
    for _ in range(m_graphs):
        a = grid_adjacency(side)
        extra = (rng.random((n, n)) < noise).astype(np.float32)
        a = np.maximum(a, np.maximum(extra, extra.T))
        np.fill_diagonal(a, 0)
        adjs.append(a[shuffle][:, shuffle])
    return SupportConfig("chebyshev", order).build_all(adjs)


def signal(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _params(tree) -> dict:
    """A flax conv's params as the port conv's state_dict."""
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


# -- the host plan ---------------------------------------------------------

@pytest.mark.parametrize("side,noise", [(8, 0.0), (10, 0.02)])
def test_rcm_permutation_equals_jax(side, noise):
    pattern = np.any(scrambled_supports(side, noise=noise) != 0.0, axis=(0, 1))
    got, want = rcm_permutation(pattern), jax_rcm_permutation(pattern)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side,tile,noise,order", [
    (8, 8, 0.01, 2), (8, 4, 0.0, 2), (9, 8, 0.02, 1), (12, 8, 0.0, 2),
])
def test_plan_tiling_equals_jax(side, tile, noise, order):
    dense = scrambled_supports(side, noise=noise, order=order)
    got, want = plan_tiling(dense, tile), jax_plan_tiling(dense, tile)
    for name in ("perm", "inv", "data", "idx", "data_t", "idx_t"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.n, got.tile, got.m_graphs, got.n_supports, got.block_rows, got.block_cols,
            len(got)) == (want.n, want.tile, want.m_graphs, want.n_supports, want.block_rows,
                          want.block_cols, len(want))
    assert got.tile_stats() == want.tile_stats()
    assert got.nbytes == want.nbytes


def test_plan_validation_and_branch_views():
    with pytest.raises(ValueError, match="dense"):
        plan_tiling(np.zeros((2, 3, 4)), tile=TILE)
    with pytest.raises(ValueError, match="tile"):
        plan_tiling(scrambled_supports(), tile=0)
    plan = plan_tiling(scrambled_supports(), tile=TILE)
    with pytest.raises(TypeError, match="int"):
        plan[0:1]
    branch = plan[1]
    assert branch.n_supports == 3 and torch.equal(branch.data, plan.data[1])
    stack = plan.as_stack()
    assert stack.branches == M and stack.n_rows == stack.n_cols == plan.n


# -- ops -------------------------------------------------------------------

def test_gathered_tiles_apply_matches_jax():
    dense = scrambled_supports(noise=0.01)
    plan, ref = plan_tiling(dense, TILE), jax_plan_tiling(dense, TILE)
    x, cot = signal((dense.shape[-1], 6)), signal((3, dense.shape[-1], 6), seed=3)
    for m in range(M):
        want = jax_gathered_tiles_apply(ref[m], jnp.asarray(x))
        want_g = jax.grad(lambda xx: jnp.sum(jax_gathered_tiles_apply(ref[m], xx) * cot))(
            jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        got = gathered_tiles_apply(plan[m], xt)
        (got * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), **GRAD)


def _conv_grads(conv, supports, x, cot):
    conv.zero_grad(set_to_none=True)
    xt = torch.tensor(x, requires_grad=True)
    out = conv(supports, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), {n: p.grad.numpy() for n, p in
                                                    conv.named_parameters()}


def _jax_conv_grads(jconv, params, supports, x, cot):
    def loss(p, xx):
        return jnp.sum(jconv.apply(p, supports, xx) * cot)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    return (np.asarray(jconv.apply(params, supports, jnp.asarray(x))), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp["params"].items()})


def _assert_conv_match(got, want):
    np.testing.assert_allclose(got[0], want[0], **FWD)
    np.testing.assert_allclose(got[1], want[1], **GRAD)
    for name in want[2]:
        np.testing.assert_allclose(got[2][name], want[2][name], err_msg=name, **GRAD)


@pytest.mark.parametrize("form", ["stack", "ktuple"])
def test_sparse_conv_matches_jax(form):
    dense = scrambled_supports(side=6, m_graphs=1, noise=0.02)[0]  # (K, N, N)
    n = dense.shape[-1]
    x, cot = signal((2, n, 3)), signal((2, n, 5), seed=4)
    if form == "stack":
        jsup, sup = jax_stack_from_dense(dense, TILE), stack_from_dense(dense, TILE)
    else:
        jsup = tuple(jax_from_dense(d, TILE) for d in dense)
        sup = tuple(from_dense(d, TILE) for d in dense)
    jconv = JaxSparseConv(n_supports=3, features=5)
    params = jconv.init(jax.random.key(0), jsup, jnp.asarray(x))
    conv = SparseChebGraphConv(3, 3, 5, device="cpu")
    conv.load_state_dict(_params(params["params"]))
    _assert_conv_match(_conv_grads(conv, sup, x, cot),
                       _jax_conv_grads(jconv, params, jsup, x, cot))


@pytest.mark.parametrize("backend,order", [("xla", 2), ("xla", 1), ("pallas", 1)])
def test_tiled_conv_matches_jax(backend, order):
    side, tile = (8, TILE) if backend == "xla" else (4, 4)  # pallas: interpret mode, small
    dense = scrambled_supports(side=side, order=order, noise=0.01)
    plan, ref = plan_tiling(dense, tile), jax_plan_tiling(dense, tile)
    n, k = dense.shape[-1], order + 1
    x, cot = signal((2, n, 2)), signal((2, n, 5), seed=5)
    jconv = JaxTiledConv(n_supports=k, features=5, backend=backend)
    params = jconv.init(jax.random.key(1), ref[0], jnp.asarray(x))
    conv = TiledChebGraphConv(k, 2, 5, device="cpu")
    conv.load_state_dict(_params(params["params"]))
    for m in range(M):
        _assert_conv_match(_conv_grads(conv, plan[m], x, cot),
                           _jax_conv_grads(jconv, params, ref[m], x, cot))


@pytest.mark.parametrize("shared", [True, False])
def test_branch_stacked_tiled_conv_matches_jax_per_branch(shared):
    """The port's one call over every branch of the plan against the JAX
    conv applied branch by branch with each branch's parameters."""
    dense = scrambled_supports(noise=0.01)
    plan, ref = plan_tiling(dense, TILE), jax_plan_tiling(dense, TILE)
    n = dense.shape[-1]
    x = signal((2, n, 3) if shared else (M, 2, n, 3))
    jconv = JaxTiledConv(n_supports=3, features=4, backend="xla")
    params = [jconv.init(jax.random.key(m), ref[m], jnp.asarray(x if shared else x[m]))
              for m in range(M)]
    conv = TiledChebGraphConv(3, 3, 4, branches=M, device="cpu")
    conv.load_state_dict({k: torch.tensor(np.stack([np.asarray(p["params"][k]) for p in params]))
                          for k in ("W", "b")})
    got = conv(plan, torch.from_numpy(x)).detach().numpy()
    for m in range(M):
        want = jconv.apply(params[m], ref[m], jnp.asarray(x if shared else x[m]))
        np.testing.assert_allclose(got[m], np.asarray(want), **FWD)


def test_convs_share_one_parameter_layout_and_refuse_wrong_forms():
    dense = scrambled_supports()
    plan = plan_tiling(dense, TILE)
    x = torch.from_numpy(signal((2, dense.shape[-1], 3)))
    convs = [cls(3, 3, 4, branches=M, device="cpu", generator=torch.Generator().manual_seed(0))
             for cls in (ChebGraphConv, SparseChebGraphConv, TiledChebGraphConv)]
    assert all(c.state_dict().keys() == convs[0].state_dict().keys() for c in convs)
    stacks = tuple(stack_from_dense(dense[m], TILE) for m in range(M))
    want = convs[0](torch.from_numpy(dense), x)
    for conv, sup in ((convs[1], stacks), (convs[2], plan)):
        np.testing.assert_allclose(conv(sup, x).detach().numpy(), want.detach().numpy(), **FWD)
    with pytest.raises(TypeError, match="TiledSupports"):
        convs[2](plan[0], x)
    with pytest.raises(ValueError, match="per-branch support groups"):
        convs[1](stacks[:2], x)
    assert conv_cls("banded") is BandedChebGraphConv
    with pytest.raises(ValueError, match="support mode must be one of"):
        conv_cls("ring")
    assert conv_cls(True) is SparseChebGraphConv and conv_cls("tiled") is TiledChebGraphConv


# -- models ----------------------------------------------------------------

WIDTHS = {
    "smoke": dict(m_graphs=1, lstm_hidden_dim=32, lstm_num_layers=1, gcn_hidden_dim=32),
    "default": dict(m_graphs=3, lstm_hidden_dim=64, lstm_num_layers=3, gcn_hidden_dim=64),
}
T, B = 5, 2


def _model_case(width, mode, seed=0):
    """JAX and port models in support ``mode`` on one scrambled 5x5 city,
    the same converted weights; returns both outputs and gradients."""
    kw = dict(WIDTHS[width], n_supports=3, seq_len=T, input_dim=1)
    m = kw["m_graphs"]
    dense = scrambled_supports(side=5, m_graphs=m, noise=0.02, seed=seed)
    n = dense.shape[-1]
    obs, cot = signal((B, T, n, 1), seed=6), signal((B, n, 1), seed=7)
    if mode == "tiled":
        jsup, sup = jax_plan_tiling(dense, TILE), plan_tiling(dense, TILE)
        jmod = JaxSTMGCN(**kw, support_modes=("tiled",) * m)
        port_kw = dict(support_modes=("tiled",) * m)
    else:
        jsup = tuple(jax_stack_from_dense(dense[i], TILE) for i in range(m))
        sup = tuple(stack_from_dense(dense[i], TILE) for i in range(m))
        jmod = JaxSTMGCN(**kw, sparse=True)
        port_kw = dict(sparse=True)
    params = jmod.init(jax.random.key(seed), jsup, jnp.asarray(obs))
    want = np.asarray(jmod.apply(params, jsup, jnp.asarray(obs)))
    want_g = jax.grad(lambda p: jnp.sum(jmod.apply(p, jsup, jnp.asarray(obs)) * cot))(params)
    model = STMGCN(**kw, **port_kw, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), m))
    return model, sup, obs, cot, want, from_jax_params(jax.tree.map(np.asarray, want_g), m)


def _model_grads(model, sup, obs, cot):
    model.zero_grad(set_to_none=True)
    out = model(sup, torch.from_numpy(obs))
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("width", ["smoke", "default"])
@pytest.mark.parametrize("mode", ["tiled", "sparse"])
def test_model_matches_jax_apply_and_grad(width, mode):
    model, sup, obs, cot, want, want_g = _model_case(width, mode)
    got, grads = _model_grads(model, sup, obs, cot)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert sorted(grads) == sorted(want_g)
    for name, g in grads.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_kernel_route_gives_every_tiled_parameter_a_gradient(monkeypatch):
    """The block kernels return tensors without autograd history, imitated
    here by detaching B3's plain forward: every parameter of a tiled
    ``STMGCN`` (the LSTM and the gate upstream of the graph conv included)
    still gets its gradient, because the route goes through
    ``BlockCSRApply``."""
    spmm_mod = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
    plain = spmm_mod.stack_forward
    monkeypatch.setattr(spmm_mod, "stack_forward", lambda *a: plain(*a).detach())
    model, sup, obs, cot, _, want_g = _model_case("default", "tiled", seed=1)
    _, grads = _model_grads(model, sup, obs, cot)
    assert not [name for name, g in grads.items() if g is None]
    for name, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().sum() > 0, name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_model_checks_its_support_form():
    kw = dict(m_graphs=3, n_supports=3, seq_len=T, input_dim=1, lstm_hidden_dim=8,
              lstm_num_layers=1, gcn_hidden_dim=8, device="cpu")
    dense = scrambled_supports(side=4)
    plan = plan_tiling(dense, 4)
    with pytest.raises(ValueError, match="model.tiled=True"):
        STMGCN(**kw)(plan, torch.zeros(1, T, 16, 1))
    with pytest.raises(ValueError, match="TiledSupports"):
        STMGCN(**kw, support_modes=("tiled",) * 3)(torch.from_numpy(dense), torch.zeros(1, T, 16, 1))
    with pytest.raises(ValueError, match="mixed"):
        STMGCN(**kw, support_modes=("tiled", "dense", "dense"))
    with pytest.raises(ValueError, match="not both"):
        STMGCN(**kw, sparse=True, support_modes=("sparse",) * 3)


# -- entry points ----------------------------------------------------------

def _port_cfg(**model_kw):
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 5, 24 * 7 + 80
    cfg.model.tile_size = TILE
    for k, v in model_kw.items():
        setattr(cfg.model, k, v)
    return cfg


def test_build_supports_and_build_model_route_each_mode():
    cfg = _port_cfg()
    ds = build_dataset(cfg)
    assert isinstance(build_supports(cfg, ds), np.ndarray)
    cfg.model.tiled = True
    plan = build_supports(cfg, ds)
    assert isinstance(plan, TiledSupports) and plan.tile == TILE
    assert build_model(cfg, ds.n_feats, device="cpu").support_mode == "tiled"
    cfg.model.tiled, cfg.model.sparse = False, True
    stacks = build_supports(cfg, ds)
    assert isinstance(stacks, tuple) and all(isinstance(s, BlockSparseStack) for s in stacks)
    assert build_model(cfg, ds.n_feats, device="cpu").support_mode == "sparse"


@pytest.mark.parametrize("edit,match", [
    (dict(sparse=True), "mutually exclusive"),
    (dict(tile_waste_budget=1e-9), "tile_waste_budget"),
])
def test_build_supports_refusals_match_jax(edit, match):
    cfg = _port_cfg(tiled=True, **edit)
    with pytest.raises(ValueError, match=match):
        build_supports(cfg, build_dataset(cfg))


def test_tiled_with_a_mesh_is_refused():
    cfg = _port_cfg(tiled=True)
    cfg.mesh.dp = 2
    with pytest.raises(ValueError, match="does not compose"):
        build_supports(cfg, build_dataset(cfg))
    with pytest.raises(ValueError, match="does not compose"):
        build_model(cfg, 1, device="cpu")


def test_jax_config_dict_keeps_its_tile_fields():
    d = jax_preset("smoke").to_dict()
    d["model"].update(tiled=True, tile_size=8, tile_waste_budget=0.5)
    cfg = ExperimentConfig.from_dict(d)
    assert (cfg.model.tiled, cfg.model.tile_size, cfg.model.tile_waste_budget) == (True, 8, 0.5)
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg


def test_tiled_trainer_matches_jax_trainer(tmp_path):
    jax_cfg = jax_preset("smoke")
    jax_cfg.data.rows, jax_cfg.data.n_timesteps = 5, 24 * 7 + 80
    jax_cfg.model.tiled, jax_cfg.model.tile_size = True, TILE
    jax_cfg.train.epochs, jax_cfg.train.batch_size, jax_cfg.train.shuffle = 2, 16, True
    jax_cfg.train.out_dir = str(tmp_path)
    d = jax_cfg.to_dict()
    d["train"]["out_dir"] = str(tmp_path / "port")  # its own checkpoints
    cfg = ExperimentConfig.from_dict(d)
    jax_trainer = jax_build_trainer(jax_cfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jax_trainer.params), 1)
    jax_history = jax_trainer.train()
    trainer = build_trainer(cfg, device="cpu", initial_state=init, verbose=False)
    assert isinstance(trainer.supports, TiledSupports)
    history = trainer.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(history[mode], jax_history[mode], rtol=2e-5)
    want = from_jax_params(jax.tree.map(np.asarray, jax_trainer.params), 1)
    for name, value in trainer.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


@pytest.fixture(scope="module")
def tiled_serving():
    """A default-width (shrunk) model on a 4x6 city's plan, the same weights
    in a dense model, and raw-unit history windows."""
    cfg = preset("default")
    cfg.data.rows, cfg.data.cols, cfg.data.n_timesteps = 4, 6, 24 * 7 * 2 + 60
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers, cfg.model.tiled, cfg.model.tile_size = 2, True, TILE
    ds = build_dataset(cfg)
    plan = build_supports(cfg, ds)
    model = build_model(cfg, ds.n_feats, device="cpu")
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    fc = Forecaster(model, model.state_dict(), ds.normalizer, cfg, derived, device="cpu")
    cfg.model.tiled = False
    dense_fc = Forecaster(build_model(cfg, ds.n_feats, device="cpu"), model.state_dict(),
                          ds.normalizer, cfg, derived, device="cpu")
    return fc, dense_fc, plan, build_supports(cfg, ds), ds.denormalize(ds.arrays("train")[0])


def test_engine_on_a_plan_matches_forecaster_at_every_size(tiled_serving):
    fc, dense_fc, plan, dense, history = tiled_serving
    ladder = ServingConfig(buckets=(1, 4, 16), max_batch=16, max_delay_ms=5.0)
    with ServingEngine.from_forecaster(fc, plan, config=ladder, device="cpu") as engine:
        for n in (1, 3, 16, 40):
            want = fc.predict(plan, history[:n])
            for got in (engine.predict(history[:n]), engine.predict_direct(history[:n])):
                assert got.shape == want.shape and np.isfinite(got).all()
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        gen = engine.swap_params(fc.model.state_dict())
        assert engine.predict(history[:2], with_generation=True)[1] == gen == 1
    # dense-trained weights serve on the plan unchanged
    np.testing.assert_allclose(fc.predict(plan, history[:5]), dense_fc.predict(dense, history[:5]),
                               rtol=1e-5, atol=1e-4)


def test_engine_checks_the_plan_against_the_model(tiled_serving):
    fc, dense_fc, plan, dense, _ = tiled_serving
    with pytest.raises(ValueError, match="tiled supports must plan"):
        ServingEngine.from_forecaster(fc, plan_tiling(dense[:2], TILE), device="cpu")
    with pytest.raises(ValueError, match="model.tiled=True"):
        ServingEngine.from_forecaster(dense_fc, plan, device="cpu")


def test_chip_smoke_metro_city_equals_bench_largen_city():
    got = chip_smoke.metro_city(16, 32, 24 * 7 + 20, seed=1)
    want = bench._largen_city(16, 32, 24 * 7 + 20, seed=1)
    np.testing.assert_array_equal(got.demand, want.demand)
    assert list(got.adjs) == list(want.adjs)
    for key in want.adjs:
        np.testing.assert_array_equal(got.adjs[key], want.adjs[key], err_msg=key)
    ds = DemandDataset(got, WindowSpec(3, 1, 1, 24))
    assert ds.n_nodes == 512


@pytest.mark.parametrize("n, tile", [(300, 64), (257, 128)])
def test_chip_smoke_ktuples_cut_from_stacks_equal_from_dense(n, tile):
    """``chip_smoke.py``'s metro K-tuples are cut from the per-branch stacks
    instead of scanned again: each support's arrays equal ``from_dense``'s."""
    from stmgcn_tpu_torch.ops.spmm import from_dense, stack_from_dense

    rng = np.random.default_rng(n)
    mats = ((rng.random((3, n, n)) < 0.01) * rng.standard_normal((3, n, n))).astype(np.float32)
    mats[2] = 0.0
    mats[2, :5, :5] = 1.0  # one support of a single block: widths differ per support
    for k, got in enumerate(chip_smoke.ktuple_of(stack_from_dense(mats, tile))):
        want = from_dense(mats[k], tile)
        assert (got.n, got.tile) == (want.n, want.tile)
        for f in ("data", "idx", "nblk", "data_t", "idx_t", "nblk_t"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (k, f)


# -- the counts of real slots ---------------------------------------------------

#: a ragged N (18 x 18 = 324) against both kernel tiles, with random links
COUNT_SIDE = 18


@pytest.mark.parametrize("tile", KERNEL_TILES)
def test_plan_counts_mark_the_real_slots(tile):
    plan = plan_tiling(scrambled_supports(COUNT_SIDE, noise=0.01), tile)
    stack = plan.as_stack()
    check_counts(plan.data, plan.idx, plan.nblk, stack.row_order)
    check_counts(plan.data_t, plan.idx_t, plan.nblk_t, stack.row_order_t)
    assert (plan.nblk < plan.block_cols).any()  # padding exists to skip
    assert plan.as_stack() is stack  # one operand per plan: its row order is derived once
    for got in (stack, plan.to("cpu")):
        assert all(torch.equal(getattr(got, k), getattr(plan, k)) for k in ("nblk", "nblk_t"))
    for m in range(M):
        branch = plan[m]
        check_counts(branch.data, branch.idx, branch.nblk, branch.as_stack().row_order)
        check_counts(branch.data_t, branch.idx_t, branch.nblk_t, branch.as_stack().row_order_t)
        assert torch.equal(branch.nblk, plan.nblk[m]) and torch.equal(branch.nblk_t, plan.nblk_t[m])
        for got in (branch.as_stack(), branch.to("cpu")):
            assert all(torch.equal(getattr(got, k), getattr(branch, k)) for k in ("nblk", "nblk_t"))
    assert plan.tile_stats()["blocks_kept"] == int((plan.data != 0).any(-1).any(-1).sum())


@pytest.mark.parametrize("tile", KERNEL_TILES)
def test_plan_plain_versions_equal_when_truncated_to_counts(tile):
    plan = plan_tiling(scrambled_supports(COUNT_SIDE, noise=0.01), tile)
    n, K, F = plan.n, plan.n_supports, 4
    L = M * K

    def flat(t):
        return t.reshape((L,) + tuple(t.shape[2:]))

    fwd = truncated(flat(plan.data), flat(plan.idx), flat(plan.nblk), n, tile)
    bwd = truncated(flat(plan.data_t), flat(plan.idx_t), flat(plan.nblk_t), n, tile)
    assert min(b.data.shape[1] for b in fwd) < plan.block_cols  # some support is cut
    x = torch.tensor(signal((M, n, F)))
    g = torch.tensor(signal((M, K, n, F), seed=5))
    full = spmm_stack_reference(plan.as_stack(), x)
    full_bwd = spmm_stack_bwd_reference(plan.as_stack(), g, shared=False)
    for m in range(M):
        for k in range(K):
            np.testing.assert_allclose(spmm_reference(fwd[m * K + k], x[m]).numpy(),
                                       full[m, k].numpy(), rtol=1e-6, atol=1e-6)
        got = sum(spmm_reference(bwd[m * K + k], g[m, k]) for k in range(K))
        np.testing.assert_allclose(got.numpy(), full_bwd[m].numpy(), rtol=1e-6, atol=1e-5)


# -- fleet rung padding: grown plans ----------------------------------------------

#: a fleet class at rung 1,024 (32 x 32) at tile 128: an 896-node city
#: (28 x 32) grows by a block row, a 960-node one (30 x 32) inside its last
GROW_ROWS, GROW_COLS, GROW_RUNG, GROW_TILE = (28, 30), 32, 1024, 128


@pytest.fixture(scope="module", params=GROW_ROWS, ids=lambda r: f"n{r * GROW_COLS}")
def grown(request):
    """A city's dense supports (M = 2 graphs: rook and queen grids), its
    port and JAX plans, both grown to the rung and widened to twice their
    block columns."""
    rows = request.param
    adjs = [grid_adjacency(rows, GROW_COLS), grid_adjacency(rows, GROW_COLS, diagonal=True)]
    dense = SupportConfig("chebyshev", 2).build_all(adjs)
    plan, jplan = plan_tiling(dense, GROW_TILE), jax_plan_tiling(dense, GROW_TILE)
    c, c_t = 2 * plan.block_cols, 2 * plan.data_t.shape[3]
    return (plan, plan.pad_to(GROW_RUNG).with_block_cols(c, c_t),
            jplan.pad_to(GROW_RUNG).with_block_cols(c, c_t))


def test_grown_plan_equals_jax(grown):
    plan, big, jbig = grown
    crosses = plan.block_rows < GROW_RUNG // GROW_TILE
    assert big.n == jbig.n == GROW_RUNG and big.block_rows == GROW_RUNG // GROW_TILE
    for key in ("perm", "inv", "data", "idx", "data_t", "idx_t"):
        got, want = getattr(big, key).numpy(), np.asarray(getattr(jbig, key))
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    assert big.tile_stats() == jbig.tile_stats()
    assert big.tile_stats()["blocks_kept"] == plan.tile_stats()["blocks_kept"]
    # grown rows hold no real slot; widening leaves every count as it was
    r = plan.block_rows
    for counts, grown_counts in ((plan.nblk, big.nblk), (plan.nblk_t, big.nblk_t)):
        assert torch.equal(grown_counts[..., :r], counts)
        assert not grown_counts[..., r:].any() and (r < big.block_rows) == crosses
    stack = big.as_stack()
    check_counts(big.data, big.idx, big.nblk, stack.row_order)
    check_counts(big.data_t, big.idx_t, big.nblk_t, stack.row_order_t)
    assert big.pad_to(GROW_RUNG) is big
    with pytest.raises(ValueError, match="cannot shrink"):
        big.pad_to(GROW_RUNG - 1)
    with pytest.raises(ValueError, match="cannot narrow"):
        big.with_block_cols(plan.block_cols - 1, big.data_t.shape[3])


def test_plain_b3_b4_on_a_grown_plan(grown):
    """B3 and B4's plain versions on the grown plan: the real rows equal the
    ungrown plan's result (rtol/atol 1e-6: the same products, more zero
    slots), every padded node's row is zero, and a nonzero signal on the
    padded nodes changes nothing real."""
    plan, big, _ = grown
    n, F, L = plan.n, 12, plan.m_graphs * plan.n_supports
    x = torch.tensor(signal((plan.m_graphs, GROW_RUNG, F)))
    g = torch.tensor(signal((plan.m_graphs, plan.n_supports, GROW_RUNG, F), seed=4))
    fwd = spmm_stack_reference(big.as_stack(), x)
    np.testing.assert_allclose(fwd[..., :n, :].numpy(),
                               spmm_stack_reference(plan.as_stack(), x[:, :n]).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not fwd[..., n:, :].any()
    for shared in (False, True):
        dx = spmm_stack_bwd_reference(big.as_stack(), g, shared=shared)
        want = spmm_stack_bwd_reference(plan.as_stack(), g[..., :n, :].contiguous(),
                                        shared=shared)
        np.testing.assert_allclose(dx[..., :n, :].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
        assert not dx[..., n:, :].any()
    assert L * big.block_rows == big.as_stack().row_order.numel()
