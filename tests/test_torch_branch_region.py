"""The port's region x branch composition (``bandedbranch``: a dp x region
x branch mesh) against the JAX package: branch-stacked banded strips
(``parallel/banded.py`` ``branch_stack``) and block-CSR strips
(``parallel/sparse.py`` ``branch_stack_sparse``) cut on both mesh axes,
each branch group running its own region collectives.

Mirrors ``tests/test_branch_banded.py``. Ranks are processes of
``tests/_torch_rank_worker.py`` over gloo (one spawn of eight, several
scenarios); the JAX side runs in this process on the conftest's virtual
CPU devices.

- ``branch_stack`` gives JAX's strips at the common halo, bit for bit;
- ``route_supports`` on ``bandedbranch`` gives JAX's forms and modes on
  each route: the preset's synthetic graphs (``auto`` falls back to the
  dense plan; ``banded`` raises JAX's message), banded city adjacencies
  (branch-stacked strips), block-CSR supports (branch-stacked strips),
  and the model's ``branch_modes()`` equals JAX's ``build_model``'s;
- the layout: a mesh's branch-stacked model writes JAX's stacked
  (vmapped) tree, which a mesh-free rebuild reads, as
  ``TestRebuildLayout``;
- placement cuts every form on both axes;
- ``TestBranchStackedParity`` (M=2, K=3, N=16, B=8, T=5, LSTM 2 x 8, gcn 8)
  on 2x2x2 ranks for ``banded`` and ``sparse``: the forward against JAX's
  one-device model of the same weights (rtol 2e-5, atol 2e-5) and three
  steps' losses against JAX's (rtol 1e-5);
- the composed ``bandedbranch`` trained on 2x2x2 ranks on each route,
  ``branch_modes()`` and ``branch_stacked`` pinned, losses against the
  port's one-device twin (rtol 2e-5) and parameters (rtol 5e-4, atol
  2e-5), one step's collectives clean against the manifest, and the
  lead's ``best.ckpt`` served by both packages' ``Forecaster``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_rank_worker as ranks  # noqa: E402

from stmgcn_tpu.config import ExperimentConfig as JaxConfig  # noqa: E402
from stmgcn_tpu.experiment import build_model as jax_build_model  # noqa: E402
from stmgcn_tpu.experiment import route_supports as jax_route_supports  # noqa: E402
from stmgcn_tpu.models import STMGCN as JaxSTMGCN  # noqa: E402
from stmgcn_tpu.parallel import branch_stack as jax_branch_stack  # noqa: E402
from stmgcn_tpu.parallel.compose import _band_adj as jax_band_adj  # noqa: E402
from stmgcn_tpu.train import make_optimizer as jax_make_optimizer  # noqa: E402
from stmgcn_tpu.train import make_step_fns as jax_make_step_fns  # noqa: E402
from stmgcn_tpu_torch.config import MeshConfig  # noqa: E402
from stmgcn_tpu_torch.experiment import build_dataset, build_model, route_supports  # noqa: E402
from stmgcn_tpu_torch.models import STMGCN  # noqa: E402
from stmgcn_tpu_torch.models.params import from_jax_params, to_jax_params  # noqa: E402
from stmgcn_tpu_torch.parallel import (  # noqa: E402
    BandedSupports,
    MeshPlacement,
    ShardedBlockSparse,
    banded_dataset,
    banded_decompose,
    branch_stack,
    branch_stack_sparse,
    composed_config,
)
from stmgcn_tpu_torch.parallel.mesh import Mesh  # noqa: E402

torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=2e-5)
STEP_RTOL = 1e-5
LOSS_RTOL = 2e-5
PARAMS = dict(rtol=5e-4, atol=2e-5)
ROUTES = ("synthetic", "banded", "sparse")


def _fake_mesh(dp=1, region=1, branch=1, rank=0):
    coords = dict(zip(("dp", "region", "branch"),
                      (int(c) for c in np.unravel_index(rank, (dp, region, branch)))))
    return Mesh(dp, region, branch, rank, coords, {}, {}, "gloo", torch.device("cpu"))


def _band_supports(M, K, N, w, seed=0):
    """``test_branch_banded.py``'s M branches of K random band matrices."""
    rng = np.random.default_rng(seed)
    sup = np.zeros((M, K, N, N), np.float32)
    for m in range(M):
        for k in range(K):
            for d in range(-w, w + 1):
                sup[m, k] += np.diag(rng.normal(size=N - abs(d)).astype(np.float32) * 0.2, d)
    return sup


def _route_cfg(route):
    cfg = composed_config("bandedbranch")
    cfg.model.sparse = route == "sparse"
    return cfg


def _route_data(route, cfg):
    """The route's dataset in both packages: the preset's synthetic graphs,
    or the composed trainer's banded stand-ins."""
    from stmgcn_tpu.experiment import build_dataset as jax_build_dataset

    jds = jax_build_dataset(JaxConfig.from_dict(cfg.to_dict()))
    if route == "synthetic":
        return build_dataset(cfg), jds
    ds = banded_dataset(cfg)
    jds.adjs = {"g0": jax_band_adj(jds.n_nodes, 1, 1), "g1": jax_band_adj(jds.n_nodes, 2, 2)}
    return ds, jds


# -- host ---------------------------------------------------------------------------

def test_branch_stack_equals_jax_at_the_common_halo():
    sup = _band_supports(M=2, K=3, N=16, w=2)
    sup[1, 0] += np.diag(np.ones(16 - 4, np.float32), 4)  # branch 1 wider
    mine, theirs = branch_stack([sup[0], sup[1]], 2), jax_branch_stack([sup[0], sup[1]], 2)
    assert isinstance(mine, BandedSupports) and mine.branch_stacked
    assert mine.halo == theirs.halo == 4
    assert mine.strips.shape == (2, 2, 3, 8, 8 + 2 * 4)
    assert (mine.n_supports, mine.n_shards) == (3, 2)
    np.testing.assert_array_equal(mine.strips, np.asarray(theirs.strips))
    plain = banded_decompose(sup[0], 2)
    assert not plain.branch_stacked and (plain.n_supports, plain.n_shards) == (3, 2)


@pytest.mark.parametrize("route", ROUTES)
def test_routes_give_jax_forms_and_branch_modes(route):
    cfg = _route_cfg(route)
    ds, jds = _route_data(route, cfg)
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    sup, modes = route_supports(cfg, ds)
    jsup, jmodes = jax_route_supports(jcfg, jds)
    assert modes == jmodes == {"synthetic": None, "banded": ("banded",) * 2,
                               "sparse": ("sparse",) * 2}[route]
    if route == "synthetic":
        np.testing.assert_array_equal(sup, np.asarray(jsup))
    else:
        assert sup.branch_stacked and jsup.branch_stacked
        for f in ("strips",) if route == "banded" else ("data", "idx", "data_t", "idx_t"):
            np.testing.assert_array_equal(getattr(sup, f), np.asarray(getattr(jsup, f)), f)
    mine = build_model(cfg, ds.n_feats, device="cpu", support_modes=modes)
    theirs = jax_build_model(jcfg, jds.n_feats, support_modes=jmodes)
    assert mine.branch_modes() == theirs.branch_modes()
    # the stacked layout, which a branch mesh cuts
    assert not mine.loop_layout and theirs.vmap_branches


def test_banded_strategy_refuses_an_over_budget_branch_as_jax():
    cfg = _route_cfg("synthetic")
    cfg.mesh.region_strategy = "banded"
    ds, jds = _route_data("synthetic", cfg)
    msgs = []
    for fn, c, d in ((route_supports, cfg, ds),
                     (jax_route_supports, JaxConfig.from_dict(cfg.to_dict()), jds)):
        with pytest.raises(ValueError, match="every branch banded") as info:
            fn(c, d)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_sparse_branch_checkpoint_rebuilds_stacked():
    """``TestRebuildLayout``: a sparse ``branch > 1`` config trains in the
    stacked layout; its mesh-free rebuild (``Forecaster``'s call) is a
    dense stacked model of the same tree, in both packages."""
    cfg = _route_cfg("sparse")
    trained = build_model(cfg, 1, device="cpu", support_modes=("sparse", "sparse"))
    rebuilt = build_model(cfg, 1, device="cpu")
    assert rebuilt.support_mode == "dense" and not rebuilt.loop_layout
    assert trained.support_mode == "sparse" and not trained.loop_layout
    jax_rebuilt = jax_build_model(JaxConfig.from_dict(cfg.to_dict()), 1)
    assert jax_rebuilt.vmap_branches and not jax_rebuilt.sparse
    tree = to_jax_params(trained.state_dict(), 2, layout="vmapped")
    assert "branches" in tree["params"] and "branch_0" not in tree["params"]
    rebuilt.load_state_dict(from_jax_params(tree, 2))


def test_placement_cuts_every_form_on_both_axes():
    dense = _band_supports(2, 3, 16, 2)
    pl = MeshPlacement(_fake_mesh(2, 2, 2, rank=3))  # dp 0, region 1, branch 1
    np.testing.assert_array_equal(pl.put(dense, "supports"), dense[1:2, :, 8:16])
    strips = branch_stack(list(dense), 2)
    mine = pl.put(strips, "supports")
    assert mine.branch_stacked and mine.strips.shape == (1, 1, 3, 8, 8 + 2 * strips.halo)
    np.testing.assert_array_equal(mine.strips, strips.strips[1:2, 1:2])
    blocks = branch_stack_sparse(dense, 2, 8)
    mine = pl.put(blocks, "supports")
    assert isinstance(mine, ShardedBlockSparse) and mine.branches == 1 and mine.n_local == 8
    np.testing.assert_array_equal(mine.data, blocks.data[1:2, 1:2])
    state = {"branches.gcn.W": torch.arange(4.0).reshape(2, 2), "head.weight": torch.ones(1)}
    np.testing.assert_array_equal(pl.put(state, "state")["branches.gcn.W"], [[2.0, 3.0]])
    with pytest.raises(ValueError, match="m_graphs 3 not divisible by branch=2"):
        pl.check_divisibility(8, 16, m_graphs=3)


def test_model_refuses_mismatched_stacked_strips():
    strips = branch_stack(list(_band_supports(2, 3, 16, 2)), 1).to("cpu")
    kw = dict(m_graphs=2, n_supports=3, seq_len=5, input_dim=1, lstm_hidden_dim=4,
              lstm_num_layers=1, gcn_hidden_dim=4, device="cpu")
    x = torch.zeros(2, 5, 16, 1)
    with pytest.raises(ValueError, match="dense"):
        STMGCN(**kw, support_modes=("banded", "dense"))(strips, x)
    with pytest.raises(ValueError, match="per-branch support groups"):
        STMGCN(**{**kw, "m_graphs": 3}, support_modes=("banded",) * 3)(strips, x)
    one = STMGCN(**kw, support_modes=("banded",) * 2)
    assert one(strips, x).shape == (2, 16, 1)  # one device: the strips whole, zero halos


# -- the spawn -------------------------------------------------------------------------

def _parity_problem():
    """``TestBranchStackedParity``'s data for both modes."""
    rng = np.random.default_rng(0)
    M, K, N, B, T, w = 2, 3, 16, 8, 5, 2
    banded = _band_supports(M, K, N, w)
    sparse = ((rng.random((M, K, N, N)) < 0.3) * rng.normal(size=(M, K, N, N)) * 0.2
              ).astype(np.float32)
    x = rng.standard_normal((B, T, N, 1)).astype(np.float32)
    y = (rng.standard_normal((B, N, 1)) * 0.1).astype(np.float32)
    return {"banded": banded, "sparse": sparse}, x, y


def _jax_parity(dense, x, y):
    """JAX's one-device reference: the forward and three steps' losses."""
    kw = dict(m_graphs=2, n_supports=3, seq_len=5, input_dim=1, lstm_hidden_dim=8,
              lstm_num_layers=2, gcn_hidden_dim=8)
    ref = JaxSTMGCN(**kw)
    params = ref.init(jax.random.key(0), jnp.asarray(dense), jnp.asarray(x))
    want = np.asarray(ref.apply(params, jnp.asarray(dense), jnp.asarray(x)))
    fns = jax_make_step_fns(ref, jax_make_optimizer(1e-2, 1e-4), "mse")
    p, o = fns.init(jax.random.key(0), jnp.asarray(dense), jnp.asarray(x))
    losses = []
    for _ in range(3):
        p, o, loss = fns.train_step(p, o, jnp.asarray(dense), jnp.asarray(x), jnp.asarray(y),
                                    jnp.ones(x.shape[0], jnp.float32))
        losses.append(float(loss))
    return from_jax_params(jax.tree.map(np.asarray, params), 2), want, losses


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """Eight ranks (dp=2 x region=2 x branch=2): the parity case in both
    modes, and the composed ``bandedbranch`` on each route; the port's
    one-device twins and JAX's references."""
    root = tmp_path_factory.mktemp("branch8")
    dense, x, y = _parity_problem()
    jax_refs = {mode: _jax_parity(dense[mode], x, y) for mode in dense}
    state = jax_refs["banded"][0]
    assert all(torch.equal(state[k], v) for k, v in jax_refs["sparse"][0].items())
    twins = {}
    for route in ROUTES:
        cfg = _route_cfg(route)
        cfg.train.epochs = 1
        cfg.mesh = MeshConfig()
        cfg.train.out_dir = str(root / f"twin-{route}")
        from stmgcn_tpu_torch.experiment import build_trainer

        t = build_trainer(cfg, device="cpu", verbose=False,
                          dataset=None if route == "synthetic" else banded_dataset(cfg))
        if route == "synthetic":
            init = {k: v.clone() for k, v in t.model.state_dict().items()}
        twins[route] = {"history": t.train(), "state": ranks._state(t), "best": t.best_path}
    out = ranks.launch(8, ["branch_parity", "branch_region_train"], root, bp_modes=("banded", "sparse"),
                       bp_dense=dense, bp_x=x, bp_y=y, bp_state=state, br_routes=ROUTES,
                       br_initial_state=init)
    return out, jax_refs, twins


@pytest.mark.parametrize("mode", ["banded", "sparse"])
def test_branch_stacked_parity_with_jax_one_device(eight, mode):
    out, jax_refs, _ = eight
    _, want, want_losses = jax_refs[mode]
    for res in out:
        got = res["branch_parity"][mode]
        assert got["modes"] == (mode,) * 2 and got["stacked"]
        assert tuple(got["wh_0"])[0] == 1  # each rank holds one of the two branches
        np.testing.assert_allclose(got["pred"].numpy(), want, **FWD)
        np.testing.assert_allclose(got["losses"], want_losses, rtol=STEP_RTOL)


@pytest.mark.parametrize("route", ROUTES)
def test_bandedbranch_trains_as_its_twin_on_every_route(eight, route):
    out, _, twins = eight
    want_modes = {"synthetic": ("dense",) * 2, "banded": ("banded",) * 2,
                  "sparse": ("sparse",) * 2}[route]
    for res in out:
        got = res["branch_region_train"][route]
        assert got["modes"] == want_modes and got["layout"] == "vmapped"
        assert got["branch_stacked"] == (None if route == "synthetic" else True)
        assert got["problems"] == []
        ops = got["report"]["ops"]
        assert "all-reduce/branch" in ops and "all-reduce/dp" in ops
        assert ("collective-permute/region" in ops) == (route == "banded")
        assert ("all-gather/region" in ops) == (route != "banded")
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], twins[route]["history"][mode],
                                       rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), twins[route]["state"][name].numpy(),
                                       **PARAMS, err_msg=name)


def test_bandedbranch_checkpoint_serves_in_both_packages(eight):
    from stmgcn_tpu.inference import Forecaster as JaxForecaster
    from stmgcn_tpu_torch import Forecaster
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

    out, _, twins = eight
    path = out[0]["branch_region_train"]["banded"]["best"]
    params = load_checkpoint(path, load_opt_state=False)[1]["params"]
    assert "branches" in params and "branch_0" not in params  # JAX's stacked layout
    cfg = _route_cfg("banded")
    ds = banded_dataset(cfg)
    cfg.mesh = MeshConfig()
    from stmgcn_tpu_torch.experiment import build_supports

    sup = build_supports(cfg, ds)
    hist = ds.denormalize(ds.arrays("test")[0][:4])
    pred = Forecaster.from_checkpoint(path, device="cpu").predict(sup, hist)
    jax_pred = np.asarray(JaxForecaster.from_checkpoint(path).predict(sup, hist))
    twin = Forecaster.from_checkpoint(twins["banded"]["best"], device="cpu").predict(sup, hist)
    assert pred.shape == (4, ds.n_nodes, ds.n_feats) and np.isfinite(pred).all()
    np.testing.assert_allclose(pred, jax_pred, rtol=1e-4, atol=1e-4 * np.abs(jax_pred).max())
    np.testing.assert_allclose(pred, twin, rtol=1e-3, atol=1e-3 * np.abs(twin).max())
