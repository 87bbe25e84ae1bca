"""The port's banded halo plan (``stmgcn_tpu_torch/parallel/banded.py``,
``halo.py``; the ``"banded"`` conv and per-branch mixed modes) against the
JAX package.

Mirrors ``tests/test_banded.py``. Ranks are processes of
``tests/_torch_rank_worker.py`` over gloo (several scenarios a spawn); the
JAX side runs in this process on the conftest's virtual CPU devices.

- the port's own ``bandwidth``, ``strip_decompose`` and
  ``banded_decompose`` give JAX's arrays exactly, and its messages;
- ``halo_exchange`` at region 2 and 4: every rank's block is its
  neighbours' boundary rows (zeros at the line's ends), exactly;
- ``sharded_banded_apply`` at region 2 and 4, forward and the gradient of
  ``sum(out * cot)`` w.r.t. the signal, against JAX's
  ``sharded_banded_apply`` on as many of the 8 virtual devices (rtol 2e-5,
  atol 2e-5: ``test_banded.py``'s forward tolerance; the reverse permute
  adds the boundary cotangents in another order than XLA's transpose);
- ``BandedChebGraphConv`` and ``ChebGraphConv`` share parameters and agree
  (``test_parity_and_param_interchange``; rtol 1e-5, atol 1e-5);
- a (banded, dense, dense) ``STMGCN`` on a region=4 mesh against JAX's
  ``STMGCN`` on one device with the same weights (the loop layout), its
  prediction and its parameter gradients summed over the ranks (rtol 2e-5,
  atol 2e-5, ``TestMixedModeModel``'s; gradients rtol 1e-4, atol 2e-5:
  the node sums split over four ranks and the halo's reverse adds).
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

from stmgcn_tpu.data import grid_adjacency  # noqa: E402
from stmgcn_tpu.ops import SupportConfig  # noqa: E402
from stmgcn_tpu.parallel import banded_decompose as jax_banded_decompose  # noqa: E402
from stmgcn_tpu.parallel import bandwidth as jax_bandwidth  # noqa: E402
from stmgcn_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from stmgcn_tpu.parallel import sharded_banded_apply as jax_banded_apply  # noqa: E402
from stmgcn_tpu.parallel import strip_decompose as jax_strip_decompose  # noqa: E402
from stmgcn_tpu_torch.models.params import from_jax_params  # noqa: E402
from stmgcn_tpu_torch.ops.chebconv import (  # noqa: E402
    BandedChebGraphConv,
    ChebGraphConv,
    MixedChebGraphConv,
    conv_cls,
    make_conv,
)
from stmgcn_tpu_torch.parallel import (  # noqa: E402
    BandedSupports,
    banded_decompose,
    bandwidth,
    strip_decompose,
)

torch.set_num_threads(1)

APPLY = dict(rtol=2e-5, atol=2e-5)
CONV = dict(rtol=1e-5, atol=1e-5)
MIXED = dict(rtol=2e-5, atol=2e-5)
MIXED_GRADS = dict(rtol=1e-4, atol=2e-5)

#: the halo problem: a 16x16 grid's Chebyshev K=1 supports, band 16
GRID, HALO, B, F = 16, 16, 2, 3


def _banded_supports(n, k, w, seed=0):
    rng = np.random.default_rng(seed)
    sup = (rng.standard_normal((k, n, n)) * 0.2).astype(np.float32)
    sup[:, np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > w] = 0.0
    return sup


def _halo_problem(region):
    sups = np.asarray(SupportConfig("chebyshev", 1).build(grid_adjacency(GRID)), np.float32)
    rng = np.random.default_rng(region)
    x = rng.standard_normal((B, GRID * GRID, F)).astype(np.float32)
    cot = rng.standard_normal((sups.shape[0], B, GRID * GRID, F)).astype(np.float32)
    return sups, x, cot


def _jax_apply(region, sups, x, cot):
    mesh = jax_build_mesh(dp=1, region=region, devices=jax.devices()[:region])
    strips = jax_strip_decompose(sups, region, HALO)

    def loss(x):
        return jnp.sum(jax_banded_apply(mesh, strips, x, HALO) * cot)

    out = jax_banded_apply(mesh, strips, jnp.asarray(x), HALO)
    return np.asarray(out), np.asarray(jax.grad(loss)(jnp.asarray(x)))


def _mixed_problem():
    n, b, t, k, w = 64, 4, 5, 3, 3
    rng = np.random.default_rng(7)
    sup = np.stack([_banded_supports(n, k, w, seed=3)]
                   + [(rng.standard_normal((k, n, n)) * 0.2).astype(np.float32)
                      for _ in range(2)])
    x = rng.standard_normal((b, t, n, 1)).astype(np.float32)
    cot = rng.standard_normal((b, n, 1)).astype(np.float32)
    return sup, x, cot


@pytest.fixture(scope="module")
def mixed_jax():
    """JAX's one-device loop-layout model of the mixed problem: weights,
    prediction, and the gradients of ``sum(pred * cot)``."""
    from stmgcn_tpu.models import STMGCN

    sup, x, cot = _mixed_problem()
    model = STMGCN(m_graphs=3, n_supports=3, seq_len=x.shape[1], input_dim=1,
                   lstm_hidden_dim=8, lstm_num_layers=2, gcn_hidden_dim=8, vmap_branches=False)
    params = model.init(jax.random.key(0), jnp.asarray(sup), jnp.asarray(x))
    pred = model.apply(params, jnp.asarray(sup), jnp.asarray(x))
    grads = jax.grad(lambda p: jnp.sum(model.apply(p, jnp.asarray(sup), jnp.asarray(x))
                                       * cot))(params)
    to_np = jax.tree.map(np.asarray, params)
    return (from_jax_params(to_np, 3), np.asarray(pred),
            from_jax_params(jax.tree.map(np.asarray, grads), 3))


@pytest.fixture(scope="module")
def spawns(tmp_path_factory, mixed_jax):
    """A region=4 job (the halo problem and the mixed model) and a region=2
    job (the halo problem)."""
    root = tmp_path_factory.mktemp("banded")
    sup, x, cot = _mixed_problem()
    out = {}
    for region in (4, 2):
        sups, hx, hcot = _halo_problem(region)
        names = ["halo_apply"] + (["mixed_model"] if region == 4 else [])
        out[region] = ranks.launch(
            region, names, root, region=region, halo=HALO,
            strips=strip_decompose(sups, region, HALO), x=hx, cot=hcot,
            sup=sup, state=mixed_jax[0], mixed_x=x, mixed_cot=cot)
    return out


# -- host arrays ------------------------------------------------------------

@pytest.mark.parametrize("n,k,w", [(16, 2, 2), (64, 3, 5), (48, 1, 0)])
def test_strips_and_bandwidth_equal_jax(n, k, w):
    sup = _banded_supports(n, k, w, seed=n)
    assert bandwidth(sup[0]) == jax_bandwidth(sup[0]) == (w if w else 0)
    for shards in (2, 4, 8):
        if n % shards or w > n // shards:
            continue
        np.testing.assert_array_equal(strip_decompose(sup, shards, w),
                                      jax_strip_decompose(sup, shards, w))
        mine, theirs = banded_decompose(sup, shards), jax_banded_decompose(sup, shards)
        assert (mine.halo, mine.n, mine.n_shards) == (theirs.halo, theirs.n, theirs.n_shards)
        np.testing.assert_array_equal(mine.strips, np.asarray(theirs.strips))


def test_grid_chebyshev_band_and_validation_messages_match_jax():
    sups = np.asarray(SupportConfig("chebyshev", 2).build(grid_adjacency(8)), np.float32)
    assert [bandwidth(s) for s in sups] == [jax_bandwidth(s) for s in sups]
    assert bandwidth(np.zeros((4, 4))) == 0
    wide = np.zeros((1, 64, 64), np.float32)
    wide[0, 0, 63] = 1.0
    for args in ((np.eye(64)[None], 7, 4), (wide, 8, 4), (np.eye(64)[None], 8, 9)):
        msgs = []
        for fn in (strip_decompose, jax_strip_decompose):
            with pytest.raises(ValueError) as info:
                fn(*args)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


def test_banded_supports_shard_and_to():
    bsup = banded_decompose(_banded_supports(32, 2, 2), 4)
    one = bsup.shard(2).to("cpu")
    assert isinstance(one, BandedSupports) and isinstance(one.strips, torch.Tensor) and one.strips.shape == (1, 2, 8, 12)
    assert (one.halo, one.n, one.n_shards, one.n_local) == (2, 32, 1, 8)
    np.testing.assert_array_equal(one.strips[0].numpy(), bsup.strips[2])


# -- the halo exchange and the strip product --------------------------------

@pytest.mark.parametrize("region", [2, 4])
def test_halo_exchange_gives_each_rank_its_neighbours_rows(spawns, region):
    _, x, _ = _halo_problem(region)
    nl = x.shape[1] // region
    rows = x.transpose(1, 0, 2)  # node rows lead, as sharded_banded_apply exchanges them
    zeros = np.zeros((HALO, B, F), np.float32)
    for j, res in enumerate(spawns[region]):
        block = res["halo_apply"]["block"].numpy()
        left = rows[j * nl - HALO:j * nl] if j else zeros
        right = rows[(j + 1) * nl:(j + 1) * nl + HALO] if j < region - 1 else zeros
        np.testing.assert_array_equal(block, np.concatenate(
            [left, rows[j * nl:(j + 1) * nl], right]))


@pytest.mark.parametrize("region", [2, 4])
def test_sharded_banded_apply_matches_jax(spawns, region):
    sups, x, cot = _halo_problem(region)
    want_out, want_grad = _jax_apply(region, sups, x, cot)
    got = [r["halo_apply"] for r in spawns[region]]
    np.testing.assert_allclose(np.concatenate([g["out"].numpy() for g in got], axis=2),
                               want_out, **APPLY)
    np.testing.assert_allclose(np.concatenate([g["grad"].numpy() for g in got], axis=1),
                               want_grad, **APPLY)


def test_sharded_banded_apply_matches_the_dense_product(spawns):
    sups, x, _ = _halo_problem(4)
    got = np.concatenate([r["halo_apply"]["out"].numpy() for r in spawns[4]], axis=2)
    np.testing.assert_allclose(got, np.einsum("kij,bjf->kbif", sups, x), **APPLY)


# -- the convs ----------------------------------------------------------------

def test_banded_conv_shares_the_dense_convs_parameters_and_output():
    from stmgcn_tpu.ops.chebconv import ChebGraphConv as JaxConv

    n, k, w = 64, 3, 2
    sup = _banded_supports(n, k, w)
    x = np.random.default_rng(1).standard_normal((4, n, 3)).astype(np.float32)
    jconv = JaxConv(n_supports=k, features=5)
    params = jconv.init(jax.random.key(0), jnp.asarray(sup), jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jnp.asarray(sup), jnp.asarray(x)))
    state = {"W": torch.from_numpy(np.array(params["params"]["W"])),
             "b": torch.from_numpy(np.array(params["params"]["b"]))}
    dense, banded = ChebGraphConv(k, 3, 5, device="cpu"), BandedChebGraphConv(k, 3, 5,
                                                                              device="cpu")
    assert dense.state_dict().keys() == banded.state_dict().keys()
    for conv in (dense, banded):
        conv.load_state_dict(state)
    one = banded_decompose(sup, 1).to("cpu")  # one shard: the whole support, zero halos
    np.testing.assert_allclose(banded(one, torch.from_numpy(x)).detach().numpy(), want, **CONV)
    np.testing.assert_allclose(dense(torch.from_numpy(sup), torch.from_numpy(x))
                               .detach().numpy(), want, **CONV)
    with pytest.raises(ValueError, match="supports"):
        BandedChebGraphConv(2, 3, 5, device="cpu")(one, torch.from_numpy(x))
    with pytest.raises(ValueError, match="its own"):
        banded(banded_decompose(sup, 4).to("cpu"), torch.from_numpy(x))


def test_conv_modes_resolve():
    assert conv_cls("banded") is BandedChebGraphConv
    assert conv_cls(("banded", "dense")) is MixedChebGraphConv
    mixed = make_conv(("banded", "dense"), 2, 3, 4, branches=2, device="cpu")
    assert isinstance(mixed, MixedChebGraphConv) and mixed.modes == ("banded", "dense")
    with pytest.raises(ValueError, match="per-branch modes"):
        make_conv(("banded", "sparse"), 2, 3, 4, branches=2, device="cpu")
    with pytest.raises(ValueError, match="support mode must be one of"):
        conv_cls("ring")


def test_mixed_model_modes_and_validation():
    from stmgcn_tpu_torch.models import STMGCN

    kw = dict(m_graphs=3, n_supports=2, seq_len=5, input_dim=1, lstm_hidden_dim=4,
              lstm_num_layers=1, gcn_hidden_dim=4, device="cpu")
    model = STMGCN(support_modes=("banded", "dense", "dense"), **kw)
    assert (model.support_mode, model.loop_layout) == ("mixed", True)
    with pytest.raises(ValueError, match="not both"):
        STMGCN(sparse=True, support_modes=("dense",) * 3, **kw)
    with pytest.raises(ValueError, match="only"):
        STMGCN(support_modes=("banded", "sparse", "dense"), **kw)
    with pytest.raises(ValueError, match="per-branch support groups"):
        model(tuple(torch.zeros(2, 8, 8) for _ in range(2)), torch.zeros(2, 5, 8, 1))
    with pytest.raises(ValueError, match="branch 0"):
        model(tuple(torch.zeros(2, 8, 8) for _ in range(3)), torch.zeros(2, 5, 8, 1))


def test_mixed_model_on_a_region_mesh_matches_jax_one_device(spawns, mixed_jax):
    _, want, _ = mixed_jax
    got = [r["mixed_model"] for r in spawns[4]]
    assert got[0]["modes"] == ("banded", "dense", "dense") and got[0]["layout"]
    np.testing.assert_allclose(np.concatenate([g["pred"].numpy() for g in got], axis=1),
                               want, **MIXED)


def test_mixed_model_gradients_summed_over_ranks_match_jax(spawns, mixed_jax):
    _, _, want = mixed_jax
    got = [r["mixed_model"]["grads"] for r in spawns[4]]
    for name, value in want.items():
        np.testing.assert_allclose(sum(g[name] for g in got).numpy(), value.numpy(),
                                   **MIXED_GRADS, err_msg=name)
