"""The port's region axis (node rows split over ranks) and its order-free
gradient sum, on CPU ranks over gloo, against one device and against the
JAX package.

Mirrors ``tests/test_node_padding.py``, ``tests/test_banded.py``'s routing
and ``tests/test_parallel.py``'s placement cases. Ranks are processes of
``tests/_torch_rank_worker.py`` (several scenarios a spawn); the JAX side
runs in this process on the conftest's virtual CPU devices.

- placement of the region kinds; ``node_pad_target`` and the padded
  supports equal JAX's exactly; ``route_supports`` gives JAX's modes;
- the dense region conv (``region_dense_apply``) at region 2 and 4 against
  JAX's one-device ``ChebGraphConv`` at the same weights: forward, the
  signal's gradient and the parameters' (summed over the ranks) (rtol
  2e-5, atol 2e-6: ``tests/test_parallel.py``'s forward tolerance);
- a node-padded region=8 mesh (N = 25 -> 32, ``test_node_padding.py``'s
  config at its default widths) trains as the port's unpadded one-device
  twin and JAX's from one initial state: per-epoch losses against both
  (rtol 2e-5, ``test_node_padding.py``'s), final parameters against the
  port's twin (rtol 5e-4, atol 2e-5, ``tests/test_parallel.py:96-104``'s;
  the JAX trainer's parameters sit up to 3.8e-4 from the port twin's at
  123 entries of ``branches.gcn.W`` and ``.b`` whose gradients are near
  zero, where Adam's normalized step turns the two frameworks' float32
  sum orders into a step of O(lr): a one-device gap, the same before the
  region axis was ported (``tests/_torch_jax_gap.py`` reads it), that
  ``tests/test_torch_train.py`` meets at its narrower widths), ``test()``
  metrics against the twin (rtol 1e-4); and its lead's ``best.ckpt`` (the
  loop layout) serves on one device;
- the same at a 31x2 grid (N = 62 -> 64), where "auto" routes the grid
  branch banded: training through the halo plan and its reverse, losses
  against the port's one-device trainer (rtol 2e-5) and JAX's (rtol 5e-4,
  atol 2e-5), parameters against the port's;
- the composed ``scaled`` shrink (grid branch banded, the others dense) on
  eight ranks against its one-device twin, and one step's collectives
  against the analytic counts and the manifest;
- the composed ``multicity`` city pair (3x3 and 4x4 grids) on a region=8
  mesh (window-free resident) trains as one fleet shape class
  (``fleet_superstep``: planned over the padded sizes, the 3x3 city padded
  9 -> 16 rows inside the 16-node rung) against its one-device fleet twin
  (the same tolerances);
- the trainer's opt-in features on a region=8 mesh (the 3x3 ``tiny``
  city padded to 16 rows) against their one-device twins
  (``tests/_torch_rank_worker.py`` ``FEATURE_RUNS``): the divergence guard
  with a fault plan trips at the twin's steps, the health rows equal the
  twin's (norms rtol 1e-5) and only the lead writes ``health.jsonl``, a
  bf16 run with ``sr_seed`` and ``debug_nans`` tracks the twin (its
  parameter updates normwise within 1e-2, ``tests/test_torch_bf16_train.py``'s
  bf16 rule); and the NaN drill: a NaN in one node's series, which lives on
  one rank, makes every rank raise the twin's ``CheckError`` (``checks``)
  and ``FloatingPointError`` (``debug_nans``) at the twin's step, within
  seconds of each other;
- SIGTERM to one non-lead rank of a region mesh stops every rank at one
  safe point;
- the refusals that remain are JAX's own (``model.tiled`` on a mesh,
  ``banded`` routing with an over-budget branch on a region x branch mesh,
  the Pallas LSTM with ``branch > 1``), with JAX's messages;
- C4: ``GradSync.reduce`` gives every rank the float64 sum of the float32
  partials rounded once, bit for bit, whatever rank holds which partial;
- the one-device gap to JAX (``tests/_torch_jax_gap.py``): at the padded
  test's 5x5 grid the port's first training step's gradients equal JAX's
  within 1e-5 of each tensor's largest value, so the trainers' 3.8e-4 end
  gap is Adam amplifying float32 sum orders, not a difference of function.
"""

import itertools
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
from stmgcn_tpu.experiment import build_dataset as jax_build_dataset  # noqa: E402
from stmgcn_tpu.experiment import build_supports as jax_build_supports  # noqa: E402
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer  # noqa: E402
from stmgcn_tpu.experiment import node_pad_target as jax_node_pad_target  # noqa: E402
from stmgcn_tpu.experiment import route_supports as jax_route_supports  # noqa: E402
from stmgcn_tpu_torch.config import ExperimentConfig, MeshConfig, preset  # noqa: E402
from stmgcn_tpu_torch.experiment import (  # noqa: E402
    build_dataset,
    build_supports,
    build_trainer,
    node_pad_target,
    route_supports,
)
from stmgcn_tpu_torch.models.params import from_jax_params  # noqa: E402
from stmgcn_tpu_torch.parallel import (  # noqa: E402
    BandedSupports,
    MeshPlacement,
    composed_config,
    composed_trainer,
)
from stmgcn_tpu_torch.parallel.mesh import Mesh  # noqa: E402

torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=2e-6)
LOSS_RTOL = 2e-5
PARAMS = dict(rtol=5e-4, atol=2e-5)
#: a bf16 run's parameter updates, normwise (tests/test_torch_bf16_train.py)
UPDATE = dict(rtol=1e-2)
METRICS_RTOL = 1e-4
#: the first step's gradients against JAX's, of each tensor's largest value
GRAD_ATOL = 1e-5


def _fake_mesh(dp=1, region=1, branch=1, rank=0):
    coords = dict(zip(("dp", "region", "branch"),
                      (int(c) for c in np.unravel_index(rank, (dp, region, branch)))))
    return Mesh(dp, region, branch, rank, coords, {}, {}, "gloo", torch.device("cpu"))


def _pad_cfg(rows=5, region=8, strategy="auto", sparse=False):
    """``test_node_padding.py``'s config: ``scaled`` at a 5x5 grid (N = 25,
    padded to 32 over region=8), K=2, float32."""
    cfg = preset("scaled")
    cfg.data.rows = rows
    cfg.data.n_timesteps = 24 * 7 * 2 + 48
    cfg.model.dtype = "float32"
    cfg.model.K = 2
    cfg.model.sparse = sparse
    cfg.train.epochs = 2
    cfg.train.batch_size = 16
    cfg.mesh.dp, cfg.mesh.region = 1, region
    cfg.mesh.region_strategy = strategy
    return cfg


def _banded_pad_cfg():
    """:func:`_pad_cfg` at a 31x2 grid: N = 62, padded to 64 over region=8;
    the grid's bandwidth 4 fits the halo budget of 8 // 2, so "auto" routes
    it banded beside two dense branches (the ``scaled`` plan)."""
    cfg = _pad_cfg(rows=31)
    cfg.data.cols = 2
    return cfg


def _jax(cfg):
    return JaxConfig.from_dict(cfg.to_dict())


# -- placement, padding and routing on the host -------------------------------

def test_placement_slices_node_rows_by_kind():
    pl = MeshPlacement(_fake_mesh(1, 4, rank=2))
    assert pl.nodes(16) == slice(8, 12)
    x = np.arange(2 * 3 * 16 * 1).reshape(2, 3, 16, 1)
    np.testing.assert_array_equal(pl.put(x, "x"), x[:, :, 8:12])
    y = x[:, 0]
    np.testing.assert_array_equal(pl.put(y, "y"), y[:, 8:12])
    np.testing.assert_array_equal(pl.put(x, "y"), x[:, :, 8:12])  # seq2seq (B, H, N, C)
    np.testing.assert_array_equal(pl.put(x[0], "series"), x[0][:, 8:12])
    sup = np.arange(3 * 2 * 16 * 16).reshape(3, 2, 16, 16)
    np.testing.assert_array_equal(pl.put(sup, "supports"), sup[:, :, 8:12])
    from stmgcn_tpu_torch.parallel import banded_decompose

    band = np.triu(np.tril(np.ones((16, 16), np.float32), 1), -1)[None]
    routed = pl.put((banded_decompose(band, 4), sup[1]), "supports")
    assert isinstance(routed[0], BandedSupports) and routed[0].n_shards == 1
    np.testing.assert_array_equal(routed[0].strips[0], banded_decompose(band, 4).strips[2])
    np.testing.assert_array_equal(routed[1], sup[1][:, 8:12])
    with pytest.raises(ValueError, match="n_nodes 15 not divisible by region=4"):
        pl.nodes(15)
    with pytest.raises(ValueError, match="2 shards on a mesh of region=4"):
        pl.put(banded_decompose(band, 2), "supports")


@pytest.mark.parametrize("n", [25, 32, 2500, 7])
def test_node_pad_target_matches_jax(n):
    for region, dp in ((8, 1), (4, 2), (1, 8)):
        cfg = _pad_cfg(region=region)
        cfg.mesh.dp = dp
        assert node_pad_target(cfg, n) == jax_node_pad_target(_jax(cfg), n)
    cfg = _pad_cfg()
    cfg.mesh = MeshConfig()
    assert node_pad_target(cfg, n) is None


@pytest.mark.parametrize("strategy", ["gspmd", "auto"])
def test_padded_supports_equal_jax(strategy):
    cfg = _pad_cfg(strategy=strategy)
    mine, theirs = build_supports(cfg, build_dataset(cfg)), jax_build_supports(
        _jax(cfg), jax_build_dataset(_jax(cfg)))
    assert mine.shape == (3, 3, 32, 32)
    np.testing.assert_array_equal(mine, np.asarray(theirs))
    assert not mine[..., 25:, :].any() and not mine[..., 25:].any()


def _routing_cases():
    shrink = composed_config("scaled")
    wide = _pad_cfg(rows=16, region=4)  # test_banded.py TestRouting's
    wide.mesh.halo = 48
    strict = _pad_cfg(rows=16, region=4, strategy="banded")
    strict.mesh.halo = 48
    return {"scaled-shrink": shrink, "grid-halo-48": wide, "gspmd": _pad_cfg(strategy="gspmd"),
            "banded-rejects-wide": strict}


@pytest.mark.parametrize("case", ["scaled-shrink", "grid-halo-48", "gspmd",
                                  "banded-rejects-wide"])
def test_route_supports_gives_jax_modes(case):
    cfg = _routing_cases()[case]
    if case == "banded-rejects-wide":
        msgs = []
        for fn, c, build in ((route_supports, cfg, build_dataset),
                             (jax_route_supports, _jax(cfg), jax_build_dataset)):
            with pytest.raises(ValueError, match="bandwidth") as info:
                fn(c, build(c))
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
        return
    sup, modes = route_supports(cfg, build_dataset(cfg))
    jsup, jmodes = jax_route_supports(_jax(cfg), jax_build_dataset(_jax(cfg)))
    assert modes == jmodes
    if modes is not None and "banded" in modes:
        for mine, theirs, mode in zip(sup, jsup, modes):
            want = theirs.strips if mode == "banded" else theirs
            np.testing.assert_array_equal(mine.strips if mode == "banded" else mine,
                                          np.asarray(want))
    if case == "scaled-shrink":
        assert modes == ("banded", "dense", "dense")


def test_remaining_region_refusals_raise_by_name():
    from stmgcn_tpu.parallel.compose import _band_adj as jax_band_adj

    # the region x branch parts build: the preset, its composition, the placement
    assert preset("bandedbranch").mesh.n_devices == 8
    assert composed_config("bandedbranch").mesh.halo == 4
    assert MeshPlacement(_fake_mesh(1, 2, 2)).put(np.zeros((2, 1, 4, 4)), "supports").shape == (
        1, 1, 2, 4)
    # JAX's refusals, with JAX's messages: the tiled plan on a mesh ...
    tiled = _pad_cfg(strategy="gspmd")
    tiled.model.tiled = True
    msgs = []
    for fn, c, build in ((route_supports, tiled, build_dataset),
                         (jax_route_supports, _jax(tiled), jax_build_dataset)):
        with pytest.raises(ValueError, match="model.tiled does not compose") as info:
            fn(c, build(c))
        msgs.append(str(info.value))
    with pytest.raises(ValueError, match="model.tiled does not compose") as info:
        build_trainer(tiled, device="cpu")
    assert msgs[0] == msgs[1] == str(info.value)
    # ... an over-budget branch under "banded" on a region x branch mesh ...
    cfg = composed_config("bandedbranch")
    cfg.mesh.region_strategy, cfg.mesh.halo = "banded", 2
    msgs = []
    for fn, c, build in ((route_supports, cfg, build_dataset),
                         (jax_route_supports, _jax(cfg), jax_build_dataset)):
        ds = build(c)
        ds.adjs = {"g0": jax_band_adj(ds.n_nodes, 1, 1),
                   "g1": jax_band_adj(ds.n_nodes, ds.n_nodes // 2, 2)}
        with pytest.raises(ValueError, match="every branch banded") as info:
            fn(c, ds)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    # ... and the Pallas LSTM with a branch axis
    cfg = composed_config("bandedbranch")
    cfg.model.lstm_backend = "pallas"
    with pytest.raises(ValueError, match="lstm_backend='pallas' does not compose with "
                                         "mesh.branch > 1"):
        build_trainer(cfg, device="cpu")


def test_one_device_first_step_gradients_match_jax():
    """The first training batch of the padded test's config on one device
    (5x5 grid, K=2, float32, batch 16) from JAX's initial parameters: the
    loss and every parameter's gradient of the port's model against
    ``jax.grad`` of JAX's, within ``GRAD_ATOL`` of each tensor's largest
    value."""
    single = _pad_cfg()
    single.mesh = MeshConfig()
    jcfg = _jax(single)
    jds = jax_build_dataset(jcfg)
    from stmgcn_tpu.experiment import build_model as jax_build_model

    jmodel = jax_build_model(jcfg, jds.n_feats)
    sup = np.asarray(jax_build_supports(jcfg, jds))
    x, y = (a[:single.train.batch_size] for a in jds.arrays("train"))
    params = jmodel.init(jax.random.key(single.train.seed), jnp.asarray(sup), jnp.asarray(x))

    def loss_fn(p):
        err = jnp.square(jmodel.apply(p, jnp.asarray(sup), jnp.asarray(x)) - jnp.asarray(y))
        return err.mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), 3)
    from stmgcn_tpu_torch.experiment import build_model
    from stmgcn_tpu_torch.train.step import masked_loss

    model = build_model(single, build_dataset(single).n_feats, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), 3))
    loss = masked_loss("mse", model(torch.from_numpy(sup), torch.from_numpy(x)),
                       torch.from_numpy(y), torch.ones(x.shape[0]))
    loss.backward()
    assert np.isclose(loss.item(), float(jloss), rtol=1e-6)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_ATOL * np.abs(ref).max(), err_msg=name)


# -- the spawns -------------------------------------------------------------------

def _conv_problem(region):
    rng = np.random.default_rng(region)
    k, n, b, f_in, f_out = 3, 16, 4, 3, 5
    sup = (rng.standard_normal((k, n, n)) * 0.3).astype(np.float32)
    x = rng.standard_normal((b, n, f_in)).astype(np.float32)
    cot = rng.standard_normal((b, n, f_out)).astype(np.float32)
    return sup, x, cot


def _jax_conv(sup, x, cot):
    from stmgcn_tpu.ops.chebconv import ChebGraphConv as JaxConv

    conv = JaxConv(n_supports=sup.shape[0], features=cot.shape[-1])
    params = conv.init(jax.random.key(1), jnp.asarray(sup), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)  # a nonzero bias too

    def loss(p, x):
        return jnp.sum(conv.apply(p, jnp.asarray(sup), x) * cot)

    (dp, dx) = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    out = conv.apply(params, jnp.asarray(sup), jnp.asarray(x))
    as_np = {k: np.array(v) for k, v in params["params"].items()}
    return as_np, {"out": np.asarray(out), "dx": np.asarray(dx),
                   "dW": np.asarray(dp["params"]["W"]), "db": np.asarray(dp["params"]["b"])}


#: C4's partials: float32 values whose float32 sums depend on the order
#: (1 + a few ulps, -1, and values below half an ulp of 1) but whose
#: float64 sum is exact (their exponents within 29 of one another)
def _c4_partials(n=64, world=4):
    rng = np.random.default_rng(17)
    ulp = np.float32(2.0 ** -23)
    big = (np.float32(1.0) + rng.integers(1, 8, n).astype(np.float32) * ulp)
    small = rng.integers(1, 2 ** 20, (world - 2, n)).astype(np.float32) * np.float32(2.0 ** -45)
    return np.concatenate([big[None], -np.ones((1, n), np.float32), small]).astype(np.float32)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """A job of four ranks: the dense region conv at region=4 and C4's
    order test on a dp=4 mesh of the same job."""
    sup, x, cot = _conv_problem(4)
    params, _ = _jax_conv(sup, x, cot)
    return ranks.launch(4, ["dense_region_conv", "grad_sync_order"],
                        tmp_path_factory.mktemp("region4"), region=4, dp=4, sup=sup, x=x,
                        cot=cot, W=params["W"], b=params["b"], partials=_c4_partials(),
                        perms=list(itertools.permutations(range(4))))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    sup, x, cot = _conv_problem(2)
    params, _ = _jax_conv(sup, x, cot)
    return ranks.launch(2, ["dense_region_conv"], tmp_path_factory.mktemp("region2"),
                        region=2, sup=sup, x=x, cot=cot, W=params["W"], b=params["b"])


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """Eight ranks: the node-padded region mesh trained from JAX's initial
    state, the composed ``scaled`` shrink, one ``scaled`` step's report,
    and the SIGTERM drill; the port's and JAX's one-device twins."""
    root = tmp_path_factory.mktemp("region8")
    single = _pad_cfg()
    single.mesh = MeshConfig()
    jcfg = _jax(single)
    jcfg.train.out_dir = str(root / "jax")
    jt = jax_build_trainer(jcfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    single.train.out_dir = str(root / "twin")
    twin = build_trainer(single, device="cpu", verbose=False, initial_state=init)
    twin_run = {"history": twin.train(), "state": ranks._state(twin),
                "test": twin.test(modes=("test",))["test"], "best": twin.best_path}
    jax_run = {"history": jt.train(),
               "state": from_jax_params(jax.tree.map(np.asarray, jt.params), 3)}
    # a padded mesh whose grid branch routes banded: its twins from JAX's weights
    bcfg = _banded_pad_cfg()
    bcfg.mesh = MeshConfig()
    bjcfg = _jax(bcfg)
    bjcfg.train.out_dir = str(root / "bjax")
    bjt = jax_build_trainer(bjcfg, verbose=False)
    binit = from_jax_params(jax.tree.map(np.asarray, bjt.params), 3)
    bcfg.train.out_dir = str(root / "btwin")
    btwin = build_trainer(bcfg, device="cpu", verbose=False, initial_state=binit)
    twin_run["banded"] = {"history": btwin.train(), "state": ranks._state(btwin)}
    jax_run["banded"] = {"history": bjt.train()}
    # the composed scaled shrink and its twin start from the seed's weights
    scaled_twin = composed_trainer("scaled", twin="single", out_dir=str(root / "stwin"),
                                   device="cpu")
    scaled = {"history": scaled_twin.train(), "state": ranks._state(scaled_twin)}
    # a heterogeneous city pair, each city padded on its own
    hetero = _hetero_cfg()
    hetero.mesh = MeshConfig()
    hetero.train.out_dir = str(root / "htwin")
    htwin = build_trainer(hetero, device="cpu", verbose=False)
    hinit = {k: v.clone() for k, v in htwin.model.state_dict().items()}
    scaled["hetero"] = {"history": htwin.train(), "state": ranks._state(htwin),
                        "path": htwin.train_path, "pads": htwin._node_pads}
    # the opt-in features' one-device twins, from the tiny city's seeded weights
    scaled["features"] = ranks.feature_twins(root / "ftwin", None, nan=True)
    out = ranks.launch(8, ["region_train", "banded_region_train", "composed", "region_step",
                           "hetero_region_train", "region_preempt", "features"], root,
                       cfg=_pad_cfg().to_dict(), region_initial_state=init, preset="scaled",
                       banded_cfg=_banded_pad_cfg().to_dict(), banded_initial_state=binit,
                       step_cfg=composed_config("scaled").to_dict(),
                       hetero_cfg=_hetero_cfg().to_dict(), hetero_initial_state=hinit,
                       feat_mesh=(1, 8, 1), feat_init=scaled["features"]["init"],
                       feat_nan=True)
    return out, twin_run, jax_run, scaled


def _hetero_cfg():
    """The composed ``multicity`` pair (4x4 and 3x3 grids) on a region=8
    mesh, batch 8."""
    cfg = composed_config("multicity")
    cfg.mesh = MeshConfig(region=8)
    cfg.train.batch_size = 8
    return cfg


@pytest.mark.parametrize("region", [2, 4])
def test_dense_region_conv_matches_jax_one_device(four, two, region):
    out = four if region == 4 else two
    sup, x, cot = _conv_problem(region)
    _, want = _jax_conv(sup, x, cot)
    got = [r["dense_region_conv"] for r in out]
    np.testing.assert_allclose(np.concatenate([g["out"].numpy() for g in got], axis=1),
                               want["out"], **FWD)
    np.testing.assert_allclose(np.concatenate([g["dx"].numpy() for g in got], axis=1),
                               want["dx"], **FWD)
    for key in ("dW", "db"):
        np.testing.assert_allclose(sum(g[key] for g in got).numpy(), want[key], **FWD,
                                   err_msg=key)


def test_grad_sync_is_order_free_bitwise(four):
    parts = _c4_partials()
    want = parts.astype(np.float64).sum(axis=0).astype(np.float32)
    orders = {np.float32(((p[0] + p[1]) + p[2]) + p[3]).tobytes() for p in (
        parts[list(perm)] for perm in itertools.permutations(range(4)))}
    assert len(orders) > 1  # float32 sums of these partials depend on the order
    for res in four:
        got = res["grad_sync_order"]
        assert got["backend"] == "gloo" and len(got["outs"]) == 24
        for out in got["outs"]:
            assert out.numpy().tobytes() == want.tobytes()


def test_grad_sync_bucket_is_float64(four):
    n = _c4_partials().shape[1]
    for res in four:
        assert res["grad_sync_order"]["bytes"] == 8 * n
        assert "collective-permute" in res["grad_sync_order"]["collectives"]


def test_padded_region_mesh_matches_unpadded_twin_and_jax(eight):
    out, twin, jax_run, _ = eight
    for res in out:
        got = res["region_train"]
        assert got["node_pads"] == (7,) and got["modes"] == ("dense",) * 3
        assert got["layout"] == "looped" and got["path"] == "per_step"  # a mesh streams
        for mode in ("train", "validate"):
            for ref in (twin, jax_run):
                np.testing.assert_allclose(got["history"][mode], ref["history"][mode],
                                           rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), twin["state"][name].numpy(), **PARAMS,
                                       err_msg=name)


def test_padded_banded_region_mesh_matches_unpadded_twin_and_jax(eight):
    """Training through the halo plan on a padded mesh: losses against the
    port's one-device trainer (LOSS_RTOL) and JAX's (the trajectory rule,
    rtol 5e-4 / atol 2e-5: at this grid the two one-device trainers' second
    validation losses sit 7.4e-5 apart, as before the region axis was
    ported, ``tests/_torch_jax_gap.py --rows 31 --cols 2``), parameters
    against the port's."""
    out, twin, jax_run, _ = eight
    for res in out:
        got = res["banded_region_train"]
        assert got["node_pads"] == (2,) and got["modes"] == ("banded", "dense", "dense")
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], twin["banded"]["history"][mode],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got["history"][mode],
                                       jax_run["banded"]["history"][mode], **PARAMS)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), twin["banded"]["state"][name].numpy(),
                                       **PARAMS, err_msg=name)


def test_padded_region_test_metrics_match_twin(eight):
    out, twin, _, _ = eight
    for res in out:
        for metric in ("mse", "rmse", "mae", "mape", "pcc"):
            np.testing.assert_allclose(res["region_train"]["test"][metric],
                                       twin["test"][metric], rtol=METRICS_RTOL)


def test_region_checkpoint_serves_on_one_device(eight, tmp_path):
    from stmgcn_tpu_torch import Forecaster
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

    out, twin, _, _ = eight
    path = out[0]["region_train"]["best"]
    params = load_checkpoint(path, load_opt_state=False)[1]["params"]
    assert sorted(k for k in params if k.startswith("branch")) == [
        "branch_0", "branch_1", "branch_2"]  # the JAX loop layout
    cfg = _pad_cfg()
    cfg.mesh = MeshConfig()
    ds = build_dataset(cfg)
    sup = build_supports(cfg, ds)
    hist = ds.denormalize(ds.arrays("test")[0][:4])
    pred = Forecaster.from_checkpoint(path, device="cpu").predict(sup, hist)
    want = Forecaster.from_checkpoint(twin["best"], device="cpu").predict(sup, hist)
    assert pred.shape == (4, ds.n_nodes, ds.n_feats) and np.isfinite(pred).all()
    np.testing.assert_allclose(pred, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_composed_scaled_on_eight_ranks_matches_its_twin(eight):
    out, _, _, scaled = eight
    for res in out:
        got = res["composed"]
        assert got["path"] == "series_superstep"
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], scaled["history"][mode],
                                       rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), scaled["state"][name].numpy(),
                                       **PARAMS, err_msg=name)


def test_heterogeneous_cities_pad_each_on_a_region_mesh(eight):
    out, _, _, twins = eight
    twin = twins["hetero"]
    assert twin["path"] == "fleet_superstep" and twin["pads"] == (0, 7)
    for res in out:
        got = res["hetero_region_train"]
        # one class of rung 16 (a multiple of region), as on one device
        assert got["node_pads"] == (0, 7) and got["path"] == "fleet_superstep"
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], twin["history"][mode],
                                       rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), twin["state"][name].numpy(), **PARAMS,
                                       err_msg=name)


def test_scaled_step_moves_the_analytic_bytes(eight):
    """One step of the composed ``scaled`` shrink (float32; M=3, B=4, the
    grid branch banded at its halo, two dense branches): forward, the gate
    conv's signal and the graph conv's LSTM states cross ranks (the banded
    branch two halo permutes each, the dense ones an all-gather of the
    whole node axis each) and the pooled gate sums once (float64 at
    float32); backward, only the graph conv's (the gate's signal is data):
    the banded branch's halo permutes back, the dense ones' input
    cotangents all-reduced, the pooled sum's cotangent; then the float64
    gradient bucket and the 4-byte loss."""
    cfg = composed_config("scaled")
    b, t, h, m = cfg.train.batch_size, cfg.data.seq_len, cfg.model.lstm_hidden_dim, 3
    for res in eight[0]:
        r = res["region_step"]
        assert r["modes"] == ("banded", "dense", "dense") and r["problems"] == []
        n = (r["nodes"].stop - r["nodes"].start) * 8
        halo = r["halos"][0]
        want = {
            "all-gather/region/node-rows": {"calls": 4, "bytes": 2 * 4 * b * n * (t + h)},
            "collective-permute/region/halo": {"calls": 4, "bytes": 2 * 4 * halo * b * (t + h)},
            "collective-permute/region/halo-grad": {"calls": 2, "bytes": 2 * 4 * halo * b * h},
            "all-reduce/region/node-rows-grad": {"calls": 2, "bytes": 2 * 4 * b * n * h},
            "all-reduce/region/node-pool": {"calls": 1, "bytes": 8 * m * b * t},
            "all-reduce/region/node-pool-grad": {"calls": 1, "bytes": 8 * m * b * t},
            "all-reduce/region/grads": {"calls": 1, "bytes": 8 * r["numel"]},
            "all-reduce/region/loss": {"calls": 1, "bytes": 4},
        }
        assert r["report"]["what"] == want


def test_scaled_step_raises_no_spmd_finding(eight):
    """The same step held to the executed manifest and the wire models:
    no finding, the largest halo permute call (the forward's, ``halo x B x
    max(T, H)`` float32) within its boundary-rows cap ``halo x B_local x
    M_local x F_cap x 4``; a cap one feature below that call fires."""
    from stmgcn_tpu_torch.analysis.spmd_check import (
        manifest_findings,
        wire_figures,
        wire_findings,
    )
    from stmgcn_tpu_torch.parallel import manifest_for_config

    cfg = composed_config("scaled")
    b, t, h = cfg.train.batch_size, cfg.data.seq_len, cfg.model.lstm_hidden_dim
    manifest = manifest_for_config(cfg, banded=True)
    for res in eight[0]:
        r = res["region_step"]
        halo = r["halos"][0]
        assert r["meta"] == {"halo": halo, "b_local": b, "m_local": 3,
                             "f_cap": t + 2 * h + cfg.model.gcn_hidden_dim,
                             "param_bytes": 4 * r["numel"]}
        assert manifest_findings("scaled/train", manifest, r["report"]) == []
        assert wire_findings("scaled/train", r["report"], r["meta"]) == []
        fig = wire_figures(r["report"], r["meta"])
        assert fig == {"permute_max": 4 * halo * b * max(t, h),
                       "permute_cap": 4 * halo * b * 3 * r["meta"]["f_cap"],
                       "dp_bytes": None, "dp_cap": 8 * r["numel"] + 4096}  # no dp axis
        assert r["report"]["max_bytes"]["collective-permute/region"] == fig["permute_max"]
        tight = dict(r["meta"], m_local=1, f_cap=max(t, h) - 1)
        (f,) = wire_findings("scaled/train", r["report"], tight)
        assert f.rule == "spmd-wire-budget" and "boundary-rows bound" in f.message


def test_sigterm_to_one_region_rank_stops_every_rank_at_one_safe_point(eight):
    got = [res["region_preempt"] for res in eight[0]]
    assert got[ranks.PREEMPT_RANK]["sent"] is not None
    assert all(g["raised"] and g["raised"].startswith("Preempted") for g in got)
    assert len({g["global_step"] for g in got}) == 1 and len({g["epoch"] for g in got}) == 1
    lead = got[0]["ckpt"]
    assert lead["global_step"] == got[0]["global_step"] and lead["mesh"]["region"] == 8


def test_guard_and_fault_plan_on_a_region_mesh_match_the_twin(eight):
    twin = eight[3]["features"]["guarded"]
    assert twin["trips"] == [(1, ranks.POISON_STEP)]
    for res in eight[0]:
        got = res["features"]["guarded"]
        assert got["trips"] == twin["trips"] and got["path"] == "series_superstep"
        ranks.check_run(got, twin, LOSS_RTOL, PARAMS)


def test_health_on_a_region_mesh_matches_the_twin(eight):
    for res in eight[0]:
        ranks.check_health(res["features"]["guarded"], eight[3]["features"]["guarded"],
                           LOSS_RTOL, 1e-5)


def test_sr_seed_and_debug_nans_on_a_region_mesh_match_the_twin(eight):
    twins = eight[3]["features"]
    for res in eight[0]:
        ranks.check_run(res["features"]["rounded"], twins["rounded"], LOSS_RTOL, UPDATE,
                        init=twins["init"])


@pytest.mark.parametrize("kind", ["checks", "debug_nans"])
def test_a_nan_on_one_region_rank_raises_the_twins_error_on_every_rank(eight, kind):
    twin = eight[3]["features"]["nan"][kind]
    assert twin["raised"].startswith("CheckError" if kind == "checks" else "FloatingPointError")
    got = [res["features"]["nan"][kind] for res in eight[0]]
    for g in got:
        assert (g["raised"], g["global_step"]) == (twin["raised"], twin["global_step"])
    assert max(g["at"] for g in got) - min(g["at"] for g in got) < 30.0

