"""The port's block-CSR row strips on a region mesh
(``stmgcn_tpu_torch/parallel/sparse.py``) and the sharded tiled plan
(``ops/tiling.py`` ``shard_tiled_plan``, ``sharded_gathered_tiles_apply``)
against the JAX package.

Mirrors ``tests/test_sparse_mesh.py`` and ``tests/test_multichip_exec.py``'s
``TestShardedTiled``. Ranks are processes of ``tests/_torch_rank_worker.py``
over gloo (one spawn of eight, several scenarios); the JAX side runs in this
process on the conftest's virtual CPU devices, its Pallas kernels in
interpret mode. On the CPU the kernels' plain versions run.

- ``sharded_from_dense``, ``branch_stack_sparse`` and ``shard_tiled_plan``
  give JAX's arrays bit for bit (padding slots included, at a strip height
  that is not a multiple of the tile), and their refusals JAX's messages;
- ``route_supports`` of a sparse config on a mesh gives JAX's modes and
  strips;
- the conv over a one-shard strip on one device equals JAX's dense conv
  (rtol 1e-4, atol 1e-4, ``test_sparse_mesh.py``'s);
- ``sharded_spmm_apply`` on dp=2 x region=4 ranks, forward and the input
  gradient, against JAX's one-device ``spmm_stack`` (atol 1e-5 of the
  output's largest value);
- the sharded tiled apply on eight ranks, forward and input gradient,
  against JAX's ``gathered_tiles_apply_reference`` and the prepared
  backward (the same tolerance);
- ``test_sparse_mesh.py``'s ``TestSparseMeshTrainer`` config trained on
  dp=2 x region=4 ranks: losses against the port's one-device sparse twin
  (rtol 2e-5) and JAX's one-device trainer (the trajectory rule, rtol
  5e-4, atol 2e-5, as the padded region test), parameters against the
  twin (rtol 5e-4, atol 2e-5), in the JAX loop layout.
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
from stmgcn_tpu.experiment import build_dataset as jax_build_dataset  # noqa: E402
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer  # noqa: E402
from stmgcn_tpu.experiment import route_supports as jax_route_supports  # noqa: E402
from stmgcn_tpu.ops.spmm import spmm_stack as jax_spmm_stack  # noqa: E402
from stmgcn_tpu.ops.spmm import stack_from_dense as jax_stack_from_dense  # noqa: E402
from stmgcn_tpu.ops.tiling import gathered_tiles_apply as jax_tiles_apply  # noqa: E402
from stmgcn_tpu.ops.tiling import gathered_tiles_apply_reference as jax_tiles_ref  # noqa: E402
from stmgcn_tpu.ops.tiling import plan_tiling as jax_plan_tiling  # noqa: E402
from stmgcn_tpu.ops.tiling import shard_tiled_plan as jax_shard_tiled_plan  # noqa: E402
from stmgcn_tpu.parallel import branch_stack_sparse as jax_branch_stack_sparse  # noqa: E402
from stmgcn_tpu.parallel import sharded_from_dense as jax_sharded_from_dense  # noqa: E402
from stmgcn_tpu_torch.config import MeshConfig, preset  # noqa: E402
from stmgcn_tpu_torch.experiment import build_dataset, build_trainer, route_supports  # noqa: E402
from stmgcn_tpu_torch.models.params import from_jax_params  # noqa: E402
from stmgcn_tpu_torch.ops.tiling import plan_tiling, shard_tiled_plan  # noqa: E402
from stmgcn_tpu_torch.parallel import (  # noqa: E402
    MeshPlacement,
    ShardedBlockSparse,
    branch_stack_sparse,
    merge_branches,
    sharded_from_dense,
)
from stmgcn_tpu_torch.parallel.mesh import Mesh  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("data", "idx", "data_t", "idx_t")
#: the applies: the port's sums over ranks against JAX's one-device kernels
APPLY_ATOL = 1e-5
LOSS_RTOL = 2e-5
PARAMS = dict(rtol=5e-4, atol=2e-5)


def make_supports(K=3, N=256, w=30, seed=0):
    """``test_sparse_mesh.py``'s banded random supports."""
    rng = np.random.default_rng(seed)
    mats = rng.standard_normal((K, N, N)).astype(np.float32)
    dist = np.abs(np.subtract.outer(np.arange(N), np.arange(N)))
    mats[:, dist > w] = 0.0
    return mats


def _fake_mesh(dp=1, region=1, branch=1, rank=0):
    coords = dict(zip(("dp", "region", "branch"),
                      (int(c) for c in np.unravel_index(rank, (dp, region, branch)))))
    return Mesh(dp, region, branch, rank, coords, {}, {}, "gloo", torch.device("cpu"))


def _tiled_plan(n=128, tile=8, k=2, band=5, seed=0):
    """``TestShardedTiled._plan``: one branch of K banded random supports."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((1, k, n, n), np.float32)
    for kk in range(k):
        a = np.zeros((n, n), np.float32)
        for d in range(1, band + 1):
            off = (rng.random(n - d) < 0.6).astype(np.float32)
            a += np.diag(off * rng.normal(size=n - d), d)
            a += np.diag(off * rng.normal(size=n - d), -d)
        np.fill_diagonal(a, rng.normal(size=n))
        dense[0, kk] = a
    return dense


def _mesh_cfg(sparse=True, mesh_on=True):
    """``TestSparseMeshTrainer._cfg``: ``scaled`` at a 16x16 grid, float32,
    one epoch of batch 16, block-CSR supports on dp=2 x region=4."""
    cfg = preset("scaled")
    cfg.data.rows = 16
    cfg.data.n_timesteps = 24 * 7 * 2 + 48
    cfg.model.dtype = "float32"
    cfg.model.sparse = sparse
    cfg.train.epochs = 1
    cfg.train.batch_size = 16
    if mesh_on:
        cfg.mesh.dp, cfg.mesh.region = 2, 4
    else:
        cfg.mesh = MeshConfig()
    return cfg


# -- host arrays ------------------------------------------------------------------

@pytest.mark.parametrize("n, shards, tile", [(256, 4, 128), (100, 4, 8), (2 * 313, 2, 128)])
def test_sharded_from_dense_equals_jax(n, shards, tile):
    mats = make_supports(N=n, w=n // 8)
    mine = sharded_from_dense(mats, shards, tile)
    theirs = jax_sharded_from_dense(mats, shards, tile)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(theirs, f)), f)
    assert (mine.n_shards, mine.n_supports, mine.n_local) == (
        theirs.n_shards, theirs.n_supports, theirs.n_local)
    # each row's real slots come first; past nblk only padding (index 0, zero blocks)
    slots = np.arange(mine.idx.shape[-1])
    pad = slots[None, None, None, :] >= mine.nblk[..., None]
    assert not mine.data[pad].any() and not mine.idx[pad].any()
    assert mine.data[~pad].reshape(-1, tile * tile).any(axis=1).all()


@pytest.mark.parametrize("case", ["indivisible", "not-square"])
def test_sharded_from_dense_refusals_are_jax_messages(case):
    bad, shards = ((make_supports(N=250), 4) if case == "indivisible" else
                   (np.zeros((2, 8, 16), np.float32), 2))
    msgs = []
    for fn in (sharded_from_dense, jax_sharded_from_dense):
        with pytest.raises(ValueError) as info:
            fn(bad, shards)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert ("divisible" if case == "indivisible" else "(K, N, N)") in msgs[0]


def test_branch_stack_sparse_equals_jax():
    rng = np.random.default_rng(3)
    dense = ((rng.random((2, 3, 40, 40)) < 0.3) * rng.normal(size=(2, 3, 40, 40)) * 0.2
             ).astype(np.float32)
    dense[1, :, :, 30:] = 0.0  # branch 1 narrower: padded to branch 0's width
    mine, theirs = branch_stack_sparse(dense, 2, 8), jax_branch_stack_sparse(dense, 2, 8)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(theirs, f)), f)
    assert mine.branch_stacked and theirs.branch_stacked and mine.branches == 2
    one = sharded_from_dense(dense[1], 2, 8)
    assert one.data.shape[3] < mine.data.shape[4]  # the common width is branch 0's


def test_strip_memory_fraction():
    mats = make_supports(N=512, w=16)
    ssp = sharded_from_dense(mats, 4)
    assert ssp.nbytes == jax_sharded_from_dense(mats, 4).nbytes
    assert ssp.nbytes / ssp.n_shards < mats.nbytes / 2


def test_placement_merges_a_ranks_branches_into_one_strip():
    dense = np.stack([make_supports(N=64, w=4, seed=s) for s in range(3)])
    forms = tuple(sharded_from_dense(dense[m], 4, 16) for m in range(3))
    pl = MeshPlacement(_fake_mesh(2, 4, rank=6))  # dp 1, region 2
    mine = pl.put(forms, "supports")
    assert isinstance(mine, ShardedBlockSparse) and mine.branches == 3
    assert mine.n_shards == 1 and mine.n_local == 16 and mine.n == 64
    c = max(f.data.shape[3] for f in forms)
    for m, form in enumerate(forms):
        part = form.shard(2)
        np.testing.assert_array_equal(mine.data[m, :, :, :, :part.data.shape[3]], part.data)
        np.testing.assert_array_equal(mine.nblk[m], part.nblk)
        assert not mine.data[m, ..., part.data.shape[3]:, :, :].any()
        assert mine.data.shape[4] == c
    np.testing.assert_array_equal(merge_branches([f.shard(2) for f in forms]).idx_t, mine.idx_t)
    stack = mine.stack()
    assert (stack.branches, stack.n_rows, stack.n_cols) == (3, 16, 64)
    with pytest.raises(ValueError, match="4 shards on a mesh of region=2"):
        MeshPlacement(_fake_mesh(1, 2)).put(forms, "supports")


def test_shard_tiled_plan_equals_jax():
    dense = _tiled_plan()
    mine = shard_tiled_plan(plan_tiling(dense, tile=8)[0], 8)
    theirs = jax_shard_tiled_plan(jax_plan_tiling(dense, tile=8)[0], 8)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(theirs, f)), f)
    assert (mine.halo, mine.halo_t, mine.n_shards, mine.block_rows_local) == (
        theirs.halo, theirs.halo_t, theirs.n_shards, theirs.block_rows_local)


@pytest.mark.parametrize("case", ["indivisible", "bandwidth"])
def test_shard_tiled_plan_refusals_are_jax_messages(case):
    dense = _tiled_plan(n=96) if case == "indivisible" else _tiled_plan(n=128, band=24)
    msgs = []
    for plan in (plan_tiling(dense, tile=8), jax_plan_tiling(dense, tile=8)):
        with pytest.raises(ValueError) as info:
            (shard_tiled_plan if isinstance(plan.perm, torch.Tensor) else
             jax_shard_tiled_plan)(plan[0], 8)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert ("pad_to a divisible rung" if case == "indivisible" else "block bandwidth") in msgs[0]
    if case == "indivisible":  # pad_to the next divisible rung and the split goes through
        assert shard_tiled_plan(plan_tiling(dense, tile=8).pad_to(128)[0], 8).block_rows_local == 2


def test_route_supports_sparse_on_a_mesh_gives_jax_strips():
    cfg = _mesh_cfg()
    sup, modes = route_supports(cfg, build_dataset(cfg))
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    jsup, jmodes = jax_route_supports(jcfg, jax_build_dataset(jcfg))
    assert modes == jmodes == ("sparse",) * 3
    assert all(isinstance(s, ShardedBlockSparse) and s.n_shards == 4 for s in sup)
    for mine, theirs in zip(sup, jsup):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(theirs, f)), f)


def test_sparse_conv_over_one_strip_matches_jax_dense_conv():
    from stmgcn_tpu.ops.chebconv import ChebGraphConv as JaxConv
    from stmgcn_tpu_torch.ops.chebconv import SparseChebGraphConv

    mats = make_supports()
    x = np.random.default_rng(4).standard_normal((8, 256, 6)).astype(np.float32)
    dense = JaxConv(n_supports=3, features=8)
    params = dense.init(jax.random.key(0), jnp.asarray(mats), jnp.asarray(x))
    want = np.asarray(dense.apply(params, jnp.asarray(mats), jnp.asarray(x)))
    conv = SparseChebGraphConv(3, 6, 8, device="cpu")
    conv.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params["params"].items()})
    got = conv(sharded_from_dense(mats, 1).shard(0), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


# -- the spawn ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """Eight ranks: ``sharded_spmm_apply`` at dp=2 x region=4, the sharded
    tiled apply at region=8, and the sparse mesh trainer at dp=2 x region=4
    from JAX's initial state; the port's and JAX's one-device twins."""
    root = tmp_path_factory.mktemp("sparse8")
    rng = np.random.default_rng(1)
    sp_mats = make_supports()
    sp_x = rng.standard_normal((8, 256, 5)).astype(np.float32)
    sp_cot = rng.standard_normal((3, 8, 256, 5)).astype(np.float32)
    plan = plan_tiling(_tiled_plan(), tile=8)
    tile_x = rng.standard_normal((plan.n, 4)).astype(np.float32)
    tile_cot = rng.standard_normal((2, plan.n, 4)).astype(np.float32)
    # the trainer's twins: JAX's one-device (dense: the same function) and
    # the port's one-device block-CSR trainer, from JAX's weights
    single = _mesh_cfg(mesh_on=False)
    jcfg = JaxConfig.from_dict(_mesh_cfg(sparse=False, mesh_on=False).to_dict())
    jcfg.train.out_dir = str(root / "jax")
    jt = jax_build_trainer(jcfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    single.train.out_dir = str(root / "twin")
    twin = build_trainer(single, device="cpu", verbose=False, initial_state=init)
    twin_run = {"history": twin.train(), "state": ranks._state(twin)}
    jax_run = {"history": jt.train()}
    out = ranks.launch(8, ["sparse_apply", "tiled_apply", "sparse_mesh_train"], root,
                       sp_mats=sp_mats, sp_x=sp_x, sp_cot=sp_cot, plan=plan, tile_x=tile_x,
                       tile_cot=tile_cot, sp_cfg=_mesh_cfg().to_dict(), sp_initial_state=init)
    return out, twin_run, jax_run, (sp_mats, sp_x, sp_cot, tile_x, tile_cot)


def test_sharded_spmm_apply_matches_jax_spmm_stack(eight):
    out, _, _, (mats, x, cot, _, _) = eight
    stack = jax_stack_from_dense(mats)
    b, n, f = x.shape

    def apply(xx):  # (B, N, F) -> (K, B, N, F) through the one-device kernel
        xm = xx.transpose(1, 0, 2).reshape(n, b * f)
        return jax_spmm_stack(stack, xm).reshape(-1, n, b, f).transpose(0, 2, 1, 3)

    want, vjp = jax.vjp(apply, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    want, want_dx = np.asarray(want), np.asarray(want_dx)
    got = np.zeros_like(want)
    got_dx = np.zeros_like(want_dx)
    for res in out:
        r = res["sparse_apply"]
        rows = slice(r["coords"]["dp"] * 4, (r["coords"]["dp"] + 1) * 4)
        nodes = slice(r["coords"]["region"] * 64, (r["coords"]["region"] + 1) * 64)
        got[:, rows, nodes] = r["out"].numpy()
        got_dx[rows, nodes] = r["grad"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=APPLY_ATOL * np.abs(want).max())
    np.testing.assert_allclose(got_dx, want_dx, rtol=0,
                               atol=APPLY_ATOL * np.abs(want_dx).max())


def test_sharded_tiled_apply_matches_jax_reference(eight):
    out, _, _, (_, _, _, x, cot) = eight
    plan = jax_plan_tiling(_tiled_plan(), tile=8)
    sharded = jax_shard_tiled_plan(plan[0], 8)
    want = np.asarray(jax_tiles_ref(plan[0], jnp.asarray(x)))
    _, vjp = jax.vjp(lambda v: jax_tiles_apply(plan[0], v), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    got = np.concatenate([r["tiled_apply"]["out"].numpy() for r in out], axis=1)[:, :plan.n]
    got_dx = np.concatenate([r["tiled_apply"]["grad"].numpy() for r in out])[:plan.n]
    assert all((r["tiled_apply"]["halo"], r["tiled_apply"]["halo_t"]) == (
        sharded.halo, sharded.halo_t) for r in out)
    np.testing.assert_allclose(got, want, rtol=0, atol=APPLY_ATOL * np.abs(want).max())
    np.testing.assert_allclose(got_dx, np.asarray(want_dx), rtol=0,
                               atol=APPLY_ATOL * np.abs(np.asarray(want_dx)).max())


def test_sparse_mesh_trainer_matches_twin_and_jax(eight):
    out, twin, jax_run, _ = eight
    for res in out:
        got = res["sparse_mesh_train"]
        assert got["modes"] == ("sparse",) * 3 and got["layout"] == "looped"
        # each rank's three branches merged into one strip: one launch a conv
        assert got["strip"] == "ShardedBlockSparse" and got["branch_stacked"]
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], twin["history"][mode],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got["history"][mode], jax_run["history"][mode],
                                       **PARAMS)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), twin["state"][name].numpy(), **PARAMS,
                                       err_msg=name)
