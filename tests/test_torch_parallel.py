"""The port's data-parallel mesh (``stmgcn_tpu_torch/parallel``) on CPU
ranks over gloo, against one device and against the JAX package.

Mirrors ``tests/test_parallel.py``: ranks are processes of
``tests/_torch_rank_worker.py`` (a few scenarios per spawn), each holding
its slice; the JAX side runs in this process on the conftest's 8 virtual
CPU devices.

- the mesh's shape and each rank's coordinates and axis lines, in the
  JAX mesh's ``reshape((dp, region, branch))`` order;
- the divisibility messages, the JAX ``MeshPlacement``'s;
- forward parity at dp 2 and 4 against one device (rtol 2e-5, atol 2e-6,
  ``tests/test_parallel.py``'s);
- the composed ``multicity`` fleet (``composed_config``) at dp=4 against
  the port's single-device twin, JAX's twin and JAX's dp=8 mesh run, from
  one initial state: per-epoch losses rtol 2e-5 (JAX's own mesh-vs-twin
  tolerance, ``tests/test_multichip_exec.py`` ``FLEET_RTOL``: the dp sum
  reassociates the loss and gradient sums), final parameters rtol 5e-4,
  atol 2e-5 (``tests/test_parallel.py:96-104``);
- the padded tail batch: each rank's loss over the global count sums to
  the single-device mean, which a local denominator misses; a dp=2
  trainer over a split with a padded tail equals one device;
- the LSTM's weight gradients of rows split 2 and 4 ways, summed, equal
  the whole batch's (``sharded_fused_lstm``'s counterpart: no collective
  in ``FusedLSTM``'s backward);
- the trainer's opt-in features at dp=2 against their one-device twins
  (``tests/_torch_rank_worker.py`` ``FEATURE_RUNS``): the divergence guard
  with a fault plan (poison, drop) trips at the twin's steps; the health
  rows equal the twin's (norms rtol 1e-5) and only the lead writes
  ``health.jsonl``; the index sanitizers run clean; a bf16 run with
  ``sr_seed`` and ``debug_nans`` tracks the twin (its parameter updates
  normwise within 1e-2, ``tests/test_torch_bf16_train.py``'s bf16 rule).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_rank_worker as ranks  # noqa: E402

from stmgcn_tpu.parallel import MeshPlacement as JaxMeshPlacement  # noqa: E402
from stmgcn_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from stmgcn_tpu.parallel.compose import composed_trainer as jax_composed  # noqa: E402
from stmgcn_tpu_torch.config import MeshConfig  # noqa: E402
from stmgcn_tpu_torch.experiment import build_trainer  # noqa: E402
from stmgcn_tpu_torch.models.params import from_jax_params  # noqa: E402
from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm_autograd  # noqa: E402
from stmgcn_tpu_torch.parallel import MeshPlacement, composed_trainer, mesh_from_config  # noqa: E402
from stmgcn_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from stmgcn_tpu_torch.train.step import masked_loss  # noqa: E402

torch.set_num_threads(1)

FWD = dict(rtol=2e-5, atol=2e-6)
LOSS_RTOL = 2e-5
PARAMS = dict(rtol=5e-4, atol=2e-5)
#: a bf16 run's parameter updates, normwise (tests/test_torch_bf16_train.py)
UPDATE = dict(rtol=1e-2)


def _single_forward(args):
    sup, x, _ = ranks._problem(args)
    return ranks._model(args)(torch.from_numpy(sup), torch.from_numpy(x)).detach().numpy()


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """Two ranks: the mesh, the forward, and a dp=2 run over a padded tail
    from the single-device run's initial state."""
    root = tmp_path_factory.mktemp("dp2")
    single = build_trainer(ranks.tiny_config(root / "single"), device="cpu", verbose=False)
    init = {k: v.clone() for k, v in single.model.state_dict().items()}
    batches = list(single.batches("train"))
    history = single.train()
    twins = ranks.feature_twins(root / "ftwin", init)
    out = ranks.launch(2, ["mesh_info", "forward", "train_tiny", "features"], root,
                       mesh=(2, 1, 1), dp=2, initial_state=init, feat_mesh=(2, 1, 1),
                       feat_init=init)
    return out, (batches, history, ranks._state(single)), twins


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    """Four ranks: the mesh, the forward, and the composed multicity fleet
    at dp=4 from JAX's initial state; JAX's twin and dp=8 mesh run; the
    port's twin."""
    root = tmp_path_factory.mktemp("dp4")
    jtwin = jax_composed("multicity", twin="single", out_dir=str(root / "jtwin"))
    init = from_jax_params(jax.tree.map(np.asarray, jtwin.params), 3)
    jmesh = jax_composed("multicity", out_dir=str(root / "jmesh"))
    jax_runs = {"twin": (jtwin.train(), jtwin), "mesh": (jmesh.train(), jmesh)}
    twin = composed_trainer("multicity", twin="single", out_dir=str(root / "twin"),
                            device="cpu", initial_state=init)
    port_twin = (twin.train(), ranks._state(twin), twin.train_path)
    out = ranks.launch(4, ["mesh_info", "forward", "composed"], root, mesh=(4, 1, 1),
                       preset="multicity", dp=4, initial_state=init)
    return out, port_twin, jax_runs


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_shape_and_rank_coords(dp2, dp4, world):
    out = (dp2 if world == 2 else dp4)[0]
    grid = np.arange(world).reshape(world, 1, 1)  # JAX's reshape((dp, region, branch))
    for rank, res in enumerate(out):
        info = res["mesh_info"]
        assert info["shape"] == {"dp": world, "region": 1, "branch": 1}
        assert info["rank"] == rank and info["backend"] == "gloo"
        want = dict(zip(("dp", "region", "branch"), np.argwhere(grid == rank)[0].tolist()))
        assert info["coords"] == want
        assert info["lines"] == {"dp": tuple(range(world)), "region": (rank,),
                                 "branch": (rank,)}


def _fake_mesh(dp, region=1, branch=1, rank=0):
    coords = dict(zip(("dp", "region", "branch"),
                      (int(c) for c in np.unravel_index(rank, (dp, region, branch)))))
    return Mesh(dp, region, branch, rank, coords, {}, {}, "gloo", torch.device("cpu"))


def test_divisibility_messages_match_jax():
    port = MeshPlacement(_fake_mesh(4, branch=2))
    jax_pl = JaxMeshPlacement(jax_build_mesh(dp=4, region=1, branch=2))
    for args in ((16, 9, 4), (6, 9, 4), (16, 9, 3)):
        errs = []
        for pl in (port, jax_pl):
            try:
                pl.check_divisibility(*args[:2], m_graphs=args[2])
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], args
    with pytest.raises(ValueError, match="batch_size 6 not divisible by dp=4"):
        port.check_divisibility(6, 9)
    region = MeshPlacement(_fake_mesh(2, region=2))
    jax_region = JaxMeshPlacement(jax_build_mesh(dp=2, region=2))
    for args in ((16, 9), (16, 10), (5, 10)):
        errs = []
        for pl in (region, jax_region):
            try:
                pl.check_divisibility(*args)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], args
    with pytest.raises(ValueError, match="unknown array kind"):
        port.put(np.ones(4), "gradients")


def test_placement_slices_by_kind():
    pl = MeshPlacement(_fake_mesh(2, branch=3, rank=4))  # dp 1, branch 1
    assert pl.mesh.coords == {"dp": 1, "region": 0, "branch": 1}
    x = np.arange(8 * 2).reshape(8, 2)
    np.testing.assert_array_equal(pl.put(x, "x"), x[4:])
    np.testing.assert_array_equal(pl.put(x.T, "index"), x.T[:, 4:])
    np.testing.assert_array_equal(pl.put(x, "series"), x)
    sup = np.arange(3 * 2).reshape(3, 2)
    np.testing.assert_array_equal(pl.put(sup, "supports"), sup[1:2])
    state = {"branches.w": torch.arange(6.0).reshape(3, 2), "head.bias": torch.ones(1)}
    got = pl.put(state, "state")
    assert got["branches.w"].tolist() == [[2.0, 3.0]] and got["head.bias"].tolist() == [1.0]


def test_mesh_from_config_single_is_none_and_world_must_match():
    assert mesh_from_config(MeshConfig()) is None
    with pytest.raises(ValueError, match="needs 8 ranks, but this job has 1"):
        mesh_from_config(MeshConfig(dp=8))


@pytest.mark.parametrize("world", [2, 4])
def test_forward_matches_single_device(dp2, dp4, world):
    out = (dp2 if world == 2 else dp4)[0]
    want = _single_forward({"mesh": (world, 1, 1)})
    for res in out:
        np.testing.assert_allclose(res["forward"]["pred"].numpy(), want, **FWD)


def test_multicity_fleet_trajectory_matches_twins_and_jax(dp4):
    out, (twin_hist, twin_state, twin_path), jax_runs = dp4
    assert twin_path == "fleet_superstep"
    for res in out:
        got = res["composed"]
        assert got["path"] == "fleet_superstep"
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], twin_hist[mode], rtol=LOSS_RTOL)
            for jhist, _ in jax_runs.values():
                np.testing.assert_allclose(got["history"][mode], jhist[mode], rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), twin_state[name].numpy(), **PARAMS,
                                       err_msg=name)
        for _, jt in jax_runs.values():
            want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
            for name, value in got["state"].items():
                np.testing.assert_allclose(value.numpy(), want[name].numpy(), **PARAMS,
                                           err_msg=name)
    assert jax_runs["mesh"][1]._meshy  # JAX's side ran its dp=8 mesh


def test_padded_tail_loss_needs_the_global_denominator():
    rng = np.random.default_rng(5)
    pred, y = (torch.from_numpy(rng.standard_normal((4, 9, 1)).astype(np.float32))
               for _ in range(2))
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])  # a padded tail batch
    whole = masked_loss("mse", pred, y, mask)
    halves = [slice(0, 2), slice(2, 4)]
    summed = sum(masked_loss("mse", pred[r], y[r], mask, rows=r) for r in halves)
    np.testing.assert_allclose(summed.item(), whole.item(), rtol=1e-6)
    local = sum(masked_loss("mse", pred[r], y[r], mask[r]) for r in halves)
    assert abs(local.item() - whole.item()) > 1e-3 * whole.item()


def test_dp2_training_over_a_padded_tail_matches_single_device(dp2):
    out, (batches, history, state), _ = dp2
    assert any(b.n_real < len(b) for b in batches)  # the split ends in a padded batch
    for res in out:
        got = res["train_tiny"]
        assert got["path"] == "per_step"  # a mesh under "auto" streams (the JAX rule)
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], history[mode], rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), state[name].numpy(), **PARAMS,
                                       err_msg=name)


@pytest.mark.parametrize("splits", [2, 4])
def test_lstm_weight_grads_of_row_splits_sum_to_the_whole(splits):
    rng = np.random.default_rng(splits)
    M, R, T, L, H = 3, 16, 5, 2, 8

    def t(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32))

    x, wh, wx, b, cot = t(M, R, T, 4 * H), t(M, L, H, 4 * H), t(M, L - 1, H, 4 * H), \
        t(M, L - 1, 4 * H), t(M, R, T, H)

    def weight_grads(rows):
        ws = [w.clone().requires_grad_() for w in (wh, wx, b)]
        out, _, _ = fused_lstm_autograd(x[:, rows].contiguous(), *ws)
        (out * cot[:, rows]).sum().backward()
        return [w.grad for w in ws]

    whole = weight_grads(slice(None))
    n = R // splits
    parts = [weight_grads(slice(i * n, (i + 1) * n)) for i in range(splits)]
    for k, want in enumerate(whole):
        np.testing.assert_allclose(sum(p[k] for p in parts).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_guard_and_fault_plan_at_dp2_match_the_twin(dp2):
    twin = dp2[2]["guarded"]
    assert twin["trips"] == [(1, ranks.POISON_STEP)]
    for res in dp2[0]:
        got = res["features"]["guarded"]
        assert got["trips"] == twin["trips"] and got["path"] == "series_superstep"
        ranks.check_run(got, twin, LOSS_RTOL, PARAMS)


def test_health_at_dp2_matches_the_twin(dp2):
    for res in dp2[0]:
        ranks.check_health(res["features"]["guarded"], dp2[2]["guarded"], LOSS_RTOL, 1e-5)


def test_sr_seed_and_debug_nans_at_dp2_match_the_twin(dp2):
    for res in dp2[0]:
        ranks.check_run(res["features"]["rounded"], dp2[2]["rounded"], LOSS_RTOL, UPDATE,
                        init=dp2[2]["init"])
        for name, value in res["features"]["shadow"].items():  # replicated: the twin's draw
            assert torch.equal(value, dp2[2]["shadow"][name]), name

