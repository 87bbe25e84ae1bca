"""Branch model parallelism on the port's mesh (dp=2 x branch=3 CPU ranks
over gloo), against one device and against the JAX package.

Mirrors ``tests/test_branch_parallel.py``:

- the 3-axis mesh's coordinates and lines, the JAX reshape order;
- the forward and a loss's gradients, gathered mesh-free, against one
  device (forward rtol 2e-5, atol 2e-6; gradients rtol 1e-4, atol 1e-7:
  the fusion sums the branches in another order);
- :class:`BranchFusion`'s backward is the identity: the same gradients
  under a summing backward (what ``torch.distributed.nn``'s all-reduce
  would give) come out ``branch`` times larger for every branch parameter
  and fail the gradient check; the head's are unchanged;
- the composed ``branchpar`` trainer against the port's single-device
  twin and JAX's (``composed_trainer("branchpar", twin="single")``) from
  JAX's initial state: per-epoch losses rtol 2e-5, final parameters rtol
  5e-4, atol 2e-5 (``tests/test_parallel.py:96-104``);
- the global clip norm: a run whose clip engages at every step (max norm
  0.05) equals one device, and the sync's squared norm is the whole
  gradient's;
- the trainer's opt-in features on this mesh against their one-device
  twins (``tests/_torch_rank_worker.py`` ``FEATURE_RUNS``, the twins held
  against JAX by the one-device tests): the divergence guard with a fault
  plan (a poisoned step, a dropped one) trips at the twin's steps; the
  health rows equal the twin's (norms rtol 1e-5), the branch slices'
  squares summed over ``branch``, and only the lead writes
  ``health.jsonl``; the index sanitizers run clean; stochastic rounding's
  noise on a branch rank is the twin's slice bit for bit, and a bf16 run
  with it and ``debug_nans`` tracks the twin (its parameter updates
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

from stmgcn_tpu.parallel.compose import composed_trainer as jax_composed  # noqa: E402
from stmgcn_tpu_torch.experiment import build_trainer  # noqa: E402
from stmgcn_tpu_torch.models.params import from_jax_params  # noqa: E402
from stmgcn_tpu_torch.parallel import composed_trainer  # noqa: E402
from stmgcn_tpu_torch.train.step import masked_loss  # noqa: E402

torch.set_num_threads(1)

MESH = (2, 1, 3)
FWD = dict(rtol=2e-5, atol=2e-6)
GRADS = dict(rtol=1e-4, atol=1e-7)
LOSS_RTOL, PARAMS = 2e-5, dict(rtol=5e-4, atol=2e-5)
#: a bf16 run's parameter updates, normwise (tests/test_torch_bf16_train.py)
UPDATE = dict(rtol=1e-2)
CLIP = dict(grad_clip_norm=0.05, steps_per_superstep=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("branch")
    jtwin = jax_composed("branchpar", twin="single", out_dir=str(root / "jtwin"))
    init = from_jax_params(jax.tree.map(np.asarray, jtwin.params), 3)
    jax_hist = jtwin.train()
    jax_state = from_jax_params(jax.tree.map(np.asarray, jtwin.params), 3)
    twin = composed_trainer("branchpar", twin="single", out_dir=str(root / "twin"),
                            device="cpu", initial_state=init)
    port_twin = (twin.train(), ranks._state(twin), twin.train_path)
    clip = build_trainer(ranks.tiny_config(root / "clip", **CLIP), device="cpu",
                         verbose=False)
    clip_init = {k: v.clone() for k, v in clip.model.state_dict().items()}
    clip_run = (clip.train(), ranks._state(clip))
    feat_twins = ranks.feature_twins(root / "ftwin", clip_init)
    out = ranks.launch(6, ["mesh_info", "forward", "composed", "train_tiny", "features"],
                       root, mesh=MESH, grads=True, preset="branchpar", initial_state=init,
                       dp=2, branch=3, train=CLIP, tiny_initial_state=clip_init,
                       feat_mesh=MESH, feat_init=clip_init)
    return out, port_twin, (jax_hist, jax_state), clip_run, feat_twins


def test_three_axis_mesh_coords(runs):
    grid = np.arange(6).reshape(2, 1, 3)
    for rank, res in enumerate(runs[0]):
        info = res["mesh_info"]
        d, _, b = np.argwhere(grid == rank)[0].tolist()
        assert info["coords"] == {"dp": d, "region": 0, "branch": b}
        assert info["lines"]["dp"] == tuple(grid[:, 0, b].tolist())
        assert info["lines"]["branch"] == tuple(grid[d, 0, :].tolist())


def _single_grads():
    args = {"mesh": MESH}
    sup, x, y = ranks._problem(args)
    model = ranks._model(args)
    pred = model(torch.from_numpy(sup), torch.from_numpy(x))
    masked_loss("mse", pred, torch.from_numpy(y), torch.ones(x.shape[0])).backward()
    return pred.detach().numpy(), {k: p.grad for k, p in model.named_parameters()}


def test_forward_and_gradients_match_single_device(runs):
    pred, grads = _single_grads()
    for res in runs[0]:
        got = res["forward"]
        np.testing.assert_allclose(got["pred"].numpy(), pred, **FWD)
        for name, want in grads.items():
            np.testing.assert_allclose(got["grads"][name].numpy(), want.numpy(), **GRADS,
                                       err_msg=name)


def test_a_summing_fusion_backward_scales_branch_gradients(runs):
    _, grads = _single_grads()
    for res in runs[0]:
        summing = res["forward"]["grads_summing"]
        for name, want in grads.items():
            if name.startswith("branches."):
                np.testing.assert_allclose(summing[name].numpy(), 3 * want.numpy(), **GRADS,
                                           err_msg=name)
                with pytest.raises(AssertionError):
                    np.testing.assert_allclose(summing[name].numpy(), want.numpy(), **GRADS)
            else:
                np.testing.assert_allclose(summing[name].numpy(), want.numpy(), **GRADS,
                                           err_msg=name)


def test_branchpar_trajectory_matches_twins_and_jax(runs):
    out, (twin_hist, twin_state, twin_path), (jax_hist, jax_state) = runs[:3]
    assert twin_path == "series_superstep"
    for res in out:
        got = res["composed"]
        assert got["path"] == "series_superstep"
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], twin_hist[mode], rtol=LOSS_RTOL)
            np.testing.assert_allclose(got["history"][mode], jax_hist[mode], rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), twin_state[name].numpy(), **PARAMS,
                                       err_msg=name)
            np.testing.assert_allclose(value.numpy(), jax_state[name].numpy(), **PARAMS,
                                       err_msg=name)


def test_global_clip_norm_matches_single_device(runs):
    history, state = runs[3]
    for res in runs[0]:
        got = res["train_tiny"]
        for mode in ("train", "validate"):
            np.testing.assert_allclose(got["history"][mode], history[mode], rtol=LOSS_RTOL)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(), state[name].numpy(), **PARAMS,
                                       err_msg=name)
        np.testing.assert_allclose(got["norm_sq"], got["norm_sq_whole"], rtol=1e-5)


def test_guard_and_fault_plan_on_a_branch_mesh_match_the_twin(runs):
    twin = runs[4]["guarded"]
    assert twin["trips"] == [(1, ranks.POISON_STEP)]
    for res in runs[0]:
        got = res["features"]["guarded"]
        assert got["trips"] == twin["trips"]
        ranks.check_run(got, twin, LOSS_RTOL, PARAMS)


def test_health_on_a_branch_mesh_matches_the_twin(runs):
    for res in runs[0]:
        ranks.check_health(res["features"]["guarded"], runs[4]["guarded"], LOSS_RTOL, 1e-5)


def test_sr_noise_on_a_branch_rank_is_the_twins_slice_bitwise(runs):
    twin = runs[4]["shadow"]
    for res in runs[0]:
        got, keep = res["features"]["shadow"], res["features"]["branches"]
        assert keep.stop - keep.start == 1 and set(got) == set(twin)
        for name, value in got.items():
            want = twin[name][keep] if name.startswith("branches.") else twin[name]
            assert value.dtype == torch.bfloat16 and torch.equal(value, want), name


def test_sr_seed_and_debug_nans_on_a_branch_mesh_match_the_twin(runs):
    for res in runs[0]:
        ranks.check_run(res["features"]["rounded"], runs[4]["rounded"], LOSS_RTOL, UPDATE,
                        init=runs[4]["init"])

