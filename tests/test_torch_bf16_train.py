"""Mixed-precision training (``precision="bf16"``, ``sr_seed``) and its
checkpoints, in the port and across the two packages.

- **Port against JAX**: the JAX trainer at ``precision="bf16"`` with
  ``lstm_backend="pallas"`` (interpret mode) or ``"xla"`` (the default
  scan) and the port's at the same backend (the config carries it) from
  the same converted weights, one epoch. Both run the same bf16 function, which
  differs where an fp32 sum in another order flips a bf16 rounding, and Adam
  divides each step by the gradient's own size, so a flip in a near-zero
  gradient entry moves that entry's step: epoch losses are held at rtol
  5e-4 and each parameter tensor's update normwise, |p - p_jax| <= 1e-2
  |p_jax - p_init| (chip_smoke.py holds card and CPU the same way;
  measured 6e-6 / 6e-5 and 1e-3).
- **Twin drill** (``tests/test_mixed_precision.py:84-116``): the port's
  bf16 steps against its fp32 steps from one state, per-step losses within
  1e-3, no non-finite loss or gradient, the parameters float32 masters.
- **Checkpoints**: float32 masters with ``precision`` (and ``sr_seed``) in
  the meta, read and written by both packages, restorable across
  precisions, and an exact mid-epoch resume at bf16, stochastic rounding
  included (the noise of step k depends on ``(sr_seed, k)`` alone).
"""

import jax
import numpy as np
import pytest
import torch

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.train import load_checkpoint as jax_load_checkpoint
from stmgcn_tpu_torch import ExperimentConfig, build_trainer, from_jax_params
from stmgcn_tpu_torch.models import STMGCN
from stmgcn_tpu_torch.models.params import leaf_dtype_census
from stmgcn_tpu_torch.ops.layers import set_compute_dtype
from stmgcn_tpu_torch.train import make_optimizer, train_step
from stmgcn_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

EPOCH_RTOL, UPDATE_RTOL, TWIN_ATOL = 5e-4, 1e-2, 1e-3


def _jax_cfg(out_dir, **train):
    cfg = jax_preset("default")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 * 2 + 40
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 2
    cfg.train.batch_size, cfg.train.out_dir, cfg.train.epochs = 16, str(out_dir), 1
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _port_cfg(jax_cfg, out_dir, **train):
    d = jax_cfg.to_dict()
    d["train"].update(out_dir=str(out_dir), **train)
    return ExperimentConfig.from_dict(d)


def _port(out_dir, **train):
    return build_trainer(_port_cfg(_jax_cfg(out_dir), out_dir, **train), device="cpu",
                         verbose=False)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bf16_trainer_matches_jax_pallas_bf16_trainer(tmp_path, backend):
    jax_cfg = _jax_cfg(tmp_path / "jax", precision="bf16")
    jax_cfg.model.lstm_backend = backend
    jt = jax_build_trainer(jax_cfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    jh = jt.train()
    pt = build_trainer(_port_cfg(jax_cfg, tmp_path / "port"), device="cpu",
                       initial_state=init, verbose=False)
    assert pt.precision == "bf16" and pt.model.compute_dtype == torch.bfloat16
    assert {m.backend for m in pt.model.modules() if hasattr(m, "backend")} == {backend}
    ph = pt.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(ph[mode], jh[mode], rtol=EPOCH_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    for name, value in pt.model.state_dict().items():
        assert value.dtype == torch.float32, name
        step = (want[name] - init[name]).norm()
        assert (value - want[name]).norm() <= UPDATE_RTOL * step, name


def _drill():
    rng = np.random.default_rng(0)
    m, n, t, b, pool = 2, 9, 5, 4, 12
    sup = torch.from_numpy(rng.standard_normal((m, 3, n, n)).astype(np.float32) * 0.2)
    x_all = torch.from_numpy(rng.standard_normal((pool, t, n, 1)).astype(np.float32))
    y_all = torch.from_numpy(rng.standard_normal((pool, n, 1)).astype(np.float32) * 0.1)
    idx = torch.from_numpy(rng.integers(0, pool, size=(6, b)))
    return sup, x_all, y_all, idx


@pytest.mark.parametrize("layers", [1, 2])
def test_twin_drill_bf16_tracks_fp32(layers):
    sup, x_all, y_all, idx = _drill()
    kw = dict(m_graphs=2, n_supports=3, seq_len=5, input_dim=1, lstm_hidden_dim=8,
              lstm_num_layers=layers, gcn_hidden_dim=8, device="cpu")
    runs = {}
    for dtype in (None, torch.bfloat16):
        model = STMGCN(**kw, generator=torch.Generator().manual_seed(0))
        set_compute_dtype(model, dtype)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-4)
        losses, finite = [], []
        step = opt.step

        def checking(step=step, model=model, finite=finite):
            finite.append(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()))
            step()

        opt.step = checking
        for rows in idx:
            losses.append(train_step(model, opt, sup, x_all[rows], y_all[rows],
                                     torch.ones(len(rows))).item())
        runs[dtype] = (np.array(losses), finite, model)
    l32, _, _ = runs[None]
    l16, finite, model16 = runs[torch.bfloat16]
    assert np.isfinite(l16).all() and all(finite)
    np.testing.assert_allclose(l16, l32, rtol=0, atol=TWIN_ATOL)
    assert leaf_dtype_census(model16.state_dict()).keys() == {"float32"}


# -- checkpoints ---------------------------------------------------------------

def _masters_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_bf16_checkpoint_holds_f32_masters_and_its_precision(tmp_path):
    tr = _port(tmp_path / "run", precision="bf16", sr_seed=9)
    tr.train()
    meta, params, opt_state = ckpt.load_checkpoint(str(tmp_path / "run" / "latest.ckpt"))
    assert (meta["precision"], meta["sr_seed"]) == ("bf16", 9)
    assert leaf_dtype_census(params).keys() == {"float32"}
    fresh = _port(tmp_path / "run", precision="bf16", sr_seed=9)
    assert fresh.restore()["precision"] == "bf16" and _masters_equal(fresh, tr)


@pytest.mark.parametrize("writer,reader", [("fp32", "bf16"), ("bf16", "fp32")])
def test_restore_across_precisions(tmp_path, writer, reader):
    tr = _port(tmp_path / "a", precision=writer)
    tr.train()
    other = _port(tmp_path / "a", precision=reader)
    assert other.restore()["precision"] == writer  # the writer's provenance
    assert _masters_equal(other, tr)


def test_port_bf16_checkpoint_resumes_in_jax_and_back(tmp_path):
    """Both packages' bf16 trainers read the other's bf16 files: the
    parameters and Adam moments land exactly."""
    jax_cfg = _jax_cfg(tmp_path / "jax", precision="bf16", sr_seed=4)
    pt = build_trainer(_port_cfg(jax_cfg, tmp_path / "port"), device="cpu", verbose=False)
    pt.train()
    path = str(tmp_path / "port" / "latest.ckpt")
    jt = jax_build_trainer(jax_cfg, verbose=False)
    meta, params, opt_state = jax_load_checkpoint(path, jt.params, jt.opt_state)
    assert (meta["precision"], meta["sr_seed"]) == ("bf16", 4)
    want = from_jax_params(jax.tree.map(np.asarray, params), 3)
    assert all(torch.equal(v, want[k]) for k, v in pt.model.state_dict().items())
    jt.restore(path)
    jt.n_epochs = 2
    jt.train()  # the JAX trainer goes on from the port's file and writes its own
    back = build_trainer(_port_cfg(jax_cfg, tmp_path / "port2"), device="cpu", verbose=False)
    back_meta = back.restore(str(tmp_path / "jax" / "latest.ckpt"))
    assert back_meta["precision"] == "bf16" and back_meta["epoch"] == 2
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    assert all(torch.equal(v, want[k]) for k, v in back.model.state_dict().items())


@pytest.mark.parametrize("sr_seed", [None, 6])
def test_mid_epoch_resume_is_exact_at_bf16(tmp_path, sr_seed):
    """Run A trains two epochs at bf16 writing latest every 3 steps; run B
    restores A's first mid-epoch file and ends with A's history and
    parameters bit for bit."""
    kw = dict(epochs=2, shuffle=True, steps_per_superstep=2, checkpoint_every_steps=3,
              precision="bf16", sr_seed=sr_seed)
    a = _port(tmp_path / "a", **kw)
    kept, save = [], a._save

    def save_and_keep(path):
        data = save(path)
        if path == a.latest_path and a._batch_in_epoch and not kept:
            kept.append(a._batch_in_epoch)
            ckpt.write_checkpoint_bytes(str(tmp_path / "mid.ckpt"), data)
        return data

    a._save = save_and_keep
    history = a.train()
    assert kept
    b = _port(tmp_path / "b", **kw)
    meta = b.restore(str(tmp_path / "mid.ckpt"))
    assert meta["precision"] == "bf16" and meta.get("sr_seed") == sr_seed
    assert b.train() == history and _masters_equal(a, b)


def test_sr_seed_draws_per_step_noise(tmp_path):
    """Stochastic rounding changes the run and is a function of the seed."""
    runs = {}
    for name, seed in (("a", 6), ("b", 6), ("c", 7)):
        tr = _port(tmp_path / name, precision="bf16", sr_seed=seed)
        runs[name] = [tr.train_batch(b).item() for b in list(tr.batches("train"))[:3]]
    rne = _port(tmp_path / "r", precision="bf16")
    plain = [rne.train_batch(b).item() for b in list(rne.batches("train"))[:3]]
    assert runs["a"] == runs["b"] and runs["a"] != runs["c"] and runs["a"] != plain
    with pytest.raises(ValueError, match="sr_seed"):
        _port(tmp_path / "x", sr_seed=3)
