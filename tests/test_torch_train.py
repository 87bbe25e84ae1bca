"""The port's training slice against the JAX package's.

Each part gets the same numpy inputs as its JAX counterpart:

- ``make_optimizer`` against the optax chain over several steps, with and
  without clipping, L2 and the cosine schedule (rtol 1e-6, atol 1e-6,
  parameters of magnitude ~1 over 8 steps: torch's Adam and optax's
  evaluate the same formula with the bias corrections applied in another
  order, and the clip's norm sums the squares in another order, each a
  few float32 ulps per step);
- the masked losses against the JAX ``loss_fn`` (rtol 1e-6: the same
  float32 sums), and the window gather array-equal;
- every parameter's gradient of a shrunk ``default`` flagship (M=3, L=2,
  H=16) against ``jax.grad`` (rtol 1e-4, atol 1e-6: the backward sums
  many float32 products in other orders in the two frameworks), through
  the layered LSTM and through the kernel route's autograd Function;
- a two-epoch ``Trainer`` run against the JAX ``Trainer`` (default ``xla``
  LSTM backend) from the same converted initial weights, per-step and in
  3-step blocks, shuffle on: epoch losses rtol 2e-5, test metrics rtol
  5e-5, parameters atol 2e-5 (40 Adam steps carry the gradients' float32
  rounding differences; measured about 4e-6, 7e-6 and 1.2e-6).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.train.step import _raw_step_bodies
from stmgcn_tpu.train.step import gather_window_batch as jax_gather_window_batch
from stmgcn_tpu.train.step import make_optimizer as jax_make_optimizer
from stmgcn_tpu_torch import ExperimentConfig, build_trainer, from_jax_params, preset, run
from stmgcn_tpu_torch.config import TrainConfig
from stmgcn_tpu_torch.models import STMGCN
from stmgcn_tpu_torch.ops.lstm import StackedLSTM
from stmgcn_tpu_torch.train import gather_window_batch, make_optimizer, masked_loss
from stmgcn_tpu_torch.train.step import lr_schedule

torch.set_num_threads(1)

# the module (the package re-exports a function of the same name)
port_fused_lstm = importlib.import_module("stmgcn_tpu_torch.ops.fused_lstm")


# -- optimizer -------------------------------------------------------------

OPTIMIZERS = {
    "adam": dict(lr=2e-3),
    "adam_l2": dict(lr=2e-3, weight_decay=1e-4),
    "clip_l2": dict(lr=1e-2, weight_decay=1e-3, grad_clip_norm=0.5),
    "cosine": dict(lr=5e-3, weight_decay=1e-4, schedule="cosine", warmup_steps=2,
                   decay_steps=6, min_lr_fraction=0.1),
    "cosine_clip_nowarmup": dict(lr=5e-3, schedule="cosine", decay_steps=5,
                                 grad_clip_norm=3.0),
    "cosine_warmup_clip_l2": dict(lr=5e-3, weight_decay=1e-4, schedule="cosine",
                                  warmup_steps=2, decay_steps=7, min_lr_fraction=0.1,
                                  grad_clip_norm=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    kw = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * (3.0 if s % 2 else 0.2)).astype(np.float32)
              for k, v in params.items()} for s in range(8)]
    tx = jax_make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), **kw)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)


def test_schedule_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10, 1e-4)
    ours = lr_schedule(1e-3, "cosine", 3, 10, 0.1)
    for step in range(14):
        assert ours(step) == pytest.approx(float(sched(step)), rel=1e-6, abs=1e-12)


def test_optimizer_rejects_what_the_jax_one_rejects():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="decay_steps"):
        make_optimizer(p, 1e-3, schedule="cosine")
    with pytest.raises(ValueError, match="only apply"):
        make_optimizer(p, 1e-3, warmup_steps=2)
    with pytest.raises(ValueError, match="grad_clip_norm"):
        make_optimizer(p, 1e-3, grad_clip_norm=0.0)


# -- loss and gather -------------------------------------------------------

class _Identity:
    """A stand-in flax model whose prediction is its input, so the JAX
    ``loss_fn`` can be called on a given prediction."""

    def apply(self, params, supports, x, n_real=None):
        return x


@pytest.mark.parametrize("kind", ["mse", "mae", "huber"])
@pytest.mark.parametrize("horizon", [1, 3])
@pytest.mark.parametrize("node_mask", [False, True])
def test_masked_loss_matches_jax_loss_fn(kind, horizon, node_mask):
    rng = np.random.default_rng(1)
    B, N, C = 5, 7, 2
    shape = (B, N, C) if horizon == 1 else (B, horizon, N, C)
    pred = (rng.normal(size=shape) * 2).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32)
    mask = (np.arange(B) < 3).astype(np.float32)
    if node_mask:
        mask = mask[:, None] * (np.arange(N) < 5).astype(np.float32)[None, :]
    _, _, eval_step, _ = _raw_step_bodies(_Identity(), optax.adam(1e-3), kind)
    want, _ = eval_step(None, None, jnp.asarray(pred), jnp.asarray(y), jnp.asarray(mask))
    got = masked_loss(kind, *map(torch.from_numpy, (pred, y, mask)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("horizon", [1, 3])
def test_gather_window_batch_equals_jax(horizon):
    rng = np.random.default_rng(2)
    series = rng.normal(size=(200, 6, 1)).astype(np.float32)
    targets = np.arange(30, 150, 3).astype(np.int32)
    offsets = np.array([-24, -3, -2, -1], np.int32)
    idx = rng.permutation(len(targets))[:9]
    want = jax_gather_window_batch(*map(jnp.asarray, (series, targets, offsets, idx)), horizon)
    got = gather_window_batch(*map(torch.from_numpy, (series, targets, offsets, idx)), horizon)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- model gradients -------------------------------------------------------

K, N, T, C, B = 3, 9, 5, 1, 4
SHRUNK = dict(m_graphs=3, n_supports=K, seq_len=T, input_dim=C, lstm_hidden_dim=16,
              lstm_num_layers=2, gcn_hidden_dim=16)


def _grad_case():
    rng = np.random.default_rng(4)
    supports = (rng.normal(size=(3, K, N, N)) * 0.3).astype(np.float32)
    x = rng.uniform(size=(B, T, N, C)).astype(np.float32)
    y = rng.uniform(size=(B, N, C)).astype(np.float32)
    mask = (np.arange(B) < 3).astype(np.float32)
    jmod = JaxSTMGCN(**SHRUNK)
    params = jmod.init(jax.random.key(0), jnp.asarray(supports), jnp.asarray(x))
    _, _, eval_step, _ = _raw_step_bodies(jmod, optax.adam(1e-3), "mse")
    args = tuple(map(jnp.asarray, (supports, x, y, mask)))
    grads = jax.grad(lambda p: eval_step(p, *args)[0])(params)
    model = STMGCN(**SHRUNK, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), 3))
    return model, (supports, x, y, mask), from_jax_params(jax.tree.map(np.asarray, grads), 3)


def _port_grads(model, case):
    supports, x, y, mask = map(torch.from_numpy, case)
    model.zero_grad(set_to_none=True)
    masked_loss("mse", model(supports, x), y, mask).backward()
    return {name: p.grad for name, p in model.named_parameters()}


@pytest.fixture(params=["layered", "fused"])
def lstm_route(request, monkeypatch):
    """``fused``: the model's LSTM takes the kernel route (``FusedLSTM``,
    its kernels' plain versions on the CPU) instead of the layered one."""
    if request.param == "fused":
        monkeypatch.setattr(StackedLSTM, "forward", StackedLSTM.fused)
    return request.param


def test_model_gradients_match_jax_grad(lstm_route):
    model, case, want = _grad_case()
    got = _port_grads(model, case)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_kernel_route_gives_every_parameter_a_gradient(monkeypatch):
    """Regression test for the CUDA route leaving ``.grad`` as ``None`` on
    every LSTM weight, the layer-0 projection and everything upstream: the
    kernel returns fresh tensors with no autograd history, which this test
    imitates on the CPU by detaching the forward's outputs."""
    plain = port_fused_lstm.fused_lstm

    def like_the_kernel(*args, **kw):
        return tuple(t.detach() for t in plain(*args, **kw))

    monkeypatch.setattr(port_fused_lstm, "fused_lstm", like_the_kernel)
    monkeypatch.setattr(StackedLSTM, "forward", StackedLSTM.fused)
    model, case, want = _grad_case()
    got = _port_grads(model, case)
    missing = [name for name, g in got.items() if g is None]
    assert not missing
    for name, g in got.items():
        assert torch.isfinite(g).all() and g.abs().sum() > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# -- the trainer -----------------------------------------------------------

def _configs(steps_per_superstep, out_dir):
    cfg = jax_preset("default")
    cfg.data.rows = 5
    cfg.data.n_timesteps = 24 * 7 * 2 + 60
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 16
    cfg.model.lstm_num_layers = 2
    cfg.train.epochs = 2
    cfg.train.batch_size = 8
    cfg.train.shuffle = True
    cfg.train.steps_per_superstep = steps_per_superstep
    cfg.train.out_dir = str(out_dir)
    port = cfg.to_dict()
    port["train"]["out_dir"] = str(out_dir / "port")  # its own checkpoints
    return cfg, ExperimentConfig.from_dict(port)


@pytest.mark.parametrize("steps_per_superstep", [1, 3])
def test_trainer_matches_jax_trainer(tmp_path, steps_per_superstep):
    jax_cfg, cfg = _configs(steps_per_superstep, tmp_path)
    jax_trainer = jax_build_trainer(jax_cfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jax_trainer.params), 3)
    jax_history = jax_trainer.train()
    jax_results = jax_trainer.test()

    trainer = build_trainer(cfg, device="cpu", initial_state=init, verbose=False)
    batches = list(trainer.dataset.batches("train", 8, pad_last=True))
    assert batches[-1].n_real < 8 and len(batches) % 3  # padded tail, short last block
    history = trainer.train()
    results = trainer.test()

    assert trainer.global_step == trainer.optimizer.count == 2 * len(batches)
    for mode in ("train", "validate"):
        np.testing.assert_allclose(history[mode], jax_history[mode], rtol=2e-5)
    for mode in ("train", "test"):
        for metric, value in jax_results[mode].items():
            np.testing.assert_allclose(results[mode][metric], value, rtol=5e-5,
                                       err_msg=f"{mode} {metric}")
    want = from_jax_params(jax.tree.map(np.asarray, jax_trainer.params), 3)
    for name, value in trainer.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)


def test_superstep_blocks_equal_per_step_bitwise(tmp_path):
    """S only sets how often losses are read back: same arithmetic."""
    runs = []
    for s in (1, 4):
        cfg = preset("smoke")
        cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 + 80
        cfg.train.epochs, cfg.train.batch_size = 2, 16
        cfg.train.shuffle, cfg.train.steps_per_superstep = True, s
        cfg.train.out_dir = str(tmp_path / f"s{s}")
        trainer = build_trainer(cfg, device="cpu", verbose=False)
        runs.append((trainer.train(), trainer.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())


def test_run_trains_and_tests_on_the_cpu(tmp_path):
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 + 80
    cfg.train.epochs, cfg.train.batch_size = 2, 16
    cfg.train.out_dir = str(tmp_path)
    out = run(cfg, device="cpu", verbose=False)
    assert len(out["history"]["train"]) == 2
    assert np.isfinite(out["history"]["validate"]).all()
    assert set(out["results"]) == {"train", "test"}
    assert all(np.isfinite(v) for r in out["results"].values() for v in r.values())


def test_test_needs_training_or_live_parameters(tmp_path):
    """Before training there is no best.ckpt to read: only the live
    parameters can be tested."""
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 + 80
    cfg.train.out_dir = str(tmp_path)
    trainer = build_trainer(cfg, device="cpu", verbose=False)
    with pytest.raises(FileNotFoundError, match="best.ckpt"):
        trainer.test()
    with pytest.raises(FileNotFoundError, match="other.ckpt"):
        trainer.test(checkpoint=str(tmp_path / "other.ckpt"))
    assert set(trainer.test(modes=("test",), checkpoint=None)) == {"test"}


# -- config ----------------------------------------------------------------

@pytest.mark.parametrize("field,value", [
    ("precision", "fp16"), ("sr_seed", 3),
    ("checks", "bogus"), ("prefetch", -1),
    ("data_placement", "disk"), ("window_free", True),
])
def test_unported_train_field_raises(field, value):
    """A training field the port refuses names itself. The placement
    fields are ported, so what stays refused is what the JAX trainer
    refuses too: a negative prefetch, an unknown placement, and
    ``window_free=True`` over streamed data."""
    fields = {field: value}
    if field == "window_free":
        fields["data_placement"] = "stream"
    with pytest.raises(ValueError, match=f"train.{field}"):
        TrainConfig(**fields)
    d = jax_preset("default").to_dict()
    d["train"].update(fields)
    with pytest.raises(ValueError, match=f"train.{field}"):
        ExperimentConfig.from_dict(d)


def test_jax_config_dict_reads_with_its_train_section():
    jax_cfg = jax_preset("smoke")
    jax_cfg.train.lr, jax_cfg.train.grad_clip_norm = 1e-3, 2.0
    cfg = ExperimentConfig.from_dict(jax_cfg.to_dict())
    assert (cfg.train.epochs, cfg.train.batch_size) == (5, 32)
    assert (cfg.train.lr, cfg.train.grad_clip_norm) == (1e-3, 2.0)
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg


@pytest.mark.parametrize("edits,match", [
    ({"mesh": {"dp": 2}}, "needs 2 ranks, but this job has 1"),
    ({"mesh": {"dp": 2}, "model": {"tiled": True}}, "does not compose"),
    ({"model": {"tiled": True, "sparse": True}}, "mutually exclusive"),
], ids=["mesh-dp-2", "model-tiled-True", "model-sparse-True"])
def test_build_trainer_refuses_unported_layouts(edits, match):
    d = jax_preset("smoke").to_dict()
    d["data"].update(rows=4, n_timesteps=24 * 7 + 80)
    for section, fields in edits.items():
        d[section].update(fields)
    with pytest.raises(ValueError, match=match):
        build_trainer(ExperimentConfig.from_dict(d), device="cpu", verbose=False)
