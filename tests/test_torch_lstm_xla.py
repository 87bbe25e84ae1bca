"""The xla form of the LSTM kernels (``lstm_backend="xla"``, the JAX
package's default bf16 LSTM) against the JAX package.

On the CPU the port's kernel route runs the kernels' plain versions
(``ops/fused_lstm.py``), which take the xla form's rounding sites; the JAX
``StackedLSTM`` runs its scan (``"xla"``) or its Pallas kernel in
interpret mode (``"pallas"``). Inputs and cotangents come from numpy
seeds; the weights are the JAX init's, converted.

The bound: at bf16, the port's xla form must lie within one tenth of the
JAX package's own pallas-vs-xla gap, measured in the same test on the
same weights and inputs (the largest output difference, and each
parameter gradient normwise), on the layered and the fused schedule; the
port's pallas form, as a control, must miss that bound. Under stochastic
rounding the parameters are a bf16 shadow and the gradients are summed in
bf16 carries, as the JAX scan sums them; there both packages take the same
shadow (the same noise) and agree to the bf16 gradients' own rounding.
At float32 the two JAX backends agree to float32 rounding, and the port
runs one kernel for both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.models.params import sr_cast_bf16 as jax_sr_cast_bf16
from stmgcn_tpu.ops.lstm import StackedLSTM as JaxStackedLSTM
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.train.step import _raw_step_bodies
from stmgcn_tpu.train.step import make_optimizer as jax_make_optimizer
import stmgcn_tpu.models.params as jax_params_module
from stmgcn_tpu_torch import Forecaster, from_jax_params
from stmgcn_tpu_torch.experiment import build_dataset, build_supports
from stmgcn_tpu_torch.models import STMGCN, to_jax_params
from stmgcn_tpu_torch.models.params import sr_cast_bf16
from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm_autograd
from stmgcn_tpu_torch.ops.layers import branch_view
from stmgcn_tpu_torch.ops.lstm import StackedLSTM
from stmgcn_tpu_torch.train import make_optimizer, train_step
import stmgcn_tpu_torch.train.step as port_step

torch.set_num_threads(1)

BF = torch.bfloat16
#: the port's xla form against the JAX one, as a share of the JAX
#: pallas-vs-xla gap
GAP_SHARE = 0.1
#: the bf16 shadow's gradients (bf16 values): the two packages may differ
#: where a float32 sum in another order flips one of their roundings
SHADOW_GRAD_NORM = 2.0**-8
#: one training step: the bf16 model tests' tolerances
LOSS_RTOL, GRAD_NORM = 1e-3, 2.0**-8
H, L, T, ROWS, F = 16, 3, 6, 24, 2


def _lstm_inputs():
    x = np.random.default_rng(0).normal(size=(ROWS, T, F)).astype(np.float32)
    cot = np.random.default_rng(1).normal(size=(ROWS, T, H)).astype(np.float32)
    return x, cot


def _jax_lstm(backend, fused, x, cot, params=None, layers=L):
    """``(params, output, gradients)`` of the JAX StackedLSTM at bf16."""
    model = JaxStackedLSTM(hidden_dim=H, num_layers=layers, dtype=jnp.bfloat16,
                           backend=backend, fused_scan=fused)
    if params is None:
        params = model.init(jax.random.key(0), jnp.asarray(x))["params"]

    def loss(p):
        out, _ = model.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out.astype(jnp.float32) * cot)

    out, _ = model.apply({"params": params}, jnp.asarray(x))
    grads = jax.grad(loss)(params)
    return params, np.asarray(out.astype(jnp.float32)), {
        k: np.asarray(v.astype(jnp.float32)) for k, v in grads.items()}


def _port_lstm(params, backend, fused, x, cot, layers=L):
    lstm = StackedLSTM(F, H, layers, backend=backend, fused_scan=fused, device="cpu")
    lstm.compute_dtype = BF
    lstm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    out, _ = lstm(torch.from_numpy(x))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out.detach().float().numpy(), {n: p.grad.numpy() for n, p in lstm.named_parameters()}


def _hold_to_the_gap(port, port_control, jax_xla, jax_pallas):
    """The bound on the output (largest difference) and on every gradient
    (normwise), and the control's miss of it wherever the JAX gap is not
    zero."""
    (out, grads), (c_out, c_grads) = port, port_control
    (j_out, j_grads), (p_out, p_grads) = jax_xla, jax_pallas
    gap = np.abs(p_out - j_out).max()
    assert gap > 0 and np.abs(out - j_out).max() <= GAP_SHARE * gap
    assert np.abs(c_out - j_out).max() > GAP_SHARE * gap  # the control misses
    for name, g in grads.items():
        gap = np.linalg.norm(p_grads[name] - j_grads[name])
        assert np.linalg.norm(g - j_grads[name]) <= GAP_SHARE * gap, name
        if gap > 0:
            assert np.linalg.norm(c_grads[name] - j_grads[name]) > GAP_SHARE * gap, name


@pytest.mark.parametrize("fused", [False, True])
def test_stacked_lstm_xla_form_matches_jax_xla(fused):
    """Layered (``lstm_fused_scan=False``: the biases and each input
    weight's gradient rounded once through bf16) and fused (the float32
    bias masters, each step's input-weight gradient rounded) schedules."""
    x, cot = _lstm_inputs()
    params, j_out, j_grads = _jax_lstm("xla", fused, x, cot)
    _, p_out, p_grads = _jax_lstm("pallas", False, x, cot, params)
    _hold_to_the_gap(_port_lstm(params, "xla", fused, x, cot),
                     _port_lstm(params, "pallas", False, x, cot),
                     (j_out, j_grads), (p_out, p_grads))


def test_xla_form_across_two_layer_groups_matches_jax_xla():
    """Five layers take two launches each way (groups of at most four),
    the second group's x_proj0 the JAX layered scan's own hoisted
    projection, and H=16 is padded to the kernels' 32."""
    x, cot = _lstm_inputs()
    params, j_out, j_grads = _jax_lstm("xla", False, x, cot, layers=5)
    _, p_out, p_grads = _jax_lstm("pallas", False, x, cot, params, layers=5)
    _hold_to_the_gap(_port_lstm(params, "xla", False, x, cot, layers=5),
                     _port_lstm(params, "pallas", False, x, cot, layers=5),
                     (j_out, j_grads), (p_out, p_grads))


@pytest.mark.parametrize("fused", [False, True])
def test_stacked_lstm_xla_form_over_a_bf16_shadow_matches_jax(fused):
    """Stochastic rounding hands the LSTM a bf16 shadow of its parameters:
    the JAX scan then sums the weight gradients in bf16 carries (and the
    fused scan rounds each step's bias gradient), which the port's form
    does too. Both packages take the same shadow, from the same noise."""
    x, cot = _lstm_inputs()
    params, _, _ = _jax_lstm("xla", fused, x, cot)
    rng = np.random.default_rng(5)
    noise = {k: rng.integers(0, 1 << 16, size=np.shape(v), dtype=np.uint32)
             for k, v in params.items()}
    shadow = {k: jax_sr_cast_bf16(v, jnp.asarray(noise[k])) for k, v in params.items()}
    model = JaxStackedLSTM(hidden_dim=H, num_layers=L, dtype=jnp.bfloat16, fused_scan=fused)

    def loss(p):
        out, _ = model.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out.astype(jnp.float32) * cot)

    want_out, _ = model.apply({"params": shadow}, jnp.asarray(x))
    want = jax.grad(loss)(shadow)
    lstm = StackedLSTM(F, H, L, fused_scan=fused, device="cpu")
    lstm.compute_dtype = BF
    port = {k: sr_cast_bf16(torch.tensor(np.asarray(v)), torch.from_numpy(
        noise[k].astype(np.int64))).requires_grad_(True) for k, v in params.items()}
    out, _ = torch.func.functional_call(lstm, port, (torch.from_numpy(x),))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want_out.astype(jnp.float32)), rtol=0, atol=1e-6)
    for k, v in port.items():
        assert v.grad.dtype == BF and want[k].dtype == jnp.bfloat16, k
        g, w = v.grad.float().numpy(), np.asarray(want[k].astype(jnp.float32))
        assert np.linalg.norm(g - w) <= SHADOW_GRAD_NORM * np.linalg.norm(w), k


# -- the whole model -------------------------------------------------------------

def _smoke_model_case():
    """The smoke preset's widths (``stmgcn_tpu/config.py`` ``smoke``) on a
    16-node city."""
    cfg = jax_preset("smoke").model
    n = 16
    kw = dict(m_graphs=cfg.m_graphs, n_supports=cfg.n_supports, seq_len=5, input_dim=1,
              lstm_hidden_dim=cfg.lstm_hidden_dim, lstm_num_layers=cfg.lstm_num_layers,
              gcn_hidden_dim=cfg.gcn_hidden_dim)
    rng = np.random.default_rng(0)
    sup = (rng.normal(size=(cfg.m_graphs, cfg.n_supports, n, n)) * 0.3).astype(np.float32)
    obs = rng.uniform(size=(4, 5, n, 1)).astype(np.float32)
    return kw, sup, obs


def _jax_model(kw, sup, obs, backend, fused, params=None):
    model = JaxSTMGCN(**kw, lstm_backend=backend, lstm_fused_scan=fused, dtype=jnp.bfloat16)
    if params is None:
        params = model.init(jax.random.key(0), jnp.asarray(sup), jnp.asarray(obs))
    out = model.apply(params, jnp.asarray(sup), jnp.asarray(obs))
    cot = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(model.apply(p, jnp.asarray(sup), jnp.asarray(obs))
                       .astype(jnp.float32) * cot)

    grads = from_jax_params(jax.tree.map(np.asarray, jax.grad(loss)(params)), kw["m_graphs"])
    return params, cot, np.asarray(out.astype(jnp.float32)), {
        k: v.numpy() for k, v in grads.items()}


def _port_model(kw, sup, obs, params, cot, backend, fused):
    model = STMGCN(**kw, lstm_backend=backend, lstm_fused_scan=fused, dtype=BF, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), kw["m_graphs"]))
    out = model(torch.from_numpy(sup), torch.from_numpy(obs))
    assert out.dtype == BF
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out.detach().float().numpy(), {n: p.grad.numpy() for n, p in
                                          model.named_parameters()}


@pytest.mark.parametrize("fused", [False, True])
def test_smoke_model_at_bf16_xla_matches_jax(fused):
    kw, sup, obs = _smoke_model_case()
    params, cot, j_out, j_grads = _jax_model(kw, sup, obs, "xla", fused)
    _, _, p_out, p_grads = _jax_model(kw, sup, obs, "pallas", False, params)
    _hold_to_the_gap(_port_model(kw, sup, obs, params, cot, "xla", fused),
                     _port_model(kw, sup, obs, params, cot, "pallas", False),
                     (j_out, j_grads), (p_out, p_grads))


# -- float32: one function for both backends -------------------------------------

def test_fp32_backends_agree_and_run_one_kernel():
    """The JAX scan and Pallas kernel agree to float32 rounding (1.5e-8 at
    these shapes); the port's two backends are one function, bit for bit,
    within float32 rounding of both."""
    x, _ = _lstm_inputs()
    outs = {}
    for backend in ("xla", "pallas"):
        model = JaxStackedLSTM(hidden_dim=H, num_layers=L, backend=backend)
        params = model.init(jax.random.key(0), jnp.asarray(x))
        outs[backend] = np.asarray(model.apply(params, jnp.asarray(x))[0])
    assert np.abs(outs["xla"] - outs["pallas"]).max() < 1e-6
    port = {}
    for backend in ("xla", "pallas"):
        lstm = StackedLSTM(F, H, L, backend=backend, device="cpu")
        lstm.load_state_dict({k: torch.tensor(np.asarray(v))
                              for k, v in params["params"].items()})
        with torch.no_grad():
            port[backend] = lstm.fused(torch.from_numpy(x))[0]
    assert torch.equal(port["xla"], port["pallas"])
    np.testing.assert_allclose(port["xla"].numpy(), outs["xla"], rtol=1e-5, atol=1e-6)


def test_bf16_pallas_form_is_the_bf16_storage_route():
    """``backend="pallas"`` at bf16 is the bf16-storage kernel route as it
    was: every operand rounded to bf16, ``x_proj0`` a bf16 product plus a
    bf16 bias add, the kernels storing in bf16, bit for bit."""
    x, cot = _lstm_inputs()
    lstm = StackedLSTM(F, H, L, backend="pallas", device="cpu",
                       generator=torch.Generator().manual_seed(3))
    lstm.compute_dtype = BF
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = lstm(xt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    want_grads = [p.grad.clone() for p in lstm.parameters()] + [xt.grad.clone()]
    lstm.zero_grad()
    xt.grad = None
    params = [[p.to(BF) for p in lstm.layer_params(layer)] for layer in range(L)]
    x_proj0 = (xt.to(BF) @ params[0][0] + branch_view(params[0][2], None, 2)).contiguous()
    got, _, _ = fused_lstm_autograd(
        x_proj0, torch.stack([p[1] for p in params]), torch.stack([p[0] for p in params[1:]]),
        torch.stack([p[2] for p in params[1:]]))
    assert got.dtype == BF and torch.equal(got, out)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    for want, p in zip(want_grads, list(lstm.parameters()) + [xt]):
        assert torch.equal(p.grad, want)


# -- one training step -----------------------------------------------------------

def _noise_like(state, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 1 << 16, size=tuple(v.shape)).astype(np.float32)
            for k, v in state.items()}


@pytest.mark.parametrize("sr", [False, True])
def test_bf16_training_step_at_xla_matches_jax(sr, monkeypatch):
    """One ``precision="bf16"`` step of the smoke model, loss and every
    parameter gradient; with stochastic rounding both packages cast the
    masters through the same noise (each package's ``compute_cast``
    replaced by a cast through one shared noise tree)."""
    kw, sup, obs = _smoke_model_case()
    y = np.random.default_rng(2).uniform(size=(4, 16, 1)).astype(np.float32)
    mask = np.ones(4, np.float32)
    jmod = JaxSTMGCN(**kw)
    params = jmod.init(jax.random.key(0), jnp.asarray(sup), jnp.asarray(obs))
    state = from_jax_params(jax.tree.map(np.asarray, params), kw["m_graphs"])
    noise = _noise_like(state, 9)
    if sr:
        jnoise = jax.tree.map(lambda a: jnp.asarray(np.asarray(a).astype(np.uint32)),
                              to_jax_params({k: torch.from_numpy(v) for k, v in noise.items()},
                                            kw["m_graphs"]))

        def jax_cast(tree, dtype, rng=None):
            return jax.tree.map(jax_sr_cast_bf16, tree, jnoise)

        def port_cast(tree, dtype, generator=None):
            return {k: sr_cast_bf16(v, torch.from_numpy(noise[k].astype(np.int64)))
                    for k, v in tree.items()}

        monkeypatch.setattr(jax_params_module, "compute_cast", jax_cast)
        monkeypatch.setattr(port_step, "compute_cast", port_cast)
    _, _, _, full = _raw_step_bodies(jmod, jax_make_optimizer(2e-3, 1e-4), "mse",
                                     precision="bf16")
    args = tuple(map(jnp.asarray, (sup, obs, y, mask)))
    _, _, want_loss, want_grads, _, _ = full(
        params, jax_make_optimizer(2e-3, 1e-4).init(params), *args, None,
        jax.random.key(0) if sr else None)
    want_grads = from_jax_params(jax.tree.map(np.asarray, want_grads), kw["m_graphs"])
    model = STMGCN(**kw, dtype=BF, device="cpu")
    model.load_state_dict(state)
    opt = make_optimizer(model.parameters(), 2e-3, 1e-4)
    step = opt.step
    grads = {}

    def keep():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return step()

    opt.step = keep
    loss = train_step(model, opt, *map(torch.from_numpy, (sup, obs, y, mask)),
                      sr_generator=torch.Generator() if sr else None)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for name, g in grads.items():
        w = want_grads[name].numpy()
        assert g.dtype == torch.float32, name
        assert np.linalg.norm(g.numpy() - w) <= GRAD_NORM * np.linalg.norm(w), name


# -- a JAX checkpoint through Forecaster.from_checkpoint -------------------------

def test_jax_xla_bf16_checkpoint_serves_in_the_xla_form(tmp_path):
    """A JAX trainer at the defaults (``lstm_backend="xla"``) and
    ``model.dtype="bfloat16"`` writes ``best.ckpt``; the port's
    ``Forecaster.from_checkpoint`` builds the xla form from its config and
    serves what the JAX Forecaster serves, within the bf16 serving limits
    (2^-9 of the largest prediction, 2^-13 normwise)."""
    cfg = jax_preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 * 2 + 40
    cfg.model.dtype, cfg.train.epochs = "bfloat16", 1
    cfg.train.batch_size, cfg.train.out_dir = 16, str(tmp_path)
    jax_build_trainer(cfg, verbose=False).train()
    best = str(tmp_path / "best.ckpt")
    fc = Forecaster.from_checkpoint(best, device="cpu")
    lstm = fc.model.branches.cg_lstm.lstm
    assert (fc.config.model.lstm_backend, lstm.backend, lstm.compute_dtype) == ("xla", "xla", BF)
    jfc = JaxForecaster.from_checkpoint(best)
    ds = build_dataset(fc.config)
    supports = build_supports(fc.config, ds)
    history = ds.denormalize(ds.arrays("test")[0][:6])
    got, want = fc.predict(supports, history), np.asarray(jfc.predict(supports, history))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2.0**-9 * scale
    assert np.linalg.norm(got - want) <= 2.0**-13 * np.linalg.norm(want)
