"""The port's fused LSTM and ``StackedLSTM`` against the JAX package.

On the CPU the port's ``fused_lstm`` is its plain version (the CUDA kernel
is held against that plain version on the card by ``chip_smoke.py``); the
JAX ``fused_lstm`` runs its Pallas kernel in interpret mode, as
``tests/test_pallas_lstm.py`` does. Inputs come from a numpy seed and go
to both packages. Tolerance rtol 1e-5, atol 1e-6: the bound
``tests/test_pallas_lstm.py`` holds the Pallas kernel to against the scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.ops.lstm import StackedLSTM as JaxStackedLSTM
from stmgcn_tpu.ops.pallas_lstm import _fused_fwd as jax_fused_fwd
from stmgcn_tpu.ops.pallas_lstm import fused_lstm as jax_fused_lstm
from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm, fused_lstm_reference
from stmgcn_tpu_torch.ops.lstm import StackedLSTM

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
H, T = 8, 5


def _inputs(rng, lead, R, L):
    scale = 1.0 / np.sqrt(H)

    def uni(*shape):
        return rng.uniform(-scale, scale, size=lead + shape).astype(np.float32)

    x_proj0 = rng.normal(size=lead + (R, T, 4 * H)).astype(np.float32)
    return x_proj0, uni(L, H, 4 * H), uni(max(L - 1, 1), H, 4 * H), uni(max(L - 1, 1), 4 * H)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_fused_lstm_matches_jax_kernel(layers):
    """Ragged R (13 rows: no power-of-two block divides it)."""
    ops = _inputs(np.random.default_rng(layers), (), 13, layers)
    want = jax_fused_lstm(*map(jnp.asarray, ops))
    got = fused_lstm(*map(torch.from_numpy, ops))
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w)


def test_fused_lstm_residuals_match_jax_kernel():
    """``with_residuals`` returns the per-step h/c the TPU kernel stores."""
    R, L = 11, 3
    ops = _inputs(np.random.default_rng(7), (), R, L)
    (out, h_fin, c_fin), (*_, hseq, cseq) = jax_fused_fwd(*map(jnp.asarray, ops))
    got = fused_lstm(*map(torch.from_numpy, ops), with_residuals=True)
    for g, w in zip(got, (out, h_fin, c_fin, hseq[:, :, :R], cseq[:, :, :R])):
        _close(g, w)


def test_fused_lstm_branch_axis_matches_vmapped_jax_kernel():
    """A leading branch axis M runs every branch at once (the vmapped form)."""
    ops = _inputs(np.random.default_rng(3), (3,), 16, 2)
    want = jax.vmap(jax_fused_lstm)(*map(jnp.asarray, ops))
    got = fused_lstm(*map(torch.from_numpy, ops), with_residuals=True)
    for g, w in zip(got[:3], want):
        _close(g, w)
    # the residuals' last step are the final states
    _close(got[3][:, -1], got[1])
    _close(got[4][:, -1], got[2])


def test_fused_lstm_rejects_bad_operands():
    x_proj0, wh, wx, b = map(torch.from_numpy, _inputs(np.random.default_rng(0), (), 4, 2))
    with pytest.raises(ValueError, match="wx_stack"):
        fused_lstm(x_proj0, wh, wx[:, :, :8], b)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_lstm(x_proj0.to("meta"), wh, wx, b)
    assert fused_lstm_reference(x_proj0, wh, wx, b)[0].shape == (4, T, H)


def _jax_lstm(layers, x, seed):
    model = JaxStackedLSTM(hidden_dim=H, num_layers=layers)
    params = model.init(jax.random.key(seed), jnp.asarray(x))
    out, finals = model.apply(params, jnp.asarray(x))
    return params["params"], out, finals


@pytest.mark.parametrize("route", ["layered", "fused"])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_stacked_lstm_matches_jax_xla_path(layers, route):
    """Both routes on the CPU (``fused`` is the kernel route, its launch
    replaced by the plain version) against the JAX scan path."""
    x = np.random.default_rng(layers).normal(size=(12, T, 3)).astype(np.float32)
    params, want_out, want_fin = _jax_lstm(layers, x, layers)
    lstm = StackedLSTM(3, H, layers, device="cpu")
    lstm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    with torch.no_grad():
        got_out, got_fin = getattr(lstm, route)(torch.from_numpy(x))
    _close(got_out, want_out)
    for (gh, gc), (wh, wc) in zip(got_fin, want_fin):
        _close(gh, wh)
        _close(gc, wc)


@pytest.mark.parametrize("route", ["layered", "fused"])
def test_branched_stacked_lstm_matches_vmapped_jax(route):
    """``branches=M`` holds M parameter sets and runs per-branch inputs."""
    M, layers = 3, 2
    x = np.random.default_rng(5).normal(size=(M, 7, T, 2)).astype(np.float32)
    model = JaxStackedLSTM(hidden_dim=H, num_layers=layers)
    keys = jnp.stack([jax.random.key(i) for i in range(M)])
    stacked = jax.vmap(lambda k, xi: model.init(k, xi))(keys, jnp.asarray(x))
    want = jax.vmap(lambda p, xi: model.apply(p, xi)[0])(stacked, jnp.asarray(x))
    lstm = StackedLSTM(2, H, layers, branches=M, device="cpu")
    lstm.load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in stacked["params"].items()}
    )
    with torch.no_grad():
        got, finals = getattr(lstm, route)(torch.from_numpy(x))
    _close(got, want)
    assert finals[-1][0].shape == (M, 7, H)
    _close(finals[-1][0], want[:, :, -1])


def test_stacked_lstm_init_is_seeded_uniform():
    a = StackedLSTM(3, H, 2, device="cpu", generator=torch.Generator().manual_seed(4))
    b = StackedLSTM(3, H, 2, device="cpu", generator=torch.Generator().manual_seed(4))
    bound = 1.0 / np.sqrt(H)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert p.abs().max() <= bound
