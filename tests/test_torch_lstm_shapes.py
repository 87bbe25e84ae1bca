"""The LSTM kernel route at shapes the kernels do not take directly.

The kernels take ``H`` in ``KERNEL_HIDDEN`` and up to four layers; the
route (``fused_lstm_autograd``) pads ``H`` up to a kernel width and chains
groups of four layers. On the CPU the route runs the same padding and
grouping around the plain versions, so these tests drive the code the card
runs, against the JAX package's ``StackedLSTM`` (XLA scan path): forward
outputs and final states, and ``jax.grad`` of a loss over them with
respect to every parameter and the input. Tolerance rtol 1e-5, atol 1e-6
as ``tests/test_torch_lstm.py``; gradients atol 1e-5 (T=5 steps of
float32 sums in other orders, entries of order 1).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.ops.lstm import StackedLSTM as JaxStackedLSTM
from stmgcn_tpu_torch.ops.lstm import StackedLSTM

torch.set_num_threads(1)

port_fused_lstm = importlib.import_module("stmgcn_tpu_torch.ops.fused_lstm")

RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5
T, F = 5, 3


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol)


def _setup(H, layers, lead, seed):
    x = np.random.default_rng(seed).normal(size=lead + (6, T, F)).astype(np.float32)
    model = JaxStackedLSTM(hidden_dim=H, num_layers=layers)
    if lead:
        keys = jnp.stack([jax.random.key(seed + i) for i in range(lead[0])])
        params = jax.vmap(lambda k, xi: model.init(k, xi))(keys, jnp.asarray(x))
        apply = jax.vmap(lambda p, xi: model.apply(p, xi))
    else:
        params = model.init(jax.random.key(seed), jnp.asarray(x))
        apply = model.apply
    lstm = StackedLSTM(F, H, layers, branches=lead[0] if lead else None, device="cpu")
    lstm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params["params"].items()})
    return x, params, apply, lstm


def _loss(out, finals):
    """Every output reaches the loss: the top sequence, and each layer's
    final h and c."""
    total = (out ** 2).sum()
    for h, c in finals:
        total = total + (h * 0.5).sum() + (c ** 2).sum()
    return total


@pytest.mark.parametrize("H,layers", [(48, 3), (64, 5), (20, 6)])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["one", "branched"])
def test_padded_and_grouped_route_matches_jax(H, layers, lead):
    x, params, apply, lstm = _setup(H, layers, lead, seed=H + layers)
    want_out, want_fin = apply(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, finals = lstm.fused(xt)
    _close(out.detach(), want_out)
    assert len(finals) == layers
    for (gh, gc), (wh, wc) in zip(finals, want_fin):
        _close(gh.detach(), wh)
        _close(gc.detach(), wc)

    want_grads = jax.grad(
        lambda p, xi: _loss(*apply(p, xi)), argnums=(0, 1))(params, jnp.asarray(x))
    _loss(out, finals).backward()
    for name, p in lstm.named_parameters():
        _close(p.grad, want_grads[0]["params"][name], atol=GRAD_ATOL)
    _close(xt.grad, want_grads[1], atol=GRAD_ATOL)


@pytest.mark.parametrize("H,layers,launches", [(48, 3, 1), (64, 5, 2), (64, 9, 3), (32, 4, 1)])
def test_route_launches_one_kernel_per_group_of_four_layers(monkeypatch, H, layers, launches):
    """The route calls the kernel wrapper ceil(L/4) times each way, at a
    kernel width and at most four layers per call."""
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = port_fused_lstm.fused_lstm, port_fused_lstm.fused_lstm_bwd

    def spy_fwd(x_proj0, wh, *a, **k):
        calls["fwd"].append(tuple(wh.shape[-3:]))
        return fwd(x_proj0, wh, *a, **k)

    def spy_bwd(x_proj0, wh, *a, **k):
        calls["bwd"].append(tuple(wh.shape[-3:]))
        return bwd(x_proj0, wh, *a, **k)

    monkeypatch.setattr(port_fused_lstm, "fused_lstm", spy_fwd)
    monkeypatch.setattr(port_fused_lstm, "fused_lstm_bwd", spy_bwd)
    lstm = StackedLSTM(F, H, layers, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, T, F, generator=torch.Generator().manual_seed(1))
    out, _ = lstm.fused(x)
    out.sum().backward()
    width = port_fused_lstm.kernel_width(H)
    for way in ("fwd", "bwd"):
        assert len(calls[way]) == launches, way
        assert all(s[1:] == (width, 4 * width) and s[0] <= 4 for s in calls[way])
        assert sum(s[0] for s in calls[way]) == layers
    with torch.no_grad():  # the serving forward: the same groups, no backward
        calls["fwd"].clear()
        lstm.fused(x)
    assert len(calls["fwd"]) == launches


def test_kernel_width_pads_up_and_names_its_limit():
    kw = port_fused_lstm.kernel_width
    assert [kw(h) for h in (1, 32, 33, 48, 64, 100, 128, 129, 256)] == \
        [32, 32, 64, 64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="256"):
        kw(257)
