"""The port's LSTM backward against the JAX package's Pallas backward.

``fused_lstm_bwd_reference`` (the plain version the CUDA kernel is held
against on the card by ``chip_smoke.py``) is compared with ``jax.vjp`` of
the JAX ``fused_lstm``, whose custom VJP runs the Pallas ``_bwd_kernel`` in
interpret mode here, as ``tests/test_pallas_lstm.py`` runs it. Inputs and
cotangents come from a numpy seed and go to both packages, nonzero at every
step and on the final states. Tolerance rtol 1e-5, atol 1e-6 (the forward
tests' bound): both sides are float32 matmul loops over the same sweep and
differ only in summation order.

The ``FusedLSTM`` autograd Function (the route ``StackedLSTM`` takes on the
card) is then held against plain autograd through the forward on the CPU,
at rtol 1e-5, atol 1e-6 for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.ops.pallas_lstm import fused_lstm as jax_fused_lstm
from stmgcn_tpu_torch.ops.fused_lstm import (
    FusedLSTM,
    fused_lstm,
    fused_lstm_autograd,
    fused_lstm_bwd,
    fused_lstm_bwd_reference,
    fused_lstm_reference,
    unpack_weight_grads,
)
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


def _cotangents(rng, lead, R, L, finals=True):
    g_out = rng.normal(size=lead + (R, T, H)).astype(np.float32)
    g_fin = [rng.normal(size=lead + (L, R, H)).astype(np.float32) * finals for _ in range(2)]
    return g_out, *g_fin


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _port_grads(ops, cots):
    """The port's backward, unpacked to (dxp, dwh, dwx, db)."""
    ops_t = [torch.from_numpy(a) for a in ops]
    _, _, _, hseq, cseq = fused_lstm(*ops_t, with_residuals=True)
    dxp, dwh0, dwxh, db = fused_lstm_bwd_reference(
        *ops_t, hseq, cseq, *map(torch.from_numpy, cots))
    return (dxp, *unpack_weight_grads(dwh0, dwxh, ops_t[1], ops_t[2]), db)


def _jax_grads(ops, cots, vmapped=False):
    def vjp(*args):
        primals, ct = args[:4], args[4:]
        _, pullback = jax.vjp(jax_fused_lstm, *primals)
        return pullback(tuple(ct))

    fn = jax.vmap(vjp) if vmapped else vjp
    return fn(*map(jnp.asarray, ops + cots))


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_bwd_reference_matches_jax_pallas_backward(layers):
    """Ragged R (13 rows: no power-of-two block divides it), cotangents on
    every step and on both final states."""
    rng = np.random.default_rng(10 + layers)
    ops = _inputs(rng, (), 13, layers)
    cots = _cotangents(rng, (), 13, layers)
    got = _port_grads(ops, cots)
    want = _jax_grads(ops, cots)
    for name, g, w in zip(("dxp", "dwh", "dwx", "db"), got, want):
        assert g.shape == w.shape, name
        _close(g, w)


def test_bwd_reference_matches_vmapped_jax_with_branch_axis():
    """A leading branch axis M: every branch's backward at once, against
    ``jax.vmap`` of the JAX backward."""
    rng = np.random.default_rng(21)
    M, R, L = 3, 11, 3
    ops = _inputs(rng, (M,), R, L)
    cots = _cotangents(rng, (M,), R, L)
    got = _port_grads(ops, cots)
    want = _jax_grads(ops, cots, vmapped=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_bwd_without_final_state_cotangents():
    """``None`` final-state cotangents (what ``CGLSTM``'s last-step read
    gives autograd) are zeros: equal to passing zeros explicitly."""
    rng = np.random.default_rng(3)
    ops = [torch.from_numpy(a) for a in _inputs(rng, (2,), 9, 2)]
    g_out, *_ = _cotangents(rng, (2,), 9, 2)
    _, _, _, hseq, cseq = fused_lstm(*ops, with_residuals=True)
    g_out = torch.from_numpy(g_out)
    none = fused_lstm_bwd(*ops, hseq, cseq, g_out, None, None)
    zeros = fused_lstm_bwd(*ops, hseq, cseq, g_out, torch.zeros(2, 2, 9, H),
                           torch.zeros(2, 2, 9, H))
    for a, b in zip(none, zeros):
        assert torch.equal(a, b)


def _leaves(ops):
    return [torch.from_numpy(a).requires_grad_(True) for a in ops]


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_autograd_function_matches_autograd_through_plain_forward(layers, lead):
    rng = np.random.default_rng(layers + 7 * len(lead))
    ops = _inputs(rng, lead, 10, layers)
    g_out, g_h, g_c = map(torch.from_numpy, _cotangents(rng, lead, 10, layers))

    def run(fn):
        leaves = _leaves(ops)
        out, h_fin, c_fin = fn(*leaves)[:3]
        ((out * g_out).sum() + (h_fin * g_h).sum() + (c_fin * g_c).sum()).backward()
        return [t.grad for t in leaves]

    got = run(FusedLSTM.apply)
    want = run(fused_lstm_reference)
    for name, g, w in zip(("x_proj0", "wh", "wx", "b"), got, want):
        if layers == 1 and name in ("wx", "b"):
            # the unread slab: zero in both
            assert not g.any() and (w is None or not w.any()), name
            continue
        _close(g, w)


def _graph_nodes(fn):
    """The names of every autograd node reachable from ``fn``."""
    seen, todo = {}, [fn]
    while todo:
        node = todo.pop()
        if node is not None and id(node) not in seen:
            seen[id(node)] = type(node).__name__
            todo += [n for n, _ in node.next_functions]
    return set(seen.values())


def test_autograd_route_keeps_serving_forward_without_grad():
    """No grad wanted: the forward alone runs (no residuals saved); grad
    wanted: the Function runs and every operand gets a gradient."""
    rng = np.random.default_rng(5)
    ops = _inputs(rng, (), 6, 2)
    plain = [torch.from_numpy(a) for a in ops]
    with torch.no_grad():
        out = fused_lstm_autograd(*_leaves(ops))
    assert out[0].grad_fn is None
    out = fused_lstm_autograd(*plain)
    assert out[0].grad_fn is None
    leaves = _leaves(ops)
    out = fused_lstm_autograd(*leaves)
    # H=8 is padded up to a kernel width, so the Function sits under the slice
    assert "FusedLSTMBackward" in _graph_nodes(out[0].grad_fn)
    out[0][:, -1].sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)


def test_bwd_rejects_bad_operands():
    rng = np.random.default_rng(0)
    ops = [torch.from_numpy(a) for a in _inputs(rng, (), 4, 2)]
    _, _, _, hseq, cseq = fused_lstm(*ops, with_residuals=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_lstm_bwd(ops[0].to("meta"), *ops[1:], hseq, cseq)


@pytest.mark.parametrize("branches", [None, 3])
def test_stacked_lstm_fused_route_gives_every_parameter_its_gradient(branches):
    """``StackedLSTM.fused`` (the card's route, plain versions here) against
    its layered route: gradients of every parameter and of the input."""
    layers = 3
    lead = () if branches is None else (branches,)
    x = np.random.default_rng(9).normal(size=lead + (7, T, 2)).astype(np.float32)
    lstm = StackedLSTM(2, H, layers, branches=branches, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    grads = {}
    for route in ("layered", "fused"):
        lstm.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_(True)
        out, finals = getattr(lstm, route)(xt)
        (out[..., -1, :].pow(2).sum() + finals[0][1].sum()).backward()
        grads[route] = {n: p.grad for n, p in lstm.named_parameters()}
        grads[route]["x"] = xt.grad
    for name, want in grads["layered"].items():
        got = grads["fused"][name]
        assert got is not None, name
        _close(got, want)
