"""The port's model modules against the JAX package on converted weights.

Every module on the serving path — ``ChebGraphConv``, ``ContextualGate``,
``CGLSTM`` and the whole ``STMGCN`` (M=3, ``horizon`` 1 and 2, vmapped
and looped parameter layouts) — gets the JAX module's initialized weights
through the converter and the same numpy inputs. Tolerance rtol 1e-5,
atol 1e-5: the einsums and matmuls of the two frameworks sum in other
orders (the port runs the plain LSTM here). The converter round trip is
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.models.cg_lstm import CGLSTM as JaxCGLSTM
from stmgcn_tpu.models.cg_lstm import ContextualGate as JaxContextualGate
from stmgcn_tpu.ops.chebconv import ChebGraphConv as JaxChebGraphConv
from stmgcn_tpu_torch.models import STMGCN, from_jax_params, to_jax_params
from stmgcn_tpu_torch.models.cg_lstm import CGLSTM, ContextualGate
from stmgcn_tpu_torch.ops.chebconv import ChebGraphConv

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
K, N, T, C, B = 3, 9, 5, 1, 2


def _data(seed, m=None):
    rng = np.random.default_rng(seed)
    lead = () if m is None else (m,)
    supports = (rng.normal(size=lead + (K, N, N)) * 0.3).astype(np.float32)
    obs = rng.uniform(size=(B, T, N, C)).astype(np.float32)
    return supports, obs


def _state(tree) -> dict:
    """A flax module's params as a torch state_dict (kernel -> weight.T)."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if hasattr(value, "items"):
                walk(value, prefix + key + ".")
            elif key == "kernel":
                out[prefix + "weight"] = torch.tensor(np.asarray(value).T)
            else:
                out[prefix + key] = torch.tensor(np.asarray(value))

    walk(tree, "")
    return out


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL
    )


def test_chebconv_matches_jax():
    supports, _ = _data(0)
    x = np.random.default_rng(1).normal(size=(B, N, 4)).astype(np.float32)
    jmod = JaxChebGraphConv(n_supports=K, features=6)
    params = jmod.init(jax.random.key(0), jnp.asarray(supports), jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(supports), jnp.asarray(x))
    conv = ChebGraphConv(K, 4, 6, device="cpu")
    conv.load_state_dict(_state(params["params"]))
    _close(conv(torch.from_numpy(supports), torch.from_numpy(x)), want)


@pytest.mark.parametrize("shared_gate_fc,n_real", [(True, None), (False, None), (True, 7)])
def test_contextual_gate_matches_jax(shared_gate_fc, n_real):
    supports, obs = _data(2)
    jmod = JaxContextualGate(n_supports=K, seq_len=T, shared_gate_fc=shared_gate_fc,
                             n_real_nodes=n_real)
    params = jmod.init(jax.random.key(1), jnp.asarray(supports), jnp.asarray(obs))
    want = jmod.apply(params, jnp.asarray(supports), jnp.asarray(obs))
    gate = ContextualGate(K, T, shared_gate_fc=shared_gate_fc, n_real_nodes=n_real,
                          device="cpu")
    gate.load_state_dict(_state(params["params"]), strict=True)
    _close(gate(torch.from_numpy(supports), torch.from_numpy(obs)), want)


@pytest.mark.parametrize("layers", [1, 3])
def test_cg_lstm_matches_jax(layers):
    supports, obs = _data(3)
    jmod = JaxCGLSTM(n_supports=K, seq_len=T, lstm_hidden_dim=8, lstm_num_layers=layers)
    params = jmod.init(jax.random.key(2), jnp.asarray(supports), jnp.asarray(obs))
    want = jmod.apply(params, jnp.asarray(supports), jnp.asarray(obs))
    mod = CGLSTM(K, T, C, 8, layers, device="cpu")
    mod.load_state_dict(_state(params["params"]))
    with torch.no_grad():
        _close(mod(torch.from_numpy(supports), torch.from_numpy(obs)), want)


def _jax_flagship(m_graphs, horizon, vmap, layers=3):
    kw = dict(m_graphs=m_graphs, n_supports=K, seq_len=T, input_dim=C, horizon=horizon,
              lstm_hidden_dim=8, lstm_num_layers=layers, gcn_hidden_dim=8)
    supports, obs = _data(4, m_graphs)
    jmod = JaxSTMGCN(**kw, vmap_branches=vmap)
    params = jmod.init(jax.random.key(3), jnp.asarray(supports), jnp.asarray(obs))
    want = jmod.apply(params, jnp.asarray(supports), jnp.asarray(obs))
    return kw, jax.tree.map(np.asarray, params), supports, obs, want


@pytest.mark.parametrize("m_graphs,horizon,vmap,layers", [
    (3, 1, True, 3), (3, 1, False, 3), (3, 2, True, 2), (3, 2, False, 2), (1, 1, True, 1),
])
def test_stmgcn_matches_jax(m_graphs, horizon, vmap, layers):
    kw, params, supports, obs, want = _jax_flagship(m_graphs, horizon, vmap, layers)
    model = STMGCN(**kw, device="cpu")
    model.load_state_dict(from_jax_params(params, m_graphs))
    with torch.no_grad():
        got = model(torch.from_numpy(supports), torch.from_numpy(obs))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("vmap", [True, False])
def test_param_round_trip_is_exact(vmap):
    _, params, *_ = _jax_flagship(3, 1, vmap)
    state = from_jax_params(params, 3)
    back = to_jax_params(state, 3, layout="vmapped" if vmap else "looped")
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    again = from_jax_params(back, 3)
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_converter_rejects_wrong_branch_count():
    _, params, *_ = _jax_flagship(3, 1, True)
    with pytest.raises(ValueError, match="branch axis"):
        from_jax_params(params, 2)
    with pytest.raises(ValueError, match="looped"):
        from_jax_params({"params": {"head": params["params"]["head"]}}, 3)


def test_port_init_follows_jax_initializers():
    """Seeded draws: equal per seed, zero biases, the variances flax uses."""
    kw = dict(m_graphs=3, n_supports=K, seq_len=12, input_dim=C, lstm_hidden_dim=64,
              gcn_hidden_dim=64)
    a = STMGCN(**kw, device="cpu", generator=torch.Generator().manual_seed(5))
    b = STMGCN(**kw, device="cpu", generator=torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not sa["branches.gcn.b"].any() and not sa["head.bias"].any()
    w = sa["branches.gcn.W"]  # (M, K*64, 64): xavier, var 2 / (192 + 64)
    assert abs(w.var().item() - 2.0 / (K * 64 + 64)) < 0.1 * 2.0 / (K * 64 + 64)
    fc = sa["branches.cg_lstm.gate.gate_fc.weight"]  # lecun, var 1 / 12
    assert abs(fc.var().item() - 1.0 / 12) < 0.25 / 12
