"""The port's model at a bf16 compute dtype against the JAX model at
``dtype=bfloat16`` with ``lstm_backend="pallas"`` (interpret mode) and
``"xla"`` (the default scan), the port pinned to the same backend, the
stochastic-rounding casts, and the bf16 configuration surface.

- The model: dense, block-sparse and tiled supports, the same converted
  weights and numpy inputs. Both round at the same sites (operands at each
  use, f32 sums, the fused LSTM's bf16 storage), so outputs may differ only
  where an fp32 sum taken in another order flips a bf16 rounding: held
  elementwise to rtol 2^-6 (four bf16 ulps) plus 2^-8 of the largest entry.
  Parameter gradients are held normwise to 2^-8, except the layer-0
  projection's (``wx_0``, ``b_0``): their cotangent is the bf16 ``dxp``,
  which XLA's CPU backend reduces over every row and step in bf16 while
  torch sums it in float32 and rounds once (on the TPU XLA too sums such
  reductions in float32), so those two are held to 2^-5.
- ``sr_cast_bf16`` equals the JAX function bit for bit on the same numpy
  noise; ``compute_cast`` without noise equals ``astype`` bit for bit; the
  census counts what JAX's counts.
- Config and CLI: ``precision``/``sr_seed`` and ``model.dtype`` as the JAX
  package validates and maps them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.cli import build_parser as jax_build_parser
from stmgcn_tpu.cli import config_from_args as jax_config_from_args
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.models.params import compute_cast as jax_compute_cast
from stmgcn_tpu.models.params import leaf_dtype_census as jax_census
from stmgcn_tpu.models.params import sr_cast_bf16 as jax_sr_cast_bf16
from stmgcn_tpu.ops.spmm import stack_from_dense as jax_stack_from_dense
from stmgcn_tpu.ops.tiling import plan_tiling as jax_plan_tiling
from stmgcn_tpu_torch.cli import build_parser, config_from_args, main
from stmgcn_tpu_torch.config import DTYPES, ExperimentConfig, ModelConfig, TrainConfig
from stmgcn_tpu_torch.models import STMGCN, from_jax_params, to_jax_params
from stmgcn_tpu_torch.models.params import compute_cast, leaf_dtype_census, sr_cast_bf16
from stmgcn_tpu_torch.ops.layers import set_compute_dtype
from stmgcn_tpu_torch.ops.spmm import stack_from_dense
from stmgcn_tpu_torch.ops.tiling import plan_tiling

torch.set_num_threads(1)

BF = torch.bfloat16
RTOL, ATOL_REL, GRAD_NORM, PROJ0_NORM = 2.0**-6, 2.0**-8, 2.0**-8, 2.0**-5
K, T, C, B, TILE = 3, 5, 1, 2, 8
KW = dict(m_graphs=3, n_supports=K, seq_len=T, input_dim=C, lstm_hidden_dim=8,
          lstm_num_layers=3, gcn_hidden_dim=8)


def _supports(n, seed):
    """Banded random supports: block-sparse at tile 8 (n = 16)."""
    rng = np.random.default_rng(seed)
    mat = (rng.normal(size=(3, K, n, n)) * 0.3).astype(np.float32)
    mat[..., np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > 5] = 0.0
    return mat


def _case(mode, horizon=1, seed=0, backend="pallas"):
    n = 16
    dense = _supports(n, seed)
    rng = np.random.default_rng(seed + 1)
    obs = rng.uniform(size=(B, T, n, C)).astype(np.float32)
    # the block modes loop over the branches in JAX: two layers keep them short
    kw = dict(KW, horizon=horizon, lstm_num_layers=3 if mode == "dense" else 2)
    if mode == "dense":
        jsup, sup, jkw, pkw = jnp.asarray(dense), torch.from_numpy(dense), {}, {}
    elif mode == "sparse":
        jsup = tuple(jax_stack_from_dense(dense[m], TILE) for m in range(3))
        sup = tuple(stack_from_dense(dense[m], TILE) for m in range(3))
        jkw = pkw = dict(sparse=True)
    else:
        jsup, sup = jax_plan_tiling(dense, TILE), plan_tiling(dense, TILE)
        jkw = pkw = dict(support_modes=("tiled",) * 3)
    jmod = JaxSTMGCN(**kw, **jkw, lstm_backend=backend, dtype=jnp.bfloat16)
    params = jmod.init(jax.random.key(seed), jsup, jnp.asarray(obs))
    cot = rng.normal(size=jmod.apply(params, jsup, jnp.asarray(obs)).shape).astype(np.float32)

    def loss(p):
        out = jmod.apply(p, jsup, jnp.asarray(obs))
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jmod.apply(params, jsup, jnp.asarray(obs))
    want_g = from_jax_params(jax.tree.map(np.asarray, jax.grad(loss)(params)), 3)
    model = STMGCN(**kw, **pkw, lstm_backend=backend, dtype=BF, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), 3))
    return model, sup, obs, cot, want, want_g


def _f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("mode,horizon", [("dense", 1), ("dense", 2), ("sparse", 1),
                                          ("tiled", 1)])
def test_bf16_model_matches_jax_pallas_bf16(mode, horizon, backend):
    model, sup, obs, cot, want, want_g = _case(mode, horizon, backend=backend)
    out = model(sup, torch.from_numpy(obs))
    assert out.dtype == BF and want.dtype == jnp.bfloat16 and out.shape == want.shape
    got, ref = _f32(out), _f32(want)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL_REL * np.abs(ref).max())
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        tol = PROJ0_NORM if name.endswith(("lstm.wx_0", "lstm.b_0")) else GRAD_NORM
        g, w = p.grad.numpy(), want_g[name].numpy()
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w), name


def test_compute_dtype_toggles_and_fp32_path_is_unchanged():
    """``set_compute_dtype(model, None)`` gives back the exact fp32 model;
    at bf16 the prediction leaves in bf16 over float32 parameters."""
    dense = torch.from_numpy(_supports(16, 3))
    obs = torch.rand(B, T, 16, C)
    a = STMGCN(**KW, device="cpu", generator=torch.Generator().manual_seed(1))
    b = STMGCN(**KW, device="cpu", generator=torch.Generator().manual_seed(1), dtype=BF)
    assert b.compute_dtype == BF and all(
        m.compute_dtype == BF for m in b.modules() if hasattr(m, "compute_dtype"))
    with torch.no_grad():
        assert b(dense, obs).dtype == BF
        set_compute_dtype(b, None)
        assert torch.equal(a(dense, obs), b(dense, obs))
    assert {p.dtype for p in b.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="compute dtype"):
        set_compute_dtype(b, torch.float16)


# -- stochastic rounding and the master -> compute casts ----------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_sr_cast_equals_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * 10.0 ** rng.integers(-8, 8, size=257)).astype(np.float32)
    x[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38]
    noise = rng.integers(0, 1 << 16, size=x.shape, dtype=np.uint32)
    want = np.asarray(jax_sr_cast_bf16(jnp.asarray(x), jnp.asarray(noise)).astype(jnp.float32))
    got = sr_cast_bf16(torch.from_numpy(x), torch.from_numpy(noise.astype(np.int64)))
    assert got.dtype == BF
    got = got.float().numpy()
    nan = np.isnan(want)  # NaN payloads are not part of the contract
    assert np.array_equal(np.isnan(got), nan) and nan.sum() == 1
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def test_sr_cast_gradient_is_straight_through():
    x = torch.randn(33, requires_grad=True)
    noise = torch.randint(0, 1 << 16, (33,))
    g = torch.randn(33).to(BF)
    sr_cast_bf16(x, noise).backward(g)
    assert x.grad.dtype == torch.float32 and torch.equal(x.grad, g.float())
    jx = jnp.asarray(x.detach().numpy())
    _, pull = jax.vjp(lambda v: jax_sr_cast_bf16(v, jnp.asarray(noise.numpy(), jnp.uint32)), jx)
    np.testing.assert_array_equal(np.asarray(pull(jnp.asarray(g.float().numpy())
                                                  .astype(jnp.bfloat16))[0]), x.grad.numpy())


def test_stochastic_rounding_is_unbiased_and_deterministic_per_seed():
    tree = {"w": torch.full((20000,), 1.0 + 2.0**-8), "i": torch.arange(3)}
    draws = [compute_cast(tree, BF, torch.Generator().manual_seed(s)) for s in (4, 4, 5)]
    assert torch.equal(draws[0]["w"], draws[1]["w"]) and not torch.equal(draws[0]["w"],
                                                                          draws[2]["w"])
    assert torch.equal(draws[0]["i"], tree["i"])  # non-float leaves pass through
    # halfway between the bf16 values 1 and 1 + 2^-7: rounded up about half
    # the time, so the mean stays the float32 value
    up = (draws[0]["w"].float() > 1.0).float().mean().item()
    assert 0.48 < up < 0.52 and abs(draws[0]["w"].float().mean().item() - (1 + 2.0**-8)) < 2e-4
    with pytest.raises(ValueError, match="bfloat16 only"):
        compute_cast(tree, torch.float16, torch.Generator())


def test_round_to_nearest_cast_and_census_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 5)).astype(np.float32) * 37.0
    got = compute_cast({"x": torch.from_numpy(x)}, BF)["x"]
    want = np.asarray(jax_compute_cast({"x": jnp.asarray(x)}, jnp.bfloat16)["x"]
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    model = STMGCN(**KW, device="cpu")
    state = model.state_dict()
    jtree = to_jax_params(state, 3)
    assert leaf_dtype_census(state) == {k: v for k, v in jax_census(jtree).items()}
    half = {k: v.to(BF) for k, v in state.items()}
    assert leaf_dtype_census(half) == jax_census(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), jtree))


# -- configuration and CLI ----------------------------------------------------

def test_config_validates_precision_as_jax():
    assert TrainConfig(precision="bf16", sr_seed=3).sr_seed == 3
    with pytest.raises(ValueError, match="precision"):
        TrainConfig(precision="fp16")
    with pytest.raises(ValueError, match="sr_seed"):
        TrainConfig(sr_seed=3)
    assert ModelConfig(dtype="bfloat16").compute_dtype == BF
    assert ModelConfig().compute_dtype is None and set(DTYPES) == {"float32", "bfloat16"}
    with pytest.raises(ValueError, match="model.dtype"):
        ModelConfig(dtype="float16").compute_dtype


def test_jax_config_dict_with_bf16_round_trips():
    cfg = jax_preset("smoke")
    cfg.model.dtype, cfg.train.precision, cfg.train.sr_seed = "bfloat16", "bf16", 11
    port = ExperimentConfig.from_dict(cfg.to_dict())
    assert (port.model.dtype, port.train.precision, port.train.sr_seed) == ("bfloat16", "bf16", 11)
    assert ExperimentConfig.from_dict(port.to_dict()) == port


@pytest.mark.parametrize("argv", [
    ["--dtype", "bfloat16"], ["--precision", "bf16"], ["--precision", "bf16", "--sr-seed", "5"],
    ["--dtype", "float32", "--precision", "fp32"],
])
def test_cli_flags_map_as_jax(argv):
    port = config_from_args(build_parser().parse_args(["--preset", "smoke"] + argv))
    ref = jax_config_from_args(jax_build_parser().parse_args(["--preset", "smoke"] + argv))
    assert (port.model.dtype, port.train.precision, port.train.sr_seed) == (
        ref.model.dtype, ref.train.precision, ref.train.sr_seed)


def test_cli_refuses_sr_seed_without_bf16(tmp_path, capsys):
    code = main(["--preset", "smoke", "--device", "cpu", "--timesteps", "400", "--epochs", "1",
                 "--out-dir", str(tmp_path), "--sr-seed", "3"])
    assert code == 1 and "sr_seed" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--precision", "fp16"])
