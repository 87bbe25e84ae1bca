"""The bf16 forms of the port's kernel functions against the JAX Pallas
kernels at a bf16 storage dtype (interpret mode on the CPU).

- **B1/B2** (``fused_lstm``, ``fused_lstm_bwd`` and their plain versions,
  which the CUDA kernels' bf16 forms are held against on the card): the
  same numpy operands, rounded to bf16 on both sides, through the JAX
  ``fused_lstm`` and its custom VJP, and through the port's plain versions
  and ``FusedLSTM``. The rounding sites coincide (``_mm`` rounds h and
  dgates to bf16, the residuals and ``dxp`` are stored in bf16, dW and db
  are fp32 sums rounded to bf16 at the end), so the results differ only
  where fp32 sums taken in another order flip a bf16 rounding. Outputs,
  final states and ``dxp`` are held elementwise to rtol 2^-6 (four bf16
  ulps of 2^-8) plus atol 2^-8 of the largest entry; the weight gradients,
  sums over every row and step, normwise to 2^-8.
- **B3/B4/B5** (``spmm_stack``, ``spmm_stack_bwd``, ``spmm``): bf16 blocks
  and a bf16 signal against the JAX kernels on the same bf16 blocks, the
  output float32 and the input gradient in the primal's dtype (bf16), as
  ``tests/test_spmm.py`` pins for the JAX kernel. Both sum exact bf16
  products in fp32, the output at rtol 1e-5 plus 1e-5 of its largest
  entry; the bf16 gradient at rtol 2^-7 (one bf16 rounding apart).
- Refusals: mixed storage dtypes raise on every device, the padded/grouped
  route stays exact in bf16, and the plain versions keep their fp32 results.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.ops.pallas_lstm import fused_lstm as jax_fused_lstm
from stmgcn_tpu.ops.spmm import from_dense as jax_from_dense
from stmgcn_tpu.ops.spmm import spmm as jax_spmm
from stmgcn_tpu.ops.spmm import spmm_stack as jax_spmm_stack
from stmgcn_tpu.ops.spmm import stack_from_dense as jax_stack_from_dense
from stmgcn_tpu_torch.ops.fused_lstm import (
    FusedLSTM,
    fused_lstm,
    fused_lstm_autograd,
    fused_lstm_bwd,
    fused_lstm_bwd_reference,
    fused_lstm_reference,
)
from stmgcn_tpu_torch.ops.spmm import (
    from_dense,
    spmm,
    spmm_stack,
    spmm_stack_bwd,
    spmm_stack_reference,
    stack_from_dense,
)

torch.set_num_threads(1)

BF = torch.bfloat16
H, T = 8, 5
#: elementwise: four bf16 ulps relative, one ulp of the largest entry absolute
RTOL, ATOL_REL = 2.0**-6, 2.0**-8
#: weight gradients, normwise
WGRAD_NORM = 2.0**-8


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * np.abs(want).max(),
                               err_msg=what)


def _normwise(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), what


def _bf16_np(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (nearest even), back as float32: both
    packages' cast."""
    return torch.from_numpy(a).to(BF).float().numpy()


def _inputs(seed, lead, R, L):
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(H)

    def uni(*shape):
        return _bf16_np(rng.uniform(-scale, scale, size=lead + shape).astype(np.float32))

    x_proj0 = _bf16_np(rng.normal(size=lead + (R, T, 4 * H)).astype(np.float32))
    ops = (x_proj0, uni(L, H, 4 * H), uni(max(L - 1, 1), H, 4 * H), uni(max(L - 1, 1), 4 * H))
    cots = tuple(_bf16_np(rng.normal(size=lead + s).astype(np.float32))
                 for s in ((R, T, H), (L, R, H), (L, R, H)))
    return ops, cots


def _jax(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _port(a):
    return torch.from_numpy(a).to(BF)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_forward_matches_jax_pallas_at_bf16(layers):
    ops, _ = _inputs(layers, (), 13, layers)
    want = jax_fused_lstm(*map(_jax, ops))
    got = fused_lstm(*map(_port, ops))
    for name, g, w in zip(("hs_top", "h_fin", "c_fin"), got, want):
        assert g.dtype == BF and w.dtype == jnp.bfloat16, name
        _close(g, w, name)


@pytest.mark.parametrize("layers", [1, 3])
def test_backward_matches_jax_pallas_at_bf16(layers):
    """``FusedLSTM`` (plain versions on the CPU) against ``jax.vjp`` of the
    Pallas kernel pair: every gradient in the weights' dtype (bf16), dW
    and db rounded once from fp32 sums."""
    ops, cots = _inputs(10 + layers, (), 13, layers)
    _, pullback = jax.vjp(jax_fused_lstm, *map(_jax, ops))
    want = pullback(tuple(map(_jax, cots)))
    leaves = [_port(a).requires_grad_(True) for a in ops]
    outs = FusedLSTM.apply(*leaves)
    torch.autograd.backward(outs, [_port(c) for c in cots])
    names = ("dxp", "dwh", "dwx", "db")
    for name, leaf, w in zip(names, leaves, want):
        assert leaf.grad.dtype == BF and w.dtype == jnp.bfloat16, name
    _close(leaves[0].grad, want[0], "dxp")
    for name, leaf, w in list(zip(names, leaves, want))[1:]:  # L == 1: dwx, db are zeros
        _normwise(leaf.grad, w, WGRAD_NORM, name)


def test_backward_with_branch_axis_matches_vmapped_jax():
    M, R, L = 2, 9, 2
    ops, cots = _inputs(21, (M,), R, L)

    def vjp(*args):
        _, pullback = jax.vjp(jax_fused_lstm, *args[:4])
        return pullback(tuple(args[4:]))

    want = jax.vmap(vjp)(*map(_jax, ops + cots))
    leaves = [_port(a).requires_grad_(True) for a in ops]
    torch.autograd.backward(FusedLSTM.apply(*leaves), [_port(c) for c in cots])
    _close(leaves[0].grad, want[0], "dxp")
    for name, leaf, w in zip(("dwh", "dwx", "db"), leaves[1:], want[1:]):
        _normwise(leaf.grad, w, WGRAD_NORM, name)


def test_weight_gradients_are_fp32_sums_rounded_once():
    """``fused_lstm_bwd`` returns dW and db in float32 (the kernel's sums);
    ``FusedLSTM`` rounds them to the weights' bf16, nearest even."""
    ops, cots = _inputs(5, (), 11, 2)
    t_ops = list(map(_port, ops))
    res = fused_lstm(*t_ops, with_residuals=True)
    dxp, dwh0, dwxh, db = fused_lstm_bwd(*t_ops, res[3], res[4], *map(_port, cots))
    assert dxp.dtype == BF and {dwh0.dtype, dwxh.dtype, db.dtype} == {torch.float32}
    leaves = [t.clone().requires_grad_(True) for t in t_ops]
    torch.autograd.backward(FusedLSTM.apply(*leaves), [_port(c) for c in cots])
    assert torch.equal(leaves[1].grad[0], dwh0.to(BF))
    assert torch.equal(leaves[3].grad, db.to(BF))


def test_rounding_sites_are_the_pallas_kernels():
    """The residuals hold bf16-rounded states, and the plain forward
    computed with every h rounded before its product (``_mm``) differs
    from one that keeps h in float32: the test sees the rounding sites."""
    ops, _ = _inputs(7, (), 13, 2)
    t_ops = list(map(_port, ops))
    out, h_fin, c_fin, hseq, cseq = fused_lstm_reference(*t_ops, with_residuals=True)
    assert {t.dtype for t in (out, h_fin, c_fin, hseq, cseq)} == {BF}
    assert torch.equal(h_fin, hseq[-1]) and torch.equal(c_fin, cseq[-1])
    f32 = fused_lstm_reference(*(t.float() for t in t_ops))
    assert not torch.equal(out, f32[0].to(BF))


def test_mixed_storage_dtypes_raise():
    ops, cots = _inputs(3, (), 5, 2)
    t_ops = list(map(_port, ops))
    t_ops[1] = t_ops[1].float()
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fused_lstm(*t_ops)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fused_lstm_bwd_reference(*t_ops, t_ops[0], t_ops[0], None, None, None)


@pytest.mark.parametrize("hidden,layers", [(6, 2), (8, 5)])
def test_padded_and_grouped_route_in_bf16(hidden, layers):
    """The route's padding (H=6 -> 32) is exact in bf16 (zeros); groups of
    four layers run as two launches whose chained projection is rounded to
    bf16 once, within the elementwise tolerance of the one-launch plain
    forward."""
    rng = np.random.default_rng(hidden + layers)
    s = 1.0 / np.sqrt(hidden)
    xp = _bf16_np(rng.normal(size=(2, 9, T, 4 * hidden)).astype(np.float32))
    w = [_bf16_np(rng.uniform(-s, s, size=shape).astype(np.float32)) for shape in
         ((2, layers, hidden, 4 * hidden), (2, max(layers - 1, 1), hidden, 4 * hidden),
          (2, max(layers - 1, 1), 4 * hidden))]
    ops = [_port(a) for a in (xp, *w)]
    got = fused_lstm_autograd(*ops)
    want = fused_lstm_reference(*ops)
    for g, w_ in zip(got, want):
        assert g.dtype == BF
        if layers <= 4:
            assert torch.equal(g, w_)
        else:
            _close(g, w_)


# -- block-CSR: B3, B4, B5 ------------------------------------------------------

def _banded(shape, w, seed=0):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal(shape).astype(np.float32)
    rows, cols = shape[-2:]
    mat[..., np.abs(np.subtract.outer(np.arange(rows), np.arange(cols))) > w] = 0.0
    return mat


def _jax_bf16(struct):
    return dataclasses.replace(struct, data=struct.data.astype(jnp.bfloat16),
                               data_t=struct.data_t.astype(jnp.bfloat16))


def _grad_close(got, want):
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-7 * np.abs(want).max())


def _out_close(got, want):
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,m,w,tile", [((3, 48, 48), 7, 6, 8), ((2, 20, 44), 5, 12, 8)])
def test_spmm_stack_bf16_matches_jax_pallas(shape, m, w, tile):
    """B3 and B4 (shared signal): bf16 blocks and signal, float32 out, the
    gradient in the primal's bf16 through the caller's cast."""
    mats = _banded(shape, w)
    x = _bf16_np(np.random.default_rng(1).standard_normal((shape[2], m)).astype(np.float32))
    cot = _bf16_np(np.random.default_rng(2).standard_normal((shape[0], shape[1], m))
                   .astype(np.float32))
    ref = _jax_bf16(jax_stack_from_dense(mats, tile))

    def jloss(xx):
        out = jax_spmm_stack(ref, xx, interpret=True).astype(xx.dtype)
        return jnp.sum((out * _jax(cot)).astype(jnp.float32))

    want = jax_spmm_stack(ref, _jax(x), interpret=True)
    want_g = jax.grad(jloss)(_jax(x))
    st = stack_from_dense(mats, tile).astype(BF)
    xt = _port(x).requires_grad_(True)
    got = spmm_stack(st, xt)
    ((got.to(BF) * _port(cot)).float().sum()).backward()
    _out_close(got, want)
    _grad_close(xt.grad, want_g)


def test_spmm_stack_bf16_per_branch_signal():
    """A branch-stacked structure with one bf16 signal per branch (the
    tiled graph conv's B3/B4), against the JAX kernel per branch."""
    mats = _banded((2, 3, 40, 40), 5, seed=4)
    x = _bf16_np(np.random.default_rng(5).standard_normal((2, 40, 6)).astype(np.float32))
    cot = _bf16_np(np.random.default_rng(6).standard_normal((2, 3, 40, 6)).astype(np.float32))
    port = [stack_from_dense(mats[b], 8) for b in range(2)]
    branch = dataclasses.replace(port[0], **{f: torch.stack([getattr(p, f) for p in port])
                                             for f in ("data", "idx", "nblk", "data_t",
                                                       "idx_t", "nblk_t")}).astype(BF)
    xt = _port(x).requires_grad_(True)
    got = spmm_stack(branch, xt)
    ((got.to(BF) * _port(cot)).float().sum()).backward()
    for b in range(2):
        ref = _jax_bf16(jax_stack_from_dense(mats[b], 8))
        want = jax_spmm_stack(ref, _jax(x[b]), interpret=True)
        want_g = jax.grad(lambda xx: jnp.sum(
            (jax_spmm_stack(ref, xx, interpret=True).astype(xx.dtype) * _jax(cot[b]))
            .astype(jnp.float32)))(_jax(x[b]))
        _out_close(got[b], want)
        _grad_close(xt.grad[b], want_g)


@pytest.mark.parametrize("n,m,w,tile", [(40, 6, 5, 8), (53, 3, 9, 8)])
def test_spmm_bf16_matches_jax_pallas(n, m, w, tile):
    """B5 and its transpose (the backward): ``tests/test_spmm.py``'s bf16
    case, the gradient back in bf16."""
    mat = _banded((n, n), w)
    x = _bf16_np(np.random.default_rng(7).standard_normal((n, m)).astype(np.float32))
    cot = _bf16_np(np.random.default_rng(8).standard_normal((n, m)).astype(np.float32))
    ref = _jax_bf16(jax_from_dense(mat, tile))
    want = jax_spmm(ref, _jax(x), interpret=True)
    want_g = jax.grad(lambda xx: jnp.sum(
        (jax_spmm(ref, xx, interpret=True).astype(xx.dtype) * _jax(cot))
        .astype(jnp.float32)))(_jax(x))
    xt = _port(x).requires_grad_(True)
    got = spmm(from_dense(mat, tile).astype(BF), xt)
    ((got.to(BF) * _port(cot)).float().sum()).backward()
    _out_close(got, want)
    _grad_close(xt.grad, want_g)


def test_block_structures_cast_once_and_refuse_mixed_dtypes():
    mats = _banded((2, 24, 24), 4)
    st = stack_from_dense(mats, 8)
    bf = st.astype(BF)
    assert bf is st.astype(BF) and st.astype(torch.float32) is st
    assert bf.data.dtype == BF and st.data.dtype == torch.float32
    assert bf.idx is st.idx and torch.equal(bf.row_order, st.row_order)
    x = torch.randn(24, 3)
    with pytest.raises(TypeError, match="blocks torch.float32 with a torch.bfloat16"):
        spmm_stack_reference(st, x.to(BF))
    with pytest.raises(TypeError, match="blocks torch.bfloat16 with a torch.float32 signal"):
        spmm_stack(bf, x)
    # the backward takes its cotangent in the blocks' dtype (BlockCSRApply
    # casts it), so a float32 cotangent of bf16 blocks raises here too
    g = torch.randn(2, 24, 3).to(BF)
    assert spmm_stack_bwd(bf, g, shared=True).dtype == torch.float32
    with pytest.raises(TypeError, match="blocks torch.bfloat16 with a torch.float32 cotangent"):
        spmm_stack_bwd(bf, g.float(), shared=True)


@pytest.mark.parametrize("form", ["stack", "spmm"])
def test_bf16_backward_rounds_a_float32_cotangent(form):
    """A float32 cotangent that bf16 cannot represent (the output used as
    float32, with no cast back to bf16) reaches B4 / B5's transpose rounded
    to bf16, on the CPU as on the card: the gradient is bitwise the one of
    the rounded cotangent, and differs from the unrounded product."""
    mats = _banded((2, 24, 24), 4, seed=9)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((24, 5)).astype(np.float32)).to(BF)
    cot = torch.from_numpy(rng.standard_normal((2, 24, 5)).astype(np.float32))
    if form == "spmm":
        st, apply, cot, mats = from_dense(mats[0], 8).astype(BF), spmm, cot[0], mats[:1]
    else:
        st, apply = stack_from_dense(mats, 8).astype(BF), spmm_stack
    assert not torch.equal(cot.to(BF).float(), cot)  # bf16 cannot hold it
    xt = x.clone().requires_grad_(True)
    (apply(st, xt) * cot).sum().backward()
    xr = x.clone().requires_grad_(True)
    (apply(st, xr) * cot.to(BF).float()).sum().backward()
    assert xt.grad.dtype == BF and torch.equal(xt.grad, xr.grad)
    # the product of the unrounded cotangent, sum_k A_k^T g_k, is another one
    unrounded = torch.einsum("kji,kjf->if", torch.from_numpy(mats).to(BF).float(),
                             cot.reshape(-1, 24, 5)).to(BF)
    assert not torch.equal(xt.grad, unrounded)
