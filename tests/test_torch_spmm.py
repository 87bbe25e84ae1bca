"""The port's block-CSR structures and products against the JAX package's.

- Host structures: ``from_dense`` and ``stack_from_dense`` (square, ragged
  against the tile, and a rectangular strip) are array-equal to the JAX
  builders (``data``, ``idx``, ``data_t``, ``idx_t``).
- Products: ``spmm`` and ``spmm_stack`` (shared and per-branch signal),
  forward and input gradient, against the JAX Pallas kernels in interpret
  mode and against the dense product: rtol/atol 1e-4, as
  ``tests/test_spmm.py`` holds the JAX kernels.
- The prepared backward (B4's plain version over the transposed blocks)
  against plain autograd of the plain forward: rtol/atol 1e-5 (the same
  float32 products summed in another order).
- Dispatch: CPU tensors take the plain versions (no launch is counted);
  anything the CUDA kernels cannot take raises; supports get no gradient.
- Counts: ``nblk``/``nblk_t`` mark each block row's leading slots that hold
  a nonzero (the rest zero blocks at index 0), ``row_order``/``row_order_t``
  list the rows by descending count and follow the counts they derive from,
  both survive ``.to``, and the plain versions give the same result on
  structures truncated to the counts.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.ops.spmm import from_dense as jax_from_dense
from stmgcn_tpu.ops.spmm import spmm as jax_spmm
from stmgcn_tpu.ops.spmm import spmm_stack as jax_spmm_stack
from stmgcn_tpu.ops.spmm import stack_from_dense as jax_stack_from_dense
from stmgcn_tpu.ops.tiling import plan_tiling as jax_plan_tiling
from stmgcn_tpu_torch.ops.spmm import (
    BlockSparseStack,
    from_dense,
    place_supports,
    spmm,
    spmm_dense_reference,
    spmm_stack,
    spmm_stack_bwd,
    spmm_stack_bwd_reference,
    spmm_stack_reference,
    stack_from_dense,
)
from stmgcn_tpu_torch.ops.tiling import plan_tiling

torch.set_num_threads(1)

S = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
TOL = dict(rtol=1e-4, atol=1e-4)


def banded(shape, w, seed=0):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal(shape).astype(np.float32)
    rows, cols = shape[-2:]
    mat[..., np.abs(np.subtract.outer(np.arange(rows), np.arange(cols))) > w] = 0.0
    return mat


def signal(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _equal(port, jax_struct, names):
    for name in names:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_struct, name)), err_msg=name)


@pytest.mark.parametrize("n,w,tile", [(64, 5, 8), (50, 9, 8), (300, 20, 128), (37, 3, 4)])
def test_from_dense_equals_jax(n, w, tile):
    mat = banded((n, n), w)
    port, ref = from_dense(mat, tile), jax_from_dense(mat, tile)
    _equal(port, ref, ("data", "idx", "data_t", "idx_t"))
    assert (port.n, port.tile, port.density) == (ref.n, ref.tile, ref.density)
    assert port.nbytes == ref.nbytes
    assert port.idx.dtype == torch.int32


@pytest.mark.parametrize("shape,w,tile", [
    ((3, 60, 60), 7, 8), ((2, 45, 45), 11, 8), ((3, 20, 60), 12, 8), ((2, 128, 128), 30, 128),
])
def test_stack_from_dense_equals_jax(shape, w, tile):
    mats = banded(shape, w)
    port, ref = stack_from_dense(mats, tile), jax_stack_from_dense(mats, tile)
    _equal(port, ref, ("data", "idx", "data_t", "idx_t"))
    assert (port.n_rows, port.n_cols, port.tile, port.n_supports) == (
        ref.n_rows, ref.n_cols, ref.tile, ref.n_supports)
    assert port.density == ref.density and port.branches is None


def test_builders_validate_shapes_as_jax_does():
    with pytest.raises(ValueError, match="square"):
        from_dense(np.ones((4, 5)))
    with pytest.raises(ValueError, match=r"\(K, Nr, Nc\)"):
        stack_from_dense(np.ones((4, 5)))


@pytest.mark.parametrize("n,m,w,tile", [(40, 6, 5, 8), (53, 3, 9, 8), (32, 5, 4, 4)])
def test_spmm_forward_and_gradient_match_jax_pallas(n, m, w, tile):
    mat, x = banded((n, n), w), signal((n, m))
    cot = signal((n, m), seed=2)
    ref = jax_from_dense(mat, tile)
    want = jax_spmm(ref, jnp.asarray(x), interpret=True)
    want_g = jax.grad(lambda xx: jnp.sum(jax_spmm(ref, xx, interpret=True) * cot))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = spmm(from_dense(mat, tile), xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), **TOL)
    np.testing.assert_allclose(got.detach().numpy(), mat @ x, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), mat.T @ cot, **TOL)


@pytest.mark.parametrize("shape,m,w,tile", [((3, 48, 48), 7, 6, 8), ((2, 20, 44), 5, 12, 8)])
def test_spmm_stack_matches_jax_pallas(shape, m, w, tile):
    """Shared signal, square and a rectangular row strip."""
    mats, x = banded(shape, w), signal((shape[2], m))
    cot = signal((shape[0], shape[1], m), seed=3)
    ref = jax_stack_from_dense(mats, tile)
    want = jax_spmm_stack(ref, jnp.asarray(x), interpret=True)
    want_g = jax.grad(lambda xx: jnp.sum(jax_spmm_stack(ref, xx, interpret=True) * cot))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = spmm_stack(stack_from_dense(mats, tile), xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), **TOL)
    np.testing.assert_allclose(got.detach().numpy(), np.einsum("kij,jf->kif", mats, x), **TOL)


@pytest.mark.parametrize("shared", [True, False])
def test_branch_stacked_spmm_stack_matches_jax_per_branch(shared):
    """All M branches of a plan in one call (one launch on the card),
    against the JAX kernel run branch by branch."""
    M, K, n, f, tile = 3, 2, 40, 4, 8
    dense = banded((M, K, n, n), 6)
    plan, ref = plan_tiling(dense, tile), jax_plan_tiling(dense, tile)
    x = signal((n, f) if shared else (M, n, f))
    cot = signal((M, K, n, f), seed=4)
    xt = torch.tensor(x, requires_grad=True)
    got = spmm_stack(plan.as_stack(), xt)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.shape == (M, K, n, f)
    grads = np.zeros_like(x)
    for m in range(M):
        xm = jnp.asarray(x if shared else x[m])
        stack = ref[m].as_stack()
        np.testing.assert_allclose(got[m].detach().numpy(),
                                   np.asarray(jax_spmm_stack(stack, xm, interpret=True)), **TOL)
        g = jax.grad(lambda xx: jnp.sum(jax_spmm_stack(stack, xx, interpret=True) * cot[m]))(xm)
        if shared:
            grads += np.asarray(g)
        else:
            grads[m] = np.asarray(g)
    np.testing.assert_allclose(xt.grad.numpy(), grads, **TOL)


@pytest.mark.parametrize("shared", [True, False])
def test_prepared_backward_matches_autograd_of_the_plain_forward(shared):
    """B4's plain version (gather over the pre-transposed blocks, no
    scatter) against autograd's scatter-add transpose of B3's."""
    M, K, n, f = 2, 3, 45, 5
    stack = plan_tiling(banded((M, K, n, n), 7), 8).as_stack()
    x = torch.tensor(signal((n, f) if shared else (M, n, f)), requires_grad=True)
    g = torch.tensor(signal((M, K, n, f), seed=5))
    (spmm_stack_reference(stack, x) * g).sum().backward()
    got = spmm_stack_bwd_reference(stack, g, shared=shared)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(spmm_stack_bwd(stack, g, shared=shared).numpy(), got.numpy())


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    mats = banded((2, 30, 30), 4)
    stack, one = stack_from_dense(mats, 8), from_dense(mats[0], 8)
    x = torch.tensor(signal((30, 3)), requires_grad=True)
    before = (spmm_stack.launches, spmm_stack_bwd.launches, spmm.launches)
    (spmm_stack(stack, x).sum() + spmm(one, x).sum()).backward()
    assert (spmm_stack.launches, spmm_stack_bwd.launches, spmm.launches) == before
    np.testing.assert_allclose(spmm_dense_reference(mats[0], x.detach()).numpy(),
                               mats[0] @ x.detach().numpy(), rtol=1e-6)


def test_supports_get_no_gradient_and_history_free_outputs_still_backprop(monkeypatch):
    """The kernels return tensors without autograd history: imitated here by
    detaching the plain forward. The gradient still reaches ``x`` (through
    ``BlockCSRApply``), and never the supports."""
    stack = stack_from_dense(banded((2, 24, 24), 3), 8)
    stack.data.requires_grad_(True)
    plain = S.stack_forward

    monkeypatch.setattr(S, "stack_forward", lambda *a: plain(*a).detach())
    x = torch.tensor(signal((24, 2)), requires_grad=True)
    spmm_stack(stack, x).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert stack.data.grad is None


def test_shape_validation_matches_jax():
    stack = stack_from_dense(banded((2, 32, 32), 3), 8)
    with pytest.raises(ValueError, match="rows"):
        spmm_stack(stack, torch.ones(16, 4))
    with pytest.raises(ValueError, match=r"x must be \(N, M\)"):
        spmm_stack(stack, torch.ones(32))
    with pytest.raises(ValueError, match=r"x must be \(N, M\)"):
        spmm_stack(stack, torch.ones(3, 32, 4))  # a branch axis the stack lacks
    with pytest.raises(ValueError, match="rows"):
        spmm(from_dense(np.eye(8, dtype=np.float32), 4), torch.ones(5, 2))


def test_wrappers_refuse_what_the_kernels_cannot_take():
    stack = stack_from_dense(banded((2, 32, 32), 3), 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        S.stack_forward(stack, torch.ones(32, 4, device="meta"))
    out = torch.empty(1, 32, 4)
    with pytest.raises(ValueError, match="tile in"):  # no kernel for tile 8
        S._launch("spmm_stack", 0, stack.data, stack.idx, stack.nblk, stack.row_order,
                  torch.ones(32, 4), out, S=1, tile=8, n_src_rows=32)


def test_place_supports_moves_every_form():
    mats = banded((2, 16, 16), 3)
    forms = (mats, torch.from_numpy(mats), stack_from_dense(mats, 8),
             (from_dense(mats[0], 8), from_dense(mats[1], 8)), plan_tiling(mats[None], 8))
    for form in forms:
        placed = place_supports(form, "cpu")
        assert type(placed) is (tuple if isinstance(form, tuple) else
                                torch.Tensor if isinstance(form, np.ndarray) else type(form))
    assert isinstance(place_supports(forms[2], "cpu"), BlockSparseStack)


def check_counts(data, idx, nblk, order):
    """Every slot before ``nblk`` holds a nonzero; every slot from it on is a
    zero block at index 0; ``order`` lists every flat row once, by
    descending count, ties in row order."""
    assert nblk.dtype == torch.int32 and nblk.shape == idx.shape[:-1]
    nonzero = (data != 0).any(dim=-1).any(dim=-1)
    real = torch.arange(idx.shape[-1]) < nblk[..., None]
    assert nonzero[real].all()
    assert not nonzero[~real].any() and not idx[~real].any()
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(nblk.numel(), dtype=torch.int32))
    counts = nblk.reshape(-1)[order.long()]
    assert (counts[:-1] >= counts[1:]).all()
    ties = counts[:-1] == counts[1:]
    assert (order[:-1][ties] < order[1:][ties]).all()


def truncated(data, idx, nblk, n, tile):
    """Each support of a flat ``(L, R, C, ...)`` structure as a BlockSparse
    cut to its fullest row's count (its transpose left empty)."""
    out = []
    for d, i, nb in zip(data, idx, nblk):
        c = max(int(nb.max()), 1)
        out.append(S.BlockSparse(data=d[:, :c], idx=i[:, :c], nblk=nb, data_t=d[:, :c],
                                 idx_t=i[:, :c], nblk_t=nb, n=n, tile=tile))
    return out


#: a ragged N against both kernel tiles; three supports of unequal reach
COUNT_N, COUNT_SHAPES = 300, ((300, 300), (3, 300, 300))


@pytest.mark.parametrize("tile", S.KERNEL_TILES)
@pytest.mark.parametrize("shape", COUNT_SHAPES)
def test_counts_mark_the_real_slots(shape, tile):
    mats = banded(shape, 60)  # the first and last block rows reach fewer block columns
    if len(shape) == 3:
        mats[0] = np.eye(shape[-1])
        built = stack_from_dense(mats, tile)
    else:
        built = from_dense(mats, tile)
    check_counts(built.data, built.idx, built.nblk, built.row_order)
    check_counts(built.data_t, built.idx_t, built.nblk_t, built.row_order_t)
    assert (built.nblk < built.idx.shape[-1]).any()  # padding exists to skip
    moved = built.to("cpu")
    for name in ("nblk", "nblk_t", "row_order", "row_order_t"):
        assert torch.equal(getattr(moved, name), getattr(built, name))
    assert place_supports(built, "cpu").nblk is not None
    full = dataclasses.replace(built, nblk=torch.full_like(built.nblk, built.idx.shape[-1]))
    assert torch.equal(full.row_order, torch.arange(built.nblk.numel(), dtype=torch.int32))


@pytest.mark.parametrize("tile", S.KERNEL_TILES)
def test_plain_versions_equal_on_structures_truncated_to_counts(tile):
    mats = banded((3, COUNT_N, COUNT_N), 150, seed=3)
    mats[0] = np.eye(COUNT_N)
    mats[1] *= np.abs(np.subtract.outer(np.arange(COUNT_N), np.arange(COUNT_N))) < 60
    stack = stack_from_dense(mats, tile)
    assert len({int(n.max()) for n in stack.nblk}) > 1  # supports are cut to different widths
    x, g = torch.tensor(signal((COUNT_N, 5))), torch.tensor(signal((3, COUNT_N, 5), seed=4))
    full, full_bwd = spmm_stack_reference(stack, x), spmm_stack_bwd_reference(stack, g, shared=True)
    fwd = truncated(stack.data, stack.idx, stack.nblk, COUNT_N, tile)
    bwd = truncated(stack.data_t, stack.idx_t, stack.nblk_t, COUNT_N, tile)
    for k in range(3):
        np.testing.assert_allclose(S.spmm_reference(fwd[k], x).numpy(), full[k].numpy(),
                                   rtol=1e-6, atol=1e-6)
    got_bwd = sum(S.spmm_reference(bwd[k], g[k]) for k in range(3))
    np.testing.assert_allclose(got_bwd.numpy(), full_bwd.numpy(), rtol=1e-6, atol=1e-5)
