"""Numerics of the block-CSR kernels' 3xTF32 products, rehearsed on the CPU.

``csrc/spmm_stack.cu`` (B3, B4 and B5) takes every product on the tensor
cores in TF32 with three passes, as the LSTM kernels do: each fp32 operand
split as ``x = hi + lo`` and ``a @ b`` taken as ``a_lo @ b_hi + a_hi @ b_lo
+ a_hi @ b_hi`` into a truncating fp32 accumulator. The split and the
accumulator model are ``tests/test_torch_lstm_tf32.py``'s, imported.

Here they replace the contraction of ``_block_apply`` (``ops/spmm.py``,
the gather of the signal's row blocks by the index lists, then each
block's product) in the kernels' own summation order:

- each real block's t-deep product (``c < nblk``; the padding blocks are
  zero and add nothing) is its own run: k-steps of 8 in a truncating
  accumulator from zero;
- a block row's runs are added in slot order in fp32 (round to nearest);
- B4: each support's (and branch's) block row is a partial, and the
  partials are added over the sources in order, as ``reduce_parts`` does.

The emulated B3 and B4 agree with the fp32 plain versions
(``spmm_stack_reference``, ``spmm_stack_bwd_reference``) at the tolerance
``chip_smoke.py`` holds the kernels to on the card (rtol 1e-5 plus 1e-5 of
the output's largest entry); one TF32 pass misses it by some 20x, which is
why the kernels take three.

Would one truncating accumulator over all of B4's K x C x t terms of an
output block do? No: it holds at small plans (a few hundred terms), but
once the block rows hold ten or more real blocks (2,000-3,500 terms: 64
and 128 tiles at N = 1,024 and 1,600 below; the metro city has up to 3 x
15 x 128 = 5,760) its truncation bias misses the tolerance, by 4% to 60%
in these cases. So the kernels keep the per-block runs.
"""

import numpy as np
import pytest
import torch
from test_torch_lstm_tf32 import f32_toward_zero, tf32_split
from test_torch_tiling import scrambled_supports

from stmgcn_tpu_torch.ops.spmm import spmm_stack_bwd_reference, spmm_stack_reference
from stmgcn_tpu_torch.ops.tiling import plan_tiling

torch.set_num_threads(1)

#: chip_smoke.py's SPMM_RTOL and SPMM_ATOL (the latter times max |want|)
SPMM_RTOL, SPMM_ATOL = 1e-5, 1e-5
#: (grid side, tile, random-link density): a small plan, then two whose
#: block rows hold ten or more real blocks (N = 1,024 and 1,600)
PLANS = [(16, 64, 0.02), (32, 64, 0.01), (40, 128, 0.01)]
F = 4


def mma_run(a, b, passes, acc=None):
    """``a @ b`` (``a`` ``(..., t, t)``, ``b`` ``(..., t, F)``) as k-steps of
    8, each pass's exact products added to a float32 accumulator rounded
    toward zero; ``acc`` continues a run (None starts one from zero)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    pairs = [(a_hi, b_hi)] if passes == 1 else [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            p = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = f32_toward_zero(p if acc is None else acc.double() + p)
    return acc


def gathered(data, idx, src, src_of):
    """``_block_apply``'s gather: the signal's row block of every slot,
    ``(L, R, C, t, F)``."""
    t = data.shape[-1]
    n_src, width = src.shape[-2:]
    rs = -(-n_src // t)
    blocks = torch.nn.functional.pad(src, (0, 0, 0, rs * t - n_src)).reshape(-1, rs, t, width)
    return blocks[src_of[:, None, None], idx.long()]


def emulated(data, idx, nblk, src, src_of, S, n_out, passes=3, one_run=False):
    """The kernels' sum over a flat ``(L, R, C, t, t)`` structure: row ``l``
    is source ``l % S`` of output group ``l // S``; returns ``(L // S,
    n_out, F)``. ``one_run``: every term of an output block in one
    truncating accumulator instead (sources, then slots, then k)."""
    L, R, C, t, _ = data.shape
    G = gathered(data, idx, src, src_of)
    O = L // S
    if one_run:
        acc = torch.zeros(O, R, t, src.shape[-1])
        d, g = data.reshape(O, S, R, C, t, t), G.reshape(O, S, R, C, t, -1)
        for s in range(S):
            for c in range(C):  # a padding block's products are zero: acc stays exact
                acc = mma_run(d[:, s, :, c], g[:, s, :, c], passes, acc)
        return acc.reshape(O, R * t, -1)[:, :n_out]
    real = (torch.arange(C) < nblk[..., None])[..., None, None]
    runs = torch.where(real, mma_run(data, G, passes), 0.0)  # one run per block
    part = runs[:, :, 0]
    for c in range(1, C):
        part = part + runs[:, :, c]
    part = part.reshape(O, S, R, t, -1)
    out = part[:, 0]
    for s in range(1, S):
        out = out + part[:, s]
    return out.reshape(O, R * t, -1)[:, :n_out]


def within(got, want) -> bool:
    scale = want.abs().max()
    return bool(torch.allclose(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL * scale))


def case(side, tile, noise, kernel):
    """``(got(passes, one_run), want)`` for one kernel on a plan of M = 3
    scrambled grids' K = 3 Chebyshev supports; the signal and cotangent
    from numpy."""
    plan = plan_tiling(scrambled_supports(side, noise=noise, order=2), tile)
    stack = plan.as_stack()
    M, K, N = plan.m_graphs, plan.n_supports, plan.n
    L = M * K
    rng = np.random.default_rng(side + tile)
    arange = torch.arange(L)

    def flat(t):
        return t.reshape((L,) + tuple(t.shape[2:]))

    if kernel.startswith("B3"):
        shared = kernel == "B3 shared x"
        x = torch.from_numpy(rng.normal(size=(N, F) if shared else (M, N, F)).astype(np.float32))
        want = spmm_stack_reference(stack, x).reshape(L, N, F)
        src, src_of = (x[None], arange * 0) if shared else (x, arange // K)
        ops = (flat(stack.data), flat(stack.idx), flat(stack.nblk), src, src_of, 1, N)
    else:
        shared = kernel == "B4 shared x"
        g = torch.from_numpy(rng.normal(size=(M, K, N, F)).astype(np.float32))
        want = spmm_stack_bwd_reference(stack, g, shared=shared)
        want = want[None] if shared else want
        ops = (flat(stack.data_t), flat(stack.idx_t), flat(stack.nblk_t), g.reshape(L, N, F),
               arange, L if shared else K, N)
    return (lambda passes=3, one_run=False: emulated(*ops, passes=passes, one_run=one_run)), want


KERNELS = ["B3 shared x", "B3 per-branch x", "B4 shared x", "B4 per-branch x"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("side,tile,noise", PLANS)
def test_3xtf32_per_block_runs_hold_the_kernel_tolerance(side, tile, noise, kernel):
    got, want = case(side, tile, noise, kernel)
    assert within(got(), want)


@pytest.mark.parametrize("kernel", KERNELS)
def test_single_pass_tf32_misses_the_kernel_tolerance(kernel):
    """The test has teeth: one TF32 pass misses the tolerance."""
    got, want = case(*PLANS[1], kernel)
    assert not within(got(passes=1), want)


@pytest.mark.parametrize("side,tile,noise", PLANS)
def test_one_truncating_run_over_b4_terms(side, tile, noise):
    """One accumulator over all of an output block's K x C x t terms holds
    the small plan and misses the two larger ones; the per-block runs hold
    all three."""
    got, want = case(side, tile, noise, "B4 per-branch x")
    assert within(got(), want)
    assert within(got(one_run=True), want) == (side == PLANS[0][0])
