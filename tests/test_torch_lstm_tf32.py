"""Numerics of the LSTM kernels' 3xTF32 products, rehearsed on the CPU.

``csrc/fused_lstm_fwd.cu`` and ``csrc/fused_lstm_bwd.cu`` compute every
matrix product of the recurrence on the tensor cores in TF32 with three
passes: each fp32 operand is split as ``x = hi + lo``, ``hi`` rounded to
TF32 (10 mantissa bits, round to nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and ``lo = x - hi`` truncated to TF32 (the tensor
core reads a TF32 operand's top 19 bits), and ``a @ b`` is taken as ``a_lo
@ b_hi + a_hi @ b_lo + a_hi @ b_hi`` (the ``lo @ lo`` term dropped, the
small terms first) into fp32 accumulators.

Here that scheme is emulated in torch and substituted for every ``@`` of
the unchanged plain versions (``fused_lstm_reference``: the gate products;
``fused_lstm_bwd_reference``: the gate recompute, ``dgates @ W^T`` and the
``hin^T @ dgates`` weight gradients), accumulator included:

- TF32 rounding and the split by bit manipulation;
- each ``mma`` (one k-step of 8, one pass) adds its exact products to the
  fp32 accumulator, rounding the sum toward zero, which is how the tensor
  cores' accumulation truncates (a model: the sum is taken exactly in fp64,
  then truncated);
- the sums run as long as the kernels let them before an fp32 add (round
  to nearest) joins them: the whole K for the gate products (from zero,
  where the kernels start from the projection or bias), ``CC``-column
  chunks for ``dgates @ W^T``, and for the weight gradients 32-row slabs of
  the rows ``n = t * R + r`` inside 4,096-row chunks whose partials are
  added in order, as ``lstm_bwd_wgrad`` and ``reduce_partials`` do.

The emulated sweeps must agree with the plain fp32 ones at the tolerances
``chip_smoke.py`` holds the kernels to on the card (forward and dxp
elementwise at rtol 1e-4, atol 1e-5; weight gradients normwise at 1e-5 of
their largest entry). A single TF32 pass must not, which is why the kernels
take three; nor may a weight gradient summed in one truncating accumulator
per 4,096-row chunk, the fault that broke the 1e-5 check on the card before
the slabs.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm_bwd_reference, fused_lstm_reference

torch.set_num_threads(1)

#: chip_smoke.py's kernel tolerances (KERNEL_*, BWD_*, WGRAD_RTOL)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
WGRAD_RTOL = 1e-5
T = 12
#: lstm_bwd_wgrad's rows per ring slab and per split-K chunk
WGRAD_SLAB, WGRAD_CHUNK = 32, 4096


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: keep 10 mantissa
    bits, round half away from zero (add half an ulp to the magnitude's bits,
    then clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 passed as TF32: the top 19
    bits (round toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """The kernels' split (``lstm_mma.cuh`` ``split``)."""
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def f32_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    f = v.to(torch.float32)
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mma_sum(a: torch.Tensor, b: torch.Tensor, passes: int, run: int) -> torch.Tensor:
    """``a @ b`` as the kernels' ``mma`` chain: k-steps of 8, each pass's
    exact products added to a float32 accumulator rounded toward zero; runs
    of ``run`` k summed from zero, then added in float32 in order."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    pairs = [(a_hi, b_hi)] if passes == 1 else [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    K = a.shape[-1]
    out = None
    for r0 in range(0, K, run):
        acc = None
        for k0 in range(r0, min(r0 + run, K), 8):
            for x, y in pairs:
                p = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
                acc = f32_toward_zero(p if acc is None else acc.double() + p)
        out = acc if out is None else out + acc
    return out


def wgrad_sum(hin: torch.Tensor, dgates: torch.Tensor, passes: int, slab: int) -> torch.Tensor:
    """``hin^T @ dgates`` over rows ``n = t * R + r`` as ``lstm_bwd_wgrad``
    sums it: per chunk of WGRAD_CHUNK rows, ``slab``-row sums added to the
    chunk's tile in float32; the chunks' partials added in order."""
    out = None
    for c0 in range(0, hin.shape[0], WGRAD_CHUNK):
        c1 = min(c0 + WGRAD_CHUNK, hin.shape[0])
        part = None
        for s0 in range(c0, c1, slab):
            s1 = min(s0 + slab, c1)
            s = mma_sum(hin[s0:s1].T, dgates[s0:s1], passes, slab)
            part = s if part is None else part + s
        out = part if out is None else out + part
    return out


def _transposed(x: torch.Tensor) -> bool:
    return x.dim() >= 2 and x.stride(-2) == 1 and x.stride(-1) != 1


class TF32Products(TorchFunctionMode):
    """Every ``@`` / ``torch.matmul`` inside the block as ``passes`` TF32
    passes (3: the kernels' scheme; 1: plain TF32) with the kernels' runs.
    The plain versions' operands tell the products apart: ``hin^T @
    dgates`` has a transposed left operand, ``dgates @ W^T`` a transposed
    right one, the gate products neither. The weight-gradient products are
    recorded and return zeros: :meth:`weight_grads` sums them across steps
    as the kernel does."""

    def __init__(self, passes: int):
        super().__init__()
        self.passes = passes
        self.calls = 0
        self.wgrad = []  # (hin, dgates) per (t, layer), in the sweep's order

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) not in ("matmul", "__matmul__"):
            return func(*args, **(kwargs or {}))
        self.calls += 1
        a, b = args
        if _transposed(a):
            self.wgrad.append((a.transpose(-1, -2), b))
            return a.new_zeros(a.shape[:-1] + b.shape[-1:])
        if _transposed(b):  # dgates @ W^T: W's column chunks of CC columns
            H4, K = b.shape[-2], b.shape[-1]
            kc = 16 if H4 // 4 <= 64 else 8
            return mma_sum(a, b, self.passes, kc * H4 // K)
        return mma_sum(a, b, self.passes, a.shape[-1])

    def weight_grads(self, L: int, slab: int = WGRAD_SLAB):
        """Each layer's weight gradient from the recorded products. The
        reverse sweep visits (t, layer) as t = T-1..0, layer = L-1..0."""
        grads = []
        for layer in range(L):
            steps = self.wgrad[L - 1 - layer::L][::-1]  # t = 0..T-1
            grads.append(wgrad_sum(torch.cat([h for h, _ in steps]),
                                   torch.cat([d for _, d in steps]), self.passes, slab))
        return grads


def _case(R, L, H, seed):
    """Operands as chip_smoke.py draws them: x ~ 2 N(0, 1), U(+-1/sqrt(H))
    weights, layer 0's hoisted projection; cotangents N(0, 1) everywhere."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(H)

    def uni(*shape):
        return torch.from_numpy(rng.uniform(-scale, scale, size=shape).astype(np.float32))

    x = torch.from_numpy((2 * rng.normal(size=(R, T, 1))).astype(np.float32))
    wx0, b0 = uni(1, 4 * H), uni(4 * H)
    fwd = ((x @ wx0 + b0).contiguous(), uni(L, H, 4 * H),
           uni(max(L - 1, 1), H, 4 * H), uni(max(L - 1, 1), 4 * H))
    cot = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                for s in ((R, T, H), (L, R, H), (L, R, H)))
    return fwd, cot


def _fwd_ok(got, want) -> bool:
    return all(torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL) for a, b in zip(got, want))


def _bwd_ok(got, want) -> bool:
    if not torch.allclose(got[0], want[0], rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        return False
    return all((a - b).abs().max() <= WGRAD_RTOL * b.abs().max() for a, b in zip(got[1:], want[1:]))


def _run_fwd(passes, fwd):
    mode = TF32Products(passes)
    with mode:
        out = fused_lstm_reference(*fwd, with_residuals=True)
    assert mode.calls > 0
    return out


def _run_bwd(passes, fwd, hseq, cseq, cot, slab=WGRAD_SLAB):
    """The emulated backward, its weight gradients summed as the kernel's
    split-K pass sums them."""
    mode = TF32Products(passes)
    with mode:
        dxp, dwh0, dwxh, db = fused_lstm_bwd_reference(*fwd, hseq, cseq, *cot)
    L = fwd[1].shape[0]
    assert mode.calls > 0 and len(mode.wgrad) == T * L
    dw = mode.weight_grads(L, slab)
    return dxp, dw[0], torch.stack(dw[1:]) if L > 1 else dwxh, db


@pytest.mark.parametrize("seed", range(4))
def test_tf32_split_is_exact_to_22_bits(seed):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=4096).astype(np.float32))
    hi, lo = tf32_split(x)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()  # TF32: 13 low bits clear
    assert ((hi - x).abs() <= x.abs() * 2.0**-11).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0**-21).all()


def test_accumulator_rounds_toward_zero():
    v = torch.tensor([1.0 + 2.0**-30, -(1.0 + 2.0**-30), 3.0], dtype=torch.float64)
    assert f32_toward_zero(v).tolist() == [1.0, -1.0, 3.0]
    # 1 + 0.75 ulp(1): one run of two k-steps truncates it to 1; two runs of
    # one k-step are joined by a float32 add, which rounds it to 1 + ulp
    a = torch.ones(1, 16, dtype=torch.float32)
    b = torch.zeros(16, 1, dtype=torch.float32)
    b[0, 0], b[8, 0] = 1.0, 1.5 * 2.0**-24
    assert mma_sum(a, b, passes=1, run=16).item() == 1.0
    assert mma_sum(a, b, passes=1, run=8).item() == 1.0 + 2.0**-23


@pytest.mark.parametrize("R,L,H", [(64, 1, 32), (200, 2, 32), (256, 3, 64), (96, 3, 64)])
def test_forward_3xtf32_holds_kernel_tolerance(R, L, H):
    fwd, _ = _case(R, L, H, seed=R + L + H)
    want = fused_lstm_reference(*fwd, with_residuals=True)
    assert _fwd_ok(_run_fwd(3, fwd), want)


@pytest.mark.parametrize("R,L,H", [(64, 1, 32), (200, 2, 32), (256, 3, 64), (96, 3, 64)])
def test_backward_3xtf32_holds_kernel_tolerance(R, L, H):
    fwd, cot = _case(R, L, H, seed=R + L + H + 1)
    hseq, cseq = fused_lstm_reference(*fwd, with_residuals=True)[3:]
    want = fused_lstm_bwd_reference(*fwd, hseq, cseq, *cot)
    assert _bwd_ok(_run_bwd(3, fwd, hseq, cseq, cot), want)


@pytest.mark.parametrize("R,L,H", [(256, 3, 64), (200, 2, 32)])
def test_single_pass_tf32_fails_kernel_tolerance(R, L, H):
    """The test has teeth: one TF32 pass misses both tolerances."""
    fwd, cot = _case(R, L, H, seed=R + L + H + 2)
    want = fused_lstm_reference(*fwd, with_residuals=True)
    assert not _fwd_ok(_run_fwd(1, fwd), want)
    hseq, cseq = want[3:]
    want_bwd = fused_lstm_bwd_reference(*fwd, hseq, cseq, *cot)
    assert not _bwd_ok(_run_bwd(1, fwd, hseq, cseq, cot), want_bwd)


@pytest.mark.parametrize("R,L,H", [(384, 1, 32), (384, 2, 32), (352, 1, 64)])
def test_wgrad_needs_short_truncating_sums(R, L, H):
    """R * T > 4,096 rows, so a split-K chunk is full: its weight gradient
    holds 1e-5 from 32-row slabs and misses it from one accumulator per
    chunk, the truncation bias that failed dwh0 on the card."""
    fwd, cot = _case(R, L, H, seed=R + L + H + 3)
    hseq, cseq = fused_lstm_reference(*fwd, with_residuals=True)[3:]
    want = fused_lstm_bwd_reference(*fwd, hseq, cseq, *cot)
    assert _bwd_ok(_run_bwd(3, fwd, hseq, cseq, cot), want)
    assert not _bwd_ok(_run_bwd(3, fwd, hseq, cseq, cot, slab=WGRAD_CHUNK), want)
