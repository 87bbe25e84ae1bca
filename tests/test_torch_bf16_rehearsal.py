"""Numerics of the LSTM kernels' bf16 forms, rehearsed on the CPU.

The bf16 forms of ``csrc/fused_lstm_fwd.cu`` and ``csrc/fused_lstm_bwd.cu``
take every product as ``mma.sync`` m16n8k16 bf16 passes: the operands are
bf16 (rounded where the JAX kernel's ``_mm`` rounds them), each k-step of
16 adds its exact products to an fp32 accumulator, and the tensor cores'
accumulation truncates (rounds toward zero), as it does for TF32. The
kernels keep the fp32 versions' short runs: the gate products sum their
whole K, ``dgates @ W^T`` sums column chunks of CC columns (CC = KC * 4H /
K, with KC = 32 bf16 rows per ring stage at H <= 64) from zero and adds
each to dh in fp32, and the weight gradients sum 32-row slabs from zero,
added in fp32 within 4,096-row chunks whose partials are added in order.

Here that scheme replaces every product of the plain bf16 versions
(``fused_lstm_reference``, ``fused_lstm_bwd_reference``), which
``chip_smoke.py`` holds the kernels against on the card, and the result
must hold ``chip_smoke.py``'s bf16 tolerances: outputs and dxp elementwise
(rtol 2^-6 plus 2^-7 of the largest entry), weight gradients normwise
(2^-8). A weight gradient summed over a whole 4,096-row chunk in one
truncating fp32 accumulator still holds the bf16 check (its bias, about
2^-12, is below bf16's resolution, where it broke the fp32 check), but one
summed in a bf16 accumulator, as a GEMM that rounds its running sum to
bf16 would sum it, misses it: the fp32 accumulation is what holds it.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm_bwd_reference, fused_lstm_reference

torch.set_num_threads(1)

BF = torch.bfloat16
#: chip_smoke.py's BF16_RTOL, BF16_ATOL_REL, BF16_WGRAD_NORM
RTOL, ATOL_REL, WGRAD_NORM = 2.0**-6, 2.0**-7, 2.0**-8
T = 12
#: lstm_bwd_wgrad's rows per slab and per split-K chunk
SLAB, CHUNK = 32, 4096


def f32_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero (the accumulator's add)."""
    f = v.to(torch.float32)
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mma_sum(a: torch.Tensor, b: torch.Tensor, run: int, bf16_acc: bool = False):
    """``a @ b`` (bf16-exact float32 operands) as the kernels' mma chain:
    k-steps of 16, each adding its exact products to a truncating fp32
    accumulator (or, with ``bf16_acc``, rounding the running sum to bf16),
    runs of ``run`` k summed from zero and added in fp32."""
    out = None
    for r0 in range(0, a.shape[-1], run):
        acc = None
        for k0 in range(r0, min(r0 + run, a.shape[-1]), 16):
            p = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
            acc = f32_toward_zero(p if acc is None else acc.double() + p)
            if bf16_acc:
                acc = acc.to(BF).float()
        out = acc if out is None else out + acc
    return out


def wgrad_sum(hin, dgates, slab: int, bf16_acc: bool):
    """``hin^T @ dgates`` over rows n = t * R + r as ``lstm_bwd_wgrad`` sums
    it: per 4,096-row chunk, ``slab``-row sums added in fp32; the chunks'
    partials added in order."""
    out = None
    for c0 in range(0, hin.shape[0], CHUNK):
        c1 = min(c0 + CHUNK, hin.shape[0])
        part = None
        for s0 in range(c0, c1, slab):
            s = mma_sum(hin[s0:min(s0 + slab, c1)].T, dgates[s0:min(s0 + slab, c1)], slab,
                        bf16_acc)
            part = s if part is None else part + s
        out = part if out is None else out + part
    return out


def _transposed(x: torch.Tensor) -> bool:
    return x.dim() >= 2 and x.stride(-2) == 1 and x.stride(-1) != 1


class BF16Products(TorchFunctionMode):
    """Every ``@`` of the plain bf16 versions as the kernels' bf16 mma
    chain with their runs. ``hin^T @ dgates`` (a transposed left operand)
    is recorded and returns zeros: :meth:`weight_grads` sums the records as
    the kernel's split-K pass does; ``dgates @ W^T`` (a transposed right
    operand) runs in CC-column chunks; the gate products over their K."""

    def __init__(self, bf16_acc: bool = False):
        super().__init__()
        self.bf16_acc = bf16_acc
        self.calls = 0
        self.wgrad = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) not in ("matmul", "__matmul__"):
            return func(*args, **(kwargs or {}))
        self.calls += 1
        a, b = args
        for t in (a, b):  # the plain versions hand bf16 values to every product
            assert torch.equal(t, t.to(BF).float())
        if _transposed(a):
            self.wgrad.append((a.transpose(-1, -2), b))
            return a.new_zeros(a.shape[:-1] + b.shape[-1:])
        if _transposed(b):
            H4, K = b.shape[-2], b.shape[-1]
            kc = 32 if H4 // 4 <= 64 else 16
            return mma_sum(a, b, kc * H4 // K, self.bf16_acc)
        return mma_sum(a, b, a.shape[-1], self.bf16_acc)

    def weight_grads(self, L: int, slab: int):
        grads = []
        for layer in range(L):
            steps = self.wgrad[L - 1 - layer::L][::-1]  # t = 0..T-1
            grads.append(wgrad_sum(torch.cat([h for h, _ in steps]),
                                   torch.cat([d for _, d in steps]), slab, self.bf16_acc))
        return grads


def _case(R, L, H, seed):
    """bf16 operands as chip_smoke.py draws them, and bf16 cotangents."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(BF)

    x = 2 * rng.normal(size=(R, T, 1))
    wx0, b0 = rng.uniform(-s, s, size=(1, 4 * H)), rng.uniform(-s, s, size=4 * H)
    fwd = (t(x @ wx0 + b0), t(rng.uniform(-s, s, size=(L, H, 4 * H))),
           t(rng.uniform(-s, s, size=(max(L - 1, 1), H, 4 * H))),
           t(rng.uniform(-s, s, size=(max(L - 1, 1), 4 * H))))
    cot = tuple(t(rng.normal(size=shape)) for shape in ((R, T, H), (L, R, H), (L, R, H)))
    return fwd, cot


def _elementwise_ok(got, want) -> bool:
    return all(torch.allclose(a.float(), b.float(), rtol=RTOL,
                              atol=ATOL_REL * b.float().abs().max().item())
               for a, b in zip(got, want))


def _normwise_ok(got, want) -> bool:
    return all((a - b).norm() <= WGRAD_NORM * b.norm() for a, b in zip(got, want))


def _emulated_bwd(fwd, hseq, cseq, cot, bf16_acc=False, slab=SLAB):
    mode = BF16Products(bf16_acc)
    with mode:
        dxp, dwh0, dwxh, db = fused_lstm_bwd_reference(*fwd, hseq, cseq, *cot)
    L = fwd[1].shape[0]
    assert mode.calls > 0 and len(mode.wgrad) == T * L
    dw = mode.weight_grads(L, slab)
    return dxp, dw[0], torch.stack(dw[1:]) if L > 1 else dwxh, db


@pytest.mark.parametrize("R,L,H", [(64, 1, 32), (96, 2, 64), (128, 3, 64)])
def test_forward_bf16_mma_holds_kernel_tolerance(R, L, H):
    fwd, _ = _case(R, L, H, seed=R + L + H)
    want = fused_lstm_reference(*fwd, with_residuals=True)
    mode = BF16Products()
    with mode:
        got = fused_lstm_reference(*fwd, with_residuals=True)
    assert mode.calls == T * L and _elementwise_ok(got, want)


@pytest.mark.parametrize("R,L,H", [(64, 1, 32), (96, 2, 64), (384, 3, 64)])
def test_backward_bf16_mma_holds_kernel_tolerance(R, L, H):
    """R = 384: R * T = 4,608 rows, one full split-K chunk and a part."""
    fwd, cot = _case(R, L, H, seed=R + L + H + 1)
    hseq, cseq = fused_lstm_reference(*fwd, with_residuals=True)[3:]
    want = fused_lstm_bwd_reference(*fwd, hseq, cseq, *cot)
    got = _emulated_bwd(fwd, hseq, cseq, cot)
    assert _elementwise_ok(got[:1], want[:1])
    assert _normwise_ok(got[1:], want[1:])


def test_bf16_accumulator_misses_the_weight_gradient_check():
    """The test has teeth: a chunk summed in one truncating fp32
    accumulator holds the normwise weight-gradient check, the same chunk in
    a bf16 accumulator misses it."""
    fwd, cot = _case(384, 2, 64, seed=9)
    hseq, cseq = fused_lstm_reference(*fwd, with_residuals=True)[3:]
    want = fused_lstm_bwd_reference(*fwd, hseq, cseq, *cot)
    assert _normwise_ok(_emulated_bwd(fwd, hseq, cseq, cot, slab=CHUNK)[1:], want[1:])
    assert not _normwise_ok(
        _emulated_bwd(fwd, hseq, cseq, cot, bf16_acc=True, slab=CHUNK)[1:], want[1:])
