"""Parameter plumbing shared by the port's modules: device resolution,
seeded initializers matching the JAX package's, the branch axis, the
compute dtype, and the ``Dense`` layer (flax ``nn.Dense``'s counterpart).

**Compute dtype.** Every module carries ``compute_dtype``: None (the
float32 path) or ``torch.bfloat16``, set for a whole model by
:func:`set_compute_dtype`. One body serves both: under None the casts are
the identity and the products plain float32 ones. Parameters stay float32
masters; under bf16 each module casts its operands, weights and
activations alike, to bf16 where it uses them (flax's ``promote_dtype``)
and takes its products through :func:`accum_matmul` /
:func:`accum_einsum`, the port's ``accum_dot_general``: bf16 operands, a
float32 result. Both devices take
its portable form, which multiplies the bf16 values as float32 (each
product of two bf16 values is exact in float32, and the sum is a float32
sum, as XLA's ``preferred_element_type=f32``); PyTorch's default float32
matmul precision ("highest", TF32 off) keeps the card's GEMM from
rounding the operands again. ``torch.mm(..., out_dtype=torch.float32)``
(bf16 operands, a float32 result) has no CPU kernel in torch 2.13's CPU
build and no autograd formula in torch 2.11's CUDA build; these plain
products stay library calls, as the JAX package leaves them to XLA.

Every module takes ``branches``: ``None`` gives plain parameters, an
integer ``M`` gives every parameter a leading ``(M, ...)`` axis — the
layout ``nn.vmap(variable_axes={'params': 0})`` gives the JAX flagship's
branches — and the forward then carries that axis on its outputs.
Parameters are drawn on the CPU from an explicit ``torch.Generator`` and
then moved to the module's device, so one seed gives the same weights on
every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = [
    "Dense",
    "accum_einsum",
    "accum_matmul",
    "branch_view",
    "branchwise_einsum",
    "lecun_normal",
    "lstm_uniform",
    "new_param",
    "promote_dtype",
    "resolve_device",
    "set_compute_dtype",
    "xavier_normal",
]

#: std of a standard normal truncated to [-2, 2] (flax's variance_scaling
#: divides by it so the truncated draw keeps the requested variance)
_TRUNC_STD = 0.87962566103423978


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Asking for CUDA without one raises: the
    port never carries on quietly on the CPU; pass ``device="cpu"`` for
    that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the host"
        )
    return dev


def _truncated(shape, std: float, generator) -> torch.Tensor:
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out * (std / _TRUNC_STD)


def lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal, variance ``1 / fan_in``."""
    return _truncated(shape, math.sqrt(1.0 / fan_in), generator)


def xavier_normal(shape, fan_in: int, fan_out: int, generator) -> torch.Tensor:
    """flax ``xavier_normal``: truncated normal, variance ``2 / (in + out)``."""
    return _truncated(shape, math.sqrt(2.0 / (fan_in + fan_out)), generator)


def lstm_uniform(shape, hidden: int, generator) -> torch.Tensor:
    """torch's LSTM init, ``U(-1/sqrt(H), 1/sqrt(H))``."""
    scale = 1.0 / math.sqrt(hidden)
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale


def new_param(value: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(value.to(device=device, dtype=torch.float32))


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Set the compute dtype of every module of ``model`` that has one:
    None (float32) or ``torch.bfloat16``. Returns ``model``."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be None, float32 or bfloat16, got {dtype}")
    dtype = None if dtype == torch.float32 else dtype
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = dtype
    return model


def promote_dtype(dtype: Optional[torch.dtype], *tensors):
    """``tensors`` cast to the compute ``dtype`` (flax's ``promote_dtype``
    with a module's ``dtype``); unchanged when ``dtype`` is None."""
    if dtype is None:
        return tensors
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def accum_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result: for bf16 operands the products
    exact, the sum in float32 (``accum_dot_general``); for float32 ones the
    plain product."""
    return a.float() @ b.float()


def accum_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`accum_matmul` for an einsum contraction."""
    return torch.einsum(spec, a.float(), b.float())


def branchwise_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`accum_einsum` of a ``spec`` written for one branch, where an
    operand with one more axis than its term carries a leading branch axis
    ``M``: then one product per branch, stacked (an operand without the axis
    is shared by every branch). One batched GEMM over stacked branches
    rounds differently from the per-branch products, so every dense support
    product (one device, per-row stacks, a region strip) takes this one form."""
    terms = spec.split("->")[0].split(",")
    lead_a, lead_b = a.dim() > len(terms[0]), b.dim() > len(terms[1])
    if not (lead_a or lead_b):
        return accum_einsum(spec, a, b)
    m = a.shape[0] if lead_a else b.shape[0]
    parts_a = a.unbind(0) if lead_a else (a,) * m
    parts_b = b.unbind(0) if lead_b else (b,) * m
    return torch.stack([accum_einsum(spec, pa, pb) for pa, pb in zip(parts_a, parts_b)])


def branch_view(p: torch.Tensor, branches: Optional[int], n_mid: int) -> torch.Tensor:
    """``p`` with ``n_mid`` singleton axes after its branch axis (a no-op
    without one), so a per-branch parameter broadcasts over activations
    shaped ``(M, *mid, ...)``."""
    if branches is None:
        return p
    return p.reshape(p.shape[:1] + (1,) * n_mid + p.shape[1:])


class Dense(nn.Module):
    """``y = x W^T + b`` with ``nn.Linear``'s ``(out, in)`` weight layout;
    lecun-normal weight, zero bias (flax ``nn.Dense`` defaults). Under a
    bf16 compute dtype (flax ``Dense(dtype=bfloat16, dot_general=
    accum_dot_general)``): x, W and b rounded to bf16, the product and the
    bias add in float32, the result float32."""

    def __init__(self, in_features: int, out_features: int, *,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        lead = () if branches is None else (branches,)
        self.branches = branches
        self.compute_dtype: Optional[torch.dtype] = None
        self.weight = new_param(
            lecun_normal(lead + (out_features, in_features), in_features, generator),
            device,
        )
        self.bias = new_param(torch.zeros(lead + (out_features,)), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote_dtype(self.compute_dtype, x, self.weight, self.bias)
        if self.branches is None:
            return accum_matmul(x, w.T) + b.float()
        y = accum_einsum("m...i,moi->m...o", x, w)
        return y + branch_view(b.float(), self.branches, x.dim() - 2)
