"""Parameter plumbing shared by the port's modules: device resolution,
seeded initializers matching the JAX package's, the branch axis, and the
``Dense`` layer (flax ``nn.Dense``'s counterpart).

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
    "branch_view",
    "lecun_normal",
    "lstm_uniform",
    "new_param",
    "resolve_device",
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


def branch_view(p: torch.Tensor, branches: Optional[int], n_mid: int) -> torch.Tensor:
    """``p`` with ``n_mid`` singleton axes after its branch axis (a no-op
    without one), so a per-branch parameter broadcasts over activations
    shaped ``(M, *mid, ...)``."""
    if branches is None:
        return p
    return p.reshape(p.shape[:1] + (1,) * n_mid + p.shape[1:])


class Dense(nn.Module):
    """``y = x W^T + b`` with ``nn.Linear``'s ``(out, in)`` weight layout;
    lecun-normal weight, zero bias (flax ``nn.Dense`` defaults)."""

    def __init__(self, in_features: int, out_features: int, *,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        lead = () if branches is None else (branches,)
        self.branches = branches
        self.weight = new_param(
            lecun_normal(lead + (out_features, in_features), in_features, generator),
            device,
        )
        self.bias = new_param(torch.zeros(lead + (out_features,)), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.branches is None:
            return x @ self.weight.T + self.bias
        y = torch.einsum("m...i,moi->m...o", x, self.weight)
        return y + branch_view(self.bias, self.branches, x.dim() - 2)
