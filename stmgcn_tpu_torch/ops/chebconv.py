"""K-support graph convolution as one fused contraction (dense supports).

Counterpart of ``stmgcn_tpu/ops/chebconv.py`` (``ChebGraphConv`` and its
``_project`` tail): all K support propagations in one
``einsum('kij,bjf->bikf')``, a k-major flatten (matching
``torch.cat(support_list, dim=-1)``), then the shared ``(K*F_in, F_out)``
projection with bias and ReLU. Xavier-normal weight, zero bias. Float32
throughout. The sparse, banded and tiled convolutions are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from stmgcn_tpu_torch.ops.layers import branch_view, new_param, xavier_normal

__all__ = ["ChebGraphConv"]


def _project(stacked, w, b, activation):
    """Projection / bias / activation tail: ``act(stacked @ w + b)``."""
    out = torch.matmul(stacked, w)
    if b is not None:
        out = out + b
    if activation is not None:
        out = activation(out)
    return out


class ChebGraphConv(nn.Module):
    """Graph convolution over a stack of K dense support matrices.

    Call with ``supports`` ``([M,] K, N, N)`` and a signal ``x``
    ``([M,] B, N, F_in)``; returns ``([M,] B, N, features)``. With
    ``branches=M`` the parameters carry a leading ``M`` axis and an ``x``
    without one is shared by every branch.
    """

    def __init__(self, n_supports: int, in_features: int, features: int, *,
                 use_bias: bool = True,
                 activation: Optional[Callable] = torch.relu,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        self.n_supports = n_supports
        self.features = features
        self.activation = activation
        self.branches = branches
        lead = () if branches is None else (branches,)
        fan_in = n_supports * in_features
        self.W = new_param(
            xavier_normal(lead + (fan_in, features), fan_in, features, generator),
            device,
        )
        self.b = new_param(torch.zeros(lead + (features,)), device) if use_bias else None

    def forward(self, supports: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if supports.shape[-3] != self.n_supports:
            raise ValueError(
                f"expected {self.n_supports} supports, got {supports.shape[-3]}"
            )
        propagated = torch.einsum("...kij,...bjf->...bikf", supports, x)
        stacked = propagated.flatten(-2)  # k-major (B, N, K*F_in)
        w = branch_view(self.W, self.branches, 1)
        b = None if self.b is None else branch_view(self.b, self.branches, 2)
        return _project(stacked, w, b, self.activation)
