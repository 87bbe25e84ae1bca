"""Multi-layer LSTM over a ``(B, T, F)`` sequence, zero initial state.

Counterpart of ``stmgcn_tpu/ops/lstm.py`` (``StackedLSTM``). Gate order
i, f, g, o; one fused bias ``b`` per layer (torch's ``nn.LSTM`` carries
``b_ih + b_hh``); ``U(-1/sqrt(H), 1/sqrt(H))`` init; per-layer parameters
``wx_l (in, 4H)``, ``wh_l (H, 4H)``, ``b_l (4H,)`` as in the flax tree.

Two routes, chosen by where the input lives:

- CUDA tensors take the kernel route (the JAX ``_pallas`` path): layer 0's
  input projection ``x @ wx_0 + b_0`` for all T steps is one matmul, and
  the whole ``T x L`` recurrence is one launch of the hand-written kernel
  (:func:`~stmgcn_tpu_torch.ops.fused_lstm.fused_lstm`) — for every branch
  at once when the module carries a branch axis;
- CPU tensors take the layered path: per layer, the hoisted input
  projection, then a Python loop over t of ``h @ wh``.

The XLA schedule knobs (``fused_scan``, ``unroll``, ``remat``) have no
counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm
from stmgcn_tpu_torch.ops.layers import branch_view, lstm_uniform, new_param

__all__ = ["StackedLSTM"]


def _cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


class StackedLSTM(nn.Module):
    """``num_layers`` stacked LSTMs; ``forward`` returns ``(outputs,
    final_states)``: the top layer's ``([M,] B, T, H)`` hidden sequence and
    a list of per-layer ``(h, c)`` pairs."""

    def __init__(self, in_features: int, hidden_dim: int, num_layers: int = 1, *,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.branches = branches
        lead = () if branches is None else (branches,)
        h4 = 4 * hidden_dim
        in_dim = in_features
        for layer in range(num_layers):
            for name, shape in (
                (f"wx_{layer}", (in_dim, h4)),
                (f"wh_{layer}", (hidden_dim, h4)),
                (f"b_{layer}", (h4,)),
            ):
                value = lstm_uniform(lead + shape, hidden_dim, generator)
                self.register_parameter(name, new_param(value, device))
            in_dim = hidden_dim

    def layer_params(self, layer: int):
        return (getattr(self, f"wx_{layer}"), getattr(self, f"wh_{layer}"),
                getattr(self, f"b_{layer}"))

    def forward(self, x: torch.Tensor):
        if x.is_cuda:
            return self.fused(x)
        return self.layered(x)

    def layered(self, x: torch.Tensor):
        """Layer by layer: hoisted input projection, then a loop over t."""
        final_states = []
        inputs = x
        for layer in range(self.num_layers):
            wx, wh, b = self.layer_params(layer)
            x_proj = inputs @ wx.unsqueeze(-3) if self.branches else inputs @ wx
            x_proj = x_proj + branch_view(b, self.branches, 2)
            h = x_proj.new_zeros(x_proj.shape[:-2] + (self.hidden_dim,))
            c = torch.zeros_like(h)
            hs = []
            for t in range(x_proj.shape[-2]):
                h, c = _cell(x_proj[..., t, :] + h @ wh, c)
                hs.append(h)
            inputs = torch.stack(hs, dim=-2)
            final_states.append((h, c))
        return inputs, final_states

    def fused(self, x: torch.Tensor):
        """Kernel route: hoisted layer-0 projection + one fused launch."""
        L, h4 = self.num_layers, 4 * self.hidden_dim
        wx0, _, b0 = self.layer_params(0)
        x_proj0 = x @ wx0.unsqueeze(-3) if self.branches else x @ wx0
        x_proj0 = (x_proj0 + branch_view(b0, self.branches, 2)).contiguous()
        wh_stack = torch.stack([self.layer_params(layer)[1] for layer in range(L)], dim=-3)
        if L > 1:
            wx_stack = torch.stack(
                [self.layer_params(layer)[0] for layer in range(1, L)], dim=-3)
            b_stack = torch.stack(
                [self.layer_params(layer)[2] for layer in range(1, L)], dim=-2)
        else:  # never-read placeholder: the kernel operand can't be empty
            lead = x_proj0.shape[:-3]
            wx_stack = x_proj0.new_zeros(lead + (1, self.hidden_dim, h4))
            b_stack = x_proj0.new_zeros(lead + (1, h4))
        hs_top, h_fin, c_fin = fused_lstm(x_proj0, wh_stack, wx_stack, b_stack)
        return hs_top, [(h_fin[..., layer, :, :], c_fin[..., layer, :, :])
                        for layer in range(L)]
