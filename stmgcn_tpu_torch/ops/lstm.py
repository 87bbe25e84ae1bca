"""Multi-layer LSTM over a ``(B, T, F)`` sequence, zero initial state.

Counterpart of ``stmgcn_tpu/ops/lstm.py`` (``StackedLSTM``). Gate order
i, f, g, o; one fused bias ``b`` per layer (torch's ``nn.LSTM`` carries
``b_ih + b_hh``); ``U(-1/sqrt(H), 1/sqrt(H))`` init; per-layer parameters
``wx_l (in, 4H)``, ``wh_l (H, 4H)``, ``b_l (4H,)`` as in the flax tree.

Two routes, chosen by where the input lives and the compute dtype:

- CUDA tensors, and every tensor under a bf16 compute dtype, take the
  kernel route (the JAX ``_pallas`` path): layer 0's
  input projection ``x @ wx_0 + b_0`` for all T steps is one matmul, and
  the whole ``T x L`` recurrence is one launch of the hand-written kernel
  (:func:`~stmgcn_tpu_torch.ops.fused_lstm.fused_lstm`) per group of up to
  four layers — for every branch at once when the module carries a branch
  axis — with ``H`` padded up to a kernel width where it is not one
  (:func:`~stmgcn_tpu_torch.ops.fused_lstm.fused_lstm_autograd`). Under
  autograd it goes through
  :class:`~stmgcn_tpu_torch.ops.fused_lstm.FusedLSTM`, whose backward is
  one launch of the backward kernel per group, so every parameter gets
  its gradient;
- float32 CPU tensors take the layered path: per layer, the hoisted
  input projection, then a Python loop over t of ``h @ wh`` (unless
  ``kernel_route`` is set, as an exported program sets it: then the kernel
  route, whose operator runs the plain version on the CPU).

Under a bf16 compute dtype the route takes the kernel route on both
devices, so the CPU tests hold the function the card runs (the kernels'
plain versions on the CPU), in the form ``backend`` names, as the JAX
``StackedLSTM``'s ``backend`` does:

- ``"xla"`` (the default, as in the JAX package): the JAX scan paths at
  ``dtype=bfloat16``. ``x_proj0 = bf16(x) @ bf16(wx_0) + b_0`` is float32
  (an f32 product of exact bf16 values), the states and ``hs_top`` stay
  float32, and each product rounds its operands to bf16 (the kernels' xla
  form, ``ops/fused_lstm.py``). ``fused_scan`` picks the schedule's
  rounding: the layered scan (False) rounds every bias through bf16 and
  each layer's input weight as a whole (its gradient rounded once, through
  autograd's casts here); the fused scan (True) adds the float32 bias
  masters and rounds each step's input-weight gradient (in the kernel).
- ``"pallas"``: the JAX ``_pallas`` path: ``_collect_params`` rounds x and
  every weight and bias to bf16, ``x_proj0 = x @ wx_0 + b_0`` is a bf16
  tensor (the product rounded, then the bias add rounded), and the kernels
  store in bf16.

At float32 both backends and both schedules are one function (the JAX
backends agree to float32 rounding), and run the same kernels. The JAX
``unroll`` and ``remat`` schedules have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm_autograd
from stmgcn_tpu_torch.ops.layers import (
    branch_view,
    promote_dtype,
    lstm_uniform,
    new_param,
)

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
                 backend: str = "xla", fused_scan: bool = False,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend must be xla|pallas, got {backend!r}")
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.branches = branches
        #: the bf16 form (module docstring); read at every forward
        self.backend = backend
        self.fused_scan = fused_scan
        self.compute_dtype: Optional[torch.dtype] = None
        #: take the kernel route on every device, the CPU too: what an
        #: exported program needs, whose operator picks the kernel or its
        #: plain version where the program runs (``export.py``)
        self.kernel_route = False
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
        if x.is_cuda or self.compute_dtype is not None or self.kernel_route:
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
        """Kernel route: hoisted layer-0 projection + one fused launch per
        group of up to four layers (and as many backward launches under
        autograd)."""
        if self.compute_dtype is not None and self.backend == "xla":
            return self._fused_xla(x)
        L, h4 = self.num_layers, 4 * self.hidden_dim
        # _collect_params: x and every parameter in the compute dtype
        params = [promote_dtype(self.compute_dtype, *self.layer_params(layer))
                  for layer in range(L)]
        (x,) = promote_dtype(self.compute_dtype, x)
        wx0, _, b0 = params[0]
        x_proj0 = x @ wx0.unsqueeze(-3) if self.branches else x @ wx0
        x_proj0 = (x_proj0 + branch_view(b0, self.branches, 2)).contiguous()
        wh_stack = torch.stack([params[layer][1] for layer in range(L)], dim=-3)
        if L > 1:
            wx_stack = torch.stack([params[layer][0] for layer in range(1, L)], dim=-3)
            b_stack = torch.stack([params[layer][2] for layer in range(1, L)], dim=-2)
        else:  # never-read placeholder: the kernel operand can't be empty
            lead = x_proj0.shape[:-3]
            wx_stack = x_proj0.new_zeros(lead + (1, self.hidden_dim, h4))
            b_stack = x_proj0.new_zeros(lead + (1, h4))
        hs_top, h_fin, c_fin = fused_lstm_autograd(x_proj0, wh_stack, wx_stack, b_stack)
        return hs_top, [(h_fin[..., layer, :, :], c_fin[..., layer, :, :])
                        for layer in range(L)]

    def _fused_xla(self, x: torch.Tensor):
        """The kernel route in the xla form (module docstring). Each
        ``astype(bf16)`` of the JAX scan is a round trip through bf16 here,
        whose autograd rounds the cotangent as the cast's transpose does.
        The parameters may be a bf16 shadow (stochastic rounding), as the
        JAX scan then closes over bf16 weights: their gradients come back in
        bf16, summed over the steps in bf16 as the scan's carries sum them
        (``ops/fused_lstm.py``)."""
        L, h4, cdt = self.num_layers, 4 * self.hidden_dim, self.compute_dtype

        def rnd(t):
            return t.to(cdt).float()

        bias = (lambda b: b) if self.fused_scan else rnd
        wx0, _, b0 = self.layer_params(0)
        xb = rnd(x)
        x_proj0 = xb @ rnd(wx0).unsqueeze(-3) if self.branches else xb @ rnd(wx0)
        x_proj0 = (x_proj0 + branch_view(bias(b0), self.branches, 2)).contiguous()
        wh_stack = torch.stack([self.layer_params(layer)[1] for layer in range(L)], dim=-3)
        if L > 1:
            wx = [self.layer_params(layer)[0] for layer in range(1, L)]
            wx_stack = torch.stack(wx if self.fused_scan else [rnd(w) for w in wx], dim=-3)
            b_stack = torch.stack([bias(self.layer_params(layer)[2]) for layer in range(1, L)],
                                  dim=-2)
        else:  # never-read placeholder: the kernel operand can't be empty
            lead = x_proj0.shape[:-3]
            wx_stack = wh_stack.new_zeros(lead + (1, self.hidden_dim, h4))
            b_stack = x_proj0.new_zeros(lead + (1, h4))
        hs_top, h_fin, c_fin = fused_lstm_autograd(
            x_proj0, wh_stack, wx_stack, b_stack, products=cdt,
            round_wx_steps=self.fused_scan)
        return hs_top, [(h_fin[..., layer, :, :], c_fin[..., layer, :, :])
                        for layer in range(L)]
