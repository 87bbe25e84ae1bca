"""ST-MGCN: the multi-graph flagship model (dense supports).

Counterpart of ``stmgcn_tpu/models/st_mgcn.py`` in its vmapped dense form:
the M graph branches are one :class:`Branch` whose parameters carry a
leading ``M`` axis, run as one batched computation over a stacked
``(M, K, N, N)`` support tensor — so the shared LSTM of all M branches is
one kernel launch on the GPU. Fusion sums the M branch outputs in float32,
then a ``Dense(gcn_hidden -> horizon * input_dim)`` head gives the
``(B, N, C)`` next-step prediction, or ``(B, H, N, C)`` for ``horizon > 1``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stmgcn_tpu_torch.models.cg_lstm import CGLSTM
from stmgcn_tpu_torch.ops.chebconv import ChebGraphConv
from stmgcn_tpu_torch.ops.layers import Dense, resolve_device

__all__ = ["Branch", "STMGCN"]


class Branch(nn.Module):
    """One graph view's encoder: CGLSTM -> graph conv on the LSTM state."""

    def __init__(self, n_supports: int, seq_len: int, input_dim: int,
                 lstm_hidden_dim: int, lstm_num_layers: int, gcn_hidden_dim: int, *,
                 use_bias: bool = True, shared_gate_fc: bool = True,
                 n_real_nodes: Optional[int] = None,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        kw = dict(branches=branches, device=device, generator=generator)
        self.cg_lstm = CGLSTM(n_supports, seq_len, input_dim, lstm_hidden_dim,
                              lstm_num_layers, use_bias=use_bias,
                              shared_gate_fc=shared_gate_fc,
                              n_real_nodes=n_real_nodes, **kw)
        self.gcn = ChebGraphConv(n_supports, lstm_hidden_dim, gcn_hidden_dim,
                                 use_bias=use_bias, **kw)

    def forward(self, supports: torch.Tensor, obs_seq: torch.Tensor) -> torch.Tensor:
        return self.gcn(supports, self.cg_lstm(supports, obs_seq))


class STMGCN(nn.Module):
    """Multi-graph spatiotemporal model; ``(B, T, N, C) -> (B, N, C)``
    (``(B, H, N, C)`` with ``horizon > 1``).

    ``device=None`` means the GPU (and raises without one); weights are
    drawn from ``generator`` (default: a generator seeded 0).
    """

    def __init__(self, m_graphs: int, n_supports: int, seq_len: int, input_dim: int, *,
                 horizon: int = 1, lstm_hidden_dim: int = 64, lstm_num_layers: int = 3,
                 gcn_hidden_dim: int = 64, use_bias: bool = True,
                 shared_gate_fc: bool = True, n_real_nodes: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.m_graphs = m_graphs
        self.n_supports = n_supports
        self.seq_len = seq_len
        self.input_dim = input_dim
        self.horizon = horizon
        self.branches = Branch(
            n_supports, seq_len, input_dim, lstm_hidden_dim, lstm_num_layers,
            gcn_hidden_dim, use_bias=use_bias, shared_gate_fc=shared_gate_fc,
            n_real_nodes=n_real_nodes, branches=m_graphs, device=device,
            generator=generator,
        )
        self.head = Dense(gcn_hidden_dim, horizon * input_dim, device=device,
                          generator=generator)

    def forward(self, supports_stack: torch.Tensor, obs_seq: torch.Tensor) -> torch.Tensor:
        """``supports_stack`` ``(M, K, N, N)``; ``obs_seq`` ``(B, T, N, C)``."""
        want = (self.m_graphs, self.n_supports)
        if supports_stack.dim() != 4 or tuple(supports_stack.shape[:2]) != want:
            raise ValueError(
                f"supports_stack must be ({want[0]}, {want[1]}, N, N), "
                f"got {tuple(supports_stack.shape)}"
            )
        feats = self.branches(supports_stack, obs_seq)  # (M, B, N, gcn_hidden)
        out = self.head(feats.sum(dim=0))
        if self.horizon == 1:
            return out  # (B, N, C)
        batch, n_nodes = out.shape[:2]
        return out.reshape(batch, n_nodes, self.horizon, self.input_dim).transpose(1, 2)

