"""Contextual-gated LSTM (CGRNN) — one graph branch's recurrent encoder.

Counterpart of ``stmgcn_tpu/models/cg_lstm.py`` (paper eqs. 6-9):

1. each region's length-T history is its feature vector, graph-convolved
   over the support stack with a residual (eq. 6);
2. a float32 mean over nodes, then FC -> ReLU -> FC -> sigmoid gives
   per-timestep attention (eqs. 7-8);
3. the observations are reweighted per timestep (eq. 9) and run through
   the globally-shared LSTM with nodes folded into rows; only the last
   step's hidden state is kept.

``shared_gate_fc=True`` (default) keeps the reference's quirk of applying
the same Dense twice in eq. 8; ``False`` gives the paper's two layers.
``n_real_nodes`` masks node-padding rows out of the eq. 7 mean. The traced
per-call real-node count of fleet serving is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stmgcn_tpu_torch.ops.chebconv import ChebGraphConv
from stmgcn_tpu_torch.ops.layers import Dense
from stmgcn_tpu_torch.ops.lstm import StackedLSTM

__all__ = ["CGLSTM", "ContextualGate"]


class ContextualGate(nn.Module):
    """Per-timestep sigmoid attention from graph-convolved temporal features:
    ``obs_seq`` ``(B, T, N, C)`` -> gated ``([M,] B, T, N, C)``."""

    def __init__(self, n_supports: int, seq_len: int, *, use_bias: bool = True,
                 shared_gate_fc: bool = True, n_real_nodes: Optional[int] = None,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        self.n_real_nodes = n_real_nodes
        kw = dict(branches=branches, device=device, generator=generator)
        self.temporal_gconv = ChebGraphConv(n_supports, seq_len, seq_len,
                                            use_bias=use_bias, **kw)
        self.gate_fc = Dense(seq_len, seq_len, **kw)
        self.gate_fc2 = None if shared_gate_fc else Dense(seq_len, seq_len, **kw)

    def forward(self, supports: torch.Tensor, obs_seq: torch.Tensor) -> torch.Tensor:
        x_nt = obs_seq.sum(dim=-1).transpose(-1, -2)  # (B, N, T): history as features
        x_hat = x_nt + self.temporal_gconv(supports, x_nt)  # eq. 6 residual
        n_nodes = x_hat.shape[-2]
        if self.n_real_nodes is not None and self.n_real_nodes != n_nodes:
            # eq. 7 over real nodes only
            mask = (torch.arange(n_nodes, device=x_hat.device) < self.n_real_nodes)
            z = (x_hat * mask[:, None].to(x_hat.dtype)).sum(dim=-2) / self.n_real_nodes
        else:
            z = x_hat.mean(dim=-2)  # eq. 7: average pool over nodes -> (B, T)
        second = self.gate_fc if self.gate_fc2 is None else self.gate_fc2
        s = torch.sigmoid(second(torch.relu(self.gate_fc(z))))  # eq. 8
        return obs_seq * s[..., None, None]  # eq. 9


class CGLSTM(nn.Module):
    """Contextual gate + globally-shared LSTM; returns ``([M,] B, N, H)``."""

    def __init__(self, n_supports: int, seq_len: int, input_dim: int,
                 lstm_hidden_dim: int, lstm_num_layers: int, *,
                 use_bias: bool = True, shared_gate_fc: bool = True,
                 n_real_nodes: Optional[int] = None,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        kw = dict(branches=branches, device=device, generator=generator)
        self.lstm_hidden_dim = lstm_hidden_dim
        self.gate = ContextualGate(n_supports, seq_len, use_bias=use_bias,
                                   shared_gate_fc=shared_gate_fc,
                                   n_real_nodes=n_real_nodes, **kw)
        self.lstm = StackedLSTM(input_dim, lstm_hidden_dim, lstm_num_layers, **kw)

    def forward(self, supports: torch.Tensor, obs_seq: torch.Tensor) -> torch.Tensor:
        gated = self.gate(supports, obs_seq)  # ([M,] B, T, N, C)
        *lead, batch, seq_len, n_nodes, n_feats = gated.shape
        # fold nodes into rows for the shared recurrence
        folded = gated.transpose(-3, -2).reshape(*lead, batch * n_nodes, seq_len, n_feats)
        outputs, _ = self.lstm(folded)
        last = outputs[..., -1, :]  # ([M,] B*N, H): keep the final timestep
        return last.reshape(*lead, batch, n_nodes, self.lstm_hidden_dim)
