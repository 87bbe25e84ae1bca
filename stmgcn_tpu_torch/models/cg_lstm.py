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
``n_real_nodes`` masks node-padding rows out of the eq. 7 mean. A fleet
shape class instead passes ``n_real`` per call (``stmgcn_tpu/models/
cg_lstm.py:83-97``): an int tensor, one count for the batch (training) or
a ``(B,)`` count per row (fleet serving), so one model serves every member
city of the class; an exact fit (``n_real == N``) takes the plain mean, so
exact-fit cities equal the unpadded model.
``support_mode`` (``"dense" | "sparse" | "tiled" | "banded"``, or a
per-branch tuple of ``"dense"``/``"banded"``) picks the gate's graph conv
(:func:`~stmgcn_tpu_torch.ops.chebconv.make_conv`); its parameters are
the same in every mode.

At float32 compute eq. 7's node sum runs in float64, so it rounds to one
float32 whatever order its addends come in. On a region mesh
(``region_mesh``, set by the model) the gate holds its rank's node rows:
eq. 7's node sum is the rank's partial summed over ``region``
(:func:`~stmgcn_tpu_torch.parallel.region.region_sum`) and divided by
the global real-node count, the padded rows (global index at or past
``n_real_nodes``, or ``n_real``) left out of the partial.

Under a bf16 compute dtype the gate's feature sum and node mean run in
float32 (the JAX gate's f32 reduction islands), its conv and Dense layers
take bf16 operands with float32 results, so the gate itself stays float32;
the LSTM runs its bf16 kernel route in the form ``lstm_backend`` names
(``ops/lstm.py``) and hands back float32 states ("xla") or bf16 ones
("pallas").
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stmgcn_tpu_torch.ops.chebconv import make_conv
from stmgcn_tpu_torch.ops.layers import Dense
from stmgcn_tpu_torch.ops.lstm import StackedLSTM
from stmgcn_tpu_torch.parallel.region import node_offset, region_sum

__all__ = ["CGLSTM", "ContextualGate"]


class ContextualGate(nn.Module):
    """Per-timestep sigmoid attention from graph-convolved temporal features:
    ``obs_seq`` ``(B, T, N, C)`` -> gated ``([M,] B, T, N, C)``."""

    def __init__(self, n_supports: int, seq_len: int, *, use_bias: bool = True,
                 shared_gate_fc: bool = True, n_real_nodes: Optional[int] = None,
                 support_mode: str = "dense",
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        self.n_real_nodes = n_real_nodes
        self.compute_dtype: Optional[torch.dtype] = None
        #: the region mesh the node rows are sharded over (None: all here)
        self.region_mesh = None
        kw = dict(branches=branches, device=device, generator=generator)
        self.temporal_gconv = make_conv(support_mode, n_supports, seq_len, seq_len,
                                        use_bias=use_bias, **kw)
        self.gate_fc = Dense(seq_len, seq_len, **kw)
        self.gate_fc2 = None if shared_gate_fc else Dense(seq_len, seq_len, **kw)

    def forward(self, supports, obs_seq: torch.Tensor,
                n_real: Optional[torch.Tensor] = None) -> torch.Tensor:
        f32 = {} if self.compute_dtype is None else {"dtype": torch.float32}
        x_nt = obs_seq.sum(dim=-1, **f32).to(obs_seq.dtype)
        x_nt = x_nt.transpose(-1, -2)  # (B, N, T): history as features
        x_hat = x_nt + self.temporal_gconv(supports, x_nt)  # eq. 6 residual
        n_nodes = x_hat.shape[-2]
        if self.region_mesh is not None:
            z = self._region_pool(x_hat, n_real)
        elif n_real is not None:
            # eq. 7 over each city's real nodes: where() keeps padded rows
            # out of the sum and out of its gradient; the unchosen arm's
            # gradient is zero
            nr = n_real[..., None]  # (1,) or (B, 1): broadcasts over (M, B, T)
            keep = torch.arange(n_nodes, device=x_hat.device) < nr
            real = torch.where(keep[..., None], x_hat, torch.zeros((), dtype=x_hat.dtype,
                                                                   device=x_hat.device))
            # float64 sums at float32 compute, on purpose (:meth:`_pool_dtype`): the
            # contract pass's fp64-promotion and implicit-cast findings on them are
            # suppressed here and on the cast back below
            acc = self._pool_dtype()
            total = real.sum(dim=-2, dtype=acc)  # stmgcn: ignore[fp64-promotion, implicit-cast]
            masked = total / nr.to(acc)  # stmgcn: ignore[fp64-promotion, implicit-cast]
            mean = x_hat.mean(dim=-2, dtype=acc)  # stmgcn: ignore[fp64-promotion, implicit-cast]
            z = torch.where(nr == n_nodes, mean, masked)  # stmgcn: ignore[fp64-promotion]
        elif self.n_real_nodes is not None and self.n_real_nodes != n_nodes:
            # eq. 7 over real nodes only
            mask = (torch.arange(n_nodes, device=x_hat.device) < self.n_real_nodes)
            z = (x_hat * mask[:, None].to(x_hat.dtype)).sum(
                dim=-2, dtype=self._pool_dtype()) / self.n_real_nodes
        else:
            # eq. 7: average pool over nodes -> (B, T); at float32 summed in
            # float64 (:meth:`_pool_dtype`), so a node-sharded mesh's pooled sum rounds
            # to the same float32 as this one (the contract pass's findings suppressed)
            acc = self._pool_dtype()
            z = x_hat.mean(dim=-2, dtype=acc)  # stmgcn: ignore[fp64-promotion, implicit-cast]
        z = z.to(x_hat.dtype)  # stmgcn: ignore[fp64-promotion, implicit-cast] float64 -> compute
        second = self.gate_fc if self.gate_fc2 is None else self.gate_fc2
        s = torch.sigmoid(second(torch.relu(self.gate_fc(z))))  # eq. 8
        return obs_seq * s[..., None, None]  # eq. 9

    def _pool_dtype(self) -> torch.dtype:
        """The node pooling's accumulator: float64 at float32 compute (an
        order-free sum: every float32 addend exact in float64, so the
        pooled mean rounds the same whatever the nodes' split over ranks),
        float32 under a bf16 compute dtype (the JAX gate's f32 island)."""
        return torch.float64 if self.compute_dtype is None else torch.float32

    def _region_pool(self, x_hat: torch.Tensor, n_real: Optional[torch.Tensor]) -> torch.Tensor:
        """Eq. 7 over a region mesh: this rank's node sum over its real
        rows (in :meth:`_pool_dtype`), summed over ``region``, over the
        global real count."""
        mesh, n_local = self.region_mesh, x_hat.shape[-2]
        n_global = n_local * mesh.region
        real = self.n_real_nodes if self.n_real_nodes is not None else n_global
        if n_real is not None:
            real = n_real[..., None]  # (1,) or (B, 1): broadcasts over (M, B, T)
        acc = self._pool_dtype()
        if isinstance(real, int) and real == n_global:
            partial = x_hat.sum(dim=-2, dtype=acc)
        else:
            node = node_offset(mesh, n_local) + torch.arange(n_local, device=x_hat.device)
            keep = node < real
            partial = torch.where(keep[..., None], x_hat, torch.zeros(
                (), dtype=x_hat.dtype, device=x_hat.device)).sum(dim=-2, dtype=acc)
        total = region_sum(partial, mesh)
        return total / (real.to(acc) if isinstance(real, torch.Tensor) else float(real))


class CGLSTM(nn.Module):
    """Contextual gate + globally-shared LSTM; returns ``([M,] B, N, H)``."""

    def __init__(self, n_supports: int, seq_len: int, input_dim: int,
                 lstm_hidden_dim: int, lstm_num_layers: int, *,
                 use_bias: bool = True, shared_gate_fc: bool = True,
                 n_real_nodes: Optional[int] = None, support_mode: str = "dense",
                 lstm_backend: str = "xla", lstm_fused_scan: bool = False,
                 branches: Optional[int] = None, device=None, generator=None):
        super().__init__()
        kw = dict(branches=branches, device=device, generator=generator)
        self.lstm_hidden_dim = lstm_hidden_dim
        self.gate = ContextualGate(n_supports, seq_len, use_bias=use_bias,
                                   shared_gate_fc=shared_gate_fc,
                                   n_real_nodes=n_real_nodes, support_mode=support_mode,
                                   **kw)
        self.lstm = StackedLSTM(input_dim, lstm_hidden_dim, lstm_num_layers,
                                backend=lstm_backend, fused_scan=lstm_fused_scan, **kw)

    def forward(self, supports, obs_seq: torch.Tensor,
                n_real: Optional[torch.Tensor] = None) -> torch.Tensor:
        gated = self.gate(supports, obs_seq, n_real)  # ([M,] B, T, N, C)
        *lead, batch, seq_len, n_nodes, n_feats = gated.shape
        # fold nodes into rows for the shared recurrence
        folded = gated.transpose(-3, -2).reshape(*lead, batch * n_nodes, seq_len, n_feats)
        outputs, _ = self.lstm(folded)
        last = outputs[..., -1, :]  # ([M,] B*N, H): keep the final timestep
        return last.reshape(*lead, batch, n_nodes, self.lstm_hidden_dim)
