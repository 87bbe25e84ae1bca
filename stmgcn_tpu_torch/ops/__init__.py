"""Operators: graph supports, graph convolution, the LSTM and its fused
CUDA kernels (forward and backward)."""

from stmgcn_tpu_torch.ops.chebconv import ChebGraphConv
from stmgcn_tpu_torch.ops.fused_lstm import (
    FusedLSTM,
    fused_lstm,
    fused_lstm_autograd,
    fused_lstm_bwd,
    fused_lstm_bwd_reference,
    fused_lstm_reference,
)
from stmgcn_tpu_torch.ops.graph import SupportConfig, build_supports, support_count
from stmgcn_tpu_torch.ops.lstm import StackedLSTM

__all__ = [
    "ChebGraphConv",
    "FusedLSTM",
    "StackedLSTM",
    "SupportConfig",
    "build_supports",
    "fused_lstm",
    "fused_lstm_autograd",
    "fused_lstm_bwd",
    "fused_lstm_bwd_reference",
    "fused_lstm_reference",
    "support_count",
]
