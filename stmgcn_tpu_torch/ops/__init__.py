"""Operators: graph supports, graph convolution, the LSTM and its fused
CUDA kernel."""

from stmgcn_tpu_torch.ops.chebconv import ChebGraphConv
from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm, fused_lstm_reference
from stmgcn_tpu_torch.ops.graph import SupportConfig, build_supports, support_count
from stmgcn_tpu_torch.ops.lstm import StackedLSTM

__all__ = [
    "ChebGraphConv",
    "StackedLSTM",
    "SupportConfig",
    "build_supports",
    "fused_lstm",
    "fused_lstm_reference",
    "support_count",
]
