"""Operators: graph supports, block-sparse and tiled supports, graph
convolution, the LSTM, and their CUDA kernels (LSTM forward and backward,
block-CSR SpMM)."""

from stmgcn_tpu_torch.ops.chebconv import (
    ChebGraphConv,
    SparseChebGraphConv,
    TiledChebGraphConv,
    conv_cls,
    make_conv,
)
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
from stmgcn_tpu_torch.ops.spmm import (
    BlockSparse,
    BlockSparseStack,
    from_dense,
    place_supports,
    spmm,
    spmm_stack,
    spmm_stack_bwd,
    stack_from_dense,
)
from stmgcn_tpu_torch.ops.tiling import (
    TiledBranchSupports,
    TiledSupports,
    gathered_tiles_apply,
    plan_tiling,
    rcm_permutation,
)

__all__ = [
    "BlockSparse",
    "BlockSparseStack",
    "ChebGraphConv",
    "FusedLSTM",
    "SparseChebGraphConv",
    "StackedLSTM",
    "SupportConfig",
    "TiledBranchSupports",
    "TiledChebGraphConv",
    "TiledSupports",
    "build_supports",
    "conv_cls",
    "from_dense",
    "fused_lstm",
    "fused_lstm_autograd",
    "fused_lstm_bwd",
    "fused_lstm_bwd_reference",
    "fused_lstm_reference",
    "gathered_tiles_apply",
    "make_conv",
    "place_supports",
    "plan_tiling",
    "rcm_permutation",
    "spmm",
    "spmm_stack",
    "spmm_stack_bwd",
    "stack_from_dense",
    "support_count",
]
