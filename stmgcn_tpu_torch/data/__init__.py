"""Data layer: NPZ loading, normalization, windowing, splits, batching —
numpy copies of the JAX package's host modules (its ``data/__init__``
pulls JAX in through ``ring.py``)."""

from stmgcn_tpu_torch.data.loader import ADJ_KEYS, DemandData, load_npz
from stmgcn_tpu_torch.data.normalize import (
    MinMaxNormalizer,
    StdNormalizer,
    normalizer_from_dict,
)
from stmgcn_tpu_torch.data.pipeline import Batch, DemandDataset
from stmgcn_tpu_torch.data.splits import SplitSpec, date_splits
from stmgcn_tpu_torch.data.synthetic import grid_adjacency, synthetic_dataset, synthetic_demand
from stmgcn_tpu_torch.data.windowing import WindowSpec, sliding_windows

__all__ = [
    "ADJ_KEYS",
    "Batch",
    "DemandData",
    "DemandDataset",
    "MinMaxNormalizer",
    "SplitSpec",
    "StdNormalizer",
    "WindowSpec",
    "date_splits",
    "grid_adjacency",
    "load_npz",
    "normalizer_from_dict",
    "sliding_windows",
    "synthetic_dataset",
    "synthetic_demand",
]
