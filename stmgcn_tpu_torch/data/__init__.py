"""Data layer: NPZ loading, normalization, windowing, splits, batching,
heterogeneous cities and the fleet shape-class planner — numpy copies of
the JAX package's host modules — and the device-resident ingest ring of
the closed loop (:mod:`.ring`)."""

from stmgcn_tpu_torch.data.fleet import FleetPlan, ShapeClass, plan_shape_classes
from stmgcn_tpu_torch.data.hetero import HeteroCityDataset
from stmgcn_tpu_torch.data.loader import ADJ_KEYS, DemandData, load_npz
from stmgcn_tpu_torch.data.normalize import (
    MinMaxNormalizer,
    StdNormalizer,
    normalizer_from_dict,
)
from stmgcn_tpu_torch.data.pipeline import Batch, DemandDataset
from stmgcn_tpu_torch.data.ring import SeriesRing, StaleObservationError, ingest_stream
from stmgcn_tpu_torch.data.splits import SplitSpec, date_splits
from stmgcn_tpu_torch.data.synthetic import grid_adjacency, synthetic_dataset, synthetic_demand
from stmgcn_tpu_torch.data.windowing import WindowSpec, sliding_windows

__all__ = [
    "ADJ_KEYS",
    "Batch",
    "DemandData",
    "DemandDataset",
    "FleetPlan",
    "HeteroCityDataset",
    "MinMaxNormalizer",
    "SeriesRing",
    "ShapeClass",
    "SplitSpec",
    "StaleObservationError",
    "StdNormalizer",
    "WindowSpec",
    "date_splits",
    "grid_adjacency",
    "ingest_stream",
    "load_npz",
    "normalizer_from_dict",
    "plan_shape_classes",
    "sliding_windows",
    "synthetic_dataset",
    "synthetic_demand",
]
