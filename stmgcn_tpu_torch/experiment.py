"""Experiment assembly for the serving slice: config -> data, supports, model.

Counterpart of ``stmgcn_tpu/experiment.py`` (``build_dataset``,
``build_supports``, ``build_model``) for homogeneous cities and dense
supports — the representation serving uses. Heterogeneous cities, node
padding for region meshes and the sparse/tiled supports are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stmgcn_tpu_torch.config import DTYPES, ExperimentConfig
from stmgcn_tpu_torch.data.loader import load_npz
from stmgcn_tpu_torch.data.pipeline import DemandDataset
from stmgcn_tpu_torch.data.splits import date_splits, fraction_splits
from stmgcn_tpu_torch.data.synthetic import synthetic_dataset
from stmgcn_tpu_torch.data.windowing import WindowSpec
from stmgcn_tpu_torch.models.st_mgcn import STMGCN

__all__ = ["build_dataset", "build_model", "build_supports"]


def build_dataset(cfg: ExperimentConfig) -> DemandDataset:
    """Load or synthesize demand data and window/split it per config."""
    d = cfg.data
    window = WindowSpec(
        d.serial_len, d.daily_len, d.weekly_len, d.day_timesteps, horizon=d.horizon
    )
    if d.hetero or d.city_rows is not None or d.city_timesteps is not None:
        raise ValueError("heterogeneous cities are not ported yet")
    if d.path is not None:
        paths = [p for p in d.path.split(",") if p]
        if len(paths) != d.n_cities:
            raise ValueError(
                f"n_cities={d.n_cities} needs {d.n_cities} comma-separated "
                f"archives in data.path, got {len(paths)}"
            )
        cities = [load_npz(p, m_graphs=cfg.model.m_graphs) for p in paths]
    else:
        cities = [
            synthetic_dataset(
                rows=d.rows, cols=d.cols, n_timesteps=d.n_timesteps,
                m_graphs=cfg.model.m_graphs, day_timesteps=d.day_timesteps,
                seed=d.seed + c,
            )
            for c in range(d.n_cities)
        ]
        if d.shared_graphs:
            for c in cities[1:]:
                c.adjs = cities[0].adjs
    n_samples = window.n_samples(cities[0].demand.shape[0])
    if d.dates is not None:
        split = date_splits(
            list(d.dates), burn_in=window.burn_in, day_timesteps=d.day_timesteps,
            val_ratio=d.val_ratio, year=d.year, n_samples=n_samples,
        )
    else:
        split = fraction_splits(n_samples, train=d.train_frac, validate=d.val_frac)
    return DemandDataset(
        cities if len(cities) > 1 else cities[0], window, split, normalize=d.normalize
    )


def build_supports(cfg: ExperimentConfig, dataset: DemandDataset) -> np.ndarray:
    """The dense ``(M, n_supports, N, N)`` support stack of the dataset's
    (shared) graphs, built on the host in float64 and returned float32."""
    if not dataset.shared_graphs:
        raise ValueError("per-city graph stacks are not ported yet")
    return cfg.model.support_config.build_all(dataset.adjs.values())


def build_model(cfg: ExperimentConfig, input_dim: int, *, device=None,
                generator: Optional[torch.Generator] = None) -> STMGCN:
    """The dense flagship from config plus the one data-derived scalar
    (feature count). ``device=None`` means the GPU."""
    m = cfg.model
    if m.dtype not in DTYPES:
        raise ValueError(
            f"model.dtype={m.dtype!r}: the port takes {DTYPES} storage so far"
        )
    return STMGCN(
        m_graphs=m.m_graphs,
        n_supports=m.n_supports,
        seq_len=cfg.data.seq_len,
        input_dim=input_dim,
        horizon=cfg.data.horizon,
        lstm_hidden_dim=m.lstm_hidden_dim,
        lstm_num_layers=m.lstm_num_layers,
        gcn_hidden_dim=m.gcn_hidden_dim,
        use_bias=m.use_bias,
        shared_gate_fc=m.shared_gate_fc,
        device=device,
        generator=generator,
    )
