"""Synthetic demand data with realistic spatiotemporal structure.

The reference's dataset (``./data/data_dict.npz``, ``Main.py:9``) is not
shipped, so the framework generates synthetic city-demand tensors with the
same schema for tests, smoke configs, and benchmarking (BASELINE.md: the
baseline must be *established* on synthetic data of matching shape).

The generator composes daily and weekly sinusoidal cycles with per-region
phase/amplitude variation, spatially-correlated noise diffused over the
region grid, and non-negativity — enough structure that the periodic
windows carry real signal and a model can beat persistence.
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_adjacency", "synthetic_demand", "synthetic_dataset"]


def grid_adjacency(rows: int, cols: int | None = None, diagonal: bool = False) -> np.ndarray:
    """Rook (or queen, with ``diagonal=True``) adjacency of a rows x cols region grid."""
    cols = rows if cols is None else cols
    n = rows * cols
    adj = np.zeros((n, n), dtype=np.float32)
    steps = [(0, 1), (1, 0)]
    if diagonal:
        steps += [(1, 1), (1, -1)]
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in steps:
                rr, cc = r + dr, c + dc
                if 0 <= rr < rows and 0 <= cc < cols:
                    j = rr * cols + cc
                    adj[i, j] = adj[j, i] = 1.0
    return adj


def synthetic_demand(
    n_timesteps: int,
    n_nodes: int,
    n_feats: int = 1,
    day_timesteps: int = 24,
    seed: int = 0,
) -> np.ndarray:
    """``(T, N, C)`` non-negative demand with daily/weekly cycles per region."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_timesteps)[:, None, None]  # (T, 1, 1)
    base = rng.gamma(shape=2.0, scale=20.0, size=(1, n_nodes, n_feats))
    day_phase = rng.uniform(0, 2 * np.pi, size=(1, n_nodes, n_feats))
    week_phase = rng.uniform(0, 2 * np.pi, size=(1, n_nodes, n_feats))
    day_amp = rng.uniform(0.3, 0.8, size=(1, n_nodes, n_feats))
    week_amp = rng.uniform(0.1, 0.4, size=(1, n_nodes, n_feats))
    daily = day_amp * np.sin(2 * np.pi * t / day_timesteps + day_phase)
    weekly = week_amp * np.sin(2 * np.pi * t / (day_timesteps * 7) + week_phase)
    noise = 0.1 * rng.standard_normal((n_timesteps, n_nodes, n_feats))
    demand = base * (1.0 + daily + weekly + noise)
    return np.maximum(demand, 0.0).astype(np.float32)


def synthetic_dataset(
    rows: int = 10,
    cols: int | None = None,
    n_timesteps: int = 24 * 7 * 6,
    n_feats: int = 1,
    m_graphs: int = 3,
    day_timesteps: int = 24,
    seed: int = 0,
):
    """A full in-memory dataset: demand + M adjacencies on a region grid.

    Graph views mirror the reference's three (``Data_Container.py:23-28``):
    spatial neighborhood (grid rook), transport connectivity (random sparse
    symmetric links), and functional similarity (similarity of mean demand
    profiles).
    """
    from stmgcn_tpu_torch.data.loader import ADJ_KEYS, DemandData

    cols = rows if cols is None else cols
    n = rows * cols
    rng = np.random.default_rng(seed + 1)
    demand = synthetic_demand(n_timesteps, n, n_feats, day_timesteps, seed)

    adjs: dict = {}
    if m_graphs >= 1:
        adjs[ADJ_KEYS[0]] = grid_adjacency(rows, cols)
    if m_graphs >= 2:
        trans = (rng.random((n, n)) < min(1.0, 10.0 / n)).astype(np.float32)
        trans = np.maximum(trans, trans.T)
        np.fill_diagonal(trans, 0.0)
        adjs[ADJ_KEYS[1]] = trans
    if m_graphs >= 3:
        profile = demand.mean(axis=2).T  # (N, T)
        profile = profile - profile.mean(axis=1, keepdims=True)
        norms = np.linalg.norm(profile, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        sim = (profile / norms) @ (profile / norms).T
        np.fill_diagonal(sim, 0.0)
        # keep the strongest similarities as edges
        thresh = np.quantile(sim, 0.9)
        adjs[ADJ_KEYS[2]] = (sim > thresh).astype(np.float32)
    if m_graphs > 3:
        raise ValueError("synthetic_dataset supports at most 3 graphs")
    return DemandData(demand=demand, adjs=adjs)
