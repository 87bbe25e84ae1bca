"""NPZ demand/adjacency loading.

Reference: ``DataInput`` (``Data_Container.py:8-29``). The archive holds a
``taxi`` demand tensor of shape ``(T, N, C)`` plus up to three adjacency
matrices gated by the graph count M, in the fixed priority order
``neighbor_adj`` -> ``trans_adj`` -> ``semantic_adj``
(``Data_Container.py:23-28``). Normalization is *not* fused into loading
here (the reference normalizes inside ``load_data``,
``Data_Container.py:21``) — the pipeline owns it so the statistics can be
checkpointed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ADJ_KEYS", "DemandData", "load_npz"]

#: Adjacency key priority, mirroring ``Data_Container.py:23-28``.
ADJ_KEYS = ("neighbor_adj", "trans_adj", "semantic_adj")


@dataclasses.dataclass
class DemandData:
    """Raw (un-normalized) demand plus M adjacency matrices."""

    demand: np.ndarray  # (T, N, C)
    adjs: dict  # key -> (N, N), insertion-ordered

    @property
    def n_graphs(self) -> int:
        return len(self.adjs)

    @property
    def n_nodes(self) -> int:
        return self.demand.shape[1]

    @property
    def n_feats(self) -> int:
        return self.demand.shape[2]

    def adj_list(self) -> list:
        return list(self.adjs.values())


def load_npz(path: str, m_graphs: int = 3, demand_key: str = "taxi") -> DemandData:
    """Load a demand archive; take the first ``m_graphs`` adjacency keys.

    Unknown ``*_adj`` keys beyond the canonical three are accepted after
    them, in file order, so multi-city archives can carry extra graphs.
    """
    with np.load(path) as npz:
        keys = list(npz.keys())
        if demand_key not in keys:
            raise KeyError(f"{path} has no {demand_key!r} array; keys: {keys}")
        demand = np.asarray(npz[demand_key], dtype=np.float32)
        if demand.ndim == 2:  # (T, N) -> (T, N, 1)
            demand = demand[..., None]
        if demand.ndim != 3:
            raise ValueError(f"demand must be (T, N, C), got {demand.shape}")
        ordered = [k for k in ADJ_KEYS if k in keys]
        ordered += [k for k in keys if k.endswith("_adj") and k not in ADJ_KEYS]
        if len(ordered) < m_graphs:
            raise ValueError(
                f"need {m_graphs} adjacency arrays but {path} only has {ordered}"
            )
        adjs = {}
        for k in ordered[:m_graphs]:
            a = np.asarray(npz[k], dtype=np.float32)
            if a.shape != (demand.shape[1], demand.shape[1]):
                raise ValueError(
                    f"{k} has shape {a.shape}, expected "
                    f"({demand.shape[1]}, {demand.shape[1]})"
                )
            adjs[k] = a
    return DemandData(demand=demand, adjs=adjs)
