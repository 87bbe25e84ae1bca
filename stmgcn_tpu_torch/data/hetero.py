"""Heterogeneous multi-city dataset: cities with differing shapes.

Numpy copy of ``stmgcn_tpu/data/hetero.py`` (``HeteroCityDataset``), with
the same windows, normalizers, split calendars and batch order. The
homogeneous :class:`~stmgcn_tpu_torch.data.pipeline.DemandDataset` needs
its cities to share one ``(T, N, C)`` shape and fits one normalizer on
their concatenation; real city pairs (BASELINE config 4) differ in region
count, series span and demand scale. :class:`HeteroCityDataset` keeps one
full :class:`DemandDataset` per city (its own series, normalizer fitted on
that city alone, and split calendar) behind the batch protocol the
:class:`~stmgcn_tpu_torch.train.trainer.Trainer` speaks. One parameter set
serves every city because every ST-MGCN parameter is region-count-agnostic:
the cities must share the :class:`WindowSpec` (``seq_len`` sizes the gate)
and the channel count ``C`` (the LSTM input projection); ``T``, ``N``,
graphs and demand scale are per city.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from stmgcn_tpu_torch.data.loader import DemandData
from stmgcn_tpu_torch.data.pipeline import Batch, DemandDataset
from stmgcn_tpu_torch.data.splits import MODES, SplitSpec
from stmgcn_tpu_torch.data.windowing import WindowSpec

__all__ = ["HeteroCityDataset"]


class HeteroCityDataset:
    """Per-city windows/normalizers/splits behind the Trainer's protocol.

    ``splits`` is an optional per-city sequence of :class:`SplitSpec`
    (``None`` entries fall back to fraction splits on that city's own
    sample count — cities with different spans get different split
    boundaries, as a calendar would give them).
    """

    #: consumers branch per-city metric/normalizer handling on this
    heterogeneous = True
    #: per-city graphs always (differing N cannot share a support stack)
    shared_graphs = False

    def __init__(
        self,
        datas: Sequence[DemandData],
        window: WindowSpec,
        splits: Optional[Sequence[Optional[SplitSpec]]] = None,
        normalize="minmax",
    ):
        datas = list(datas)
        if not datas:
            raise ValueError("need at least one city")
        feats = {d.demand.shape[-1] for d in datas}
        if len(feats) != 1:
            raise ValueError(
                "cities must share the feature/channel count C (it sizes the "
                f"LSTM input projection), got {sorted(feats)}"
            )
        for d in datas[1:]:
            if list(d.adjs) != list(datas[0].adjs):
                raise ValueError(
                    f"cities must carry the same graph views (adjacency keys), "
                    f"got {list(datas[0].adjs)} vs {list(d.adjs)}"
                )
        if splits is None:
            splits = [None] * len(datas)
        if len(splits) != len(datas):
            raise ValueError(
                f"got {len(splits)} splits for {len(datas)} cities — pass one "
                "SplitSpec (or None) per city"
            )
        self.window = window
        self.cities = [
            DemandDataset(d, window, s, normalize) for d, s in zip(datas, splits)
        ]

    # -- structure -------------------------------------------------------
    @property
    def n_cities(self) -> int:
        return len(self.cities)

    @property
    def city_adjs(self) -> list:
        return [c.adjs for c in self.cities]

    @property
    def adjs(self):
        """City 0's graphs (the protocol slot; per-city consumers use
        :attr:`city_adjs`)."""
        return self.cities[0].adjs

    @property
    def normalizer(self):
        """Always ``None``: normalization is per-city (:attr:`normalizers`)."""
        return None

    @property
    def normalizers(self) -> list:
        return [c.normalizer for c in self.cities]

    @property
    def n_feats(self) -> int:
        return self.cities[0].n_feats

    @property
    def city_n_nodes(self) -> list:
        return [c.n_nodes for c in self.cities]

    @property
    def n_nodes(self) -> int:
        raise ValueError(
            "heterogeneous cities have per-city region counts — use "
            "city_n_nodes"
        )

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.cities)

    @property
    def n_samples(self) -> int:
        return sum(c.n_samples for c in self.cities)

    # -- window-free protocol (per-city delegation) ----------------------
    # Mirrors DemandDataset's resident-series surface so the trainer's
    # window-free gather (and the fleet superstep built on it) treats a
    # hetero fleet like any resident dataset — one (T, N_c, C) series per
    # city, target vectors per (mode, city), no window materialization.
    def series(self, city: int = 0) -> np.ndarray:
        return self.cities[city].series(0)

    def series_stack(self, city: int = 0) -> np.ndarray:
        return self.cities[city].series_stack()

    def mode_targets(self, mode: str, city: int = 0) -> np.ndarray:
        return self.cities[city].mode_targets(mode, 0)

    @property
    def resident_nbytes(self) -> int:
        return sum(c.resident_nbytes for c in self.cities)

    @property
    def materialized(self) -> bool:
        return any(c.materialized for c in self.cities)

    # -- samples ---------------------------------------------------------
    def mode_size(self, mode: str) -> int:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        return sum(c.mode_size(mode) for c in self.cities)

    def num_batches(self, mode: str, batch_size: int, drop_last: bool = False) -> int:
        return sum(c.num_batches(mode, batch_size, drop_last) for c in self.cities)

    def arrays(self, mode: str):
        raise ValueError(
            "heterogeneous cities cannot concatenate into one array — use "
            "city_arrays(mode, city)"
        )

    def city_arrays(self, mode: str, city: int):
        return self.cities[city].arrays(mode)

    def denormalize(self, values, city: Optional[int] = None):
        """Per-city inverse transform; ``city`` may be omitted only when a
        single city makes it unambiguous."""
        if city is None:
            if self.n_cities != 1:
                raise ValueError(
                    "denormalize needs city= with heterogeneous cities (each "
                    "has its own normalizer)"
                )
            city = 0
        return self.cities[city].denormalize(values)

    def batches(
        self,
        mode: str,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        epoch: int = 0,
        drop_last: bool = False,
        pad_last: bool = False,
        with_arrays: bool = True,
    ) -> Iterator[Batch]:
        """City-sequential batches; every batch carries its city index.

        Batches never mix cities (their shapes differ). City 0 streams
        with the unmodified ``seed`` so a city-0-only run reproduces the
        single-city iteration order exactly; later cities decorrelate
        their shuffle streams with a per-city offset.
        """
        for city, ds in enumerate(self.cities):
            for b in ds.batches(
                mode,
                batch_size,
                shuffle=shuffle,
                seed=seed + city * 7919,
                epoch=epoch,
                drop_last=drop_last,
                pad_last=pad_last,
                with_arrays=with_arrays,
            ):
                yield dataclasses.replace(b, city=city) if b.city != city else b
