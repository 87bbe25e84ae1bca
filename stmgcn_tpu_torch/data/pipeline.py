"""End-to-end data pipeline: normalize -> window -> split -> batch.

Counterpart of the reference's ``DataGenerator.get_data_loader`` +
``TaxiDataset`` (``Data_Container.py:54-123``), redesigned for TPU:

- the dataset's primary storage is the normalized raw ``(T, N, C)``
  series per city; materialized windows (``x`` of shape
  ``(S, seq_len, N, C)`` — a ~``seq_len``x copy of the series) are built
  lazily, vectorized, on first access, because the window-free resident
  trainer path never needs them: it gathers windows on device from the
  series via :meth:`DemandDataset.mode_targets` + ``WindowSpec.offsets``;
- splits are computed per city and the per-mode slices of every city are
  concatenated, so multi-city training (BASELINE config 4) sees both
  cities in every mode rather than one city leaking entirely into test;
- batching yields host numpy — device placement is the trainer's decision
  (``tensor.to(device)`` once, by the caller)
  rather than an eager ``.to(device)`` inside the dataset
  (``Data_Container.py:88-89``, SURVEY.md §2 quirk 7);
- the last partial batch can be dropped or padded to keep shapes static
  under ``jit`` (the reference's DataLoader lets the tail batch ragged).

Reference parity defaults: min-max normalization over the full tensor,
``shuffle=False`` for every mode (``Data_Container.py:122``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Union

import numpy as np

from stmgcn_tpu_torch.data.loader import DemandData
from stmgcn_tpu_torch.data.normalize import MinMaxNormalizer, StdNormalizer
from stmgcn_tpu_torch.data.splits import MODES, SplitSpec, fraction_splits
from stmgcn_tpu_torch.data.windowing import WindowSpec, sliding_windows

__all__ = ["Batch", "DemandDataset"]


@dataclasses.dataclass(frozen=True)
class Batch:
    """One step's input: ``x`` ``(B, seq_len, N, C)``; target ``y`` is
    ``(B, N, C)`` for next-step forecasting or ``(B, H, N, C)`` for a
    multi-step horizon."""

    x: np.ndarray
    y: np.ndarray
    #: number of *real* (non-padding) samples; == len(y) except for a padded tail
    n_real: int
    #: which city's graphs this batch belongs to (always 0 when cities
    #: share one graph stack; batches never mix cities with differing graphs)
    city: int = 0
    #: positions of these samples in the mode's (city-relative) arrays —
    #: shuffled order and tail padding included, so a device-resident
    #: consumer can gather ``arrays(mode)[indices]`` instead of uploading
    #: ``x``/``y`` (``Trainer``'s resident data placement). With
    #: ``batches(with_arrays=False)`` the indices are the *only* payload
    #: (``x``/``y`` are None — not even materialized on the host).
    indices: np.ndarray | None = None

    def __len__(self) -> int:
        return self.y.shape[0] if self.y is not None else len(self.indices)


class DemandDataset:
    """Windowed, normalized, split demand samples with batch iteration.

    ``data`` may be a single :class:`DemandData` or a sequence of
    same-shape cities; windows never cross city boundaries, and each mode's
    samples are the concatenation of that mode's slice from every city.
    """

    #: homogeneous cities: one shared shape/normalizer/split (the
    #: heterogeneous counterpart is data.hetero.HeteroCityDataset)
    heterogeneous = False

    #: normalizer selected per ``normalize=`` kind (None = raw values)
    _NORMALIZERS = {"minmax": MinMaxNormalizer, "std": StdNormalizer, "none": None}

    def __init__(
        self,
        data: Union[DemandData, Sequence[DemandData]],
        window: WindowSpec,
        split: SplitSpec | None = None,
        normalize: Union[bool, str] = "minmax",
    ):
        # bool accepted for back-compat: True = reference-parity min-max
        # (Data_Container.py:21), False = raw values.
        if isinstance(normalize, bool):
            normalize = "minmax" if normalize else "none"
        if normalize not in self._NORMALIZERS:
            raise ValueError(
                f"normalize must be one of {sorted(self._NORMALIZERS)}, got {normalize!r}"
            )
        datas = list(data) if isinstance(data, (list, tuple)) else [data]
        if not datas:
            raise ValueError("need at least one city")
        shapes = {d.demand.shape for d in datas}
        if len(shapes) != 1:
            raise ValueError(f"cities must share (T, N, C) shape, got {shapes}")
        for d in datas[1:]:
            if list(d.adjs) != list(datas[0].adjs):
                raise ValueError(
                    f"cities must carry the same graph views (adjacency keys), "
                    f"got {list(datas[0].adjs)} vs {list(d.adjs)}"
                )
        self.window = window
        self.n_cities = len(datas)
        #: per-city adjacency dicts; real city pairs (BASELINE config 4,
        #: Chengdu+Beijing) have different graphs, so each batch carries a
        #: city index and the trainer applies that city's support stack
        self.city_adjs = [d.adjs for d in datas]
        #: whether one support stack serves every city (true for a single
        #: city or synthetic cities built over one region structure)
        self.shared_graphs = all(
            all(np.array_equal(d.adjs[k], datas[0].adjs[k]) for k in d.adjs)
            for d in datas[1:]
        )
        self.adjs = datas[0].adjs  # city 0 (the shared stack when shared_graphs)
        self._mode_cache: dict = {}

        norm_cls = self._NORMALIZERS[normalize]
        stacked = np.concatenate([d.demand for d in datas], axis=0)
        self.normalizer = norm_cls.fit(stacked) if norm_cls is not None else None

        # Primary storage: one normalized (T, N, C) series per city. The
        # materialized windows are derived lazily (see materialize()) —
        # the window-free resident path never touches them.
        self._series = [
            (
                self.normalizer.transform(d.demand)
                if self.normalizer is not None
                else d.demand
            ).astype(np.float32)
            for d in datas
        ]
        self._series_stack = None
        self._xs = self._ys = None

        T = self._series[0].shape[0]
        per_city = window.n_samples(T)
        if per_city <= 0:
            # the same error sliding_windows would raise — kept eager so a
            # too-short series fails at construction, not at first access
            raise ValueError(
                f"need more than burn_in+horizon-1="
                f"{window.burn_in + window.horizon - 1} timesteps, got T={T}"
            )
        self.split = (
            split.validate_against(per_city)
            if split is not None
            else fraction_splits(per_city)
        )

    def materialize(self) -> None:
        """Build the windowed ``(x, y)`` sample arrays from the series.

        The non-resident/hetero fallback (and the window-free path's
        parity oracle): ``x[i] == series[targets[i] + offsets]`` by
        construction, so the two representations are bit-identical views
        of the same data. Idempotent; called lazily by every accessor
        that needs host-side windows.
        """
        if self._xs is None:
            pairs = [sliding_windows(s, self.window) for s in self._series]
            self._xs = [x for x, _ in pairs]
            self._ys = [y for _, y in pairs]

    @property
    def materialized(self) -> bool:
        """Whether the windowed sample arrays have been built."""
        return self._xs is not None

    def series(self, city: int = 0) -> np.ndarray:
        """One city's normalized ``(T, N, C)`` series — the window-free
        resident payload; windows gather from it by target + offset."""
        return self._series[city]

    def series_stack(self) -> np.ndarray:
        """All cities' series concatenated along time: ``(n_cities*T, N, C)``
        (a zero-copy view for a single city).

        :meth:`mode_targets` indices with ``city=None`` address this
        tensor; window offsets never cross a city boundary because every
        offset lies within ``burn_in`` of its target and every target sits
        at least ``burn_in`` into its own city's block.
        """
        if self.n_cities == 1:
            return self._series[0]
        if self._series_stack is None:
            self._series_stack = np.concatenate(self._series, axis=0)
        return self._series_stack

    def mode_targets(self, mode: str, city: int | None = None) -> np.ndarray:
        """int32 target timesteps for a mode's samples, in ``arrays(mode)``
        order.

        ``city=None`` returns absolute indices into :meth:`series_stack`
        (cities concatenated city-major, matching the ``arrays(mode)``
        concatenation); ``city=k`` returns indices into ``series(k)``.
        Sample ``i`` of the mode satisfies
        ``arrays(mode)[0][i] == stack[targets[i] + window.offsets]`` and
        ``arrays(mode)[1][i] == stack[targets[i] (+ arange(H))]`` exactly.
        """
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        start, stop = self.split.range_for(mode)
        base = self.window.burn_in + np.arange(start, stop)
        if city is not None:
            return base.astype(np.int32)
        T = self._series[0].shape[0]
        return np.concatenate(
            [c * T + base for c in range(self.n_cities)]
        ).astype(np.int32)

    @property
    def samples_per_city(self) -> int:
        return self.window.n_samples(self._series[0].shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the windowed sample arrays (all cities, all modes) —
        what the materialized resident path would upload. Computed
        analytically so sizing decisions never force materialization."""
        per_sample = (
            (self.window.seq_len + self.window.horizon)
            * self.n_nodes
            * self.n_feats
        )
        itemsize = self._series[0].dtype.itemsize
        return self.n_cities * self.samples_per_city * per_sample * itemsize

    @property
    def resident_nbytes(self) -> int:
        """Bytes the window-free resident path keeps on device: the raw
        normalized series plus the int32 target vectors and offset table —
        smaller than :attr:`nbytes` by ~``seq_len``x (windows overlap;
        the series stores each timestep once)."""
        series = sum(s.nbytes for s in self._series)
        targets = 4 * self.n_samples  # one int32 target per sample
        offsets = 4 * self.window.seq_len
        return series + targets + offsets

    @property
    def n_samples(self) -> int:
        return self.samples_per_city * self.n_cities

    @property
    def n_nodes(self) -> int:
        return self._series[0].shape[1]

    @property
    def n_feats(self) -> int:
        return self._series[0].shape[2]

    def mode_size(self, mode: str) -> int:
        """Total samples for a mode across all cities."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        return self.split.mode_len[mode] * self.n_cities

    def arrays(self, mode: str) -> tuple[np.ndarray, np.ndarray]:
        """Full ``(x, y)`` for a mode — a view for one city, a cached concat
        otherwise. Materializes the windowed arrays on first use."""
        start, stop = self.split.range_for(mode)
        self.materialize()
        if self.n_cities == 1:
            return self._xs[0][start:stop], self._ys[0][start:stop]
        if mode not in self._mode_cache:
            self._mode_cache[mode] = (
                np.concatenate([x[start:stop] for x in self._xs], axis=0),
                np.concatenate([y[start:stop] for y in self._ys], axis=0),
            )
        return self._mode_cache[mode]

    def city_arrays(self, mode: str, city: int) -> tuple[np.ndarray, np.ndarray]:
        """One city's ``(x, y)`` views for a mode."""
        start, stop = self.split.range_for(mode)
        self.materialize()
        return self._xs[city][start:stop], self._ys[city][start:stop]

    def denormalize(self, values):
        if self.normalizer is None:
            return values
        return self.normalizer.inverse(values)

    def num_batches(self, mode: str, batch_size: int, drop_last: bool = False) -> int:
        per = self.split.mode_len[mode]
        if self.shared_graphs:
            n = per * self.n_cities
            return n // batch_size if drop_last else -(-n // batch_size)
        # differing graphs: batches never span cities, so each city's tail
        # rounds (or drops) independently
        one = per // batch_size if drop_last else -(-per // batch_size)
        return one * self.n_cities

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
        """Yield :class:`Batch` es over a mode.

        ``pad_last`` repeats the final sample to fill the tail batch so every
        batch has the same static shape under ``jit``; ``Batch.n_real`` lets
        the loss/metrics mask the padding. ``shuffle`` reshuffles per epoch
        with a deterministic ``(seed, epoch)`` stream.

        ``with_arrays=False`` yields index-only batches (``x``/``y`` None):
        a device-resident consumer gathers on device from ``Batch.indices``,
        so materializing host copies here would be pure waste — the
        windowed arrays are not even built (the window-free path runs a
        whole training job on indices + the raw series alone).

        With per-city graphs (``shared_graphs=False``) batches never mix
        cities — every batch carries the ``city`` whose support stack
        applies to it; shuffling permutes within each city.
        """
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last are mutually exclusive")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        per_mode = self.split.mode_len[mode]
        if self.shared_graphs:
            yield from self._iter_arrays(
                lambda: self.arrays(mode), per_mode * self.n_cities, 0,
                batch_size, shuffle, (seed,), epoch, drop_last, pad_last,
                with_arrays,
            )
            return
        for city in range(self.n_cities):
            yield from self._iter_arrays(
                lambda c=city: self.city_arrays(mode, c), per_mode, city,
                batch_size, shuffle, (seed, city), epoch, drop_last,
                pad_last, with_arrays,
            )

    def _iter_arrays(
        self, arrays_fn, n, city, batch_size, shuffle, seed_key, epoch,
        drop_last, pad_last, with_arrays=True,
    ) -> Iterator[Batch]:
        # arrays are a thunk so index-only iteration stays window-free
        x = y = None
        order = None
        if shuffle:
            order = np.random.default_rng((*seed_key, epoch)).permutation(n)
        stop = n - n % batch_size if drop_last else n
        for i in range(0, stop, batch_size):
            idx = slice(i, min(i + batch_size, n))
            if order is not None:
                sel = order[idx]
            else:
                sel = np.arange(i, min(i + batch_size, n))
            n_real = sel.shape[0]
            if pad_last and n_real < batch_size:
                sel = np.concatenate([sel, np.repeat(sel[-1:], batch_size - n_real)])
            if not with_arrays:
                yield Batch(x=None, y=None, n_real=n_real, city=city, indices=sel)
                continue
            if x is None:
                x, y = arrays_fn()
            if order is not None:
                bx, by = x[sel[:n_real]], y[sel[:n_real]]
            else:  # contiguous: keep the zero-copy views
                bx, by = x[idx], y[idx]
            if n_real < sel.shape[0]:  # padded tail
                reps = sel.shape[0] - n_real
                bx = np.concatenate([bx, np.repeat(bx[-1:], reps, axis=0)])
                by = np.concatenate([by, np.repeat(by[-1:], reps, axis=0)])
            yield Batch(x=bx, y=by, n_real=n_real, city=city, indices=sel)
