"""Date-range driven train/validate/test splits, in timestep units.

Reference: ``DataGenerator.date2len`` (``Data_Container.py:102-112``) maps
``MMDD`` date strings to split *lengths* in timesteps, carves validation off
the end of train with ``val_ratio``, and places test immediately after
validation ("Test follows train", ``Main.py:27``).

Fixed here (SURVEY.md §2 quirk 3): the reference returns the train start as
a **day** index and uses it directly to index **timestep**-resolution sample
arrays, and never subtracts the windowing burn-in — correct only for the
default ``-date 0101 ...`` start. This module converts the start date to
timesteps, subtracts the burn-in, and validates that every split fits inside
the available samples.
"""

from __future__ import annotations

import dataclasses
import datetime
import warnings

__all__ = ["SplitSpec", "date_splits", "fraction_splits"]

MODES = ("train", "validate", "test")


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    """Contiguous sample ranges per mode over a windowed sample array."""

    start_idx: int
    mode_len: dict  # {"train": int, "validate": int, "test": int}

    def range_for(self, mode: str) -> tuple[int, int]:
        """Half-open ``[start, stop)`` sample range for ``mode``.

        Cumulative offsets exactly as ``TaxiDataset.prepare_xy``
        (``Data_Container.py:75-80``).
        """
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        start = self.start_idx
        for m in MODES:
            if m == mode:
                break
            start += self.mode_len[m]
        return start, start + self.mode_len[mode]

    @property
    def total(self) -> int:
        return sum(self.mode_len.values())

    def validate_against(self, n_samples: int) -> "SplitSpec":
        if self.start_idx + self.total > n_samples:
            raise ValueError(
                f"splits need {self.start_idx + self.total} samples but only "
                f"{n_samples} exist"
            )
        return self


def fraction_splits(
    n_samples: int, train: float = 0.7, validate: float = 0.1
) -> SplitSpec:
    """Fractional contiguous splits for date-less (e.g. synthetic) data.

    Test takes the remainder. Same contiguous train->validate->test layout
    as the date-driven path.
    """
    if not 0 < train < 1 or not 0 <= validate < 1 or train + validate >= 1:
        raise ValueError(f"invalid fractions train={train}, validate={validate}")
    train_len = int(n_samples * train)
    val_len = int(n_samples * validate)
    test_len = n_samples - train_len - val_len
    return SplitSpec(
        start_idx=0,
        mode_len={"train": train_len, "validate": val_len, "test": test_len},
    ).validate_against(n_samples)


def _day_of_year(year: int, mmdd: str) -> int:
    d = datetime.date(year, int(mmdd[:2]), int(mmdd[2:]))
    return (d - datetime.date(year, 1, 1)).days


def date_splits(
    dates,
    *,
    burn_in: int,
    day_timesteps: int = 24,
    val_ratio: float = 0.2,
    year: int = 2017,
    n_samples: int | None = None,
) -> SplitSpec:
    """Build a :class:`SplitSpec` from ``[train_start, train_end, test_start, test_end]``.

    Lengths match the reference exactly: ``train = days * day_timesteps``
    with ``validate = int(train * val_ratio)`` carved off the end
    (``Data_Container.py:104-108``), ``test = test-days * day_timesteps``
    (``:109-111``). The start index is converted to timesteps and shifted by
    ``burn_in`` (the unit-bug fix), clamped at the first available sample:
    when the train start date falls inside the initial burn-in window (as
    the default ``0101`` start does) the split begins at the first sample
    with a full history — the position the reference's ``start_idx = 0``
    denotes. A clamp that actually moves a non-day-0 start is warned about.
    ``burn_in`` is a required keyword (pass ``WindowSpec.burn_in``) so the
    fix cannot be silently skipped. Pass ``n_samples`` to bounds-check the
    split extents.
    """
    if len(dates) != 4:
        raise ValueError("dates must be [train_start, train_end, test_start, test_end]")
    t0, t1, s0, s1 = (_day_of_year(year, d) for d in dates)
    if t1 < t0 or s1 < s0:
        raise ValueError(f"date ranges must be ascending, got {dates}")
    if s0 != t1 + 1:
        # The test dates only determine the split *length*; the test range is
        # always placed immediately after validation ("Test follows train",
        # Main.py:27-28). A gap or overlap between the ranges means the test
        # samples do not cover the dates the caller named — surface that.
        warnings.warn(
            f"test start {dates[2]} is not the day after train end {dates[1]}; "
            "the test split is placed contiguously after validation, so its "
            "samples will not correspond to the named test dates",
            stacklevel=2,
        )
    train_len = (t1 + 1 - t0) * day_timesteps
    val_len = int(train_len * val_ratio)
    train_len -= val_len
    test_len = (s1 + 1 - s0) * day_timesteps
    if 0 < t0 * day_timesteps < burn_in:
        warnings.warn(
            f"train start {dates[0]} falls inside the {burn_in}-timestep window "
            "burn-in; the split begins at the first sample with a full history, "
            f"{burn_in - t0 * day_timesteps} timesteps after the named date",
            stacklevel=2,
        )
    spec = SplitSpec(
        start_idx=max(0, t0 * day_timesteps - burn_in),
        mode_len={"train": train_len, "validate": val_len, "test": test_len},
    )
    if n_samples is not None:
        spec.validate_against(n_samples)
    return spec
