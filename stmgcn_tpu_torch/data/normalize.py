"""Normalization with externally-storable statistics.

Reference: ``Data_Container.py:31-51`` (min-max to ``[-1, 1]`` and the unused
std pair). The reference keeps ``_min``/``_max`` as hidden attributes on the
live ``DataInput`` object, so its saved checkpoints cannot denormalize
without re-running the loader (SURVEY.md §5.d). Here the statistics are an
explicit, serializable value that travels inside the training checkpoint.

Parity notes: statistics are fit over the *entire* tensor (train and test
together), exactly like ``DataInput.load_data`` (``Data_Container.py:21``),
and the min-max transform maps to ``[-1, 1]`` via ``2x - 1``
(``Data_Container.py:34-35``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MinMaxNormalizer", "StdNormalizer", "normalizer_from_dict"]


@dataclasses.dataclass(frozen=True)
class MinMaxNormalizer:
    """Min-max to ``[-1, 1]``; reference ``Data_Container.py:31-41``."""

    minimum: float
    maximum: float

    @classmethod
    def fit(cls, x) -> "MinMaxNormalizer":
        x = np.asarray(x)
        lo, hi = float(x.min()), float(x.max())
        if hi == lo:
            # The reference silently divides by zero here
            # (Data_Container.py:34); fail loudly instead of emitting NaN.
            raise ValueError(
                f"cannot min-max normalize constant data (min == max == {lo})"
            )
        return cls(minimum=lo, maximum=hi)

    @property
    def scale(self) -> float:
        return self.maximum - self.minimum

    def transform(self, x):
        x = (x - self.minimum) / self.scale
        return 2.0 * x - 1.0

    def inverse(self, x):
        x = (x + 1.0) / 2.0
        return self.scale * x + self.minimum

    def to_dict(self) -> dict:
        return {"kind": "minmax", "minimum": self.minimum, "maximum": self.maximum}


@dataclasses.dataclass(frozen=True)
class StdNormalizer:
    """Zero-mean unit-variance; reference ``Data_Container.py:43-51``."""

    mean: float
    std: float

    @classmethod
    def fit(cls, x) -> "StdNormalizer":
        x = np.asarray(x)
        std = float(x.std())
        if std == 0.0:
            raise ValueError("cannot std-normalize constant data (std == 0)")
        return cls(mean=float(x.mean()), std=std)

    def transform(self, x):
        return (x - self.mean) / self.std

    def inverse(self, x):
        return x * self.std + self.mean

    def to_dict(self) -> dict:
        return {"kind": "std", "mean": self.mean, "std": self.std}


def normalizer_from_dict(d: dict):
    kind = d.get("kind")
    if kind == "minmax":
        return MinMaxNormalizer(minimum=d["minimum"], maximum=d["maximum"])
    if kind == "std":
        return StdNormalizer(mean=d["mean"], std=d["std"])
    raise ValueError(f"unknown normalizer kind {kind!r}")
