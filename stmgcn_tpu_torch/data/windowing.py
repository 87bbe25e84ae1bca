"""Vectorized serial / daily-periodic / weekly-periodic window extraction.

Reference semantics (``Data_Container.py:125-146``, verified in SURVEY.md §2
C3/C5) reproduced exactly, but as **one fancy-index gather** over a
precomputed offset table instead of a Python loop over every timestep — the
reference's hottest host-side loop (SURVEY.md §3.1).

Pinned semantics:

- burn-in ``= max(serial_len, daily_len*day_steps, weekly_len*day_steps*7)``
  (``Data_Container.py:127``): the first sample's target is the first
  timestep with a full history.
- serial component: the ``serial_len`` timesteps immediately before the
  target (``Data_Container.py:129``).
- periodic components use skip stride ``p_len * period`` — i.e. the *d*-th
  daily lag sits ``d * daily_len`` days back, not ``d`` days
  (``Data_Container.py:138-140``); same for weekly with period ``7`` — and
  are emitted oldest-first (the ``[::-1]`` at ``Data_Container.py:145``).
- concatenation order along the sequence axis is
  ``[weekly | daily | serial]`` (``Data_Container.py:83-86``), with
  zero-length components skipped (the ``ndim != 2`` test at
  ``Data_Container.py:84``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WindowSpec", "sliding_windows"]


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Observation-window lengths (reference CLI ``-cpt s d w``, ``Main.py:30-33``).

    ``day_timesteps`` is the number of timesteps per day (``24 // dt``,
    ``Data_Container.py:96``).
    """

    serial_len: int = 3
    daily_len: int = 1
    weekly_len: int = 1
    day_timesteps: int = 24
    #: forecast steps per sample; 1 reproduces the reference's next-step
    #: target (``Data_Container.py:132``), H>1 makes targets ``t .. t+H-1``
    horizon: int = 1

    def __post_init__(self):
        if min(self.serial_len, self.daily_len, self.weekly_len) < 0:
            raise ValueError("window lengths must be >= 0")
        if self.seq_len == 0:
            raise ValueError("at least one window component must be non-empty")
        if self.day_timesteps <= 0:
            raise ValueError("day_timesteps must be positive")
        if self.horizon < 1:
            raise ValueError("horizon must be >= 1")

    @property
    def seq_len(self) -> int:
        """Total model sequence length (reference ``sum(obs_len)``, ``Main.py:62``)."""
        return self.serial_len + self.daily_len + self.weekly_len

    @property
    def burn_in(self) -> int:
        """Timesteps of history needed before the first target.

        The reference computes ``max(s, d*day_steps, w*day_steps*7)``
        (``Data_Container.py:127``), but because the periodic skip stride is
        itself scaled by the component length (``p_steps * k`` for lag ``k``,
        ``Data_Container.py:138-144``) the deepest lag reaches
        ``p_len**2 * period`` timesteps back — for ``daily_len`` or
        ``weekly_len`` >= 2 the reference's first samples wrap to *negative*
        indices and silently read future data. Fixed here by covering the
        deepest actual lag; identical to the reference for the default
        ``(3, 1, 1)`` config (168).
        """
        return max(
            self.serial_len,
            self.daily_len**2 * self.day_timesteps,
            self.weekly_len**2 * self.day_timesteps * 7,
        )

    def n_samples(self, n_timesteps: int) -> int:
        """Windowed sample count for a ``T``-timestep series."""
        return n_timesteps - self.burn_in - (self.horizon - 1)

    @property
    def offsets(self) -> np.ndarray:
        """Gather offsets (relative to the target index) in ``[weekly|daily|serial]`` order."""
        parts = []
        if self.weekly_len:
            stride = self.weekly_len * self.day_timesteps * 7
            parts.append(-stride * np.arange(self.weekly_len, 0, -1))
        if self.daily_len:
            stride = self.daily_len * self.day_timesteps
            parts.append(-stride * np.arange(self.daily_len, 0, -1))
        if self.serial_len:
            parts.append(np.arange(-self.serial_len, 0))
        return np.concatenate(parts)

    def target_indices(self, n_timesteps: int) -> np.ndarray:
        """Target timesteps for every sample of a ``T``-step series.

        Sample ``i`` targets timestep ``burn_in + i``; its observation
        window is ``series[target + offsets]`` and its label is
        ``series[target : target + horizon]``. This is the whole sample
        enumeration — :func:`sliding_windows` is exactly the gather of
        these targets, which is what lets the window-free resident path
        ship targets + offsets instead of materialized windows.
        """
        return np.arange(self.burn_in, n_timesteps - self.horizon + 1)


def sliding_windows(data, spec: WindowSpec) -> tuple[np.ndarray, np.ndarray]:
    """Extract all ``(x_seq, y)`` samples from a ``(T, N, C)`` demand tensor.

    Returns ``x`` of shape ``(S, seq_len, N, C)`` and ``y`` of shape
    ``(S, N, C)`` for ``horizon == 1`` (reference parity) or
    ``(S, horizon, N, C)`` for multi-step forecasting, where
    ``S = T - spec.burn_in - (spec.horizon - 1)``; sample ``i``'s first
    target is timestep ``spec.burn_in + i``. Equivalent to the reference's
    ``get_feats`` + per-mode concatenation (``Data_Container.py:125-146`` and
    ``:82-86``) in a single gather.
    """
    data = np.asarray(data)
    if data.ndim < 1:
        raise ValueError("data must have a leading time axis")
    T = data.shape[0]
    h = spec.horizon
    if T <= spec.burn_in + h - 1:
        raise ValueError(
            f"need more than burn_in+horizon-1={spec.burn_in + h - 1} "
            f"timesteps, got T={T}"
        )
    targets = spec.target_indices(T)
    x = data[targets[:, None] + spec.offsets[None, :]]
    if h == 1:
        y = data[targets]
    else:
        y = data[targets[:, None] + np.arange(h)[None, :]]
    return x, y
