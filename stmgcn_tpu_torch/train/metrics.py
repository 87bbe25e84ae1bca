"""Regression metrics (numpy, host side).

A copy of ``stmgcn_tpu/train/metrics.py`` (which the port may not import).
Reference: the five staticmethods at ``Model_Trainer.py:100-114`` — MSE,
RMSE, MAE, MAPE with an ``epsilon=1.0`` zero-division guard (``:110``), and
PCC (defined there, never called; wired into the report here). Metrics are
computed host-side on denormalized arrays, matching the reference's
evaluation flow (``Model_Trainer.py:89-95``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MSE", "RMSE", "MAE", "MAPE", "PCC", "regression_report"]


def MSE(y_pred, y_true) -> float:
    return float(np.mean(np.square(np.asarray(y_pred) - np.asarray(y_true))))


def RMSE(y_pred, y_true) -> float:
    return float(np.sqrt(MSE(y_pred, y_true)))


def MAE(y_pred, y_true) -> float:
    return float(np.mean(np.abs(np.asarray(y_pred) - np.asarray(y_true))))


def MAPE(y_pred, y_true, epsilon: float = 1.0) -> float:
    """Mean absolute percentage error with the reference's additive guard.

    Note the guard is ``y_true + epsilon`` in the denominator
    (``Model_Trainer.py:110-111``), not ``max(|y|, eps)``.
    """
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    return float(np.mean(np.abs(y_pred - y_true) / (y_true + epsilon)))


def PCC(y_pred, y_true) -> float:
    """Pearson correlation of the flattened arrays (``Model_Trainer.py:112-114``).

    Returns NaN (without the numpy warning) when either side is constant.
    """
    a = np.asarray(y_pred).ravel()
    b = np.asarray(y_true).ravel()
    if a.std() == 0.0 or b.std() == 0.0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def regression_report(y_pred, y_true) -> dict:
    """All metrics at once; the reference prints MSE/RMSE/MAE/MAPE
    (``Model_Trainer.py:92-95``) — PCC included as a bonus."""
    return {
        "mse": MSE(y_pred, y_true),
        "rmse": RMSE(y_pred, y_true),
        "mae": MAE(y_pred, y_true),
        "mape": MAPE(y_pred, y_true),
        "pcc": PCC(y_pred, y_true),
    }
