"""Framework-free serving glue shared by the forecaster and the engine.

Imports nothing but numpy, so the raw-units contract lives in one place:
:class:`stmgcn_tpu_torch.inference.Forecaster` runs it per call, and
:class:`stmgcn_tpu_torch.serving.engine.ServingEngine` implements the same
validate → normalize → call → denormalize contract with the
normalization vectorized per coalesced dispatch (agreement between the
two flows is pinned in tests/test_torch_serving.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["serve_predict"]


def serve_predict(call, normalizer, expected, history, normalized: bool) -> np.ndarray:
    """Shared raw-units serving flow: validate → normalize → call →
    denormalize. ``expected`` is ``(seq_len, n_nodes, input_dim)``;
    ``call`` maps a normalized ``(B, T, N, C)`` array to predictions.
    """
    history = np.asarray(history, dtype=np.float32)
    if history.ndim != 4 or history.shape[1:] != tuple(expected):
        raise ValueError(
            f"history must be (B, seq_len={expected[0]}, n_nodes={expected[1]}, "
            f"n_feats={expected[2]}) for this model, got {history.shape}"
        )
    if not normalized and normalizer is not None:
        history = normalizer.transform(history)
    pred = np.asarray(call(history))
    if normalizer is not None:
        pred = normalizer.inverse(pred)
    return pred
