"""Model-to-forecast inference: raw demand history in, raw forecasts out.

Counterpart of ``stmgcn_tpu/inference.py`` (``Forecaster``)::

    fc = Forecaster(model, state_dict, normalizer, cfg, derived)  # on the GPU
    demand_forecast = fc.predict(supports, history)               # raw units

``supports`` are rebuilt from the city's adjacency matrices
(:class:`~stmgcn_tpu_torch.ops.graph.SupportConfig`), which are data, not
model state. ``from_checkpoint`` waits for the checkpoint slice.
"""

from __future__ import annotations

import numpy as np
import torch

from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.serving.predict import serve_predict

__all__ = ["Forecaster"]


class Forecaster:
    """A trained ST-MGCN ready to forecast from raw demand history.

    ``model`` is an :class:`~stmgcn_tpu_torch.models.STMGCN`; it is loaded
    with ``state_dict``, moved to ``device`` (``None`` means the GPU, and
    raises without one) and put in eval mode. ``derived`` is
    ``{"input_dim": C, "n_nodes": N}``.
    """

    def __init__(self, model, state_dict, normalizer, config, derived: dict,
                 device=None):
        self.device = resolve_device(device)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.state_dict = state_dict
        self.normalizer = normalizer
        self.config = config
        self.derived = derived

    @property
    def seq_len(self) -> int:
        return self.config.data.seq_len

    @property
    def horizon(self) -> int:
        return self.config.data.horizon

    @property
    def expected(self) -> tuple:
        """``(seq_len, n_nodes, input_dim)`` of one history window."""
        return (self.seq_len, self.derived["n_nodes"], self.derived["input_dim"])

    def predict(self, supports, history, *, normalized: bool = False) -> np.ndarray:
        """Forecast demand from raw-scale history.

        ``history``: ``(B, seq_len, N, C)`` windowed observations in raw
        demand units (``normalized=True`` if already model-scaled);
        ``supports``: the stacked ``(M, K, N, N)`` array. Returns raw-unit
        forecasts ``(B, N, C)`` or ``(B, H, N, C)``.
        """
        sup = torch.as_tensor(np.asarray(supports, dtype=np.float32), device=self.device)

        def call(h: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                out = self.model(sup, torch.as_tensor(h, device=self.device))
            return out.cpu().numpy()

        return serve_predict(call, self.normalizer, self.expected, history, normalized)

    def serving_engine(self, supports, *, config=None, device=None):
        """A :class:`stmgcn_tpu_torch.serving.ServingEngine` over this model."""
        from stmgcn_tpu_torch.serving.engine import ServingEngine

        return ServingEngine.from_forecaster(self, supports, config=config, device=device)
