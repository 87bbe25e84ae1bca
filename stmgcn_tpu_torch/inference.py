"""Model-to-forecast inference: raw demand history in, raw forecasts out.

Counterpart of ``stmgcn_tpu/inference.py`` (``Forecaster``)::

    fc = Forecaster(model, state_dict, normalizer, cfg, derived)  # on the GPU
    demand_forecast = fc.predict(supports, history)               # raw units

``supports`` are rebuilt from the city's adjacency matrices
(:class:`~stmgcn_tpu_torch.ops.graph.SupportConfig`), which are data, not
model state: a dense stack, or for a metro-scale city a
:class:`~stmgcn_tpu_torch.ops.tiling.TiledSupports` plan (``plan_tiling``)
served by a model built with ``model.tiled=True``. The parameters are the
same in every support mode, so weights trained on dense supports serve on
a plan as they are: the port's counterpart of the JAX package's
``to_tiled_serving`` is the identity.

A model built at ``model.dtype="bfloat16"`` serves in bf16 over its float32
parameters; its predictions come back as float32 numpy, as the JAX
package's serve boundary hands bf16 values to numpy. A checkpoint of
either package carries its config (and so ``model.dtype``), the derived
model facts and the normalizer, so serving from a fresh process is::

    fc = Forecaster.from_checkpoint("output/best.ckpt")   # on the GPU

A heterogeneous multi-city checkpoint carries one normalizer per city
(``normalizers``) and a per-city ``derived["n_nodes"]``; ``predict`` then
takes ``city=`` and :meth:`Forecaster.fleet_engine` serves every city from
one engine (``serving/fleet.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stmgcn_tpu_torch.config import ExperimentConfig
from stmgcn_tpu_torch.data.normalize import normalizer_from_dict
from stmgcn_tpu_torch.experiment import build_model
from stmgcn_tpu_torch.models.params import from_jax_params
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.ops.spmm import place_supports
from stmgcn_tpu_torch.serving.predict import serve_predict
from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

__all__ = ["Forecaster"]


class Forecaster:
    """A trained ST-MGCN ready to forecast from raw demand history.

    ``model`` is an :class:`~stmgcn_tpu_torch.models.STMGCN`; it is loaded
    with ``state_dict``, moved to ``device`` (``None`` means the GPU, and
    raises without one) and put in eval mode. ``derived`` is
    ``{"input_dim": C, "n_nodes": N}``, with ``n_nodes`` a per-city list
    when ``normalizers`` (one per city, a heterogeneous checkpoint's) is
    given. ``health_baseline`` is the training-time drift baseline of the
    checkpoint's meta (None without one): what the serving engines' drift
    monitor compares live traffic against.
    """

    def __init__(self, model, state_dict, normalizer, config, derived: dict,
                 normalizers=None, device=None, health_baseline: Optional[dict] = None):
        self.device = resolve_device(device)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.state_dict = state_dict
        self.normalizer = normalizer
        #: heterogeneous multi-city checkpoints: one normalizer per city;
        #: ``predict`` selects with ``city=``
        self.normalizers = None if normalizers is None else list(normalizers)
        self.config = config
        self.derived = derived
        self.health_baseline = health_baseline
        self._placed = None  # (supports as given, supports on the device)

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "Forecaster":
        """The model of a checkpoint file (written by either package's
        trainer): rebuilt from its ``config`` and ``derived["input_dim"]``,
        loaded with its parameters (the optimizer blob is skipped) and its
        normalizer, on ``device`` (``None`` means the GPU)."""
        meta, params, _ = load_checkpoint(path, load_opt_state=False)
        if "config" not in meta or "derived" not in meta:
            raise ValueError(
                f"{path} lacks the config/derived metadata needed to rebuild "
                "the model (was it written by a Trainer from build_trainer?)"
            )
        cfg = ExperimentConfig.from_dict(meta["config"])
        normalizer = normalizer_from_dict(meta["normalizer"]) if "normalizer" in meta else None
        normalizers = None
        if "normalizers" in meta:  # heterogeneous multi-city checkpoint
            normalizers = [normalizer_from_dict(n) if n is not None else None
                           for n in meta["normalizers"]]
        device = resolve_device(device)
        model = build_model(cfg, meta["derived"]["input_dim"], device=device)
        state = from_jax_params(params, cfg.model.m_graphs)
        return cls(model, state, normalizer, cfg, meta["derived"], normalizers, device=device,
                   health_baseline=meta.get("health_baseline"))

    def place(self, supports):
        """``supports`` on this forecaster's device, checked against the
        model; the last object placed is kept, so repeated calls with the
        same supports upload them once."""
        if self._placed is None or self._placed[0] is not supports:
            placed = place_supports(supports, self.device)
            self.model.check_supports(placed)
            self._placed = (supports, placed)
        return self._placed[1]

    @property
    def seq_len(self) -> int:
        return self.config.data.seq_len

    @property
    def horizon(self) -> int:
        return self.config.data.horizon

    @property
    def expected(self) -> tuple:
        """``(seq_len, n_nodes, input_dim)`` of one history window (of a
        homogeneous checkpoint; :meth:`city_view` for one city of a
        heterogeneous one)."""
        return (self.seq_len, self.derived["n_nodes"], self.derived["input_dim"])

    def city_view(self, city: Optional[int]) -> tuple:
        """``(normalizer, expected)`` of one city, with the JAX package's
        checks: ``city`` is required when a heterogeneous checkpoint holds
        more than one normalizer, must lie in range, and applies to
        heterogeneous checkpoints only."""
        if self.normalizers is None:
            if city not in (None, 0):
                raise ValueError("city= only applies to heterogeneous multi-city checkpoints")
            return self.normalizer, self.expected
        if city is None:
            if len(self.normalizers) > 1:
                # cities may share N, so no shape check would catch a wrong default
                raise ValueError(f"this checkpoint holds {len(self.normalizers)} per-city "
                                 "normalizers; pass city= to select one")
            city = 0
        if not 0 <= city < len(self.normalizers):
            raise ValueError(f"city must be in [0, {len(self.normalizers)}), got {city}")
        expected = (self.seq_len, self.derived["n_nodes"][city], self.derived["input_dim"])
        return self.normalizers[city], expected

    def predict(self, supports, history, *, normalized: bool = False,
                city: Optional[int] = None) -> np.ndarray:
        """Forecast demand from raw-scale history.

        ``history``: ``(B, seq_len, N, C)`` windowed observations in raw
        demand units (``normalized=True`` if already model-scaled);
        ``supports``: the model's support form — the stacked ``(M, K, N,
        N)`` array, a ``TiledSupports`` plan, or M block-sparse groups —
        placed on the device once per object (:meth:`place`). With a
        heterogeneous checkpoint ``city`` selects the city's normalizer and
        region count (:meth:`city_view`). Returns raw-unit forecasts ``(B,
        N, C)`` or ``(B, H, N, C)``.
        """
        normalizer, expected = self.city_view(city)
        sup = self.place(supports)

        def call(h: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                out = self.model(sup, torch.as_tensor(h, device=self.device))
            return out.float().cpu().numpy()  # a bf16 model's predictions, exactly

        return serve_predict(call, normalizer, expected, history, normalized)

    def serving_engine(self, supports, *, config=None, city=None, device=None, graphs=None,
                       fault_plan=None):
        """A :class:`stmgcn_tpu_torch.serving.ServingEngine` over this model
        (one city of a heterogeneous checkpoint: ``city=``; ``graphs`` and
        ``fault_plan`` as ``ServingEngine.from_forecaster``'s)."""
        from stmgcn_tpu_torch.serving.engine import ServingEngine

        return ServingEngine.from_forecaster(self, supports, config=config, city=city,
                                             device=device, graphs=graphs,
                                             fault_plan=fault_plan)

    def fleet_engine(self, city_supports, *, config=None, max_classes: int = 8,
                     max_pad_waste: float = 0.5, device=None, graphs=None, fault_plan=None):
        """A :class:`stmgcn_tpu_torch.serving.FleetServingEngine` over this
        heterogeneous checkpoint: every city from one engine, requests for
        cities of one shape class coalescing into one dispatch (``graphs``
        and ``fault_plan`` as ``FleetServingEngine.from_forecaster``'s)."""
        from stmgcn_tpu_torch.serving.fleet import FleetServingEngine

        return FleetServingEngine.from_forecaster(
            self, city_supports, config=config, max_classes=max_classes,
            max_pad_waste=max_pad_waste, device=device, graphs=graphs, fault_plan=fault_plan)
