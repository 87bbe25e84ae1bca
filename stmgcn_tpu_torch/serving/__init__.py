"""Serving: the shared predict flow and the bucketed engine.

- :mod:`.predict` — ``serve_predict``, the numpy-only normalize → call →
  denormalize flow shared by ``Forecaster`` and the engine;
- :mod:`.bucketing` — shape-bucket arithmetic (covering rung, padding);
- :mod:`.admission` — SLO admission control and the typed errors;
- :mod:`.engine` — :class:`ServingEngine`: bucket ladder, resident
  supports, hot-swappable params behind one ``(generation, model)``
  reference, and :class:`CheckpointWatcher`, its checkpoint hot-swap;
- :mod:`.fleet` — :class:`FleetServingEngine`: a ``(city -> shape
  class)`` router in front of per-class micro-batchers, so one engine
  serves a whole heterogeneous fleet from one checkpoint;
- :mod:`.microbatch` — the request queue coalescing concurrent callers;
- :mod:`.metrics` — per-bucket latency, queue-wait vs device-time split,
  pad waste.
"""

from stmgcn_tpu_torch.serving.admission import (
    AdmissionController,
    BatcherWedged,
    DeadlineExceeded,
    DispatchError,
    Overloaded,
    ShedError,
)
from stmgcn_tpu_torch.serving.bucketing import pad_to_bucket, smallest_covering_bucket
from stmgcn_tpu_torch.serving.engine import CheckpointWatcher, ServingEngine
from stmgcn_tpu_torch.serving.fleet import FleetServingEngine
from stmgcn_tpu_torch.serving.metrics import EngineStats
from stmgcn_tpu_torch.serving.microbatch import MicroBatcher
from stmgcn_tpu_torch.serving.predict import serve_predict

__all__ = [
    "AdmissionController",
    "BatcherWedged",
    "CheckpointWatcher",
    "DeadlineExceeded",
    "DispatchError",
    "EngineStats",
    "FleetServingEngine",
    "MicroBatcher",
    "Overloaded",
    "ServingEngine",
    "ShedError",
    "pad_to_bucket",
    "serve_predict",
    "smallest_covering_bucket",
]
