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
- :mod:`.promotion` — :class:`PromotionGate` and :class:`TierPromotionGate`,
  the guarded door from the continual loop's candidates to the engines;
- :mod:`.federation` — :class:`FederationRouter`: city-sharded engine
  replicas behind one router (consistent hashing, scatter/gather, drain,
  re-shard, warm spares), sharing one :class:`GlobalBudget`;
- :mod:`.microbatch` — the request queue coalescing concurrent callers;
- :mod:`.metrics` — per-bucket latency, queue-wait vs device-time split,
  pad waste.
"""

from stmgcn_tpu_torch.serving.admission import (
    AdmissionController,
    BatcherWedged,
    DeadlineExceeded,
    DispatchError,
    GlobalBudget,
    Overloaded,
    ShedError,
)
from stmgcn_tpu_torch.serving.bucketing import pad_to_bucket, smallest_covering_bucket
from stmgcn_tpu_torch.serving.engine import CheckpointWatcher, ServingEngine
from stmgcn_tpu_torch.serving.federation import (
    CityOutcome,
    FederationRouter,
    HashRing,
    ReplicaHandle,
    ReplicaUnavailable,
    ring_hash,
)
from stmgcn_tpu_torch.serving.fleet import FleetServingEngine
from stmgcn_tpu_torch.serving.metrics import EngineStats
from stmgcn_tpu_torch.serving.microbatch import MicroBatcher
from stmgcn_tpu_torch.serving.predict import serve_predict
from stmgcn_tpu_torch.serving.promotion import GateDecision, PromotionGate, TierPromotionGate

__all__ = [
    "AdmissionController",
    "BatcherWedged",
    "CheckpointWatcher",
    "CityOutcome",
    "DeadlineExceeded",
    "DispatchError",
    "EngineStats",
    "FederationRouter",
    "FleetServingEngine",
    "GateDecision",
    "GlobalBudget",
    "HashRing",
    "MicroBatcher",
    "Overloaded",
    "PromotionGate",
    "ReplicaHandle",
    "ReplicaUnavailable",
    "ServingEngine",
    "ShedError",
    "TierPromotionGate",
    "pad_to_bucket",
    "ring_hash",
    "serve_predict",
    "smallest_covering_bucket",
]
