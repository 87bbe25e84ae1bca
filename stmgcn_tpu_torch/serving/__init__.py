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
  pad waste;
- :mod:`.bench` — ``serve-bench``, the serving benchmark (imported by
  name only: its throwaway trainer pulls the whole stack).

The names below resolve lazily (a module ``__getattr__``), so
``stmgcn_tpu_torch.serving.predict`` imports without the engine and its
model stack: what ``stmgcn_tpu_torch.export`` needs.
"""

import importlib

#: every name and the submodule it lives in
_LAZY = {
    "AdmissionController": "admission",
    "BatcherWedged": "admission",
    "DeadlineExceeded": "admission",
    "DispatchError": "admission",
    "GlobalBudget": "admission",
    "Overloaded": "admission",
    "ShedError": "admission",
    "pad_to_bucket": "bucketing",
    "smallest_covering_bucket": "bucketing",
    "CheckpointWatcher": "engine",
    "ServingEngine": "engine",
    "CityOutcome": "federation",
    "FederationRouter": "federation",
    "HashRing": "federation",
    "ReplicaHandle": "federation",
    "ReplicaUnavailable": "federation",
    "ring_hash": "federation",
    "FleetServingEngine": "fleet",
    "EngineStats": "metrics",
    "MicroBatcher": "microbatch",
    "serve_predict": "predict",
    "GateDecision": "promotion",
    "PromotionGate": "promotion",
    "TierPromotionGate": "promotion",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
