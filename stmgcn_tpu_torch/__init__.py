"""PyTorch/CUDA port of stmgcn-tpu for one NVIDIA H100.

A package of its own beside the JAX reference ``stmgcn_tpu``: module names
mirror it (``stmgcn_tpu_torch/models/cg_lstm.py`` is the counterpart of
``stmgcn_tpu/models/cg_lstm.py``), and the tests hold each module against
its JAX counterpart on the same weights and inputs. This package imports
``torch`` and numpy, never JAX, flax or the JAX package.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
there the hand-written kernels give way to their plain PyTorch versions.

The top-level names resolve lazily (a module ``__getattr__``, as the JAX
package's), so importing a leaf module such as ``stmgcn_tpu_torch.export``
does not pull in the model, training and experiment stack.
"""

import importlib

#: every top-level name and the module it lives in
_LAZY = {
    "ExperimentConfig": "stmgcn_tpu_torch.config",
    "ServingConfig": "stmgcn_tpu_torch.config",
    "TrainConfig": "stmgcn_tpu_torch.config",
    "preset": "stmgcn_tpu_torch.config",
    "SeriesRing": "stmgcn_tpu_torch.data",
    "StaleObservationError": "stmgcn_tpu_torch.data",
    "ingest_stream": "stmgcn_tpu_torch.data",
    "build_trainer": "stmgcn_tpu_torch.experiment",
    "run": "stmgcn_tpu_torch.experiment",
    "ExportedForecaster": "stmgcn_tpu_torch.export",
    "export_forecaster": "stmgcn_tpu_torch.export",
    "Forecaster": "stmgcn_tpu_torch.inference",
    "STMGCN": "stmgcn_tpu_torch.models",
    "from_jax_params": "stmgcn_tpu_torch.models",
    "to_jax_params": "stmgcn_tpu_torch.models",
    "CityOutcome": "stmgcn_tpu_torch.serving",
    "FederationRouter": "stmgcn_tpu_torch.serving",
    "FleetServingEngine": "stmgcn_tpu_torch.serving",
    "GateDecision": "stmgcn_tpu_torch.serving",
    "GlobalBudget": "stmgcn_tpu_torch.serving",
    "HashRing": "stmgcn_tpu_torch.serving",
    "PromotionGate": "stmgcn_tpu_torch.serving",
    "ReplicaHandle": "stmgcn_tpu_torch.serving",
    "ReplicaUnavailable": "stmgcn_tpu_torch.serving",
    "ServingEngine": "stmgcn_tpu_torch.serving",
    "TierPromotionGate": "stmgcn_tpu_torch.serving",
    "CitySupports": "stmgcn_tpu_torch.train",
    "ContinualDaemon": "stmgcn_tpu_torch.train",
    "ContinualTrainer": "stmgcn_tpu_torch.train",
    "Trainer": "stmgcn_tpu_torch.train",
    "closed_loop_smoke": "stmgcn_tpu_torch.train",
    "make_holdout_eval": "stmgcn_tpu_torch.train",
}

__all__ = sorted(_LAZY)

#: subpackages reachable as attributes, imported on first use
_SUBPACKAGES = ("parallel", "utils")


def __getattr__(name):
    """``stmgcn_tpu_torch.Forecaster`` and the other top-level names, and
    the subpackages ``parallel`` (the mesh) and ``utils`` (with ``comm``),
    imported on first use."""
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
