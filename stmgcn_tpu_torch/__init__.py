"""PyTorch/CUDA port of stmgcn-tpu for one NVIDIA H100.

A package of its own beside the JAX reference ``stmgcn_tpu``: module names
mirror it (``stmgcn_tpu_torch/models/cg_lstm.py`` is the counterpart of
``stmgcn_tpu/models/cg_lstm.py``), and the tests hold each module against
its JAX counterpart on the same weights and inputs. This package imports
``torch`` and numpy, never JAX, flax or the JAX package.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
there the hand-written kernels give way to their plain PyTorch versions.
"""

from stmgcn_tpu_torch.config import ExperimentConfig, ServingConfig, TrainConfig, preset
from stmgcn_tpu_torch.data import SeriesRing, StaleObservationError, ingest_stream
from stmgcn_tpu_torch.experiment import build_trainer, run
from stmgcn_tpu_torch.inference import Forecaster
from stmgcn_tpu_torch.models import STMGCN, from_jax_params, to_jax_params
from stmgcn_tpu_torch.serving import (
    CityOutcome,
    FederationRouter,
    FleetServingEngine,
    GateDecision,
    GlobalBudget,
    HashRing,
    PromotionGate,
    ReplicaHandle,
    ReplicaUnavailable,
    ServingEngine,
    TierPromotionGate,
)
from stmgcn_tpu_torch.train import (
    CitySupports,
    ContinualDaemon,
    ContinualTrainer,
    Trainer,
    closed_loop_smoke,
    make_holdout_eval,
)

__all__ = [
    "CitySupports",
    "CityOutcome",
    "ContinualDaemon",
    "ContinualTrainer",
    "ExperimentConfig",
    "FederationRouter",
    "FleetServingEngine",
    "Forecaster",
    "GateDecision",
    "GlobalBudget",
    "HashRing",
    "PromotionGate",
    "ReplicaHandle",
    "ReplicaUnavailable",
    "STMGCN",
    "SeriesRing",
    "ServingConfig",
    "ServingEngine",
    "StaleObservationError",
    "TierPromotionGate",
    "TrainConfig",
    "Trainer",
    "build_trainer",
    "closed_loop_smoke",
    "from_jax_params",
    "ingest_stream",
    "make_holdout_eval",
    "preset",
    "run",
    "to_jax_params",
]
