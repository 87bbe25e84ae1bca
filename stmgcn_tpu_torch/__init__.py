"""PyTorch/CUDA port of stmgcn-tpu for one NVIDIA H100.

A package of its own beside the JAX reference ``stmgcn_tpu``: module names
mirror it (``stmgcn_tpu_torch/models/cg_lstm.py`` is the counterpart of
``stmgcn_tpu/models/cg_lstm.py``), and the tests hold each module against
its JAX counterpart on the same weights and inputs. This package imports
``torch`` and numpy, never JAX, flax or the JAX package.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
there the hand-written kernels give way to their plain PyTorch versions.
"""

from stmgcn_tpu_torch.config import ExperimentConfig, ServingConfig, preset
from stmgcn_tpu_torch.inference import Forecaster
from stmgcn_tpu_torch.models import STMGCN, from_jax_params, to_jax_params
from stmgcn_tpu_torch.serving import ServingEngine

__all__ = [
    "ExperimentConfig",
    "Forecaster",
    "STMGCN",
    "ServingConfig",
    "ServingEngine",
    "from_jax_params",
    "preset",
    "to_jax_params",
]
