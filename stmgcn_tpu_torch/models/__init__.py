"""Model layer: the dense ST-MGCN flagship and its weight converter."""

from stmgcn_tpu_torch.models.cg_lstm import CGLSTM, ContextualGate
from stmgcn_tpu_torch.models.params import from_jax_params, to_jax_params
from stmgcn_tpu_torch.models.st_mgcn import STMGCN, Branch

__all__ = ["Branch", "CGLSTM", "ContextualGate", "STMGCN", "from_jax_params", "to_jax_params"]
