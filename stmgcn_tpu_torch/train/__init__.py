"""Training and evaluation: the optimizer, the steps, the epoch loop and
the metrics (counterpart of ``stmgcn_tpu/train``, fp32 on one device;
checkpoint files not ported yet)."""

from stmgcn_tpu_torch.train.metrics import MAE, MAPE, MSE, PCC, RMSE, regression_report
from stmgcn_tpu_torch.train.step import (
    LOSSES,
    Optimizer,
    eval_step,
    gather_window_batch,
    make_optimizer,
    masked_loss,
    train_step,
)
from stmgcn_tpu_torch.train.trainer import Trainer

__all__ = [
    "LOSSES",
    "MAE",
    "MAPE",
    "MSE",
    "Optimizer",
    "PCC",
    "RMSE",
    "Trainer",
    "eval_step",
    "gather_window_batch",
    "make_optimizer",
    "masked_loss",
    "regression_report",
    "train_step",
]
