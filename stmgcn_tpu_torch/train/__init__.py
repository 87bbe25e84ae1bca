"""Training and evaluation: the optimizer, the steps, the epoch loop and
the metrics, the checkpoint files both packages read and write, and the
continual loop's fine-tune side (counterpart of ``stmgcn_tpu/train``, on
one device or as a mesh rank)."""

from stmgcn_tpu_torch.train.checkpoint import (
    CorruptCheckpointError,
    load_checkpoint,
    load_latest_verified,
    save_checkpoint,
)
from stmgcn_tpu_torch.train.continual import (
    ContinualDaemon,
    ContinualTrainer,
    closed_loop_smoke,
    make_holdout_eval,
)
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
from stmgcn_tpu_torch.train.trainer import CitySupports, Trainer

__all__ = [
    "CitySupports",
    "ContinualDaemon",
    "ContinualTrainer",
    "CorruptCheckpointError",
    "LOSSES",
    "MAE",
    "MAPE",
    "MSE",
    "Optimizer",
    "PCC",
    "RMSE",
    "Trainer",
    "closed_loop_smoke",
    "eval_step",
    "gather_window_batch",
    "load_checkpoint",
    "load_latest_verified",
    "make_holdout_eval",
    "make_optimizer",
    "masked_loss",
    "regression_report",
    "save_checkpoint",
    "train_step",
]
