"""The training loop: epochs over the window-free resident series.

Counterpart of ``stmgcn_tpu/train/trainer.py`` (``Trainer``) on its
single-device, homogeneous, window-free resident path:

- the normalized ``(T, N, C)`` series, the per-mode int32 target vectors
  and the window's offset table are uploaded once; every batch is an
  index vector, gathered on the device (``gather_window_batch``);
- batches come from ``DemandDataset.batches(..., pad_last=True,
  with_arrays=False)`` in the JAX order (``shuffle``/``seed``/``epoch``),
  and a ``(B,)`` sample mask drops the padded tail from the loss;
- ``steps_per_superstep=S`` runs S optimizer steps per block with one loss
  readback per block (a plain loop of steps; CUDA-graph capture is later
  work), the short tail block included;
- epoch losses are sample-weighted; best-on-val uses ``<=``, with
  patience and early stop, as the reference does;
- ``test()`` reports denormalized ``regression_report``s per mode.

Checkpoint files are not ported (the JAX format needs msgpack): the best
parameters are kept as an in-memory ``state_dict`` copy, which
``test(checkpoint="best")`` evaluates. Nothing is written to disk. Not
ported either: streaming placement, materialized windows, fleet classes,
heterogeneous cities, node padding and meshes, the divergence guard and
fault plan, health telemetry, sanitizers and bf16.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from stmgcn_tpu_torch.data.splits import MODES
from stmgcn_tpu_torch.ops.layers import resolve_device
from stmgcn_tpu_torch.ops.spmm import place_supports
from stmgcn_tpu_torch.train.metrics import regression_report
from stmgcn_tpu_torch.train.step import (
    LOSSES,
    eval_step,
    gather_window_batch,
    make_optimizer,
    train_step,
)

__all__ = ["Trainer"]


class Trainer:
    """Trains an :class:`~stmgcn_tpu_torch.models.STMGCN` over a
    :class:`~stmgcn_tpu_torch.data.DemandDataset`.

    ``supports`` is the model's support form — the dense ``(M, K, N, N)``
    stack, a ``TiledSupports`` plan or the M per-branch block-sparse
    groups — placed on the device once, here; ``initial_state`` a
    ``state_dict`` to start from (e.g. the JAX trainer's converted initial
    parameters, ``from_jax_params``). ``device=None`` means the GPU, and
    raises without one. Other arguments as the JAX ``Trainer``'s.
    """

    def __init__(self, model, dataset, supports, *, lr: float = 2e-3,
                 weight_decay: float = 1e-4, lr_schedule: str = "none",
                 warmup_epochs: float = 0.0, min_lr_fraction: float = 0.0,
                 grad_clip_norm: Optional[float] = None, loss: str = "mse",
                 n_epochs: int = 100, batch_size: int = 32, patience: int = 10,
                 shuffle: bool = False, seed: int = 0, steps_per_superstep: int = 1,
                 initial_state: Optional[dict] = None, device=None,
                 verbose: bool = True):
        if loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
        if steps_per_superstep < 1:
            raise ValueError(f"steps_per_superstep must be >= 1, got {steps_per_superstep}")
        if getattr(dataset, "heterogeneous", False) or not dataset.shared_graphs:
            raise ValueError("per-city graphs and heterogeneous cities are not ported yet")
        for mode in ("train", "validate"):
            if dataset.mode_size(mode) == 0:
                raise ValueError(
                    f"the {mode!r} split is empty — adjust split fractions/dates "
                    "or provide more data"
                )
        self.device = resolve_device(device)
        self.dataset = dataset
        self.loss = loss
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.patience = patience
        self.shuffle = shuffle
        self.seed = seed
        self.steps_per_superstep = steps_per_superstep
        self.verbose = verbose
        self.model = model.to(self.device)
        if initial_state is not None:
            self.model.load_state_dict(initial_state)

        dev = self.device
        self.supports = place_supports(supports, dev)
        self.model.check_supports(self.supports)
        # the resident data, uploaded once: one series serves every mode
        self.series = torch.as_tensor(np.asarray(dataset.series_stack(), np.float32), device=dev)
        self.offsets = torch.as_tensor(np.asarray(dataset.window.offsets, np.int32), device=dev)
        self.targets = {
            mode: torch.as_tensor(dataset.mode_targets(mode), device=dev) for mode in MODES
        }
        self.horizon = dataset.window.horizon

        # schedule extents are optimizer steps (pad_last: one per batch)
        spe = self.train_steps_per_epoch
        self.optimizer = make_optimizer(
            self.model.parameters(), lr, weight_decay, schedule=lr_schedule,
            warmup_steps=int(warmup_epochs * spe), decay_steps=n_epochs * spe,
            min_lr_fraction=min_lr_fraction, grad_clip_norm=grad_clip_norm,
        )
        self.epoch = 0
        self.global_step = 0
        self.best_val = float("inf")
        self.patience_left = patience
        #: the best-on-validation parameters (an in-memory copy)
        self.best_state: Optional[dict] = None

    @property
    def train_steps_per_epoch(self) -> int:
        return -(-self.dataset.mode_size("train") // self.batch_size)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def batches(self, mode: str, *, shuffle: bool = False):
        """The mode's index-only batches, padded to ``batch_size``, in the
        JAX trainer's order for this epoch."""
        return self.dataset.batches(
            mode, self.batch_size, shuffle=shuffle, seed=self.seed, epoch=self.epoch,
            pad_last=True, with_arrays=False,
        )

    def place(self, batch, mode: str):
        """``(x, y, mask)`` on the device: the window gather from the
        resident series, and the ``(B,)`` mask of real samples."""
        idx = torch.as_tensor(np.asarray(batch.indices, np.int64), device=self.device)
        x, y = gather_window_batch(self.series, self.targets[mode], self.offsets, idx,
                                   self.horizon)
        mask = (np.arange(len(batch)) < batch.n_real).astype(np.float32)
        return x, y, torch.as_tensor(mask, device=self.device)

    def train_batch(self, batch, mode: str = "train") -> torch.Tensor:
        """One optimizer step on ``batch``; returns its loss on the device."""
        x, y, mask = self.place(batch, mode)
        loss = train_step(self.model, self.optimizer, self.supports, x, y, mask, self.loss)
        self.global_step += 1
        return loss

    def _run_train_epoch(self) -> float:
        batches = list(self.batches("train", shuffle=self.shuffle))
        S = self.steps_per_superstep
        losses, counts = [], []
        for start in range(0, len(batches), S):
            block = batches[start:start + S]
            block_losses = [self.train_batch(b) for b in block]
            losses += torch.stack(block_losses).tolist()  # one readback per block
            counts += [b.n_real for b in block]
        return self._weighted(losses, counts)

    def _run_eval_epoch(self, mode: str) -> float:
        losses, counts = [], []
        for batch in self.batches(mode):
            x, y, mask = self.place(batch, mode)
            losses.append(eval_step(self.model, self.supports, x, y, mask, self.loss)[0])
            counts.append(batch.n_real)
        return self._weighted(torch.stack(losses).tolist(), counts)

    @staticmethod
    def _weighted(losses, counts) -> float:
        """Sample-weighted mean, a float32 dot as in the JAX trainer."""
        if not counts:
            raise ValueError("no samples in the mode")
        weights = torch.tensor(counts, dtype=torch.float32)
        return float(torch.tensor(losses, dtype=torch.float32) @ weights) / float(weights.sum())

    def train(self) -> dict:
        """Run the epoch loop; returns ``{"train": [...], "validate": [...]}``."""
        history = {"train": [], "validate": []}
        self._log(f"Training starts at: {time.ctime()}")
        for epoch in range(self.epoch + 1, self.n_epochs + 1):
            self.epoch = epoch
            t0 = time.time()
            train_loss = self._run_train_epoch()
            val_loss = self._run_eval_epoch("validate")
            history["train"].append(train_loss)
            history["validate"].append(val_loss)
            if val_loss <= self.best_val:  # <= : reference Model_Trainer.py:48
                self._log(f"Epoch {epoch}, val_loss drops from {self.best_val:.5} to "
                          f"{val_loss:.5}. Keeping the best parameters..")
                self.best_val = val_loss
                self.patience_left = self.patience
                self.best_state = {k: v.detach().clone()
                                   for k, v in self.model.state_dict().items()}
            else:
                self.patience_left -= 1
                self._log(f"Epoch {epoch}, val_loss {val_loss:.5} does not improve from "
                          f"{self.best_val:.5} (patience {self.patience_left})")
            self._log(f"Epoch {epoch}: train_loss {train_loss:.6g}, val_loss "
                      f"{val_loss:.6g}, {time.time() - t0:.3f} s")
            if self.patience_left == 0:
                self._log(f"Early stopping at epoch {epoch}..")
                break
        self._log(f"Training ends at: {time.ctime()}")
        return history

    @torch.no_grad()
    def _predict_mode(self, mode: str, state: Optional[dict] = None):
        """Normalized ``(pred, true)`` over a mode's real samples, with
        ``state`` (a ``state_dict``) or the live parameters."""
        preds, trues = [], []
        for batch in self.batches(mode):
            x, y, _ = self.place(batch, mode)
            if state is None:
                pred = self.model(self.supports, x)
            else:
                pred = torch.func.functional_call(self.model, state, (self.supports, x))
            preds.append(pred[: batch.n_real].cpu().numpy())
            trues.append(y[: batch.n_real].cpu().numpy())
        return np.concatenate(preds), np.concatenate(trues)

    def test(self, modes=("train", "test"), checkpoint: Optional[str] = "best") -> dict:
        """Denormalized metrics per mode (``Model_Trainer.py:68-98``, train
        split re-scored too). ``checkpoint="best"`` evaluates the in-memory
        best parameters, ``None`` the live ones; checkpoint files are not
        ported."""
        if checkpoint == "best":
            if self.best_state is None:
                raise ValueError("no best parameters yet: train() first, or pass "
                                 "checkpoint=None for the live ones")
            state = self.best_state
        elif checkpoint is None:
            state = None
        else:
            raise ValueError(f"checkpoint={checkpoint!r}: checkpoint files are not ported "
                             "yet; use 'best' (in memory) or None")
        self._log(f"Testing starts at: {time.ctime()}")
        results = {}
        for mode in modes:
            pred, true = self._predict_mode(mode, state)
            results[mode] = report = regression_report(
                self.dataset.denormalize(pred), self.dataset.denormalize(true))
            self._log(f"{mode} true MSE: {report['mse']:.6g}  RMSE: {report['rmse']:.6g}  "
                      f"MAE: {report['mae']:.6g}  MAPE: {report['mape'] * 100:.4g}%  "
                      f"PCC: {report['pcc']:.4g}")
        self._log(f"Testing ends at: {time.ctime()}")
        return results
