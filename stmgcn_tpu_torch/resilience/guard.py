"""Copy of ``stmgcn_tpu/resilience/guard.py``.

Divergence guard: non-finite-loss detection with bounded patience.

A single poisoned or pathological batch can NaN the Adam moments and
silently destroy a run hours in — every later step multiplies NaN into
the params, and the failure surfaces (if at all) as a flat loss curve.
The guard is the cheap runtime tripwire: the trainer checks each step's
(host-fetched) loss for finiteness, and on a trip rolls ``params`` /
``opt_state`` back to an in-memory last-good snapshot taken just before
the step, then skips or defers the offending batch. This class holds the
policy and trip accounting; the rollback mechanics (snapshots under
buffer donation, superstep block re-runs) live in the trainer.

Off by default: detection costs a device sync per step on the per-step
path (one per S-step block on the superstep path), and the production
loop keeps losses on device until the epoch ends.
"""

from __future__ import annotations

from typing import Optional

from stmgcn_tpu_torch.obs.registry import REGISTRY

__all__ = ["DivergenceError", "DivergenceGuard"]

ACTIONS = ("skip", "defer")


class DivergenceError(RuntimeError):
    """Too many consecutive non-finite steps — the divergence is not a
    single bad batch, and skipping forward would train on garbage."""


class DivergenceGuard:
    """Policy + accounting for non-finite-loss trips.

    - ``action`` — what happens to the offending batch after rollback:
      ``"skip"`` drops it from the epoch (its loss never enters the epoch
      mean, exactly as if the batch were never drawn); ``"defer"``
      re-queues it once at the end of the epoch (re-ordering instead of
      losing data; a second trip then skips it).
    - ``patience`` — abort after this many *consecutive* trips by raising
      :class:`DivergenceError`: persistent non-finiteness means the
      params/data are bad, not one batch.
    - ``lr_cut`` — optional factor in (0, 1); each trip multiplies the
      learning rate by it (the trainer rebuilds its optimizer at the new
      scale, keeping the optimizer state).
    """

    def __init__(
        self,
        action: str = "skip",
        patience: int = 3,
        lr_cut: Optional[float] = None,
    ):
        if action not in ACTIONS:
            raise ValueError(f"divergence action must be one of {ACTIONS}, got {action!r}")
        if patience < 1:
            raise ValueError(f"divergence patience must be >= 1, got {patience}")
        if lr_cut is not None and not 0.0 < lr_cut < 1.0:
            raise ValueError(f"divergence lr_cut must be in (0, 1), got {lr_cut}")
        self.action = action
        self.patience = patience
        self.lr_cut = lr_cut
        self.consecutive = 0
        self.total = 0

    def trip(self, loss: float, epoch: int, step: int) -> None:
        """Record a non-finite step; raise after ``patience`` consecutive.

        Called *after* the trainer has rolled back to the last-good
        snapshot, so even the aborting raise leaves finite live state
        behind (and a final checkpoint write stays loadable).
        """
        self.consecutive += 1
        self.total += 1
        REGISTRY.counter("train.divergence_trips").inc()
        if self.consecutive >= self.patience:
            raise DivergenceError(
                f"{self.consecutive} consecutive non-finite losses "
                f"(last {loss!r} at epoch {epoch}, step {step}) — params "
                "were rolled back to the last finite snapshot, but this is "
                "not a single bad batch. Re-run with --checkify nan to "
                "locate the op producing the first NaN, or lower the "
                "learning rate (--divergence-lr-cut cuts it automatically)."
            )

    def ok(self) -> None:
        """A finite step landed — reset the consecutive-trip counter."""
        self.consecutive = 0
