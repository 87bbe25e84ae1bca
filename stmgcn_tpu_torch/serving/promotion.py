"""Guarded checkpoint promotion: the serving end of the continual loop.

Counterpart of ``stmgcn_tpu/serving/promotion.py``. :class:`PromotionGate`
is the one door between the fine-tune daemon and the serving path: a
candidate checkpoint reaches ``swap_params`` only after passing, in order,

1. **integrity** — the file CRC- and structure-verifies;
2. **nonfinite** — zero non-finite gradient or loss observations in the
   fine-tune's health summary;
3. **grad-norm band** — the fine-tune's peak gradient norm within bound;
4. **update-ratio band** — the peak ‖Δparam‖/‖param‖ within bound;
5. **held-out eval** — the candidate's loss on the freshest held-out
   targets no worse than the live generation's by more than the relative
   margin (the candidate loaded through the engine's
   ``params_from_checkpoint``).

A rejected candidate is quarantined in place as
``<name>.rejected-<reason>`` with a typed :class:`GateDecision`, and the
engine keeps serving its generation. An accepted one is rotated into the
watch directory (``latest.ckpt``, the previous one kept as
``latest.prev.ckpt``) and applied through the engine's
``CheckpointWatcher.poll()`` → ``swap_params(..., health_baseline=...)``,
the production hot-swap path (on the card a swap captures the new
generation's programs before publishing them).

The engine's :class:`~stmgcn_tpu_torch.resilience.ServeFaultPlan` gets its
``promotion-raise`` shot at the top of each evaluation; an injected gate
crash quarantines the candidate as ``"gate-error"``. Each evaluation is a
``promotion.gate`` span while tracing, and counts in
``continual.promotions`` or ``continual.rejections{reason}``.

:class:`TierPromotionGate` lifts the door to a federation of replicas: it
evaluates once and quarantines once, and an acceptance is one rotation
followed by a cutover poll of every live replica's watcher; a replica whose
poll fails is detached from the ring rather than left on the old
generation.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

from stmgcn_tpu_torch.obs import trace as obs_trace
from stmgcn_tpu_torch.obs.registry import REGISTRY

__all__ = ["GateDecision", "PromotionGate", "TierPromotionGate"]


def _host_copy(params) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class GateDecision:
    """Outcome of one gate evaluation. ``reason`` is ``"promoted"`` on
    acceptance, else the typed rejection: ``"corrupt"``, ``"nonfinite"``,
    ``"grad-norm"``, ``"update-ratio"``, ``"eval-regression"``,
    ``"swap-failed"`` or ``"gate-error"``. ``path`` is where the candidate
    ended up: the live ``latest.ckpt`` or its quarantine name."""

    accepted: bool
    reason: str
    ordinal: int
    path: str
    generation: int
    checks: dict


class PromotionGate:
    """Evaluate candidate checkpoints and promote survivors atomically.

    ``holdout_eval`` is ``evaluate(state_dict) -> float`` (see
    :func:`~stmgcn_tpu_torch.train.continual.make_holdout_eval`); with it,
    ``live_params`` is the serving ``state_dict``, the baseline a candidate
    must not fall behind. Without either the eval check is skipped.
    """

    def __init__(self, engine, out_dir: str, *, grad_norm_max: float = 1e3,
                 update_ratio_max: float = 0.5, eval_margin: float = 0.05,
                 holdout_eval: Optional[Callable] = None, live_params=None, log=None,
                 registry=None):
        self._engine = engine
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.grad_norm_max = float(grad_norm_max)
        self.update_ratio_max = float(update_ratio_max)
        self.eval_margin = float(eval_margin)
        self.holdout_eval = holdout_eval
        self._live_params = None if live_params is None else _host_copy(live_params)
        self._log = log if log is not None else (lambda msg: None)
        self._reg = REGISTRY if registry is None else registry
        # promotion rides the production hot-swap path: a passive watcher
        # the gate polls after rotating a survivor in
        self.watcher = engine.watch_checkpoints(out_dir)
        self.ordinal = 0
        self.promotions = 0
        self.rejections = 0
        self.decisions: list[GateDecision] = []

    @classmethod
    def from_config(cls, engine, out_dir: str, config, **kwargs) -> "PromotionGate":
        """Build with the bands of a :class:`~stmgcn_tpu_torch.config.ContinualConfig`."""
        return cls(engine, out_dir, grad_norm_max=config.promote_grad_norm_max,
                   update_ratio_max=config.promote_update_ratio_max,
                   eval_margin=config.promote_eval_margin, **kwargs)

    def consider(self, candidate_path: str, health: dict) -> GateDecision:
        """Run the whole gate on one candidate; promote or quarantine.
        ``health`` is the fine-tune's summary (``nonfinite``,
        ``grad_norm_max``, ``update_ratio_max``). Never raises on a bad
        candidate: every failure is a typed rejection and the engine keeps
        its generation."""
        from stmgcn_tpu_torch.resilience.faults import InjectedFault

        t0 = time.perf_counter()
        ordinal = self.ordinal
        self.ordinal += 1
        checks: dict = {}
        try:
            reason = self._evaluate(candidate_path, health, ordinal, checks)
        except InjectedFault as e:
            reason = "gate-error"
            checks["error"] = str(e)
        if reason is None:
            decision = self._promote(candidate_path, ordinal, checks)
        else:
            decision = self._reject(candidate_path, ordinal, reason, checks)
        t1 = time.perf_counter()
        self._reg.histogram("promotion.gate_ms").add((t1 - t0) * 1e3)
        trc = obs_trace.active_tracer()
        if trc is not None:
            trc.record_span("promotion.gate", t0, t1, {
                "ordinal": ordinal, "accepted": decision.accepted, "reason": decision.reason})
        self.decisions.append(decision)
        return decision

    def _evaluate(self, path: str, health: dict, ordinal: int, checks: dict) -> Optional[str]:
        """The check chain; returns the rejection reason or None."""
        from stmgcn_tpu_torch.train.checkpoint import verify_checkpoint

        plan = getattr(self._engine, "_fault_plan", None)
        if plan is not None:
            plan.before_promotion(ordinal)
        try:
            verify_checkpoint(path)
        except (ValueError, OSError) as e:
            checks["corrupt"] = str(e)
            return "corrupt"
        nonfinite = int(health.get("nonfinite", 0))
        checks["nonfinite"] = nonfinite
        if nonfinite:
            return "nonfinite"
        grad_norm = float(health.get("grad_norm_max", 0.0))
        checks["grad_norm"] = (grad_norm, self.grad_norm_max)
        # NaN-safe: "within band" must hold, not "not above band"
        if not grad_norm <= self.grad_norm_max:
            return "grad-norm"
        ratio = float(health.get("update_ratio_max", 0.0))
        checks["update_ratio"] = (ratio, self.update_ratio_max)
        if not ratio <= self.update_ratio_max:
            return "update-ratio"
        if self.holdout_eval is not None and self._live_params is not None:
            params = self._engine.params_from_checkpoint(path)
            cand = float(self.holdout_eval(params))
            live = float(self.holdout_eval(self._live_params))
            bound = live * (1.0 + self.eval_margin)
            checks["eval"] = (cand, live, bound)
            if not cand <= bound:
                return "eval-regression"
            checks["_params"] = params  # the live baseline once promoted
        return None

    def _rotate(self, path: str) -> str:
        """Move ``path`` to ``latest.ckpt``, the previous one aside."""
        latest = os.path.join(self.out_dir, "latest.ckpt")
        try:
            os.replace(latest, os.path.join(self.out_dir, "latest.prev.ckpt"))
        except OSError:  # first promotion: nothing to rotate
            pass
        os.replace(path, latest)
        return latest

    def _promote(self, path: str, ordinal: int, checks: dict) -> GateDecision:
        latest = self._rotate(path)
        params = checks.pop("_params", None)
        if not self.watcher.poll():
            # the rotated-in file did not swap: the engine is untouched
            self._count_reject("swap-failed")
            self._log(f"promotion {ordinal}: rotated {latest} but the watcher applied no swap")
            return GateDecision(False, "swap-failed", ordinal, latest,
                                self._engine.generation, checks)
        if params is not None:
            self._live_params = params
        self.promotions += 1
        self._reg.counter("continual.promotions").inc()
        self._log(f"promotion {ordinal}: {latest} -> generation {self._engine.generation}")
        return GateDecision(True, "promoted", ordinal, latest, self._engine.generation, checks)

    def _reject(self, path: str, ordinal: int, reason: str, checks: dict) -> GateDecision:
        checks.pop("_params", None)
        quarantined = f"{path}.rejected-{reason}"
        try:
            os.replace(path, quarantined)
        except OSError:
            quarantined = path  # nothing to move (already gone or torn)
        self._count_reject(reason)
        self._log(f"promotion {ordinal}: rejected ({reason}) — quarantined as {quarantined}")
        return GateDecision(False, reason, ordinal, quarantined, self._engine.generation,
                            checks)

    def _count_reject(self, reason: str) -> None:
        self.rejections += 1
        self._reg.counter("continual.rejections", {"reason": reason}).inc()


class TierPromotionGate(PromotionGate):
    """One promotion door for a whole replica tier, over a
    :class:`~stmgcn_tpu_torch.serving.federation.FederationRouter`: every
    replica (active and warm spare: a spare promoted later must not serve
    an old generation) watches the same ``out_dir``, and the base gate's
    checks run once, against one primary replica. On top of that:

    - **evaluate once** and **quarantine once**: a rejected candidate is
      renamed away before any watcher could see it;
    - **generation-consistent cutover**: an acceptance rotates
      ``latest.ckpt`` once, then polls every live replica's watcher; a
      replica whose poll fails is detached from the ring
      (:meth:`FederationRouter.detach`).

    A :class:`~stmgcn_tpu_torch.resilience.FederationFaultPlan` attached to
    the router gets its ``poisoned-candidate`` shot (a byte flip at rest)
    before evaluation, so the drill runs the integrity check.
    """

    def __init__(self, router, out_dir: str, **kwargs):
        engines = router.engines()
        if not engines:
            raise ValueError("TierPromotionGate needs at least one live replica")
        self.router = router
        self._primary_rid = next(iter(engines))
        super().__init__(engines[self._primary_rid], out_dir, **kwargs)
        self.watchers = {self._primary_rid: self.watcher}
        for rid, eng in engines.items():
            if rid != self._primary_rid:
                self.watchers[rid] = eng.watch_checkpoints(out_dir)
        self.detached: list[int] = []

    @classmethod
    def from_config(cls, router, out_dir: str, config, **kwargs) -> "TierPromotionGate":
        """Build with the bands of a :class:`~stmgcn_tpu_torch.config.ContinualConfig`."""
        return cls(router, out_dir, grad_norm_max=config.promote_grad_norm_max,
                   update_ratio_max=config.promote_update_ratio_max,
                   eval_margin=config.promote_eval_margin, **kwargs)

    def consider(self, candidate_path: str, health: dict) -> GateDecision:
        plan = getattr(self.router, "_fault_plan", None)
        if plan is not None:
            # at-rest poisoning lands before the integrity check
            plan.poison_candidate(candidate_path)
        return super().consider(candidate_path, health)

    def _promote(self, path: str, ordinal: int, checks: dict) -> GateDecision:
        latest = self._rotate(path)
        params = checks.pop("_params", None)
        live = self.router.engines()  # killed or detached replicas skip the cutover
        swapped, failed = [], []
        for rid in sorted(self.watchers):
            if rid not in live:
                continue
            (swapped if self.watchers[rid].poll() else failed).append(rid)
        if not swapped:
            self._count_reject("swap-failed")
            self._log(f"tier promotion {ordinal}: rotated {latest} but no replica applied a "
                      "swap")
            return GateDecision(False, "swap-failed", ordinal, latest,
                                self._engine.generation, checks)
        for rid in failed:
            moved = self.router.detach(rid)
            self.detached.append(rid)
            self._log(f"tier promotion {ordinal}: replica {rid} missed the cutover — "
                      f"detached from the ring ({moved} cities moved)")
        gens = {rid: live[rid].generation for rid in swapped}
        checks["tier"] = {"swapped": swapped, "failed": failed, "generations": gens}
        if params is not None:
            self._live_params = params
        self.promotions += 1
        self._reg.counter("continual.promotions").inc()
        generation = max(gens.values())
        self._log(f"tier promotion {ordinal}: {latest} -> generation {generation} on "
                  f"replicas {swapped}")
        return GateDecision(True, "promoted", ordinal, latest, generation, checks)
