"""``obs-overhead``, ``health-overhead``, ``continual-config`` and
``federation-config``: each config section's own ``violations()``, per
preset (the JAX ``obs_check``, ``health_check``, ``continual_check`` and
``federation_check``). The continual loop's are evaluated with the row
bytes of the preset's grid (one float32 channel), the trainer's resident
budget and the sibling ``health``/``data`` sections; the federation's with
the ``serving`` section and the city count.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs, resident_budget
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = [
    "check_continual_config",
    "check_federation_config",
    "check_health_overhead",
    "check_obs_overhead",
]

#: demand channels and storage dtype (one float32 channel, as the
#: synthetic data and the pipeline store it)
_CHANNELS, _ITEMSIZE = 1, 4


def _check(configs, rule: str, kind: str, section: str, violations) -> List[Finding]:
    findings = []
    for name, cfg in configs if configs is not None else preset_configs():
        sec = getattr(cfg, section, None)
        if sec is None:
            continue
        findings += [finding(rule, kind, name, f"{name}: {v}") for v in violations(cfg, sec)]
    return findings


def check_obs_overhead(configs: Optional[Iterable[Tuple[str, object]]] = None
                       ) -> List[Finding]:
    """Every config's tracing knobs against the documented budgets."""
    return _check(configs, "obs-overhead", "obs", "obs", lambda cfg, obs: obs.violations())


def check_health_overhead(configs: Optional[Iterable[Tuple[str, object]]] = None
                          ) -> List[Finding]:
    """Every config's numeric-health knobs."""
    return _check(configs, "health-overhead", "health", "health",
                  lambda cfg, health: health.violations())


def check_continual_config(configs: Optional[Iterable[Tuple[str, object]]] = None,
                           budget_bytes: Optional[int] = None) -> List[Finding]:
    """Every config's continual-loop knobs (``budget_bytes`` default: the
    trainer's ``RESIDENT_CAP_BYTES``)."""
    if budget_bytes is None:
        budget_bytes = resident_budget()

    def violations(cfg, cont):
        data = getattr(cfg, "data", None)
        row_bytes = None
        if data is not None:
            cols = data.cols if data.cols is not None else data.rows
            row_bytes = data.rows * cols * _CHANNELS * _ITEMSIZE
        return cont.violations(row_bytes=row_bytes, budget_bytes=budget_bytes,
                               health=getattr(cfg, "health", None), data=data)

    return _check(configs, "continual-config", "continual", "continual", violations)


def check_federation_config(configs: Optional[Iterable[Tuple[str, object]]] = None
                            ) -> List[Finding]:
    """Every config's federation topology knobs."""
    def violations(cfg, fed):
        data = getattr(cfg, "data", None)
        return fed.violations(serving=getattr(cfg, "serving", None),
                              n_cities=None if data is None else getattr(data, "n_cities", None))

    return _check(configs, "federation-config", "federation", "federation", violations)
