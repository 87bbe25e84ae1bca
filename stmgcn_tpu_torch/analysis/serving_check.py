"""``serving-bucket-shape`` and ``serving-slo``: the serving ladder and
the SLO knobs from config alone (``stmgcn_tpu/analysis/serving_check.py``).

The engine builds one program per ``ServingConfig.buckets`` rung and pads
every batch up to its covering rung; with the SLO knobs set it puts an
admission controller in front of the queue. A bad ladder or a
self-contradictory SLO fails only when the engine is built, on the serving
host; these passes evaluate the same ``ServingConfig`` methods the engine
enforces (``ladder_violations``, ``slo_violations``) at lint time.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = ["check_serving_buckets", "check_serving_slo"]


def _check(configs, rule: str, method: str) -> List[Finding]:
    findings = []
    for name, cfg in configs if configs is not None else preset_configs():
        serving = getattr(cfg, "serving", None)
        if serving is None:
            continue
        findings += [finding(rule, "serving", name, f"{name}: {message}")
                     for message in getattr(serving, method)()]
    return findings


def check_serving_buckets(configs: Optional[Iterable[Tuple[str, object]]] = None
                          ) -> List[Finding]:
    """Every config's bucket ladder (default: every preset)."""
    return _check(configs, "serving-bucket-shape", "ladder_violations")


def check_serving_slo(configs: Optional[Iterable[Tuple[str, object]]] = None
                      ) -> List[Finding]:
    """Every config's SLO and admission knobs (default: every preset)."""
    return _check(configs, "serving-slo", "slo_violations")
