"""``precision-policy``, the policy half: each preset's
:class:`~stmgcn_tpu_torch.config.PrecisionPolicy` against its own
``violations()`` (``stmgcn_tpu/analysis/precision_check.py``
``check_precision``'s first step). The dtype-flow half, which walks the
JAX package's traced step programs, has no counterpart in the port.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = ["check_precision_policy"]


def check_precision_policy(configs: Optional[Iterable[Tuple[str, object]]] = None
                           ) -> List[Finding]:
    """Every config's precision policy (default: every preset)."""
    findings = []
    for name, cfg in configs if configs is not None else preset_configs():
        policy = getattr(cfg, "precision", None)
        if policy is None:
            continue
        findings += [finding("precision-policy", "precision", name,
                             f"{name}: PrecisionPolicy: {v}") for v in policy.violations()]
    return findings
