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

__all__ = ["check_precision_policy", "precision_summary"]


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


def precision_summary(configs: Optional[Iterable[Tuple[str, object]]] = None) -> dict:
    """The lint gate's ``precision`` section (the JAX ``precision_summary``'s
    keys): ``programs``, the configs (default: every preset) with a
    precision policy; ``bf16_programs``, those that compute in bfloat16
    (``model.dtype``) under a policy that admits it at matmul operands
    (``dot_general``), so that a port without a bf16 config counts 0;
    ``sites``, the policy fields checked (each role's
    dtypes, each float32 reduction role, the master dtype, each
    whitelisted cast); ``findings``, :func:`check_precision_policy`'s. The
    JAX section counts traced programs and their dtype sites, which the
    port has not."""
    configs = list(preset_configs() if configs is None else configs)
    ruled = [cfg for _, cfg in configs if getattr(cfg, "precision", None)]
    policies = [cfg.precision for cfg in ruled]
    return {
        "programs": len(policies),
        "bf16_programs": sum(cfg.model.dtype == "bfloat16"
                             and "bfloat16" in (cfg.precision.allowed("dot_general") or ())
                             for cfg in ruled),
        "sites": sum(len(p.role_dtypes) + len(p.reduction_f32_roles) + 1 + len(p.cast_whitelist)
                     for p in policies),
        "findings": len(check_precision_policy(configs)),
    }
