"""The port's lint: config contracts and the CUDA kernels' launch budgets.

The counterparts of the JAX package's pure-config lint passes
(``stmgcn_tpu/analysis``), each evaluated over the port's presets or over
given ``(name, ExperimentConfig)`` pairs, returning :class:`Finding` s:

- ``serving-bucket-shape``, ``serving-slo`` (:mod:`.serving_check`);
- ``resident-memory`` (:mod:`.resident_check`), ``fleet-shape-class``
  (:mod:`.fleet_check`), ``tile-plan`` (:mod:`.tiling_check`);
- ``obs-overhead``, ``health-overhead``, ``continual-config``,
  ``federation-config`` (:mod:`.section_check`);
- ``precision-policy``, the policy half (:mod:`.precision_check`);
- ``kernel-smem`` and ``kernel-shape`` (:mod:`.kernel_check`), the Hopper
  counterpart of the Pallas kernels' VMEM model.

``python -m stmgcn_tpu_torch.cli lint`` runs them all (:mod:`.cli`). Each
pass imports what it reads when it runs, so importing this package pulls
in neither JAX nor the port's model stack. The JAX package's AST,
concurrency, jaxpr, HLO, dtype-flow and SPMD passes have no counterpart
here (``ROADMAP.md``).
"""

from stmgcn_tpu_torch.analysis.fleet_check import check_fleet_shape_classes, estimate_fleet_plan
from stmgcn_tpu_torch.analysis.kernel_check import check_kernel_budgets, config_launches
from stmgcn_tpu_torch.analysis.precision_check import check_precision_policy
from stmgcn_tpu_torch.analysis.report import (
    REPORT_VERSION,
    Finding,
    render_json,
    render_sarif,
    render_text,
)
from stmgcn_tpu_torch.analysis.resident_check import (
    check_resident_memory,
    estimate_resident_bytes,
)
from stmgcn_tpu_torch.analysis.rules import RULES, Rule
from stmgcn_tpu_torch.analysis.section_check import (
    check_continual_config,
    check_federation_config,
    check_health_overhead,
    check_obs_overhead,
)
from stmgcn_tpu_torch.analysis.serving_check import check_serving_buckets, check_serving_slo
from stmgcn_tpu_torch.analysis.tiling_check import check_tile_plan, tile_plan_violations

__all__ = [
    "Finding",
    "REPORT_VERSION",
    "RULES",
    "Rule",
    "check_continual_config",
    "check_federation_config",
    "check_fleet_shape_classes",
    "check_health_overhead",
    "check_kernel_budgets",
    "check_obs_overhead",
    "check_precision_policy",
    "check_resident_memory",
    "check_serving_buckets",
    "check_serving_slo",
    "check_tile_plan",
    "config_launches",
    "estimate_fleet_plan",
    "estimate_resident_bytes",
    "render_json",
    "render_sarif",
    "render_text",
    "run_passes",
    "tile_plan_violations",
]

#: every pass of the lint, in report order
PASSES = (
    check_resident_memory,
    check_fleet_shape_classes,
    check_serving_buckets,
    check_serving_slo,
    check_obs_overhead,
    check_health_overhead,
    check_continual_config,
    check_federation_config,
    check_tile_plan,
    check_precision_policy,
    check_kernel_budgets,
)


def run_passes(configs=None) -> list:
    """Every pass's findings over ``configs`` (``(name, ExperimentConfig)``
    pairs; default: every preset)."""
    configs = list(configs) if configs is not None else None
    return [f for check in PASSES for f in check(configs)]
