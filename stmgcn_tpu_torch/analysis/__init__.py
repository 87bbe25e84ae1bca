"""The port's lint: the whole-program AST and concurrency passes, the
config contracts, the mesh contracts and the CUDA kernels' launch budgets.

The counterparts of the JAX package's lint (``stmgcn_tpu/analysis``),
each returning :class:`Finding` s. Over the package's source
(:func:`lint_package`): the program database (:mod:`.program_db`), the
AST rules ``host-sync-in-jit``, ``traced-control-flow``,
``unfenced-timing`` and ``partition-axis-name`` over the functions a CUDA
graph captures (:mod:`.lint`), and the concurrency rules
``unguarded-attr``, ``lock-order-cycle``, ``condvar-discipline`` and
``thread-lifecycle`` (:mod:`.concurrency_check`). Over the port's presets
or given ``(name, ExperimentConfig)`` pairs (:func:`run_passes`):

- ``collective-shape`` (:mod:`.collective_check`);
- ``spmd-shard-footprint`` and the declared manifests' coverage
  (``spmd-collective-manifest``) (:mod:`.spmd_check`, whose executed half,
  :func:`manifest_findings` and :func:`wire_findings`, reads one executed
  step's counted collectives);
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
in neither JAX nor the port's model stack. The JAX package's jaxpr, HLO
and dtype-flow passes have no counterpart (the port traces no programs;
:mod:`.lint` lists the rules left out, with the reason for each).
"""

from stmgcn_tpu_torch.analysis.collective_check import (
    branch_bandwidth_floor,
    check_collective_contracts,
    expected_branch_nnz,
    grid_bandwidth_estimate,
)
from stmgcn_tpu_torch.analysis.concurrency_check import check_concurrency
from stmgcn_tpu_torch.analysis.fleet_check import check_fleet_shape_classes, estimate_fleet_plan
from stmgcn_tpu_torch.analysis.kernel_check import check_kernel_budgets, config_launches
from stmgcn_tpu_torch.analysis.lint import lint_package, lint_paths, lint_source
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
from stmgcn_tpu_torch.analysis.spmd_check import (
    check_manifest_coverage,
    check_shard_footprints,
    check_spmd_contracts,
    estimate_shard_footprint,
    manifest_findings,
    wire_findings,
)
from stmgcn_tpu_torch.analysis.tiling_check import check_tile_plan, tile_plan_violations

__all__ = [
    "Finding",
    "REPORT_VERSION",
    "RULES",
    "Rule",
    "branch_bandwidth_floor",
    "check_collective_contracts",
    "check_concurrency",
    "check_continual_config",
    "check_federation_config",
    "check_fleet_shape_classes",
    "check_health_overhead",
    "check_kernel_budgets",
    "check_manifest_coverage",
    "check_obs_overhead",
    "check_precision_policy",
    "check_resident_memory",
    "check_serving_buckets",
    "check_serving_slo",
    "check_shard_footprints",
    "check_spmd_contracts",
    "check_tile_plan",
    "config_launches",
    "estimate_fleet_plan",
    "estimate_resident_bytes",
    "estimate_shard_footprint",
    "expected_branch_nnz",
    "grid_bandwidth_estimate",
    "lint_package",
    "lint_paths",
    "lint_source",
    "manifest_findings",
    "render_json",
    "render_sarif",
    "render_text",
    "run_passes",
    "tile_plan_violations",
    "wire_findings",
]

#: every config pass of the lint, in report order
PASSES = (
    check_collective_contracts,
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
    check_spmd_contracts,
)


def run_passes(configs=None) -> list:
    """Every config pass's findings over ``configs`` (``(name,
    ExperimentConfig)`` pairs; default: every preset)."""
    configs = list(configs) if configs is not None else None
    return [f for check in PASSES for f in check(configs)]
