"""The rule registry of the port's lint (``python -m stmgcn_tpu_torch.cli
lint``).

The config rules carry the JAX package's ids, severities and summaries
(``stmgcn_tpu/analysis/rules.py``); ``tile-plan``'s summary names the CUDA
kernels' tiles where the JAX one names the Pallas kernels' VMEM, and
``precision-policy`` covers only the policy's own contract (the JAX
dtype-flow pass has no counterpart). ``kernel-smem`` and ``kernel-shape``
are the port's own: the hand-written kernels' launch budgets on sm_90
(:mod:`~stmgcn_tpu_torch.analysis.kernel_check`). There is no JAX symbol
compatibility table: the port imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["RULES", "Rule"]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str  # "error" | "warning"
    summary: str
    #: long-form text for SARIF ``fullDescription``; empty falls back to
    #: ``summary``
    description: str = ""


_ALL_RULES = [
    # -- config passes (JAX ids, severities and summaries) ----------------
    Rule(
        "resident-memory",
        "error",
        "a preset requests resident data placement its device cannot hold "
        "(window-free series vs materialized windows vs the per-core "
        "budget, or resident on a multi-device mesh) — the run OOMs or is "
        "rejected at the first epoch",
    ),
    Rule(
        "fleet-shape-class",
        "error",
        "a preset's fleet shape-class plan is unviable (invalid planner "
        "knobs, fleet=True on a homogeneous dataset or streamed data, "
        "cities uncovered within the class/waste budget, or a class's "
        "resident footprint over the per-core budget) — the fleet fast path"
        " is rejected, OOMs, or silently degrades per city",
    ),
    Rule(
        "serving-bucket-shape",
        "error",
        "a preset's serving bucket ladder is unservable (not strictly "
        "increasing, tops out below max_batch, or a rung's worst-case pad "
        "waste exceeds max_pad_waste) — engine construction would reject it"
        " at deploy time",
    ),
    Rule(
        "serving-slo",
        "error",
        "a preset's SLO/admission knobs are self-contradictory (deadline_ms"
        " at or below the max_delay_ms coalescing floor sheds every "
        "coalesced request, queue_bound_rows below the top rung can never "
        "fill a saturated dispatch, degrade_rung outside the ladder has no "
        "compiled program) — a deploy-time outage detectable from config "
        "math",
    ),
    Rule(
        "obs-overhead",
        "error",
        "a preset enables tracing with an unbounded span ring or configures"
        " a histogram reservoir past the documented budget "
        "(config.OBS_RING_BUDGET / OBS_RESERVOIR_BUDGET) — observability "
        "itself becomes the memory leak / perf regression in a long-lived "
        "process",
    ),
    Rule(
        "health-overhead",
        "error",
        "a preset's numeric-health knobs are self-defeating (drift "
        "comparison without a training-time baseline, sketch/reservoir "
        "sizes outside the documented OBS_RESERVOIR_BUDGET, or a "
        "non-positive sampling cadence) — HealthConfig.violations() config "
        "math, detectable before any step runs",
    ),
    Rule(
        "continual-config",
        "error",
        "a preset's continual-loop knobs cannot run unattended (ring sized "
        "past the per-core resident budget or too small for one training "
        "window, retrain cadence the measured superstep time cannot sustain"
        " without starving serving, promotion-gate thresholds missing or "
        "unordered, or a drift-only trigger with no health baseline to fire"
        " against) — ContinualConfig.violations() config math, detectable "
        "before any step runs",
    ),
    Rule(
        "federation-config",
        "error",
        "a preset's serving-federation topology cannot hold its own "
        "contracts (more replicas than cities — engines permanently idle "
        "behind the hash ring, too few virtual nodes for the configured "
        "imbalance bound, a tier-wide overload budget below a single "
        "replica's local queue bound or top dispatch rung — the global "
        "limiter binds before any local SLO math applies, or a handover "
        "window that out-waits the drain window) — "
        "FederationConfig.violations() config math, detectable before any "
        "replica is built",
    ),
    Rule(
        "tile-plan",
        "error",
        "a preset's tiled-support plan cannot hold: "
        "tile_size/tile_waste_budget outside their ranges, tiled combined "
        "with sparse or a >1-device mesh, node padding on the tile grid "
        "already past the waste budget (build_supports guaranteed to "
        "raise), or a tile_size the CUDA block-CSR kernels do not take (64 "
        "or 128) — pure config math, detectable before any adjacency is "
        "built",
    ),
    Rule(
        "precision-policy",
        "error",
        "the preset's PrecisionPolicy is self-contradictory (a master dtype"
        " narrower than float32, an accumulation role allowed a sub-f32 "
        "dtype, unknown roles or dtypes, a whitelisted cast to itself or to"
        " float64) — PrecisionPolicy.violations() config math; the JAX "
        "dtype-flow half over traced programs has no counterpart here",
    ),
    # -- the CUDA kernels' launch budgets (kernel_check) -------------------
    Rule(
        "kernel-smem",
        "error",
        "a hand-written CUDA kernel's launch at a preset's shapes needs "
        "more dynamic shared memory (the Python mirror of its launch plan) "
        "than an sm_90 block may opt in to (227 KB), or more threads, "
        "registers or shared memory per SM than the card has — the launch "
        "fails with a CUDA error at the first step",
        description=(
            "For every launch a config's shapes give the LSTM forward "
            "(lstm_fwd_kernel), the backward sweep (lstm_bwd_sweep) and "
            "weight-gradient (lstm_bwd_wgrad) kernels and the block-CSR SpMM "
            "kernels (B3/B4/B5), the pass recomputes each kernel's dynamic "
            "shared memory and threads per block from a Python mirror of the "
            "plan arithmetic in stmgcn_tpu_torch/csrc (FwdPlan, BwdPlan, "
            "kWSmem, the SpMM Plan), and holds them to sm_90's limits: 227 KB "
            "of dynamic shared memory per block after opt-in, 1,024 threads per"
            " block, 255 registers per thread and 64 K registers per SM. "
            "chip_smoke.py holds the mirror against what the built kernels "
            "report on the card."
        ),
    ),
    Rule(
        "kernel-shape",
        "error",
        "a preset asks a hand-written CUDA kernel for a shape it does not "
        "take and the wrapper cannot pad or split: an LSTM hidden width "
        "above 256 (the widest kernel width) or a tiled plan whose "
        "tile_size is not 64 or 128 — the wrapper raises at the first "
        "forward",
    ),
]

RULES: Dict[str, Rule] = {r.id: r for r in _ALL_RULES}
