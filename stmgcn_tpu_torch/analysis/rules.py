"""The rule registry of the port's lint (``python -m stmgcn_tpu_torch.cli
lint``).

The config rules carry the JAX package's ids, severities and summaries
(``stmgcn_tpu/analysis/rules.py``); ``tile-plan``'s summary names the CUDA
kernels' tiles where the JAX one names the Pallas kernels' VMEM. The
contract pass's rules (``fp64-promotion``, ``primitive-budget``,
``precision-policy``, ``accum-dtype``, ``implicit-cast``) keep the JAX ids
and texts, worded for traced aten graphs where the JAX ones name jaxprs.
``kernel-smem`` and ``kernel-shape``
are the port's own: the hand-written kernels' launch budgets on sm_90
(:mod:`~stmgcn_tpu_torch.analysis.kernel_check`), and so is
``unparseable-module``. The mesh, AST and concurrency rules keep the JAX
ids and severities; the AST rules' texts name CUDA-graph capture where the
JAX ones name ``jit``, and ``spmd-collective-manifest``/``spmd-wire-budget``
read an executed step's counted collectives where the JAX ones read
compiled HLO. There is no JAX symbol compatibility table: the port imports
no JAX, and the JAX rules without a counterpart are listed in
:mod:`~stmgcn_tpu_torch.analysis.lint`.
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
    # -- the contract pass over the traced step programs (program_check,
    # dtype_flow, precision_check; JAX ids) --------------------------------
    Rule(
        "fp64-promotion",
        "error",
        "a traced step program contains a cast to float64 or a float64 "
        "value — a silent 2x memory/bandwidth promotion (the H100's float64 "
        "rate is a fraction of its float32 one, and no kernel here takes it)",
    ),
    Rule(
        "primitive-budget",
        "error",
        "a traced step program's node count exceeds the recorded budget of "
        "its route — a fusion or op-count regression (rebaseline "
        "deliberately if intended)",
    ),
    Rule(
        "precision-policy",
        "error",
        "a dtype site's compute dtype is outside its role's PrecisionPolicy "
        "allowance, the policy itself is self-contradictory, a registered "
        "contract program escaped the dtype-flow walk, or the measured "
        "dtype census drifted from PRECISION_BASELINES (rebaseline "
        "deliberately with the feature that moved it)",
        description=(
            "The dtype-flow pass walks the traced aten graph of every "
            "registered contract program, classifies each node into the "
            "precision role taxonomy (dot-general operand/accumulator, "
            "accumulating reduction, order statistic, normalization stat, "
            "cast, and each kernel operator's documented contract), and "
            "checks each site's dtype against the declarative "
            "PrecisionPolicy in config.py. This rule fires when a site's "
            "dtype falls outside its role's allowance, when "
            "PrecisionPolicy.violations() reports the policy "
            "self-contradictory (for every preset too), when a program in "
            "the contract registry was not walked (a coverage hole is a "
            "finding, not silence), when a master-state or loss leaf at a "
            "program's edge is off its declared dtype, or when the "
            "per-program dtype census (float dtype set, cast count) drifts "
            "from the PRECISION_BASELINES literal — a precision migration "
            "lands as a deliberate `lint --rebaseline`, never as silent "
            "drift. Each finding names the node, role, provenance chain, "
            "and the policy knob that bans it."
        ),
    ),
    Rule(
        "accum-dtype",
        "error",
        "a reduction accumulator — sum-family output or dot-general "
        "accumulator — has a floating dtype narrower than float32 (the "
        "classic bf16 accumulation hazard: low-order bits lost on every add)",
        description=(
            "Accumulation sites sum many addends, so precision loss "
            "compounds. For every role in PrecisionPolicy.reduction_f32_roles "
            "(by default reduce_sum, scan_carry, psum, dot_general_accum; the "
            "port's programs have no scan carry and, on one device, no psum) "
            "this rule fires on any floating dtype with itemsize < 4 bytes, "
            "naming the exact node, its source line, and the full dtype "
            "provenance chain back to the program input, constant, or cast "
            "site that introduced the narrow dtype. bf16 *compute* with f32 "
            "accumulation passes; bf16 accumulation never does."
        ),
    ),
    Rule(
        "implicit-cast",
        "error",
        "a float->float dtype-changing cast the PrecisionPolicy.cast_whitelist "
        "did not declare — a silent up- or downcast the migration plan never "
        "audited",
        description=(
            "Every dtype-changing float cast in a traced program must appear "
            "in PrecisionPolicy.cast_whitelist as a (src, dst) pair (by "
            "default exactly the f32<->bf16 boundary). Casts to float64 are "
            "excluded here — the fp64-promotion rule owns those "
            "unconditionally. Each finding names the node, the src->dst "
            "pair, and the provenance chain of the value being cast."
        ),
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

_ALL_RULES += [
    # -- the mesh passes (collective_check, spmd_check; JAX ids) -----------
    Rule(
        "collective-shape",
        "error",
        "a preset's mesh extents and collective operand shapes disagree "
        "(halo ring-exchange rows vs shard size, batch vs dp, m_graphs vs "
        "branch) — the collective fails or drops data at runtime",
    ),
    Rule(
        "spmd-shard-footprint",
        "error",
        "a multi-device preset's per-device sharded operand footprint "
        "(support strips/shards + batch shard) exceeds the per-core "
        "budget — the resident-memory math extended to mesh shards; the "
        "step OOMs on every device at once",
    ),
    Rule(
        "spmd-collective-manifest",
        "error",
        "a multi-device step, as executed and counted (step_comm_report), "
        "runs a collective (kind x mesh axis) its plan never declared — "
        "traffic the plan never asked for — or a declared required "
        "collective never runs, meaning the plan did not engage; or a "
        "multi-device preset lacks its declared train/serve manifests, or "
        "requires a collective over an axis of extent 1",
    ),
    Rule(
        "spmd-wire-budget",
        "error",
        "an executed step's halo ring exchange moves more than the "
        "boundary-rows bound in one call, or its dp all-reduce traffic "
        "exceeds the gradient-sync model (2 x param_bytes + slack) — a "
        "communication regression. The JAX rule's rebaselined "
        "per-program ceilings (WIRE_BUDGETS, which its --rebaseline "
        "re-measures from compiled programs) have no counterpart: the "
        "port lowers no programs, so it holds executed steps to a model",
    ),
    # -- the AST lint (lint; JAX ids, worded for CUDA-graph capture) -------
    Rule(
        "host-sync-in-jit",
        "error",
        "host-synchronizing call (.item()/.cpu()/.tolist()/.numpy()/float()/"
        "np.asarray/torch.cuda.synchronize) inside a function reachable from "
        "a CUDA-graph-captured body — a hidden device->host readback that "
        "fails the capture on the card",
    ),
    Rule(
        "traced-control-flow",
        "error",
        "Python if/while on a device tensor (a torch.* call or .any()/.all())"
        " inside a capture-reachable function — a hidden readback that fails"
        " under capture, or silently freezes one branch into the graph",
    ),
    Rule(
        "unfenced-timing",
        "warning",
        "time.time()/perf_counter() span around device dispatch with no "
        "readback fence — CUDA launches are asynchronous, so it times the "
        "launch, not the work (see stmgcn_tpu_torch.utils.profiling)",
    ),
    Rule(
        "partition-axis-name",
        "error",
        "a stmgcn_tpu_torch.utils.comm collective names a mesh axis that no "
        "mesh in this repo defines (known axes: dp, region, branch, and "
        "world for every rank)",
    ),
    Rule(
        "unparseable-module",
        "error",
        "a module of the linted tree does not parse — no rule can check it "
        "(the JAX lint files this under jax-compat-import, which has no "
        "counterpart in the port)",
    ),
    # -- static concurrency analysis (concurrency_check; JAX ids) ----------
    Rule(
        "unguarded-attr",
        "error",
        "an attribute written under `with self._lock` in one method is "
        "read/written lock-free in another method of the same class — a "
        "data race; the finding carries the guarding-writer -> lock-free-"
        "access chain",
    ),
    Rule(
        "lock-order-cycle",
        "error",
        "the global lock-acquisition graph (built across modules through "
        "the type-informed call graph) contains a cycle — two threads "
        "taking the locks in opposite orders deadlock",
    ),
    Rule(
        "condvar-discipline",
        "error",
        "Condition.wait() outside a while-predicate loop (spurious "
        "wakeup / missed notify), or wait/notify without the condvar's "
        "owning lock held (RuntimeError at runtime)",
    ),
    Rule(
        "thread-lifecycle",
        "error",
        "a non-daemon Thread started with no reachable join()/cancel() "
        "path (shutdown hangs on it), or a blocking call (queue.get/put, "
        "sleep, join, Event.wait, device sync) made while holding a lock",
    ),
]

RULES: Dict[str, Rule] = {r.id: r for r in _ALL_RULES}
