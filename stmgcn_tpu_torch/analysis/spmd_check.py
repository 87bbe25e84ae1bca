"""SPMD contracts: per-rank footprints, declared manifests, executed steps.

Counterpart of ``stmgcn_tpu/analysis/spmd_check.py``, in two halves.

**The config half** (pure config math, run by ``lint``):

- ``spmd-shard-footprint``: the ``resident-memory`` arithmetic extended to
  mesh shards, the JAX formula unchanged (:func:`estimate_shard_footprint`):
  each rank's supports (dense row shards ``m_local x K x n_local x
  n_pad``, or banded strips ``n_local x (n_local + 2*halo)`` when the halo
  plan is forced) plus one batch shard, float32, held to the per-core
  budget, which is the trainer's ``RESIDENT_CAP_BYTES`` off the card (the
  figure ``Trainer._resident_cap_bytes`` uses on it);
- ``spmd-collective-manifest``, coverage (:func:`check_manifest_coverage`):
  every multi-device preset has its declared ``train`` and ``serve``
  manifests (:data:`PROGRAM_SPECS`, the JAX table), and no required
  declaration names an axis of extent 1, on which no collective ever runs.

**The executed half.** The JAX pass lowers the composed programs and walks
their HLO; the port has no such programs. Every collective of the port is
one counted call of :mod:`stmgcn_tpu_torch.utils.comm`, so the rules read
what one executed step moved (:func:`~stmgcn_tpu_torch.utils.comm.
step_comm_report`, or ``collective_stats()``):

- :func:`manifest_findings`: the problems of
  :func:`~stmgcn_tpu_torch.parallel.manifest.check_executed` (an
  undeclared collective, a required one that never ran, a count past
  ``max_count``) as ``spmd-collective-manifest`` findings;
- :func:`wire_findings`: the JAX package's two analytic models and nothing
  looser, as ``spmd-wire-budget`` findings: each halo
  ``collective-permute`` call moves at most ``halo x B_local x M_local x
  F_cap x 4`` bytes (``meta`` from
  :func:`stmgcn_tpu_torch.parallel.compose.banded_meta`; a dense program
  has none and gets no permute bound), and a step's ``all-reduce`` over
  ``dp`` moves at most ``2 x param_bytes + 4096``, ``param_bytes`` the
  float32 parameters' bytes (the float64 gradient bucket is exactly ``2 x
  param_bytes``; the loss scalar rides the slack). The JAX rule's
  rebaselined per-program ceilings (``WIRE_BUDGETS``, ``lint
  --rebaseline``) have no counterpart: there are no compiled programs to
  re-measure.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs, resident_budget
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = [
    "PROGRAM_SPECS",
    "check_manifest_coverage",
    "check_shard_footprints",
    "check_spmd_contracts",
    "declared_manifests",
    "estimate_shard_footprint",
    "manifest_findings",
    "param_bytes",
    "spmd_summary",
    "wire_figures",
    "wire_findings",
]

#: declared program registry: name -> (preset, "train"|"serve", banded?).
#: Every preset whose mesh spans more than one device must appear here
#: (coverage is itself checked); ``banded`` marks the programs whose
#: routing engages the halo plan, which flips the manifest's required ops
#: (the JAX table)
PROGRAM_SPECS = {
    "multicity/train": ("multicity", "train", False),
    "multicity/serve": ("multicity", "serve", False),
    "scaled/train": ("scaled", "train", True),
    "scaled/serve": ("scaled", "serve", True),
    "branchpar/train": ("branchpar", "train", False),
    "branchpar/serve": ("branchpar", "serve", False),
    "bandedbranch/train": ("bandedbranch", "train", True),
    "bandedbranch/serve": ("bandedbranch", "serve", True),
}

_ITEMSIZE = 4  # float32 parameters, supports and data
_PSUM_SLACK_BYTES = 4096  # loss/count scalars riding the dp sync


def _emit(findings: List[Finding], rule: str, name: str, message: str) -> None:
    findings.append(finding(rule, "spmd", name, message))


# -- the declared manifests ------------------------------------------------------

def declared_manifests(configs: Optional[Iterable[Tuple[str, object]]] = None) -> dict:
    """``{program name: CollectiveManifest}`` of every declared program of
    :data:`PROGRAM_SPECS` whose preset is among ``configs`` (default:
    every preset), built from that config (pure config)."""
    from stmgcn_tpu_torch.parallel.manifest import manifest_for_config

    cfgs = dict(preset_configs() if configs is None else configs)
    return {name: manifest_for_config(cfgs[p], program=kind, banded=banded)
            for name, (p, kind, banded) in PROGRAM_SPECS.items() if p in cfgs}


def check_manifest_coverage(
    configs: Optional[Iterable[Tuple[str, object]]] = None,
) -> List[Finding]:
    """Every multi-device preset among ``configs`` (``(name, config)``
    pairs, a preset's by its name; default: every preset) has a declared
    train and serve program, and no required declaration of either runs
    over an axis of extent 1 (a required collective there never runs, so
    every executed step would break the manifest). Configs named after no
    preset are out of its scope, as in the JAX pass."""
    from stmgcn_tpu_torch.config import PRESETS

    configs = list(preset_configs() if configs is None else configs)
    manifests = declared_manifests(configs)
    findings: List[Finding] = []
    for name, cfg in configs:
        if cfg.mesh.n_devices <= 1 or name not in PRESETS:
            continue
        for kind in ("train", "serve"):
            program = f"{name}/{kind}"
            if program not in manifests:
                _emit(findings, "spmd-collective-manifest", name,
                      f"{name}: multi-device preset has no declared {kind} program — add "
                      f"{program!r} to analysis/spmd_check.PROGRAM_SPECS so its executed "
                      "collectives are held to a manifest")
                continue
            for decl in manifests[program].decls:
                flat = [ax for ax in decl.axes.split("+")
                        if ax != "world" and getattr(cfg.mesh, ax) == 1]
                if decl.required and flat:
                    _emit(findings, "spmd-collective-manifest", program,
                          f"{program}: required {decl.kind} over '{decl.axes}' names an "
                          f"axis of extent 1 ({', '.join(flat)}) — no collective runs there,"
                          " so every executed step would break the manifest")
    return findings


def spmd_summary(configs: Optional[Iterable[Tuple[str, object]]] = None) -> dict:
    """The lint gate's ``spmd`` section (the JAX ``spmd_summary``'s keys):
    ``programs``, the declared manifests of :data:`PROGRAM_SPECS` checked
    over ``configs`` (default: every preset); ``collectives``, their
    declarations; ``findings``, :func:`check_spmd_contracts`'. The JAX
    section counts lowered programs and their compiled collectives; the
    port's executed steps are the gate's ``spmd_exec`` section."""
    configs = list(preset_configs() if configs is None else configs)
    manifests = declared_manifests(configs)
    return {"programs": len(manifests),
            "collectives": sum(len(m.decls) for m in manifests.values()),
            "findings": len(check_spmd_contracts(configs))}


# -- the executed half ---------------------------------------------------------

def manifest_findings(program: str, manifest, stats: dict) -> List[Finding]:
    """``spmd-collective-manifest`` findings of one executed step whose
    collectives ``stats`` counts (``step_comm_report``'s report or
    ``collective_stats()``): :func:`~stmgcn_tpu_torch.parallel.manifest.
    check_executed`'s problems, at ``<contract:spmd:{program}>``."""
    from stmgcn_tpu_torch.parallel.manifest import check_executed

    findings: List[Finding] = []
    for problem in check_executed(manifest, stats):
        _emit(findings, "spmd-collective-manifest", program,
              f"{program}: {problem} — fix the plan's traffic, or declare it in the "
              "plan's manifest fragment (parallel/placement.py) if the movement is intended")
    return findings


def param_bytes(model) -> int:
    """The float32 bytes of ``model``'s parameters on this rank (its branch
    slice on a branch mesh): the dp wire model's ``param_bytes``."""
    return _ITEMSIZE * sum(p.numel() for p in model.parameters())


def wire_figures(stats: dict, meta: dict) -> dict:
    """The wire models' figures of one step beside their caps:
    ``{"dp_bytes", "dp_cap"}`` when ``meta`` has ``param_bytes`` and
    ``{"permute_max", "permute_cap"}`` when it has the halo plan's
    extents (None where the step ran no such collective). ``stats`` is
    ``step_comm_report``'s report or ``collective_stats()``: a permute's
    largest call is its ``max_bytes`` entry, since sums cannot give it."""
    ops = stats.get("ops", {})
    out = {}
    if "param_bytes" in meta:
        dp = ops.get("all-reduce/dp")
        out["dp_bytes"] = None if dp is None else dp["bytes"]
        out["dp_cap"] = 2 * meta["param_bytes"] + _PSUM_SLACK_BYTES
    if "halo" in meta:
        calls = [stats["max_bytes"][k] for k in ops if k.startswith("collective-permute/")]
        out["permute_max"] = max(calls) if calls else None
        out["permute_cap"] = (meta["halo"] * meta["b_local"] * meta["m_local"]
                              * meta["f_cap"] * _ITEMSIZE)
    return out


def wire_findings(program: str, stats: dict, meta: dict) -> List[Finding]:
    """``spmd-wire-budget`` findings of one executed step (module
    docstring): ``meta`` carries ``halo``/``b_local``/``m_local``/
    ``f_cap`` for the halo bound and ``param_bytes`` for the dp bound;
    either may be missing."""
    findings: List[Finding] = []
    ops = stats.get("ops", {})
    fig = wire_figures(stats, meta)
    if "halo" in meta:
        cap = fig["permute_cap"]
        for key in sorted(ops):
            if not key.startswith("collective-permute/"):
                continue
            biggest = stats["max_bytes"][key]
            if biggest > cap:
                _emit(findings, "spmd-wire-budget", program,
                      f"{program}: a halo collective-permute over '{key.split('/', 1)[1]}' "
                      f"moves {biggest:,} bytes in one call, over the boundary-rows bound "
                      f"{cap:,} (halo {meta['halo']} x B_local {meta['b_local']} x M_local "
                      f"{meta['m_local']} x F_cap {meta['f_cap']} x {_ITEMSIZE}) — the "
                      "exchange is moving more than boundary rows, which erases the banded "
                      "plan's N/(2·halo)x wire reduction")
    if fig.get("dp_bytes") is not None and fig["dp_bytes"] > fig["dp_cap"]:
        _emit(findings, "spmd-wire-budget", program,
              f"{program}: dp all-reduce traffic {fig['dp_bytes']:,} bytes exceeds the "
              f"gradient-sync model 2 x param_bytes ({meta['param_bytes']:,}) + "
              f"{_PSUM_SLACK_BYTES} — something beyond gradients/loss is syncing over dp")
    return findings


# -- per-device footprint math (pure config) --------------------------------------

def estimate_shard_footprint(cfg) -> dict:
    """Per-device operand bytes of a config's sharded training step.

    The ``resident-memory`` arithmetic extended to mesh shards: supports
    (dense row shards over ``region`` and graph shards over ``branch``,
    or banded strips ``n_local x (n_local + 2*halo)`` when the halo plan
    is forced) plus one batch's ``x``/``y`` shard. Data is float32
    whatever the compute dtype, as in ``resident_check``. Pure config
    math: nothing is built.
    """
    from stmgcn_tpu_torch.data.windowing import WindowSpec

    d, mesh = cfg.data, cfg.mesh
    spec = WindowSpec(d.serial_len, d.daily_len, d.weekly_len, d.day_timesteps,
                      horizon=d.horizon)
    cols = d.cols if d.cols is not None else d.rows
    if d.city_rows is not None:
        city_nodes = [r * r for r in d.city_rows]
    else:
        city_nodes = [d.rows * cols] * max(1, d.n_cities)
    ksup = cfg.model.n_supports
    m_local = max(1, cfg.model.m_graphs // mesh.branch)
    region = mesh.region
    supports_bytes = 0
    for n in city_nodes:
        n_pad = -(-n // region) * region
        n_local = n_pad // region
        if mesh.region_strategy == "banded" and region > 1:
            halo = min(mesh.halo if mesh.halo is not None else n_local // 2, n_local)
            supports_bytes += m_local * ksup * n_local * (n_local + 2 * halo) * _ITEMSIZE
        else:
            # dense row shard (the auto plan's worst case: it may route
            # every branch dense)
            supports_bytes += m_local * ksup * n_local * n_pad * _ITEMSIZE
    n_pad = -(-max(city_nodes) // region) * region
    b_local = -(-cfg.train.batch_size // mesh.dp)
    x_bytes = b_local * spec.seq_len * (n_pad // region) * _ITEMSIZE
    y_bytes = b_local * max(1, d.horizon) * (n_pad // region) * _ITEMSIZE
    return {"supports_bytes": supports_bytes, "batch_bytes": x_bytes + y_bytes,
            "total_bytes": supports_bytes + x_bytes + y_bytes}


def check_shard_footprints(
    configs: Optional[Iterable[Tuple[str, object]]] = None,
    budget_bytes: Optional[int] = None,
) -> List[Finding]:
    """Per-device operand footprint vs the per-core budget, every
    multi-device config (default: every preset; budget: the trainer's
    ``RESIDENT_CAP_BYTES``). One device's residency is
    ``resident-memory``'s."""
    configs = preset_configs() if configs is None else configs
    budget_bytes = resident_budget() if budget_bytes is None else budget_bytes
    findings: List[Finding] = []
    for name, cfg in configs:
        if cfg.mesh.n_devices <= 1:
            continue
        est = estimate_shard_footprint(cfg)
        if est["total_bytes"] > budget_bytes:
            _emit(findings, "spmd-shard-footprint", name,
                  f"{name}: per-device sharded operands need {est['total_bytes']:,} bytes "
                  f"(supports {est['supports_bytes']:,} + batch {est['batch_bytes']:,}) but "
                  f"the per-core budget is {budget_bytes:,} — the step OOMs on every device "
                  "at once; raise region/branch extents, shrink the batch, or band the "
                  "supports")
    return findings


def check_spmd_contracts(
    configs: Optional[Iterable[Tuple[str, object]]] = None,
) -> List[Finding]:
    """The config half over ``configs`` (default: every preset): manifest
    coverage, then per-device footprints."""
    configs = list(preset_configs() if configs is None else configs)
    return check_manifest_coverage(configs) + check_shard_footprints(configs)
