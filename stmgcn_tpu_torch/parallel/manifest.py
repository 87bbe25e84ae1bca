"""Declared collective manifests: what a sharding plan promises to move.

A copy of ``stmgcn_tpu/parallel/manifest.py`` (which imports nothing of
JAX): every parallel plan implies a communication signature — the
data-parallel placement all-reduces gradients over ``dp``, branch
parallelism all-reduces the fusion over ``branch``, a region plan gathers
or exchanges node rows over ``region``. A :class:`CollectiveManifest`
writes that signature down as data: the collective kinds and mesh axes a
step is *allowed* (and, for the plan-defining ones, *required*) to run.

The declarations live as fragment tuples next to the code they describe
(``placement.DP_GRAD_SYNC``, ``placement.BRANCH_FUSION``, ...);
:func:`manifest_for_config` composes a config's fragments into one
program's manifest. The JAX package diffs it against the compiled HLO (its
``spmd-collective-manifest`` rule); the port has no compiled program, so
:func:`check_executed` diffs it against what one *executed* step moved,
read off :mod:`stmgcn_tpu_torch.utils.comm`'s counts: a required
declaration that never ran means the plan never engaged, and a collective
with no declaration is traffic the plan never asked for — either is a
violation. ``max_count`` bounds the calls of one kind over one axis in
the step (``None``: unbounded).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["CollectiveDecl", "CollectiveManifest", "check_executed", "manifest_for_config"]


@dataclasses.dataclass(frozen=True)
class CollectiveDecl:
    """One permitted collective: kind (the HLO op's name) x mesh axes
    (``"+"``-joined).

    ``required=True`` marks a plan-defining op — its absence from the
    compiled program means the plan silently never engaged (e.g. the
    banded path fell back to dense GSPMD).
    """

    kind: str
    axes: str
    required: bool = False
    max_count: Optional[int] = None
    reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CollectiveManifest:
    """The full declared signature of one compiled program."""

    program: str
    decls: Tuple[CollectiveDecl, ...]

    def lookup(self, kind: str, axes: str) -> Optional[CollectiveDecl]:
        for d in self.decls:
            if d.kind == kind and d.axes == axes:
                return d
        return None

    def to_dict(self) -> dict:
        return {
            "program": self.program,
            "decls": [d.to_dict() for d in self.decls],
        }


def manifest_for_config(
    cfg, program: str = "train", banded: bool = False, transport: str = "gloo",
    debug_nans: bool = False,
) -> CollectiveManifest:
    """Compose a config's plan fragments into one program manifest.

    ``program`` is ``"train"`` (grads + optimizer: every axis the loss
    and parameters span syncs) or ``"serve"`` (forward only: no gradient
    traffic; a ``dp``-only mesh serves with *zero* collectives, and any
    observed op is implicit resharding). ``banded=True`` declares the
    explicit halo plan for the region axis — permutes required — which
    is exactly when routing produced banded strips; otherwise a
    ``region`` axis gets GSPMD's dense signature (node all-gathers).
    ``transport`` is the job's backend: over NCCL a region mesh's training
    step also reduce-scatters its input cotangents
    (:func:`~stmgcn_tpu_torch.utils.comm.reduce_scatter`), which gloo
    all-reduces; the gloo manifest is the JAX package's. A training step
    with the sanitizers on (``train.checks``), the divergence guard or
    ``debug_nans`` (the trainer's argument, not the config's) also agrees
    its flags over every rank (``AGREED_FLAGS``, optional); without them
    the manifest is the plain one.
    """
    from stmgcn_tpu_torch.parallel.placement import (
        AGREED_FLAGS,
        HALO_EXCHANGE,
        BRANCH_FUSION,
        DP_GRAD_SYNC,
        GSPMD_REGION,
    )

    train = program == "train"
    decls: list = []
    if cfg.mesh.dp > 1 and train:
        decls.extend(DP_GRAD_SYNC)
    if cfg.mesh.region > 1:
        if banded:
            decls.extend(HALO_EXCHANGE)
        # dense-branch signal gathers (and, in banded programs, the
        # backward-pass transposes and node-pooling reductions) ride
        # GSPMD's region signature either way
        decls.extend(
            dataclasses.replace(d, required=d.required and not banded)
            for d in GSPMD_REGION
        )
        decls.append(
            CollectiveDecl(
                "all-reduce", "region", required=False,
                reason="node-pooling (gate context) and, in training, "
                "loss-mean / weight-grad reductions over the "
                "region-sharded node axis",
            )
        )
        if train and transport == "nccl":
            decls.append(
                CollectiveDecl(
                    "reduce-scatter", "region", required=False,
                    reason="the graph convs' input cotangent summed over the node "
                    "rows (gloo, which has no reduce-scatter, all-reduces it)",
                )
            )
    if cfg.mesh.branch > 1:
        decls.extend(BRANCH_FUSION)
        if train:
            decls.append(
                CollectiveDecl(
                    "all-gather", "branch", required=False,
                    reason="optimizer re-gather of branch-sharded "
                    "parameter updates",
                )
            )
    if train and cfg.mesh.n_devices > 1 and (
            cfg.train.checks is not None or cfg.train.divergence_guard or debug_nans):
        decls.extend(AGREED_FLAGS)
    return CollectiveManifest(program=program, decls=tuple(decls))


def check_executed(manifest: CollectiveManifest, stats: dict) -> list:
    """The violations of ``manifest`` by one executed step whose
    collectives ``stats`` counts (:func:`~stmgcn_tpu_torch.utils.comm.
    step_comm_report`'s or ``collective_stats``'s ``"ops"``, keyed
    ``"kind/axis"``): each required declaration the step never ran, each
    collective it ran that no declaration covers, and each count past a
    declaration's ``max_count``. An empty list: the step kept to the
    manifest."""
    ops = stats.get("ops", stats)
    problems = []
    for decl in manifest.decls:
        seen = ops.get(f"{decl.kind}/{decl.axes}", {"calls": 0})["calls"]
        if decl.required and not seen:
            problems.append(f"required {decl.kind} over {decl.axes!r} never ran "
                            f"({decl.reason}): the plan did not engage")
        if decl.max_count is not None and seen > decl.max_count:
            problems.append(f"{decl.kind} over {decl.axes!r} ran {seen} times, more than "
                            f"its max_count {decl.max_count}")
    for name, value in sorted(ops.items()):
        kind, axes = name.split("/", 1)
        if value["calls"] and manifest.lookup(kind, axes) is None:
            problems.append(f"undeclared {kind} over {axes!r} ({value['calls']} call(s), "
                            f"{value['bytes']} bytes) in program {manifest.program!r}")
    return problems
