"""The port's collective layer and its accounting
(``stmgcn_tpu_torch/utils/comm.py``) and the executed manifest check
(``parallel/manifest.py`` ``check_executed``).

Mirrors ``tests/test_comm.py``: where the JAX package parses the compiled
HLO, the port counts every collective it runs. One training step of a
small model on a dp=2 x branch=3 CPU mesh (gloo) with the clip on moves
exactly (each the op's output bytes, the JAX rule):

- the gradient bucket: one all-reduce over ``dp`` of 8 bytes per local
  parameter (the rank's branch slice plus the head: the float32 gradients
  summed as float64, so the sum does not depend on its order);
- the step's loss: one 4-byte all-reduce over ``dp``;
- the fusion: one all-reduce over ``branch`` of ``B/dp x N x gcn_hidden``
  float32 per forward;
- the clip norm: one 4-byte all-reduce over ``branch``;

and nothing else. The step keeps to ``manifest_for_config``'s manifest;
an added all-gather over ``dp`` is flagged as undeclared, and a dp-only
manifest flags the branch traffic. The counts reach the registry as the
``comm.bytes``/``comm.calls`` counters.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_rank_worker as ranks  # noqa: E402

from stmgcn_tpu.config import preset as jax_preset  # noqa: E402
from stmgcn_tpu.parallel.manifest import manifest_for_config as jax_manifest  # noqa: E402
from stmgcn_tpu_torch.config import ExperimentConfig  # noqa: E402
from stmgcn_tpu_torch.obs.registry import REGISTRY  # noqa: E402
from stmgcn_tpu_torch.parallel import check_executed, manifest_for_config  # noqa: E402
from stmgcn_tpu_torch.parallel.manifest import CollectiveManifest  # noqa: E402
from stmgcn_tpu_torch.utils import comm  # noqa: E402


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    return ranks.launch(6, ["step_report", "feature_step"], tmp_path_factory.mktemp("comm"),
                        dp=2, branch=3, train={"grad_clip_norm": 0.01})


def test_step_bytes_match_the_analytic_counts(step):
    for res in step:
        r = res["step_report"]
        rows = r["rows"].stop - r["rows"].start
        fusion = rows * r["nodes"] * r["gcn"] * 4
        assert r["report"]["what"] == {
            "all-reduce/dp/grads": {"calls": 1, "bytes": 8 * r["numel"]},
            "all-reduce/dp/loss": {"calls": 1, "bytes": 4},
            "all-reduce/branch/fusion": {"calls": 1, "bytes": fusion},
            "all-reduce/branch/clip-norm": {"calls": 1, "bytes": 4},
        }
        assert r["report"]["ops"] == {
            "all-reduce/dp": {"calls": 2, "bytes": 8 * r["numel"] + 4},
            "all-reduce/branch": {"calls": 2, "bytes": fusion + 4},
        }
        assert r["report"]["total_bytes"] == 8 * r["numel"] + 8 + fusion


def test_step_keeps_to_its_manifest(step):
    for res in step:
        r = res["step_report"]
        assert r["problems"] == []
        assert r["leak_problems"] == [
            "undeclared all-gather over 'dp' (1 call(s), 8 bytes) in program 'train'"]
        assert len(r["dp_only_problems"]) == 1
        assert "undeclared all-reduce over 'branch'" in r["dp_only_problems"][0]


def test_step_raises_no_spmd_finding(step, tmp_path):
    """The step held to the executed manifest and the dp wire model: the
    float64 gradient bucket is exactly ``2 x param_bytes`` (float32) and
    the 4-byte loss rides the 4,096-byte slack; the leaky step's undeclared
    all-gather is one ``spmd-collective-manifest`` finding."""
    from stmgcn_tpu_torch.analysis.spmd_check import (
        manifest_findings,
        wire_figures,
        wire_findings,
    )

    manifest = manifest_for_config(ranks.tiny_config(str(tmp_path), 2, 3))
    for res in step:
        r = res["step_report"]
        assert r["meta"] == {"param_bytes": 4 * r["numel"]}
        assert manifest_findings("train", manifest, r["report"]) == []
        assert wire_findings("train", r["report"], r["meta"]) == []
        assert wire_figures(r["report"], r["meta"]) == {
            "dp_bytes": 8 * r["numel"] + 4, "dp_cap": 8 * r["numel"] + 4096}
        assert r["report"]["max_bytes"]["all-reduce/dp"] == 8 * r["numel"]
        (f,) = manifest_findings("train", manifest, r["leak"])
        assert (f.rule, f.severity, f.path) == (
            "spmd-collective-manifest", "error", "<contract:spmd:train>")
        assert "undeclared all-gather over 'dp'" in f.message
        assert wire_findings("train", r["leak"], r["meta"]) == []


def test_a_guarded_step_agrees_its_flags_in_the_analytic_bytes(step):
    """A step with the divergence guard, health and the ``nan`` sanitizers
    at dp=2 x branch=3 moves the plain step's collectives, the health row's
    loss in the loss sum, and three more: the health stats' branch slices
    (three member vectors and the split non-finite count) over ``branch``,
    the flag word's seven bits and the guard's flag over ``world``; all
    declared only for a config with these features on."""
    for res in step:
        r = res["feature_step"]
        assert r["report"]["what"] == {
            "all-reduce/dp/grads": {"calls": 1, "bytes": 8 * r["numel"]},
            "all-reduce/dp/loss": {"calls": 1, "bytes": 4},
            "all-reduce/branch/fusion": {"calls": 1, "bytes": r["fusion"]},
            "all-reduce/branch/health": {"calls": 1, "bytes": 4 * (3 * r["members"] + 2)},
            "all-reduce/world/checks": {"calls": 1, "bytes": 4 * 7},
            "all-reduce/world/guard": {"calls": 1, "bytes": 4},
        }
        assert r["problems"] == []
        assert r["plain_problems"] == [
            "undeclared all-reduce over 'world' (2 call(s), 32 bytes) in program 'train'"]


def test_agreed_flags_are_declared_with_their_features_only():
    cfg = ExperimentConfig.from_dict(jax_preset("branchpar").to_dict())
    plain = manifest_for_config(cfg).to_dict()
    assert manifest_for_config(cfg).lookup("all-reduce", "world") is None
    for train in ({"checks": "nan"}, {"divergence_guard": True}, {}):
        on = ExperimentConfig.from_dict(cfg.to_dict())
        for k, v in train.items():
            setattr(on.train, k, v)
        decl = manifest_for_config(on, debug_nans=not train).lookup("all-reduce", "world")
        assert decl is not None and not decl.required
        assert manifest_for_config(on, program="serve").to_dict() == manifest_for_config(
            cfg, program="serve").to_dict()
    one = ExperimentConfig.from_dict(cfg.to_dict())
    one.mesh.dp = one.mesh.branch = 1
    one.train.checks = "all"
    assert manifest_for_config(one).lookup("all-reduce", "world") is None
    assert manifest_for_config(cfg).to_dict() == plain


@pytest.mark.parametrize("name", ["multicity", "scaled", "bandedbranch", "default"])
@pytest.mark.parametrize("program", ["train", "serve"])
def test_manifest_for_config_matches_jax(name, program):
    jcfg = jax_preset(name)
    cfg = ExperimentConfig.from_dict(jcfg.to_dict())
    for banded in (False, True):
        want = jax_manifest(jcfg, program, banded=banded).to_dict()
        assert manifest_for_config(cfg, program, banded=banded).to_dict() == want


def test_check_executed_flags_a_plan_that_never_engaged():
    cfg = ExperimentConfig.from_dict(jax_preset("multicity").to_dict())
    manifest = manifest_for_config(cfg)
    assert check_executed(manifest, {"ops": {"all-reduce/dp": {"calls": 2, "bytes": 8}}}) == []
    (problem,) = check_executed(manifest, {"ops": {}})
    assert "required all-reduce over 'dp' never ran" in problem
    capped = CollectiveManifest("train", tuple(
        d.__class__(d.kind, d.axes, d.required, 1, d.reason) for d in manifest.decls))
    (problem,) = check_executed(capped, {"ops": {"all-reduce/dp": {"calls": 2, "bytes": 8}}})
    assert "more than its max_count 1" in problem


def test_stats_count_and_reach_the_registry():
    stats = comm.CommStats()
    before = REGISTRY.counter("comm.bytes", {"kind": "all-gather", "axis": "dp"}).value
    stats.add("all-gather", "dp", 64, "predictions")
    stats.add("all-gather", "dp", 64, "targets")
    snap = stats.snapshot()
    assert snap["ops"] == {"all-gather/dp": {"calls": 2, "bytes": 128}}
    assert snap["what"]["all-gather/dp/targets"] == {"calls": 1, "bytes": 64}
    assert snap["total_bytes"] == 128 and snap["calls"] == 2
    assert REGISTRY.counter("comm.bytes",
                            {"kind": "all-gather", "axis": "dp"}).value == before + 128
    with pytest.raises(ValueError, match="unknown collective"):
        stats.add("ppermute", "dp", 4)
    stats.reset()
    assert stats.snapshot()["calls"] == 0


def test_an_axis_of_extent_one_moves_nothing():
    from stmgcn_tpu_torch.parallel.mesh import Mesh
    import torch

    mesh = Mesh(2, 1, 1, 0, {"dp": 0, "region": 0, "branch": 0}, {"dp": None, "region": None,
                "branch": None}, {}, "gloo", torch.device("cpu"))
    before = comm.collective_stats()["calls"]
    t = torch.ones(3)
    assert comm.all_reduce(t, "branch", mesh) is t
    report = comm.step_comm_report(comm.all_gather, t, "region", mesh)
    assert report["result"] is t and report["calls"] == 0
    assert comm.collective_stats()["calls"] == before
